"""Per-database test suites — the port's copy of :mod:`jepsen_tpu.suites`.

Each suite is a module under ``jepsen_tpu_torch.suites`` that exposes
``db(opts)``, ``client(opts)``, ``workloads(opts)`` and ``test(opts)``
(a full runnable test map); :mod:`.common` holds the DB base
(:class:`~.common.DaemonDB`), the generic workloads and the assembly
every suite ends with (:func:`~.common.build_test`).

The port's suites:

- ``localkv``: a native replicated register (``native/repregd.cc``)
  built on each node with the host's g++, run as real processes,
  partitioned and killed;
- ``etcd`` and ``consul`` over HTTP (:mod:`.proto.http`), ``raftis`` and
  ``disque`` over RESP (:mod:`.proto.resp`), ``zookeeper`` over its jute
  protocol (:mod:`.proto.zk`), ``postgres_rds`` and ``stolon`` over
  pgwire (:mod:`.proto.pgwire`, through :mod:`.sql`, whose ``mysql``
  dialect speaks :mod:`.proto.mysql`);
- ``cockroachdb`` over pgwire (the ``cockroach`` dialect) with its own
  workloads (:mod:`.monotonic`, :mod:`.sequential`, :mod:`.comments`,
  :mod:`.crdb_sets`, :mod:`.g2_sql`) and fault menu (:mod:`.crdb_nemesis`),
  and ``galera``, ``percona`` and ``mysql_cluster`` over MySQL, with the
  dirty-read probe of :mod:`.dirty_reads_sql`;
- ``tidb`` over MySQL (pd, tikv and tidb on every node) with its
  transactional and table clients and its fault menu
  (:mod:`.tidb_nemesis`);
- ``yugabyte`` over CQL (:mod:`.proto.cql`, the YCQL clients) and pgwire
  (the YSQL clients, through :mod:`.sql`), masters on the first RF nodes
  and tservers everywhere, with its fault menu (:mod:`.yb_nemesis`);
- ``dgraph`` over its HTTP API (:mod:`.proto.http`; upsert blocks and
  startTs transactions), zero on the first node and alphas everywhere,
  with its fault menu (:mod:`.dgraph_nemesis`: alpha and zero kills,
  tablet moves under :mod:`..trace` spans, clock skew).

The reference's other suites drive servers over protocols the port does
not have yet; asking for one raises ``NotImplementedError`` naming its
module.
"""

from __future__ import annotations

import importlib

#: the suites the port runs
SUITES = (
    "cockroachdb",
    "consul",
    "dgraph",
    "disque",
    "etcd",
    "galera",
    "localkv",
    "mysql_cluster",
    "percona",
    "postgres_rds",
    "raftis",
    "stolon",
    "tidb",
    "yugabyte",
    "zookeeper",
)

#: every suite of the reference (``jepsen_tpu.suites.SUITES``), ported or not
REFERENCE_SUITES = (
    "aerospike",
    "chronos",
    "cockroachdb",
    "consul",
    "crate",
    "dgraph",
    "disque",
    "elasticsearch",
    "etcd",
    "faunadb",
    "galera",
    "hazelcast",
    "ignite",
    "localkv",
    "logcabin",
    "mongodb_rocks",
    "mongodb_smartos",
    "mysql_cluster",
    "percona",
    "postgres_rds",
    "rabbitmq",
    "raftis",
    "rethinkdb",
    "robustirc",
    "stolon",
    "tidb",
    "yugabyte",
    "zookeeper",
)


def suite(name: str):
    """Import and return the suite module for ``name`` (dashes ok).  A
    suite of the reference that the port lacks raises
    ``NotImplementedError`` naming its module; an unknown name raises
    ``KeyError``, as the reference's does."""
    name = name.replace("-", "_")
    if name not in REFERENCE_SUITES:
        raise KeyError(
            f"unknown suite {name!r}; known: {sorted(REFERENCE_SUITES)}")
    if name not in SUITES:
        raise NotImplementedError(
            f"suite {name!r} (the reference's jepsen_tpu/suites/{name}.py) "
            f"is not ported to jepsen_tpu_torch yet; ported: {list(SUITES)}")
    return importlib.import_module(f"jepsen_tpu_torch.suites.{name}")
