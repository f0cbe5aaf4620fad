"""Per-database test suites — the port's copy of :mod:`jepsen_tpu.suites`.

Each suite is a module under ``jepsen_tpu_torch.suites`` that exposes
``db(opts)``, ``client(opts)``, ``workloads(opts)`` and ``test(opts)``
(a full runnable test map); :mod:`.common` holds the assembly every
suite ends with (:func:`~.common.build_test`).

The port has one suite so far, ``localkv``: a native replicated register
(``native/repregd.cc``) built on each node with the host's g++, run as
real processes, partitioned and killed.  The reference's other suites
drive servers over their wire protocols (``jepsen_tpu/suites/proto``);
asking for one raises ``NotImplementedError`` naming its module.
"""

from __future__ import annotations

import importlib

#: the suites the port runs
SUITES = ("localkv",)

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
