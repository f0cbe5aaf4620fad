"""Wire-protocol clients, from scratch on the Python stdlib — the port's
copy of :mod:`jepsen_tpu.suites.proto`.

The reference suites pull in a JVM driver per database (JDBC, the
Aerospike Java client, carmine for Redis, …).  Since this framework's
clients are Python and the environment forbids new dependencies, each
protocol the suites need is implemented here directly:

- :mod:`resp`    — Redis serialization protocol (disque, raftis)
- :mod:`http`    — JSON-over-HTTP helper (etcd, consul)
- :mod:`pgwire`  — PostgreSQL wire protocol v3 (postgres-rds, stolon)
- :mod:`mysql`   — MySQL client/server protocol (:mod:`..sql`'s ``mysql``
                   dialect)
- :mod:`zk`      — ZooKeeper jute protocol (zookeeper)
- :mod:`cql`     — Cassandra CQL binary protocol v4 (yugabyte's YCQL)

The reference's other protocols (aerospike, amqp, hazelcast, irc, mongo,
reql) serve suites the port does not have yet.

Each client is deliberately small: connect, authenticate, issue the
handful of statements the workloads need, and surface errors as
:class:`ProtocolError` with enough detail for clients to classify
ok/fail/info.
"""

from __future__ import annotations


class ProtocolError(Exception):
    """A database-reported error (definite failure)."""

    def __init__(self, message: str, code=None):
        super().__init__(message)
        self.code = code


class IndeterminateError(Exception):
    """The connection died mid-request: the op may or may not have
    applied (maps to a :type :info completion)."""
