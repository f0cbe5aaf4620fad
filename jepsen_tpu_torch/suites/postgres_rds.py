"""PostgreSQL-RDS suite.

The port's copy of :mod:`jepsen_tpu.suites.postgres_rds`.

Reference: postgres-rds/src/jepsen/dirty_read.clj — unlike every other
suite, the database is an *externally managed* RDS endpoint: there is
no DB automation at all (the DB is a noop), and every client connects
to the one endpoint given by ``--endpoint`` rather than to its own
node.  The workload probes READ COMMITTED dirty reads: writers insert
rows in transactions, readers select, and a final read determines which
writes are visible.

Clients speak pgwire via :mod:`.sql` (dialect ``pg``); the endpoint is
passed as ``opts["host"]`` (every node maps to the same endpoint,
matching the reference's single-endpoint topology).
"""

from __future__ import annotations

from typing import Optional

from .. import db as db_mod
from . import common, sql

PORT = 5432


def _opts(opts: Optional[dict]) -> dict:
    o = dict(opts or {})
    o.setdefault("dialect", "pg")
    o.setdefault("port", PORT)
    o.setdefault("user", "postgres")
    if o.get("endpoint"):
        o.setdefault("host", o["endpoint"])
    return o


def db(opts: Optional[dict] = None):
    """RDS is managed; nothing to install.  (reference:
    postgres-rds has no db.clj — the endpoint is a CLI param)"""
    return db_mod.noop()


def client(opts: Optional[dict] = None):
    return sql.SetClient(_opts(opts))


WORKLOADS = ("set", "register", "bank", "list-append")


def workloads(opts: Optional[dict] = None) -> dict:
    opts = _opts(opts)
    return {w: common.generic_workload(w, opts) for w in WORKLOADS}


def test(opts: Optional[dict] = None) -> dict:
    opts = _opts(opts)
    wname = opts.get("workload", "set")
    w = workloads(opts)[wname]
    return common.build_test(
        f"postgres-rds-{wname}", opts, db=db(opts),
        client=sql.client_for(wname, opts), workload=w,
    )
