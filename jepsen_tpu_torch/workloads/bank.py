"""Bank-transfer workload: transfers between accounts must preserve the
total balance (a snapshot-isolation probe) — the port's copy of
:mod:`jepsen_tpu.workloads.bank`.

Test map options: ``accounts`` (ids), ``total-amount``, ``max-transfer``.

One difference by design: a read's balance map read back from JSON
(``cli analyze`` of a stored run) has its integer account ids as
strings; the checker maps a key back to the account whose ``str`` it
is, so a stored run re-checks to the live run's verdict (the
reference's checker reports every such key as ``unexpected-key``).
(reference: jepsen/src/jepsen/tests/bank.clj)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .. import checker as checker_mod
from .. import generator as gen
from ..checker import Checker
from ..history import OK


def read(test, ctx) -> dict:
    """(reference: bank.clj:20-23)"""
    return {"type": "invoke", "f": "read"}


def transfer(test, ctx) -> dict:
    """A random amount between two random accounts.
    (reference: bank.clj:25-33)"""
    accounts = test["accounts"]
    return {
        "type": "invoke",
        "f": "transfer",
        "value": {
            "from": accounts[gen.rng.randrange(len(accounts))],
            "to": accounts[gen.rng.randrange(len(accounts))],
            "amount": 1 + gen.rng.randrange(test["max-transfer"]),
        },
    }


#: Transfers only between different accounts.  (reference: bank.clj:35-39)
diff_transfer = gen.filter(
    lambda op: op["value"]["from"] != op["value"]["to"], transfer
)


def generator():
    """A mixture of reads and transfers.  (reference: bank.clj:41-44)"""
    return gen.mix([diff_transfer, read])


def err_badness(test: dict, err: dict) -> float:
    """How egregious is a bank error?  (reference: bank.clj:46-55)"""
    t = err["type"]
    if t == "unexpected-key":
        return len(err["unexpected"])
    if t == "nil-balance":
        return len(err["nils"])
    if t == "wrong-total":
        return abs((err["total"] - test["total-amount"]) / test["total-amount"])
    if t == "negative-value":
        return -sum(err["negative"])
    return 0


def account_keys(value: dict, accts: set) -> dict:
    """A balance map with each key that is not an account but is the
    ``str`` of one (a JSON object key) mapped back to that account."""
    names = {str(a): a for a in accts}
    if all(k in accts or k not in names for k in value):
        return value
    return {(k if k in accts else names.get(k, k)): v
            for k, v in value.items()}


def check_op(accts: set, total: int, negative_balances: bool, op) -> Optional[dict]:
    """Errors in one read's balance map.  (reference: bank.clj:57-82)"""
    value = account_keys(op.value or {}, accts)
    ks = list(value.keys())
    balances = list(value.values())
    unexpected = [k for k in ks if k not in accts]
    if unexpected:
        return {"type": "unexpected-key", "unexpected": unexpected, "op": op}
    nils = {k: v for k, v in value.items() if v is None}
    if nils:
        return {"type": "nil-balance", "nils": nils, "op": op}
    s = sum(balances)
    if s != total:
        return {"type": "wrong-total", "total": s, "op": op}
    negative = [b for b in balances if b < 0]
    if not negative_balances and negative:
        return {"type": "negative-value", "negative": negative, "op": op}
    return None


class _BankChecker(Checker):
    def __init__(self, checker_opts: dict):
        self.negative_balances = bool(checker_opts.get("negative-balances?"))

    def check(self, test, history, opts=None):
        accts = set(test["accounts"])
        total = test["total-amount"]
        reads = [op for op in history if op.type == OK and op.f == "read"]
        errors: Dict[str, list] = {}
        for op in reads:
            err = check_op(accts, total, self.negative_balances, op)
            if err is not None:
                errors.setdefault(err["type"], []).append(err)
        all_errs = [e for errs in errors.values() for e in errs]
        first_error = (
            min(all_errs, key=lambda e: e["op"].index) if all_errs else None
        )
        summary = {}
        for etype, errs in errors.items():
            entry = {
                "count": len(errs),
                "first": errs[0],
                "worst": max(errs, key=lambda e: err_badness(test, e)),
                "last": errs[-1],
            }
            if etype == "wrong-total":
                entry["lowest"] = min(errs, key=lambda e: e["total"])
                entry["highest"] = max(errs, key=lambda e: e["total"])
            summary[etype] = entry
        return {
            "valid?": not all_errs,
            "read-count": len(reads),
            "error-count": len(all_errs),
            "first-error": first_error,
            "errors": summary,
        }


def checker(checker_opts: Optional[dict] = None) -> Checker:
    """All reads sum to total-amount; balances non-negative unless
    negative-balances?.  (reference: bank.clj:84-121)"""
    return _BankChecker(checker_opts or {})


class _BankPlotter(Checker):
    def check(self, test, history, opts=None):
        from ..checker import perf

        reads = [op for op in history if op.type == OK and op.f == "read"]
        if not reads:
            return {"valid?": True}
        nodes = test.get("nodes", [])
        series: Dict[Any, list] = {}
        for op in reads:
            node = (
                nodes[op.process % len(nodes)]
                if nodes and isinstance(op.process, int)
                else op.process
            )
            totals = [v for v in (op.value or {}).values() if v is not None]
            series.setdefault(node, []).append(
                (op.time / 1e9, sum(totals))
            )
        perf.scatter_plot(
            test,
            series,
            path_components=list((opts or {}).get("subdirectory", []))
            + ["bank.svg"],
            title=f"{test.get('name', 'test')} bank",
            ylabel="Total of all accounts",
            history=history,
        )
        return {"valid?": True}


def plotter() -> Checker:
    """Balances-over-time scatter plot, one series per node.
    (reference: bank.clj:151-177; SVG instead of gnuplot)"""
    return _BankPlotter()


def test(opts: Optional[dict] = None) -> dict:
    """A partial test: default accounts/amounts + generator + checker;
    ``accounts``/``total-amount``/``max-transfer`` opts override the
    defaults.  (reference: bank.clj:179-192)"""
    opts = opts or {}
    return {
        "max-transfer": opts.get("max-transfer", 5),
        "total-amount": opts.get("total-amount", 100),
        "accounts": list(opts.get("accounts", range(8))),
        "checker": checker_mod.compose(
            {"SI": checker(opts), "plot": plotter()}
        ),
        "generator": generator(),
    }
