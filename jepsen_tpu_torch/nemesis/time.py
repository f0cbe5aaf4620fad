"""Clock-fault nemesis: reset / bump / strobe node clocks.

The port's copy of :mod:`jepsen_tpu.nemesis.time`.

(reference: jepsen/src/jepsen/nemesis/time.clj — compile! uploads C
sources and gccs them on each DB node :20-50, install! :52-84,
bump-time! :86-91, strobe-time! :92-97, clock-nemesis :98-146, and the
generators reset-gen/bump-gen/strobe-gen :148-205 with bump magnitudes
±2²…2¹⁸ ms and strobe periods 1–1024 ms for ≤32 s :170-192.)

The C sources live in this repo's native/ directory (fresh
implementations) and are shipped + compiled on the nodes, exactly the
reference's deployment mechanism.
"""

from __future__ import annotations

import os
from typing import Optional

from .. import control
from ..control.core import RemoteError
from ..control.util import meh, write_file
from . import Nemesis

BIN_DIR = "/opt/jepsen"
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def _source(name: str) -> str:
    with open(os.path.join(NATIVE_DIR, name)) as f:
        return f.read()


def compile_tool(c_file: str, bin_name: str) -> None:
    """Upload a C source and compile it on the node (reference:
    nemesis/time.clj:20-50 compiles with gcc on the DB node)."""
    with control.su():
        control.execute("mkdir", "-p", BIN_DIR)
        src_path = f"{BIN_DIR}/{bin_name}.c"
        write_file(_source(c_file), src_path)
        control.execute("gcc", "-O2", "-o", f"{BIN_DIR}/{bin_name}", src_path)


def install() -> None:
    """Ensure clock tools exist on the current node.
    (reference: nemesis/time.clj:52-84)"""
    compile_tool("bump-time.c", "bump-time")
    compile_tool("strobe-time.c", "strobe-time")


def bump_time(delta_ms: float) -> str:
    """Jump this node's clock by delta ms.
    (reference: nemesis/time.clj:86-91)"""
    with control.su():
        return control.execute(f"{BIN_DIR}/bump-time", str(int(delta_ms)))


def strobe_time(delta_ms: float, period_ms: float, duration_s: float) -> str:
    """Oscillate this node's clock.  (reference: nemesis/time.clj:92-97)"""
    with control.su():
        return control.execute(
            f"{BIN_DIR}/strobe-time",
            str(int(delta_ms)),
            str(int(period_ms)),
            str(int(duration_s)),
        )


def strobe_time_experiment(
    delta_ms: float, period_ms: float, duration_s: float
) -> str:
    """The experimental one-sided strobe (true vs true+delta) that
    reports its adjustment count; compiled on first use — it's not part
    of the standard clock-nemesis toolkit.  (reference:
    jepsen/resources/strobe-time-experiment.c, shipped but unwired
    there too; native/strobe-time-experiment.c here)"""
    with control.su():
        compile_tool("strobe-time-experiment.c", "strobe-time-experiment")
        return control.execute(
            f"{BIN_DIR}/strobe-time-experiment",
            str(int(delta_ms)),
            str(int(period_ms)),
            str(int(duration_s)),
        )


def reset_time() -> None:
    """Reset via ntpdate, falling back to date -s from the control
    host's clock.  (reference: nemesis/time.clj reset-time!)"""
    import time as _time

    with control.su():
        try:
            control.execute("ntpdate", "-p", "1", "-b", "pool.ntp.org")
        except RemoteError:
            control.execute("date", "+%s", "-s", f"@{int(_time.time())}")


class ClockNemesis(Nemesis):
    """Handles ops: {"f": "reset"|"bump"|"strobe", "value": ...}.
    value for bump: {node: delta-ms}; for strobe:
    {node: {"delta": ms, "period": ms, "duration": s}}.
    (reference: nemesis/time.clj:98-146)"""

    def setup(self, test):
        def init(test_, node):
            install()
            # stop ntp daemons so they don't fight us
            meh(lambda: control.execute("service", "ntp", "stop", check=False))
            meh(lambda: control.execute("service", "ntpd", "stop", check=False))
            meh(lambda: control.execute(
                "systemctl", "stop", "systemd-timesyncd", check=False
            ))

        control.on_nodes(test, init)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        value = op.get("value")
        if f == "reset":
            nodes = value or test["nodes"]
            res = control.on_many(nodes, reset_time)
        elif f == "bump":
            res = control.on_nodes(
                test,
                list(value.keys()),
                lambda t, node: bump_time(value[node]),
            )
        elif f == "strobe":
            res = control.on_nodes(
                test,
                list(value.keys()),
                lambda t, node: strobe_time(
                    value[node]["delta"],
                    value[node]["period"],
                    value[node]["duration"],
                ),
            )
        elif f == "check-offsets":
            # observation-only op: the shared post-op sweep below IS the
            # value (reference: nemesis/time.clj:108,126-130)
            res = None
        else:
            raise ValueError(f"clock nemesis cannot handle f={f!r}")
        clock_offsets = control.on_nodes(test, lambda t, n: current_offset())
        if f == "check-offsets":
            res = clock_offsets
        return {**op, "type": "info", "value": res, "clock-offsets": clock_offsets}

    def teardown(self, test):
        control.on_nodes(test, lambda t, n: reset_time())

    def fs(self):
        return {"reset", "bump", "strobe", "check-offsets"}


def current_offset() -> Optional[float]:
    """This node's clock offset from the control host, seconds."""
    import time as _time

    try:
        remote = float(control.execute("date", "+%s.%N"))
        return remote - _time.time()
    except Exception:
        return None


def clock_nemesis() -> Nemesis:
    return ClockNemesis()


# ---------------------------------------------------------------------------
# Generators (reference: nemesis/time.clj:148-205)
# ---------------------------------------------------------------------------


def _rng():
    from .. import generator as gen

    return gen.rng


def reset_gen(test, ctx):
    """Reset a random subset of nodes' clocks."""
    from ..util import random_nonempty_subset

    nodes = test.get("nodes", [])
    return {"f": "reset", "value": random_nonempty_subset(nodes, _rng())}


def bump_gen(test, ctx):
    """Bump a random subset by ±2²–2¹⁸ ms.
    (reference: nemesis/time.clj:170-173)"""
    from ..util import random_nonempty_subset

    rng = _rng()
    nodes = random_nonempty_subset(test.get("nodes", []), rng)
    return {
        "f": "bump",
        "value": {
            node: (2 ** rng.randint(2, 18)) * rng.choice([-1, 1])
            for node in nodes
        },
    }


def strobe_gen(test, ctx):
    """Strobe a random subset: delta ≤2¹⁸ ms, period 1–1024 ms,
    duration ≤32 s.  (reference: nemesis/time.clj:178-192)"""
    from ..util import random_nonempty_subset

    rng = _rng()
    nodes = random_nonempty_subset(test.get("nodes", []), rng)
    return {
        "f": "strobe",
        "value": {
            node: {
                "delta": 2 ** rng.randint(2, 18),
                "period": 2 ** rng.randint(0, 10),
                "duration": rng.randint(1, 32),
            }
            for node in nodes
        },
    }


def check_offsets_gen(test, ctx):
    """(reference: nemesis/time.clj:204)"""
    return {"type": "info", "f": "check-offsets", "value": None}


def clock_gen():
    """Mix of reset/bump/strobe/check-offsets ops.
    (reference: nemesis/time.clj:194-205)"""
    from .. import generator as gen

    return gen.mix([reset_gen, bump_gen, strobe_gen, check_offsets_gen])
