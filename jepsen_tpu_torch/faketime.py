"""libfaketime wrappers: run DB processes on skewed or scaled clocks.

The port's copy of :mod:`jepsen_tpu.faketime`.

(reference: jepsen/src/jepsen/faketime.clj — builds libfaketime on the
node with make :8-22, script :24-35, wrap! rebinds a binary to run under
faketime :36-55, rand-factor :57-65.)
"""

from __future__ import annotations

from typing import Optional

from . import control
from .control.core import lit
from .control.util import write_file

LIBFAKETIME_URL = (
    "https://github.com/wolfcw/libfaketime/archive/refs/tags/v0.9.10.tar.gz"
)
BUILD_DIR = "/opt/jepsen/faketime"


def install() -> None:
    """Fetch + build libfaketime on the current node (the reference
    builds its fork the same way, faketime.clj:8-22); falls back to a
    distro package if the build fails."""
    from .control.core import RemoteError
    from .control.util import install_archive

    with control.su():
        try:
            install_archive(LIBFAKETIME_URL, BUILD_DIR)
            with control.cd(BUILD_DIR):
                control.execute("make")
                control.execute("make", "install")
        except RemoteError:
            control.execute("apt-get", "install", "-y", "faketime")


def script(offset_s: float = 0.0, rate: Optional[float] = None) -> str:
    """A shell preamble exporting LD_PRELOAD + FAKETIME for child
    processes.  (reference: faketime.clj:24-35)"""
    spec = f"{offset_s:+f}s"
    if rate is not None:
        spec += f" x{rate}"
    return (
        'export LD_PRELOAD="${LD_PRELOAD:+$LD_PRELOAD:}'
        'libfaketime.so.1"\n'
        f'export FAKETIME="{spec}"\n'
        'export FAKETIME_NO_CACHE=1\n'
    )


def wrap(bin_path: str, offset_s: float = 0.0, rate: Optional[float] = None) -> None:
    """Replace a binary with a faketime-launching wrapper script; the
    original moves to <bin>.real.  (reference: faketime.clj:36-55)"""
    real = f"{bin_path}.real"
    with control.su():
        out = control.execute(
            lit(f"test -f {real} && echo yes || echo no")
        )
        if out.strip() != "yes":
            control.execute("mv", bin_path, real)
        wrapper = "#!/bin/bash\n" + script(offset_s, rate) + f'exec "{real}" "$@"\n'
        write_file(wrapper, bin_path)
        control.execute("chmod", "+x", bin_path)


def unwrap(bin_path: str) -> None:
    """Restore the original binary."""
    real = f"{bin_path}.real"
    with control.su():
        control.execute(
            lit(f"test -f {real} && mv {real} {bin_path} || true")
        )


def rand_factor(rng=None) -> float:
    """A random clock rate in [1/5, 5], log-uniform.
    (reference: faketime.clj:57-65)"""
    import math
    import random as _random

    rng = rng or _random
    return math.exp(rng.uniform(math.log(0.2), math.log(5.0)))
