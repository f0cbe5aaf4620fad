"""Where the checkers' artifacts land — the path half of
:mod:`jepsen_tpu.store` (``BASE``, ``base_dir``, ``test_dir``, ``path``,
``path_``): ``<store-base>/<name>/<start-time>/...``, the reference's
layout, so a witness or a per-key result lands where the reference puts
it.  The test persistence around it (saving histories and test maps,
symlinks, logs) belongs to the harness and is not ported.
"""

from __future__ import annotations

import os
from typing import Any

BASE = "store"


def base_dir(test: dict) -> str:
    return test.get("store-base", BASE)


def test_dir(test: dict) -> str:
    """store/<name>/<start-time> for this test run."""
    name = test.get("name", "noname")
    start = str(test.get("start-time", "unknown"))
    return os.path.join(base_dir(test), name, start)


def path(test: dict, *components: Any) -> str:
    """Path to an artifact within the test's store directory.
    (reference: store.clj:40-56)"""
    parts = [str(c) for c in components if c is not None and str(c) != ""]
    return os.path.join(test_dir(test), *parts)


def path_(test: dict, *components: Any) -> str:
    """Like path, but ensures the parent directory exists.
    (reference: store.clj `path!`)"""
    p = path(test, *components)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    return p
