"""State carried across from the JAX package to the port.

The checker has no weights: what a test hands to both packages is the
encoded batch and the dense automaton's static subset-map tables.  These
helpers take the reference's arrays as numpy (never its modules) and
check them on the way in, so a dtype or table drift between the two
packages fails loudly instead of comparing unlike inputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .dense import _subset_has, _subset_maps

#: EncodedBatch array dtypes (jepsen_tpu/ops/encode.py:44-66)
BATCH_DTYPES = (
    ("init_state", np.int32, 1),
    ("ev_slot", np.int32, 2),
    ("cand_slot", np.int8, 3),
    ("cand_f", np.int8, 3),
    ("cand_a", np.int16, 3),
    ("cand_b", np.int16, 3),
)


def batch_from_reference(init_state, ev_slot, cand_slot, cand_f, cand_a,
                         cand_b, device) -> Tuple[torch.Tensor, ...]:
    """The reference ``EncodedBatch`` arrays (numpy) as the port's
    tensors on ``device``, after checking dtype, rank and shape."""
    arrays = (init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)
    out = []
    for a, (name, dtype, ndim) in zip(arrays, BATCH_DTYPES):
        a = np.asarray(a)
        if a.dtype != dtype:
            raise TypeError(f"{name}: expected {np.dtype(dtype)}, got "
                            f"{a.dtype}")
        if a.ndim != ndim:
            raise ValueError(f"{name}: expected rank {ndim}, got {a.ndim}")
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    B, E, C = out[2].shape
    if out[0].shape != (B,) or out[1].shape != (B, E) or any(
        t.shape != (B, E, C) for t in out[3:]
    ):
        raise ValueError("EncodedBatch arrays disagree on [B, E, C]")
    return tuple(out)


def tables_from_reference(C: int, uidx, umask, ushl, didx, dmask, dshr,
                          has) -> None:
    """Check the port's ``_subset_maps(C)``/``_subset_has(C)`` against the
    reference's (given as numpy): same dtypes, same values.  Raises
    ``ValueError`` naming the first table that differs."""
    ref = dict(uidx=uidx, umask=umask, ushl=ushl, didx=didx, dmask=dmask,
               dshr=dshr, has=has)
    ours = dict(zip(("uidx", "umask", "ushl", "didx", "dmask", "dshr"),
                    _subset_maps(C)))
    ours["has"] = _subset_has(C)
    for name, r in ref.items():
        r = np.asarray(r)
        o = ours[name]
        if r.dtype != o.dtype or r.shape != o.shape or not np.array_equal(
            r, o
        ):
            raise ValueError(f"subset table {name} (C={C}) differs from "
                             "the reference")
