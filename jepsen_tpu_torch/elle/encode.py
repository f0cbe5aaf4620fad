"""Batched graph encoding for the transactional screens — the port of
:mod:`jepsen_tpu.elle.encode`.

The Elle side of the engine speaks graphs, not histories: a dependency
(or per-key version) graph becomes a dense **relation-bit matrix** —
``rel[i, j]`` is the OR of :data:`REL_BITS` for every dependency type
edge ``i → j`` carries — padded to a power-of-two vertex bucket, and
graphs from many keys, histories, and concurrent runs stack into
shared ``(B, n, n)`` dispatches exactly the way history encodes stack
into per-(E, C) buckets in :mod:`jepsen_tpu_torch.engine.planning`.
The device kernels (:mod:`jepsen_tpu_torch.ops.cycles`) then answer, for every
graph and every relation filter of the classify ladder at once: which
vertices sit on a cycle (forward×backward closure intersection → SCC
membership masks), and which sit on a nonadjacent-rw closed walk (the
snapshot-isolation cycle test's lifted product graph).

Filter masks are **canonicalized per graph** to the relation bits the
graph actually contains (``25 & present``): a graph with no
process/realtime edges screens its suffixed ladder rungs through the
identical plain-relation closure instead of paying extra ones, and
graphs sharing a (bucket, filter-profile) key share one dispatch
and one dispatch row budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph, PROCESS, REALTIME, RW, WR, WW

#: relation-type → bit in the encoded adjacency entries.  The device
#: kernels AND these against static filter masks, so the assignment is
#: part of the kernel cache key contract — append, never renumber.
REL_BITS: Dict[str, int] = {WW: 1, WR: 2, RW: 4, PROCESS: 8, REALTIME: 16}

WW_BIT = REL_BITS[WW]
WR_BIT = REL_BITS[WR]
RW_BIT = REL_BITS[RW]
PR_MASK = REL_BITS[PROCESS] | REL_BITS[REALTIME]
ALL_MASK = WW_BIT | WR_BIT | RW_BIT | PR_MASK

#: the classify ladder's relation filters, pre-canonicalization: the
#: G0 / G1c / G2-item rungs and their process/realtime-suffixed
#: variants (elle.cycles.classify walks exactly these subgraphs)
LADDER_MASKS = (
    WW_BIT,
    WW_BIT | WR_BIT,
    WW_BIT | WR_BIT | RW_BIT,
    WW_BIT | PR_MASK,
    WW_BIT | WR_BIT | PR_MASK,
    ALL_MASK,
)

#: the nonadjacent-rw walk tests (want, rest): plain and suffixed —
#: the snapshot-isolation cycle characterization's screening question
NONADJ_MASKS = (
    (RW_BIT, WW_BIT | WR_BIT),
    (RW_BIT, WW_BIT | WR_BIT | PR_MASK),
)

#: smallest vertex bucket — matches ops.cycles._bucket so the screen
#: kernels and the boolean has-cycle closure share shape discipline
GRAPH_BUCKET_MIN = 16

#: boolean lanes per packed uint32 word — the word floor
#: :func:`graph_bucket` pads vertex counts to, so the screen kernel's
#: rows are whole words (mirrors ``jepsen_tpu_torch.ops.dense.WORD_LANES``)
WORD_LANES = 32

#: plane weight of one lifted nonadjacent walk query: its 2n×2n product
#: graph carries four n×n planes' worth of closure state, vs one plane per
#: membership filter mask
LIFTED_PLANE_WEIGHT = 4


def plane_weight(masks: Sequence[int],
                 nonadj: Sequence[Tuple[int, int]]) -> int:
    """n×n planes one profile expands into — the ``frontier`` axis of a
    screen bucket's cost proxy (:func:`jepsen_tpu_torch.engine.planning.
    estimated_cost`): one plane per membership mask,
    :data:`LIFTED_PLANE_WEIGHT` per lifted walk query, at least 1.  The
    reference's uint8 pricing; the port has no ``packed32`` lowering to
    discount."""
    return max(1, len(masks) + LIFTED_PLANE_WEIGHT * len(nonadj))


def rel_mask(rels) -> int:
    """OR of :data:`REL_BITS` over an edge's relation set."""
    m = 0
    for r in rels:
        m |= REL_BITS.get(r, 0)
    return m


def graph_bucket(n: int) -> int:
    """Pad vertex counts to powers of two (min
    :data:`GRAPH_BUCKET_MIN`) so graphs of nearby size share one
    dispatch shape — the same discipline as ``ops.cycles._bucket`` and
    the engine's (E, C) buckets.

    Vertex counts first round up to a multiple of :data:`WORD_LANES`
    (the **word floor**) so the kernel's uint32 words never carry
    ragged lanes: every bucket a screen can see is a
    multiple of 32, making W = n/32 exact.  The effective minimum
    bucket is therefore 32.  Padding is provably inert — padded
    rows/columns carry no relation bits (:func:`stack_rel` zero-fills),
    an edge-free vertex is acyclic and unreachable, and the closure
    recurrence ``r ← r ∪ r·r`` never sets a bit no path witnesses —
    so a graph screened at bucket 32 answers byte-identically to the
    same graph at the pre-word-floor bucket 16."""
    n = -(-max(1, int(n)) // WORD_LANES) * WORD_LANES
    return max(GRAPH_BUCKET_MIN, 1 << (n - 1).bit_length())


class EncodedGraph:
    """One graph, host-encoded for the screens: the deterministic
    vertex ``order`` (the same sort ``Graph.adjacency`` uses, so
    device masks and CPU searches can never disagree about which row
    is which vertex), the ``(n, n)`` uint8 relation-bit matrix, the
    union of bits actually ``present``, and the canonicalized filter
    profile (``masks``, ``nonadj``) this graph needs screened."""

    __slots__ = ("order", "rel", "present", "masks", "nonadj")

    def __init__(self, order, rel, present, masks, nonadj):
        self.order = order
        self.rel = rel
        self.present = present
        self.masks = masks
        self.nonadj = nonadj

    @property
    def n(self) -> int:
        return len(self.order)


def encode_graph(g: Graph) -> EncodedGraph:
    """Encode one dependency graph into its relation-bit matrix and
    canonical screen profile."""
    order = sorted(g.vertices, key=str)
    index = {v: i for i, v in enumerate(order)}
    n = len(order)
    rel = np.zeros((n, n), dtype=np.uint8)
    present = 0
    for a, nbrs in g.out.items():
        ia = index[a]
        for b, rels in nbrs.items():
            m = rel_mask(rels)
            rel[ia, index[b]] = m
            present |= m
    masks = tuple(sorted({m & present for m in LADDER_MASKS} - {0}))
    if present & RW_BIT:
        nonadj = tuple(sorted(
            {(RW_BIT, rest & present) for _w, rest in NONADJ_MASKS}
        ))
    else:
        # no rw edge anywhere: every nonadjacent-rw question is a
        # definitive no without a kernel
        nonadj = ()
    return EncodedGraph(order, rel, present, masks, nonadj)


def bucket_key(enc: EncodedGraph) -> Tuple[int, tuple, tuple]:
    """The shared-dispatch key: vertex bucket + canonical filter
    profile.  Graphs from different keys/histories/runs with the same
    key stack into one ``(B, n, n)`` dispatch."""
    return (graph_bucket(enc.n), enc.masks, enc.nonadj)


def bucket_graphs(
    encs: Sequence[EncodedGraph],
) -> Tuple[Dict[tuple, List[int]], List[tuple]]:
    """Group encoded graphs by :func:`bucket_key`; returns
    ``(buckets, order)`` with ``buckets[key] = [enc index, ...]`` in
    first-seen key order — the same bucket-stream shape
    ``Planner.encode_buckets`` produces for histories."""
    buckets: Dict[tuple, List[int]] = {}
    order: List[tuple] = []
    for i, enc in enumerate(encs):
        key = bucket_key(enc)
        acc = buckets.get(key)
        if acc is None:
            acc = buckets[key] = []
            order.append(key)
        acc.append(i)
    return buckets, order


def stack_rel(encs: Sequence[EncodedGraph], n: int) -> np.ndarray:
    """Stack encoded graphs into one padded ``(B, n, n)`` uint8 batch;
    padding rows/cols carry no edges, so they are acyclic by
    construction and never perturb a screen."""
    batch = np.zeros((len(encs), n, n), dtype=np.uint8)
    for row, enc in enumerate(encs):
        k = enc.n
        batch[row, :k, :k] = enc.rel
    return batch
