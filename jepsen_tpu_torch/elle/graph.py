"""Typed dependency graphs and cycle search.

The transactional checker reduces a history to a directed graph whose
vertices are transactions and whose edges carry dependency types
(``ww``/``wr``/``rw``, plus ``process``/``realtime``).  Anomalies are
cycles with particular edge-type profiles, found via strongly-connected
components (Tarjan, iterative) and per-SCC BFS.

The reference consumes the external Elle library for this
(jepsen/project.clj:11; jepsen/src/jepsen/tests/cycle.clj:5-16).  The
hot screening step — does any cycle exist over thousands of per-key
graphs — runs on the GPU via jepsen_tpu_torch.ops.cycles (batched boolean
closure); this module is the exact CPU path and witness extractor, the
port's copy of :mod:`jepsen_tpu.elle.graph`.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

#: Dependency edge types.
WW = "ww"
WR = "wr"
RW = "rw"
PROCESS = "process"
REALTIME = "realtime"


class Graph:
    """A directed multigraph: edges carry a set of dependency types."""

    def __init__(self):
        self.vertices: Set[Any] = set()
        self.out: Dict[Any, Dict[Any, Set[str]]] = defaultdict(dict)

    def add_vertex(self, v: Any) -> None:
        self.vertices.add(v)

    def add_edge(self, a: Any, b: Any, rel: str) -> None:
        if a == b:
            return  # self-deps are intra-txn; never cycle material
        self.vertices.add(a)
        self.vertices.add(b)
        rels = self.out[a].get(b)
        if rels is None:
            self.out[a][b] = {rel}
        else:
            rels.add(rel)

    def edge_rels(self, a: Any, b: Any) -> Set[str]:
        return self.out.get(a, {}).get(b, set())

    def successors(self, v: Any) -> Iterable[Any]:
        return self.out.get(v, {}).keys()

    def union(self, other: "Graph") -> "Graph":
        g = Graph()
        for v in self.vertices | other.vertices:
            g.add_vertex(v)
        for src in (self, other):
            for a, nbrs in src.out.items():
                for b, rels in nbrs.items():
                    for r in rels:
                        g.add_edge(a, b, r)
        return g

    def filtered(self, pred: Callable[[Set[str]], bool]) -> "Graph":
        """Subgraph keeping only edges whose rel-set satisfies pred."""
        g = Graph()
        for v in self.vertices:
            g.add_vertex(v)
        for a, nbrs in self.out.items():
            for b, rels in nbrs.items():
                if pred(rels):
                    for r in rels:
                        g.add_edge(a, b, r)
        return g

    def edge_count(self) -> int:
        return sum(len(nbrs) for nbrs in self.out.values())

    def adjacency(self, order: Optional[List[Any]] = None):
        """(order, dense bool numpy adjacency) — the screens' input."""
        import numpy as np

        order = order or sorted(self.vertices, key=str)
        index = {v: i for i, v in enumerate(order)}
        n = len(order)
        m = np.zeros((n, n), dtype=bool)
        for a, nbrs in self.out.items():
            for b in nbrs:
                m[index[a], index[b]] = True
        return order, m


def strongly_connected_components(g: Graph) -> List[List[Any]]:
    """Tarjan's SCC, iterative (histories can be deep).  Only components
    with ≥2 vertices or a self-loop can hold cycles; we return all and
    let callers filter."""
    index: Dict[Any, int] = {}
    low: Dict[Any, int] = {}
    on_stack: Set[Any] = set()
    stack: List[Any] = []
    sccs: List[List[Any]] = []
    counter = [0]

    for root in g.vertices:
        if root in index:
            continue
        work: List[Tuple[Any, Optional[Iterable]]] = [(root, None)]
        while work:
            v, it = work.pop()
            if it is None:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
                it = iter(list(g.successors(v)))
            advanced = False
            for w in it:
                if w not in index:
                    work.append((v, it))
                    work.append((w, None))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return [c for c in sccs if len(c) > 1]


def find_cycle(g: Graph, scc: List[Any]) -> Optional[List[Any]]:
    """A shortest cycle within an SCC: BFS from each vertex back to
    itself through SCC-internal edges.  Returns [v1 v2 … v1] or None."""
    members = set(scc)
    for start in scc:
        parent: Dict[Any, Any] = {}
        q = deque([start])
        seen = {start}
        while q:
            v = q.popleft()
            for w in g.successors(v):
                if w not in members:
                    continue
                if w == start:
                    path = [v]
                    while path[-1] != start:
                        path.append(parent[path[-1]])
                    path.reverse()
                    path.append(start)
                    return path
                if w not in seen:
                    seen.add(w)
                    parent[w] = v
                    q.append(w)
    return None


def find_cycle_with(
    g: Graph,
    scc: List[Any],
    want: Callable[[Set[str]], bool],
    rest: Callable[[Set[str]], bool],
    want_count: int = 1,
) -> Optional[List[Any]]:
    """Find a cycle containing exactly ``want_count`` edges satisfying
    ``want``, all other edges satisfying ``rest``.  Used for G-single
    (exactly one rw, rest ww/wr).  BFS over a layered product graph:
    state = (vertex, #want-edges-used)."""
    members = set(scc)
    for start in scc:
        # state: (v, k) = reached v using k want-edges
        parent: Dict[Tuple[Any, int], Tuple[Any, int]] = {}
        q = deque([(start, 0)])
        seen = {(start, 0)}
        while q:
            v, k = q.popleft()
            for w in g.successors(v):
                if w not in members:
                    continue
                rels = g.edge_rels(v, w)
                steps = []
                if want(rels) and k < want_count:
                    steps.append(k + 1)
                if rest(rels):
                    steps.append(k)
                for k2 in steps:
                    if w == start and k2 == want_count:
                        path = [v]
                        vv, kk = v, k
                        while (vv, kk) != (start, 0):
                            vv, kk = parent[(vv, kk)]
                            path.append(vv)
                        path.reverse()
                        path.append(start)
                        return path
                    if (w, k2) not in seen and w != start:
                        seen.add((w, k2))
                        parent[(w, k2)] = (v, k)
                        q.append((w, k2))
    return None


def cycle_rels(g: Graph, cycle: List[Any]) -> List[Set[str]]:
    """The rel-sets along a cycle path [v1 v2 … v1]."""
    return [g.edge_rels(a, b) for a, b in zip(cycle, cycle[1:])]


#: Sentinel returned by :func:`find_nonadjacent_cycle` when the bounded
#: simple-cycle search ran out of budget before reaching a verdict: a
#: nonadjacent witness *walk* exists but no simple witness was confirmed
#: or refuted.  Callers must not treat this as "no cycle" — under
#: snapshot isolation that would be a silent false negative.
INDETERMINATE = object()

#: Default expansion budget for the bounded simple-cycle search (DFS
#: node expansions across the whole SCC).  Simple-cycle enumeration is
#: exponential in the worst case; the budget keeps classify() bounded
#: while letting it answer definitively on real-world SCC sizes.  The
#: DFS prunes to vertices that can still reach the cycle's start
#: (Johnson-style), so realistic per-key dependency graphs resolve in
#: far fewer steps than this — the bound is a backstop, not a ceiling
#: histories routinely hit.
NONADJ_BUDGET = 2_000_000


def find_nonadjacent_cycle(
    g: Graph,
    scc: List[Any],
    want: Callable[[Set[str]], bool],
    rest: Callable[[Set[str]], bool],
    budget: Optional[int] = None,
):
    """Find a *simple* cycle containing ≥1 ``want`` edges, no two of
    them adjacent (cyclically — the wrap-around pair counts), every
    other edge satisfying ``rest``.  Used for G-nonadjacent: under
    snapshot isolation every dependency cycle must contain two
    *adjacent* rw anti-dependency edges, so a cycle whose rw edges are
    all isolated is a genuine SI violation (Adya G-SI / Cerone's SI
    characterization).

    Any qualifying cycle can be rotated to start with a want edge, so
    trying every start vertex with a forced want first edge is complete.
    Fast path: BFS over the product graph state
    (vertex, last-edge-was-want); a want edge is only traversable when
    the previous edge was not, and the closing edge back to start must
    be non-want (it precedes the first, want, edge in the rotation).
    The BFS decides *walk* existence exactly, so a no-walk answer is a
    sound "no cycle".  A walk witness can be non-simple, though, and a
    non-simple walk is not a sound nonadjacent witness (its simple
    decomposition may contain only adjacent-rw cycles) — in that case a
    budgeted DFS enumerates simple cycles directly.

    Returns the cycle path ``[v1 v2 … v1]``, ``None`` (definitely no
    qualifying simple cycle), or :data:`INDETERMINATE` when the DFS
    budget ran out first — callers must surface that as an unknown
    verdict, not a pass."""
    members = set(scc)

    def bfs(start: Any) -> Optional[List[Any]]:
        parent: Dict[Tuple[Any, bool], Tuple[Any, bool]] = {}
        q: deque = deque()
        seen: Set[Tuple[Any, bool]] = set()
        # seed: the forced want first edge out of start
        for w in g.successors(start):
            if w not in members or w == start:
                continue
            if want(g.edge_rels(start, w)):
                st = (w, True)
                if st not in seen:
                    seen.add(st)
                    q.append(st)
        while q:
            v, last = q.popleft()
            for w in g.successors(v):
                if w not in members:
                    continue
                rels = g.edge_rels(v, w)
                if w == start:
                    # closing edge must be non-want (wrap adjacency)
                    if rest(rels):
                        back = []
                        cur: Optional[Tuple[Any, bool]] = (v, last)
                        while cur is not None:
                            back.append(cur[0])
                            cur = parent.get(cur)
                        return [start] + back[::-1] + [start]
                    continue
                steps = []
                if want(rels) and not last:
                    steps.append(True)
                if rest(rels):
                    steps.append(False)
                for is_want in steps:
                    st = (w, is_want)
                    if st not in seen:
                        seen.add(st)
                        parent[st] = (v, last)
                        q.append(st)
        return None

    saw_walk = False
    for start in scc:
        cyc = bfs(start)
        if cyc is None:
            continue
        saw_walk = True
        if len(set(cyc[:-1])) == len(cyc) - 1:
            return cyc
    if not saw_walk:
        # BFS is complete over walks, and every simple cycle is a walk:
        # no closing walk from any start ⇒ no qualifying cycle at all.
        return None
    # Some witness walk exists but every first-found one was non-simple.
    # Enumerate simple cycles directly with a budgeted DFS; exhausting
    # the budget yields INDETERMINATE rather than a silent downgrade to
    # the (SI-permitted) G2-item rung.
    if budget is None:
        budget = NONADJ_BUDGET
    found, exhausted = _simple_nonadjacent_dfs(g, members, scc, want, rest, budget)
    if found is not None:
        return found
    return INDETERMINATE if exhausted else None


def _simple_nonadjacent_dfs(
    g: Graph,
    members: Set[Any],
    scc: List[Any],
    want: Callable[[Set[str]], bool],
    rest: Callable[[Set[str]], bool],
    budget: int,
) -> Tuple[Optional[List[Any]], bool]:
    """Bounded DFS enumeration of simple nonadjacent-want cycles.
    Returns ``(cycle_or_None, budget_exhausted)``.  The first edge out
    of each start is forced to be a want edge (rotation completeness);
    interior vertices are never revisited, so every found cycle is
    simple by construction.  Per start, the walk is pruned to vertices
    that can still REACH the start over usable edges (Johnson-style):
    any simple cycle through start lies entirely in that set, so the
    prune is exact while dead-end subgraphs — the DFS's exponential
    waste on real dependency graphs — are never entered."""
    steps = 0

    # usable reverse adjacency within the SCC (edges failing both
    # predicates can never appear in a qualifying cycle)
    rpred: Dict[Any, List[Any]] = {v: [] for v in members}
    for v in members:
        for w in g.successors(v):
            if w in members and w != v:
                rels = g.edge_rels(v, w)
                if rest(rels) or want(rels):
                    rpred[w].append(v)

    def options(v: Any, last_want: bool, start: Any, on_path: Set[Any],
                reach: Set[Any]):
        for w in g.successors(v):
            if w not in members:
                continue
            rels = g.edge_rels(v, w)
            if w == start:
                # closing edge precedes the first (want) edge in the
                # rotation, so it must be non-want
                if rest(rels):
                    yield (w, False)
                continue
            if w in on_path or w not in reach:
                continue
            if rest(rels):
                yield (w, False)
            if not last_want and want(rels):
                yield (w, True)

    for start in scc:
        # skip the reach BFS entirely for starts with no qualifying
        # want out-edge — most vertices of a real dependency graph
        if not any(
            w in members and w != start and want(g.edge_rels(start, w))
            for w in g.successors(start)
        ):
            continue
        # vertices that can reach start over usable edges; its pops
        # count against the same budget as DFS steps so the budget
        # bounds TOTAL work, not just the enumeration phase
        reach: Set[Any] = {start}
        rq: deque = deque([start])
        while rq:
            steps += 1
            if steps > budget:
                return None, True
            x = rq.popleft()
            for p in rpred[x]:
                if p not in reach:
                    reach.add(p)
                    rq.append(p)
        for first in g.successors(start):
            if (
                first not in members
                or first == start
                or first not in reach
                or not want(g.edge_rels(start, first))
            ):
                continue
            path = [start, first]
            on_path = {start, first}
            stack = [options(first, True, start, on_path, reach)]
            while stack:
                steps += 1
                if steps > budget:
                    return None, True
                try:
                    w, is_want = next(stack[-1])
                except StopIteration:
                    stack.pop()
                    on_path.discard(path.pop())
                    continue
                if w == start:
                    return path + [start], False
                path.append(w)
                on_path.add(w)
                stack.append(options(w, is_want, start, on_path, reach))
    return None, False
