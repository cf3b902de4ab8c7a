"""3D torus / twisted-torus slice topologies (paper §2).

A TPU v4 slice is a 3D torus of shape (a, b, c) chips built from 4³ blocks
joined by OCS circuits; the OCS can "rewire" wraparound links in milliseconds,
which enables the *twisted torus* variants of Camarero-Martinez-Beivide [8]
for k×k×2k / k×2k×2k geometries (paper §2.8, Figure 5).

This module is plain numpy (no jax): it models the physical link graph and is
consumed by the collective cost model, the goodput simulation, the scheduler,
and the autotopo search.

The twist rule (validated against Figure 6): wrapping around the *shortest*
dimension (size n) advances the coordinate of every *longer* dimension by n
(mod its size).  For n×n×2n this shifts only the long dimension (the classic
Camarero k×k×2k lattice); for n×2n×2n it shifts both long dimensions.  With
ideal multipath shortest-path routing this reproduces all-to-all throughput
gains of 1.52× (4×4×8) and 1.39× (4×8×8) vs the paper's measured 1.63×/1.31×
— within ±15% (benchmarks/fig6_twisted_alltoall.py asserts this).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

Coord = Tuple[int, int, int]


def is_twistable(dims: Sequence[int]) -> bool:
    """n×n×2n or n×2n×2n with n >= 4 (paper §2.9)."""
    a, b, c = sorted(dims)
    if a < 4:
        return False
    return (a == b and c == 2 * a) or (b == c and b == 2 * a)


@dataclass(frozen=True)
class SliceTopology:
    dims: Tuple[int, int, int]
    twisted: bool = False
    wraparound: bool = True          # <4^3 slices are meshes (paper §2.9)

    def __post_init__(self):
        if self.twisted:
            assert is_twistable(self.dims), (
                f"{self.dims} is not twistable (need n*n*2n or n*2n*2n)")

    # -- basic properties ---------------------------------------------------

    @property
    def num_chips(self) -> int:
        a, b, c = self.dims
        return a * b * c

    @property
    def num_blocks(self) -> int:
        return self.num_chips // 64

    def nodes(self) -> List[Coord]:
        a, b, c = self.dims
        return [(x, y, z) for x in range(a) for y in range(b)
                for z in range(c)]

    def node_index(self, n: Coord) -> int:
        a, b, c = self.dims
        return (n[0] * b + n[1]) * c + n[2]

    # -- link graph -----------------------------------------------------------

    def neighbors(self, n: Coord) -> List[Coord]:
        """The 6 (or fewer, for meshes) ICI neighbours of a chip."""
        a, b, c = self.dims
        dims = self.dims
        out: List[Coord] = []
        # twist role: wrapping the shortest dim advances every longer dim
        tshort = int(np.argmin(dims)) if self.twisted else None
        nshort = min(dims)
        for ax in range(3):
            size = dims[ax]
            if size == 1:
                continue
            for step in (1, -1):
                m = list(n)
                m[ax] += step
                wrapped = m[ax] < 0 or m[ax] >= size
                if wrapped:
                    if not self.wraparound or size <= 2:
                        if size <= 2 and step == -1:
                            continue  # avoid double link for size-2 dims
                        if not self.wraparound:
                            continue
                    m[ax] %= size
                    if self.twisted and ax == tshort:
                        shift = nshort * step
                        for other in range(3):
                            if other != ax and dims[other] > nshort:
                                m[other] = (m[other] + shift) % dims[other]
                out.append(tuple(m))
        return out

    def edges(self) -> List[Tuple[int, int]]:
        """Undirected edge list over node indices."""
        es = set()
        for n in self.nodes():
            i = self.node_index(n)
            for m in self.neighbors(n):
                j = self.node_index(m)
                es.add((min(i, j), max(i, j)))
        return sorted(es)

    def adjacency(self) -> List[List[int]]:
        adj: List[List[int]] = [[] for _ in range(self.num_chips)]
        for i, j in self.edges():
            adj[i].append(j)
            adj[j].append(i)
        return adj

    # -- metrics --------------------------------------------------------------

    def bisection_links(self) -> int:
        """Links crossing the best canonical balanced cut.

        Checks the three axis-aligned half cuts (the standard torus bisection
        planes); the minimum is the bisection for these topologies.
        """
        best = None
        nodes = self.nodes()
        for ax in range(3):
            size = self.dims[ax]
            if size < 2:
                continue
            half = size // 2
            left = {self.node_index(n) for n in nodes if n[ax] < half}
            cut = 0
            for n in nodes:
                i = self.node_index(n)
                for m in self.neighbors(n):
                    j = self.node_index(m)
                    if i < j and ((i in left) != (j in left)):
                        cut += 1
            best = cut if best is None else min(best, cut)
        return best or 0

    def diameter_and_avg_hops(self) -> Tuple[int, float]:
        adj = self.adjacency()
        N = self.num_chips
        diam = 0
        total = 0
        for s in range(N):
            dist = _bfs(adj, s)
            diam = max(diam, int(dist.max()))
            total += int(dist.sum())
        return diam, total / (N * (N - 1))

    def link_loads_alltoall(self) -> Dict[Tuple[int, int], float]:
        """Per-directed-link load for uniform all-to-all with ideal
        (fractional) shortest-path multipath routing.

        Load on edge (u, v) = expected number of unit messages traversing it
        when every ordered pair exchanges one unit.  max(load) bounds
        all-to-all time: T = max_load * message_bytes / link_bw.
        """
        adj = self.adjacency()
        N = self.num_chips
        loads: Dict[Tuple[int, int], float] = {}
        for s in range(N):
            for e, l in _spdag_loads(adj, s).items():
                loads[e] = loads.get(e, 0.0) + l
        return loads

    def alltoall_max_load(self) -> float:
        loads = self.link_loads_alltoall()
        return max(loads.values()) if loads else 0.0

    def describe(self) -> str:
        t = "_T" if self.twisted else ""
        a, b, c = self.dims
        return f"{a}x{b}x{c}{t}"


def _bfs(adj: List[List[int]], s: int) -> np.ndarray:
    N = len(adj)
    dist = np.full(N, -1, np.int32)
    dist[s] = 0
    frontier = [s]
    d = 0
    while frontier:
        nxt = []
        d += 1
        for u in frontier:
            for v in adj[u]:
                if dist[v] < 0:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def _spdag_loads(adj: List[List[int]], s: int) -> Dict[Tuple[int, int], float]:
    """Fractional shortest-path-DAG edge loads for one source.

    Every destination t receives one unit from s, split equally over all
    shortest paths (classic ideal multipath load model).
    """
    N = len(adj)
    dist = _bfs(adj, s)
    order = np.argsort(dist)                     # nodes by distance
    # number of shortest paths from s
    nsp = np.zeros(N, np.float64)
    nsp[s] = 1.0
    for u in order:
        du = dist[u]
        for v in adj[u]:
            if dist[v] == du + 1:
                nsp[v] += nsp[u]
    # accumulate flow backwards: flow into t is 1 (for t != s)
    flow = np.ones(N, np.float64)
    flow[s] = 0.0
    loads: Dict[Tuple[int, int], float] = {}
    for u in order[::-1]:
        if u == s or dist[u] <= 0:
            continue
        preds = [v for v in adj[u] if dist[v] == dist[u] - 1]
        tot = sum(nsp[v] for v in preds)
        for v in preds:
            share = flow[u] * (nsp[v] / tot)
            loads[(v, u)] = loads.get((v, u), 0.0) + share
            flow[v] += share
    return loads


# ---------------------------------------------------------------------------
# Slice geometry enumeration (scheduler + autotopo)
# ---------------------------------------------------------------------------

def geometries_for(num_chips: int, *, min_dim: int = 4
                   ) -> List[Tuple[int, int, int]]:
    """All 4i×4j×4k (i<=j<=k) geometries with the given chip count."""
    out = []
    n = num_chips
    for a in range(min_dim, n + 1, min_dim):
        if n % a:
            continue
        for b in range(a, n // a + 1, min_dim):
            if (n // a) % b:
                continue
            c = n // (a * b)
            if c >= b and c % min_dim == 0:
                out.append((a, b, c))
    return out
