"""Graph algorithms: traversal orders, k-core, bipartite matching.

The reference keeps these in libsrc/utility/graphoperations.cpp —
bin-sort k-core decomposition (:5-72), BFS/DFS traversal orders
(:74ff), and the semi-perfect bipartite matching used by some ordering
heuristics (match_bfs / old_cheap, :74-196).  Only getKCore is even
reachable there (via Static_Graph::buildCoreTable); here they are all
live API, host-side (they order *query* graphs — tiny, irregular,
latency-critical: device dispatch would cost more than the compute).

CSRGraph.k_core holds the bin-sort core decomposition; this module
adds the traversal orders and matching.
"""

# The port's own copy of gnnpe_tpu/graph/ops.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from gnnpe_tpu_torch.graph.csr import CSRGraph


def bfs_order(graph: CSRGraph, root: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """BFS vertex order + parent tree from ``root``.  Unreached
    vertices (other components) are appended in id order with parent
    -1.  Returns (order int32[V], parent int32[V])."""
    n = graph.num_vertices
    parent = np.full(n, -1, dtype=np.int32)
    seen = np.zeros(n, dtype=bool)
    order: List[int] = []
    for start in [root] + [v for v in range(n)]:
        if seen[start]:
            continue
        seen[start] = True
        dq = deque([start])
        while dq:
            v = dq.popleft()
            order.append(v)
            for u in graph.vertex_neighbors(v):
                u = int(u)
                if not seen[u]:
                    seen[u] = True
                    parent[u] = v
                    dq.append(u)
    return np.array(order, dtype=np.int32), parent


def dfs_order(graph: CSRGraph, root: int = 0) -> np.ndarray:
    """Preorder DFS vertex order from ``root`` (iterative; neighbors
    visited in adjacency order), other components appended."""
    n = graph.num_vertices
    seen = np.zeros(n, dtype=bool)
    order: List[int] = []
    for start in [root] + [v for v in range(n)]:
        if seen[start]:
            continue
        stack = [start]
        while stack:
            v = stack.pop()
            if seen[v]:
                continue
            seen[v] = True
            order.append(v)
            # reversed → visit first neighbor first
            for u in graph.vertex_neighbors(v)[::-1]:
                if not seen[int(u)]:
                    stack.append(int(u))
    return np.array(order, dtype=np.int32)


def core_order(graph: CSRGraph) -> np.ndarray:
    """Vertices sorted by descending core number (ties by descending
    degree) — the dense-first matching order used by core-based
    heuristics."""
    core = graph.k_core()
    deg = np.diff(graph.offsets)
    return np.lexsort((-deg, -core)).astype(np.int32)


def bipartite_match(adj: List[np.ndarray], num_right: int) -> np.ndarray:
    """Maximum bipartite matching: left vertex i may match any id in
    ``adj[i]``.  Returns match int32[num_left] (-1 if unmatched).
    Hopcroft–Karp-free augmenting-path form (the reference's
    match_bfs semantics: greedy seed + BFS augmentation).
    """
    num_left = len(adj)
    match_l = np.full(num_left, -1, dtype=np.int32)
    match_r = np.full(num_right, -1, dtype=np.int32)

    # Greedy seed (the reference's old_cheap pass).
    for i in range(num_left):
        for j in adj[i]:
            j = int(j)
            if match_r[j] < 0:
                match_l[i] = j
                match_r[j] = i
                break

    def augment(i: int) -> bool:
        # BFS for an augmenting path from left vertex i.
        parent_r = {}
        frontier = [i]
        origin = {i: i}
        while frontier:
            nxt = []
            for li in frontier:
                for j in adj[li]:
                    j = int(j)
                    if j in parent_r:
                        continue
                    parent_r[j] = li
                    if match_r[j] < 0:
                        # Augment along the path.
                        while True:
                            li2 = parent_r[j]
                            prev = match_l[li2]
                            match_l[li2] = j
                            match_r[j] = li2
                            if prev < 0:
                                return True
                            j = prev
                    else:
                        nxt.append(int(match_r[j]))
            frontier = nxt
        return False

    for i in range(num_left):
        if match_l[i] < 0:
            augment(i)
    return match_l


def connected_components(graph: CSRGraph) -> np.ndarray:
    """Component id per vertex (BFS labelling)."""
    n = graph.num_vertices
    comp = np.full(n, -1, dtype=np.int32)
    c = 0
    for s in range(n):
        if comp[s] >= 0:
            continue
        comp[s] = c
        dq = deque([s])
        while dq:
            v = dq.popleft()
            for u in graph.vertex_neighbors(v):
                u = int(u)
                if comp[u] < 0:
                    comp[u] = c
                    dq.append(u)
        c += 1
    return comp
