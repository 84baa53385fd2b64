"""Query planning: greedy path cover and GQL-style matching order.

References:
  * gen_query_pde greedy cover (GNN-PE/include/custom.h:574-632): sort
    query paths by weight (Σ degrees) descending, keep each path that
    covers ≥1 new vertex, stop once all vertices are covered.
  * generateGQLQueryPlan / selectGQLStartVertex (custom.h:635-722):
    matching order by ascending candidate count, ties broken by larger
    degree; pivot = earliest ordered neighbor.
  * generateBN (custom.h:724-755): backward neighbors per depth.

Note on sort stability: the reference uses std::sort (unstable); for the
small path counts involved libstdc++ falls back to insertion sort, which
is stable, so a stable descending sort reproduces the plan.  Candidate
parity on Test/ is validated against the instrumented reference run.
"""

# The port's own copy of gnnpe_tpu/match/plan.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gnnpe_tpu_torch.graph.csr import CSRGraph


def greedy_path_cover(paths: np.ndarray, weight: np.ndarray,
                      num_query_vertices: int) -> np.ndarray:
    """Indices of the query paths kept by the greedy cover
    (custom.h:601-628), in plan order."""
    order = np.argsort(-weight.astype(np.int64), kind="stable")
    covered: set = set()
    plan: List[int] = []
    l = paths.shape[1]
    for idx in order:
        vids = paths[idx]
        newly = sum(1 for v in vids if int(v) in covered)
        if newly != l:
            covered.update(int(v) for v in vids)
            plan.append(int(idx))
        if len(covered) == num_query_vertices:
            break
    return np.array(plan, dtype=np.int64)


def gql_order(query_graph: CSRGraph, candidate_counts: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """GQL matching order + pivots (custom.h:635-722).

    Start: min candidate count, tie → larger degree (custom.h:639-651).
    Then repeatedly pick the unvisited vertex adjacent to the matched
    prefix with min candidate count, tie → larger degree.  Pivot[i] is
    the first vertex in order[0..i-1] adjacent to order[i].
    """
    n = query_graph.num_vertices
    counts = candidate_counts
    deg = query_graph.degrees

    start = 0
    for v in range(1, n):
        if counts[v] < counts[start] or (
                counts[v] == counts[start] and deg[v] > deg[start]):
            start = v

    order = np.zeros(n, dtype=np.int32)
    order[0] = start
    visited = np.zeros(n, dtype=bool)
    adjacent = np.zeros(n, dtype=bool)
    visited[start] = True
    adjacent[query_graph.vertex_neighbors(start)] = True

    for i in range(1, n):
        nxt = -1
        min_value = None
        for v in range(n):
            if visited[v] or not adjacent[v]:
                continue
            if min_value is None or counts[v] < min_value:
                min_value = counts[v]
                nxt = v
            elif counts[v] == min_value and deg[v] > deg[nxt]:
                nxt = v
        if nxt < 0:
            raise ValueError(
                "query graph must be connected (the reference reads an "
                "uninitialized vertex here, custom.h:683-705)")
        order[i] = nxt
        visited[nxt] = True
        adjacent[query_graph.vertex_neighbors(nxt)] = True

    pivot = np.zeros(n, dtype=np.int32)
    for i in range(1, n):
        u = order[i]
        for j in range(i):
            if query_graph.has_edge(np.array([u]),
                                    np.array([order[j]]))[0]:
                pivot[i] = order[j]
                break
    return order, pivot


def generate_bn(query_graph: CSRGraph, order: np.ndarray,
                pivot: np.ndarray) -> List[np.ndarray]:
    """Backward neighbors per depth: already-matched neighbors of
    order[i], excluding the pivot (custom.h:724-755)."""
    n = query_graph.num_vertices
    visited = np.zeros(n, dtype=bool)
    visited[order[0]] = True
    bn: List[np.ndarray] = [np.zeros(0, dtype=np.int32)]
    for i in range(1, n):
        u = order[i]
        nbrs = query_graph.vertex_neighbors(u)
        keep = [int(w) for w in nbrs if visited[w] and w != pivot[i]]
        bn.append(np.array(keep, dtype=np.int32))
        visited[u] = True
    return bn
