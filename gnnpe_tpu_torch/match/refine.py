"""Candidate refinement: exact backtracking enumeration on the host.

Mirrors the reference's GQL plan + QuickSI-style exploration
(GNN-PE/include/custom.h:757-932): candidates per query vertex feed a
depth-first search where each depth extends the partial embedding via
the pivot's data-graph neighbors, filtered by label, degree, visited
flag, and edge checks against the backward neighbors.

Irregular backtracking is the one stage kept off-device (SURVEY.md
§7.1.4).  Two engines:
  * ``"native"`` — the C++ explorer (match/native/refine.cpp, built with
    g++ at first use); a failed build raises;
  * ``"python"`` — the explorer of this file, reference semantics.
Both produce identical counts.  There is no silent fallback from one to
the other.
"""

# The port's own copy of gnnpe_tpu/match/refine.py (numpy only; the two
# packages share no code).  gnnpe_tpu's ``engine="auto"``, which falls
# back to Python when the native build fails, is not offered.

from __future__ import annotations

from typing import List

import numpy as np

from gnnpe_tpu_torch.config import UNLIMITED
from gnnpe_tpu_torch.graph.csr import CSRGraph
from gnnpe_tpu_torch.match.plan import generate_bn, gql_order


def refinement(data_graph: CSRGraph, query_graph: CSRGraph,
               candidates: List[np.ndarray],
               max_answers: int = UNLIMITED,
               engine: str = "native",
               return_embeddings: bool = False):
    """Count (and optionally emit) all monomorphisms consistent with the
    per-query-vertex candidate sets (ref refinement, custom.h:890-932).

    Returns count, or (count, embeddings int32[N, |Vq|]) if requested
    (embeddings indexed by query vertex id, matching ref semantics).
    """
    counts = np.array([len(c) for c in candidates], dtype=np.int64)
    order, pivot = gql_order(query_graph, counts)
    bn = generate_bn(query_graph, order, pivot)

    if engine == "python":
        return _explore_python(data_graph, query_graph, candidates, order,
                               pivot, bn, max_answers, return_embeddings)
    if engine != "native":
        raise ValueError(f"engine must be 'native' or 'python', got "
                         f"{engine!r}")
    from gnnpe_tpu_torch.match.native import explore_native
    count = explore_native(data_graph, query_graph, candidates, order,
                           pivot, bn, max_answers)
    if not return_embeddings:
        return count
    # Emission needs a sized buffer: count first (cheap), then re-run
    # emitting into an exact-size allocation.
    if count == 0:
        return 0, np.zeros((0, query_graph.num_vertices), dtype=np.int32)
    return explore_native(data_graph, query_graph, candidates, order,
                          pivot, bn, max_answers, max_emit=count)


def _explore_python(data_graph: CSRGraph, query_graph: CSRGraph,
                    candidates: List[np.ndarray], order: np.ndarray,
                    pivot: np.ndarray, bn: List[np.ndarray],
                    max_answers: int, return_embeddings: bool):
    """QuickSI-style iterative DFS (ref exploreQuickSIStyle,
    custom.h:799-888), vectorized per depth with numpy masks."""
    nq = query_graph.num_vertices
    q_labels = query_graph.labels
    q_degrees = query_graph.degrees
    d_labels = data_graph.labels
    d_degrees = data_graph.degrees

    visited = np.zeros(data_graph.num_vertices, dtype=bool)
    embedding = np.zeros(nq, dtype=np.int64)
    stacks: List[np.ndarray] = [None] * nq
    idx = np.zeros(nq, dtype=np.int64)

    stacks[0] = np.asarray(candidates[order[0]], dtype=np.int64)
    count = 0
    emb_out: List[np.ndarray] = []
    depth = 0

    while True:
        advanced = False
        while idx[depth] < len(stacks[depth]):
            v = int(stacks[depth][idx[depth]])
            idx[depth] += 1
            u = int(order[depth])
            embedding[u] = v
            if depth == nq - 1:
                count += 1
                if return_embeddings:
                    emb_out.append(embedding.copy())
                if count >= max_answers:
                    if return_embeddings:
                        return count, np.array(emb_out, dtype=np.int64)
                    return count
            else:
                visited[v] = True
                depth += 1
                idx[depth] = 0
                stacks[depth] = _valid_candidates(
                    data_graph, depth, order, pivot, bn, embedding,
                    visited, q_labels, q_degrees, d_labels, d_degrees)
                advanced = True
                break
        if advanced:
            continue
        depth -= 1
        if depth < 0:
            break
        visited[embedding[order[depth]]] = False

    if return_embeddings:
        return count, (np.array(emb_out, dtype=np.int64)
                       if emb_out else np.zeros((0, nq), dtype=np.int64))
    return count


def _valid_candidates(data_graph, depth, order, pivot, bn, embedding,
                      visited, q_labels, q_degrees, d_labels, d_degrees
                      ) -> np.ndarray:
    """Vectorized generateValidCandidates (custom.h:757-797): pivot's
    data neighbors filtered by label/degree/visited and backward-edge
    existence."""
    u = int(order[depth])
    p = int(embedding[pivot[depth]])
    # Per-label adjacency slice (ref buildLabelOffset semantics,
    # graph.cpp:125-159): only pivot's neighbors carrying u's label.
    nbrs = data_graph.neighbors_with_label(
        p, int(q_labels[u])).astype(np.int64)
    ok = (~visited[nbrs]) & (d_degrees[nbrs] >= q_degrees[u])
    cand = nbrs[ok]
    for u_nbr in bn[depth]:
        if not len(cand):
            break
        w = int(embedding[u_nbr])
        cand = cand[data_graph.has_edge(cand, np.full(len(cand), w))]
    return cand
