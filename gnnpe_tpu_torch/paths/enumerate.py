"""Simple-path enumeration as vectorized frontier expansion.

Replaces the reference's recursive DFS with hash-set dedup
(GNN-PE/include/custom.h:66-119) by an array program:

  1. **Expansion**: paths of k vertices are an int32[N, k] matrix; one
     hop appends every neighbor of each row's last vertex (repeat +
     gather over CSR), then masks rows whose new vertex already appears
     (simple-path constraint, custom.h:85).  Expanding rows in order with
     neighbors in ascending order preserves the reference's DFS
     *completion* order exactly, because a depth-first traversal of the
     neighbor tree emits leaves in lexicographic neighbor order.

  2. **Orientation dedup** (PE variant, custom.h:68-78): the reference
     keeps a path only if its reverse wasn't seen earlier.  Every
     directed simple path is generated exactly once, so of each
     {P, reverse(P)} pair the *first-seen* member is kept.  That is a
     group-by-canonical-key, argmin-over-rank reduction — fully
     vectorized, no hash set.

The same expansion (without dedup) serves the PGE variant
(GNN-PGE/include/custom.h:52-71) and the device-side enumerator.
"""

# The port's own copy of gnnpe_tpu/paths/enumerate.py (numpy only; the
# two packages share no code, so the tests can hold one against the
# other).

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gnnpe_tpu_torch.graph.csr import CSRGraph


def _expand_once(graph: CSRGraph, rows: np.ndarray) -> np.ndarray:
    """One frontier hop: append each neighbor of the last vertex, keep
    simple paths, preserve lexicographic order."""
    if rows.shape[0] == 0:
        return np.zeros((0, rows.shape[1] + 1), dtype=np.int32)
    last = rows[:, -1]
    deg = graph.degrees[last].astype(np.int64)
    # Gather each row's full neighbor list, rows expanded in order.
    rep = np.repeat(np.arange(rows.shape[0], dtype=np.int64), deg)
    starts = graph.offsets[last].astype(np.int64)
    # Positions within each row's adjacency: global arange minus the
    # per-row cumulative start.
    row_start = np.concatenate([[0], np.cumsum(deg)])[:-1]
    local = np.arange(rep.shape[0], dtype=np.int64) - row_start[rep]
    nbr = graph.neighbors[starts[rep] + local]
    expanded = np.concatenate(
        [rows[rep], nbr[:, None].astype(np.int32)], axis=1)
    # Simple-path mask: new vertex must differ from all previous.
    simple = (expanded[:, :-1] != expanded[:, -1:]).all(axis=1)
    return expanded[simple]


def enumerate_paths_from(graph: CSRGraph, starts: np.ndarray,
                         num_vertices_per_path: int) -> np.ndarray:
    """All directed simple paths of ``num_vertices_per_path`` vertices
    beginning at ``starts`` (in the given start order), int32[P, L].
    Matches the reference DFS emission order for the same start order."""
    rows = np.asarray(starts, dtype=np.int32)[:, None]
    for _ in range(num_vertices_per_path - 1):
        rows = _expand_once(graph, rows)
    return rows


def dedup_orientations(paths: np.ndarray) -> np.ndarray:
    """Row indices (sorted ascending = enumeration order) of paths that
    survive the reference's reverse-orientation dedup (custom.h:68-78):
    the first-seen member of each {P, reverse(P)} pair."""
    p = paths.shape[0]
    if p == 0:
        return np.zeros(0, dtype=np.int64)
    rev = paths[:, ::-1]
    # Canonical key: lexicographic min of (P, reverse(P)).
    fwd_lt = _lex_less(paths, rev)
    canon = np.where(fwd_lt[:, None], paths, rev)
    # Group identical canonical rows; keep the earliest rank per group.
    order = np.lexsort(canon.T[::-1])
    sorted_canon = canon[order]
    new_group = np.concatenate(
        [[True], (sorted_canon[1:] != sorted_canon[:-1]).any(axis=1)])
    group_id = np.cumsum(new_group) - 1
    num_groups = group_id[-1] + 1
    first_rank = np.full(num_groups, p, dtype=np.int64)
    np.minimum.at(first_rank, group_id, order)
    return np.sort(first_rank)


def dedup_orientations_streaming(paths: np.ndarray,
                                 start_rank: np.ndarray) -> np.ndarray:
    """O(P) bool keep-mask equivalent to :func:`dedup_orientations`
    when ``paths`` is a full enumeration in start-rank order.

    Key fact: a simple path P = (u, ..., w) with u != w and its reverse
    are enumerated from *different* start vertices, and starts are
    processed in rank order — so the first-seen member of each
    {P, reverse(P)} pair is exactly the one whose start has the smaller
    rank.  The reference's hash-set dedup (custom.h:68-78) therefore
    reduces to ``rank[u] < rank[w]``: no sort, no hash set, no global
    state — the rule is local to each row, streams over chunks of the
    enumeration, and shards trivially (each shard filters its own
    rows).  Proven equal to the sort-based oracle on the golden
    415,545-path Test/ set (tests/test_paths.py).

    Args:
      paths: int32[P, L] rows in enumeration order (any contiguous
        chunk of it works too).
      start_rank: int[V] rank of each vertex in the start order
        (rank[order[i]] = i for the degree-sorted order).
    """
    if paths.shape[1] == 1:      # a 1-vertex path is its own reverse
        return np.ones(paths.shape[0], dtype=bool)
    return start_rank[paths[:, 0]] < start_rank[paths[:, -1]]


def start_ranks(order: np.ndarray, num_vertices: int) -> np.ndarray:
    """Inverse of a start order: rank[order[i]] = i.  A vertex outside
    ``order`` ranks after every start (``len(order)``), so the dedup
    keeps a path that ends there: its reverse is never enumerated."""
    rank = np.full(num_vertices, len(order), dtype=np.int64)
    rank[np.asarray(order, dtype=np.int64)] = np.arange(len(order))
    return rank


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise lexicographic a < b for equal-shaped int matrices."""
    result = np.zeros(a.shape[0], dtype=bool)
    decided = np.zeros(a.shape[0], dtype=bool)
    for j in range(a.shape[1]):
        lt = ~decided & (a[:, j] < b[:, j])
        gt = ~decided & (a[:, j] > b[:, j])
        result |= lt
        decided |= lt | gt
    return result


def enumerate_paths(graph: CSRGraph, starts: np.ndarray,
                    num_vertices_per_path: int, *,
                    dedup: bool = True,
                    membership: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, Optional[list]]:
    """Full enumeration pipeline.

    Args:
      starts: start vertices in enumeration order (degree-ascending for
        reference parity; GNN-PE/src/main.cpp:92-96).
      dedup: apply orientation dedup (PE semantics).  False = keep all
        directed paths (PGE semantics / exactness mode).
      membership: optional int[V] partition of each vertex; when given,
        also returns per-partition lists of kept path indices, assigned by
        the path's start vertex (custom.h:74-76).

    Returns (paths int32[P, L], partition_lists or None).
    """
    all_rows = enumerate_paths_from(graph, starts, num_vertices_per_path)
    if dedup:
        # O(P) local rule; == the sort-based dedup_orientations oracle
        # for full enumerations (see dedup_orientations_streaming).
        rank = start_ranks(starts, graph.num_vertices)
        paths = all_rows[dedup_orientations_streaming(all_rows, rank)]
    else:
        paths = all_rows
    parts = None
    if membership is not None:
        num_parts = int(membership.max()) + 1 if len(membership) else 1
        owner = membership[paths[:, 0]]
        parts = [np.nonzero(owner == pid)[0].astype(np.int64)
                 for pid in range(num_parts)]
    return paths, parts
