"""Plain reference, the parts every variant shares: the label-seeded
features, the vertex dominance embedding (VDE) and the answer count of
refinement.  NumPy only; nothing of the program is imported.

Semantics (GNN-PE, Ye et al., VLDB 2024; its code's custom.h):
  * a label's feature x is ``dim`` draws of libstdc++'s
    ``uniform_real_distribution<double>(0, 1)`` on ``std::mt19937(label)``
    (two 32-bit outputs g1, g2 give (g1 + g2 * 2^32) / 2^64), divided by
    their left-to-right sum;
  * vde(v) = x(v) + sum of x(u) over the neighbours u of v;
  * refinement counts the injective, label- and edge-preserving maps of
    the query (a data vertex's degree at least its query vertex's) whose
    first vertex in matching order takes one of its candidates, stopping
    at ``cap``.  The first vertex is the query vertex with the fewest
    candidates, ties to the larger query degree, then the lower id.  The
    other vertices are not held to their candidate sets, so the count is
    min(cap, that number of maps), whatever order the maps are found in.
"""

from __future__ import annotations

from typing import List

import numpy as np

_TWO32 = float(2 ** 32)
_TWO64 = float(2 ** 64)


def label_table(labels_count: int, dim: int) -> np.ndarray:
    """float64[labels_count, dim]: row l is label l's feature x."""
    table = np.empty((labels_count, dim), np.float64)
    for label in range(labels_count):
        raw = np.random.RandomState(label).randint(
            0, 2 ** 32, size=2 * dim, dtype=np.uint64).astype(np.float64)
        vals = np.minimum((raw[0::2] + raw[1::2] * _TWO32) / _TWO64,
                          np.nextafter(1.0, 0.0))
        total = 0.0
        for v in vals:
            total += v
        table[label] = vals / total
    return table


def vde(offsets: np.ndarray, neighbors: np.ndarray, labels: np.ndarray,
        dim: int, dtype=np.float64) -> np.ndarray:
    """The VDE of every vertex, [V, dim] in ``dtype``: the features and
    the neighbour sums are taken in ``dtype`` (float64 as configured;
    float32 is the control's)."""
    x = label_table(int(labels.max(initial=-1)) + 1, dim).astype(dtype)
    xv = x[labels]
    n = len(labels)
    src = np.repeat(np.arange(n), np.diff(offsets))
    if dtype == np.float64:
        # bincount adds each row's terms left to right, in row order.
        nx = np.stack([np.bincount(src, weights=xv[neighbors, j],
                                   minlength=n) for j in range(dim)], 1)
    else:
        nx = np.zeros((n, dim), dtype)
        np.add.at(nx, src, xv[neighbors])
    return (xv + nx).astype(dtype)


def has_edge(offsets, neighbors, u: np.ndarray, w: np.ndarray) -> np.ndarray:
    """bool per pair: is w in u's sorted row?"""
    end = offsets[u + 1]
    lo, hi = offsets[u].copy(), end.copy()
    while (lo < hi).any():                       # lower bound, every row at once
        live = lo < hi
        mid = (lo + hi) // 2
        below = live & (neighbors[np.where(live, mid, 0)] < w)
        lo = np.where(below, mid + 1, lo)
        hi = np.where(live & ~below, mid, hi)
    return (lo < end) & (neighbors[np.minimum(lo, len(neighbors) - 1)] == w)


def first_vertex(candidates: List[np.ndarray], q_degrees: np.ndarray) -> int:
    best = 0
    for u in range(1, len(candidates)):
        if (len(candidates[u]), -q_degrees[u]) < (len(candidates[best]),
                                                 -q_degrees[best]):
            best = u
    return best


def count_answers(offsets, neighbors, labels, q_edges: np.ndarray,
                  q_labels: np.ndarray, candidates: List[np.ndarray],
                  cap: int, rows_per_step: int = 1 << 15) -> int:
    """min(cap, the maps of the query as set out above).  The maps are
    grown a query vertex at a time over rows of partial maps, in slices
    of at most ``rows_per_step`` new rows."""
    n = len(q_labels)
    q_adj = [set() for _ in range(n)]
    for a, b in np.asarray(q_edges).reshape(-1, 2):
        q_adj[int(a)].add(int(b))
        q_adj[int(b)].add(int(a))
    q_deg = np.array([len(s) for s in q_adj])
    d_deg = np.diff(offsets)
    root = first_vertex(candidates, q_deg)
    order, parent = [root], {root: None}
    for u in order:                              # breadth first
        for w in sorted(q_adj[u]):
            if w not in parent:
                parent[w] = u
                order.append(w)
    if len(order) != n:
        raise ValueError("query graph is not connected")
    pos = {u: i for i, u in enumerate(order)}
    steps = []
    for i, u in enumerate(order[1:], 1):
        back = [pos[w] for w in q_adj[u] if pos[w] < i and w != parent[u]]
        steps.append((u, pos[parent[u]], back))

    def grow(rows: np.ndarray, depth: int) -> int:
        if depth == n:
            return len(rows)
        u, p, back = steps[depth - 1]
        pv = rows[:, p]
        deg = d_deg[pv]
        total = 0
        # Slices whose rows have at most rows_per_step neighbours in all.
        ends = np.searchsorted(np.cumsum(deg), np.arange(
            rows_per_step, int(deg.sum()) + rows_per_step, rows_per_step),
            side="right")
        lo = 0
        for hi in np.unique(np.append(ends, len(rows))):
            if hi <= lo:
                continue
            part, d = rows[lo:hi], deg[lo:hi]
            lo = hi
            rep = np.repeat(np.arange(len(part)), d)
            first = np.repeat(offsets[part[:, p]], d)
            k = np.arange(len(rep)) - np.repeat(np.cumsum(d) - d, d)
            w = neighbors[first + k].astype(np.int64)
            ok = (labels[w] == q_labels[u]) & (d_deg[w] >= q_deg[u])
            for j in range(depth):
                ok &= part[rep, j] != w
            for j in back:
                sel = np.nonzero(ok)[0]
                ok[sel] = has_edge(offsets, neighbors, part[rep[sel], j],
                                   w[sel])
            nxt = np.concatenate([part[rep[ok]], w[ok][:, None]], 1)
            total += grow(nxt, depth + 1)
            if total >= cap:
                return total
        return total

    roots = np.asarray(candidates[root], np.int64)[:, None]
    return min(cap, grow(roots, 1)) if len(roots) else 0
