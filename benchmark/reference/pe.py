"""Plain reference of GNN-PE's candidates (Ye et al., VLDB 2024; its
code's custom.h), for paths of 2 or 3 vertices (l = 1 or 2).  NumPy
only; nothing of the program is imported.

Semantics:
  * the index holds every simple path of L vertices in one orientation:
    (a, ..., c) is kept where (degree(a), a) < (degree(c), c), the
    orientation that enumeration from vertices in ascending degree order
    meets first;
  * a query's paths are its own simple paths kept where a < c (its
    enumeration runs from vertex 0 up), in that enumeration's order
    (a ascending, then each next vertex in ascending neighbour order);
    the plan is the greedy cover: paths by the sum of their query
    degrees, largest first (stable), each kept where it adds a vertex,
    until every vertex is covered;
  * a data path matches a plan path where at every position the labels
    are equal, the data degree is at least the query degree, and every
    VDE entry d satisfies d >= q - max(eps, eps * |q|);
  * a query vertex's candidates are the data vertices at its positions
    in the matching paths of every plan path.

The matching paths are not enumerated: for a plan path (q0, q1, q2) and
a middle vertex b that passes q1's test, (a, b, c) matches exactly where
a is a neighbour of b passing q0's test, c one passing q2's, and
(degree(a), a) < (degree(c), c).  So a is a candidate where some c of b
ranks above it, c where some a ranks below it, b where the lowest a
ranks below the highest c.
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.reference.graph import vde as vertex_embedding


class Data:
    """The data graph as the reference holds it."""

    def __init__(self, offsets, neighbors, labels, dim: int,
                 dtype=np.float64):
        self.offsets, self.neighbors = offsets, neighbors
        self.labels = labels
        self.degrees = np.diff(offsets)
        self.vde = vertex_embedding(offsets, neighbors, labels, dim, dtype)
        n = len(labels)
        self.rank = self.degrees.astype(np.int64) * n + np.arange(n)
        order = np.argsort(labels, kind="stable")
        bounds = np.searchsorted(labels[order], np.arange(labels.max() + 2))
        self.by_label = [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def passing(self, label: int, degree: int, thr: np.ndarray) -> np.ndarray:
        """bool[V]: the vertices of ``label`` with at least ``degree``
        neighbours and every VDE entry at least ``thr``'s."""
        out = np.zeros(len(self.labels), bool)
        if not 0 <= label < len(self.by_label):
            return out
        ids = self.by_label[label]
        keep = self.degrees[ids] >= degree
        for j, t in enumerate(thr):
            keep &= self.vde[ids, j] >= t
        out[ids[keep]] = True
        return out


def query_paths(q_edges: np.ndarray, n: int, length: int) -> np.ndarray:
    adj = [[] for _ in range(n)]
    for a, b in np.asarray(q_edges).reshape(-1, 2):
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    adj = [sorted(r) for r in adj]
    rows = [[a] for a in range(n)]
    for _ in range(length - 1):
        rows = [r + [w] for r in rows for w in adj[r[-1]] if w not in r]
    return np.array([r for r in rows if r[0] < r[-1]],
                    np.int64).reshape(-1, length)


def plan(paths: np.ndarray, q_degrees: np.ndarray, n: int) -> np.ndarray:
    weight = q_degrees[paths].sum(1)
    covered, keep = set(), []
    for i in np.argsort(-weight, kind="stable"):
        new = set(int(v) for v in paths[i]) - covered
        if new:
            covered |= new
            keep.append(int(i))
        if len(covered) == n:
            break
    return np.array(keep, np.int64)


def query_table(q_edges: np.ndarray, q_labels: np.ndarray, dim: int,
                length: int, dtype=np.float64) -> dict:
    """The plan's rows: ``vids`` int[R, L], ``labels``, ``degrees`` and
    ``pde`` [R, L * dim] (the VDE of its vertices, side by side)."""
    n = len(q_labels)
    offsets, neighbors = _csr(n, q_edges)
    degrees = np.diff(offsets)
    q_vde = vertex_embedding(offsets, neighbors, q_labels, dim, dtype)
    paths = query_paths(q_edges, n, length)
    rows = paths[plan(paths, degrees, n)]
    return dict(vids=rows, labels=q_labels[rows], degrees=degrees[rows],
                pde=q_vde[rows].reshape(len(rows), -1), n=n)


def _csr(n, edges):
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    arcs = np.sort(np.concatenate([edges[:, 0] * n + edges[:, 1],
                                   edges[:, 1] * n + edges[:, 0]]))
    offsets = np.concatenate([[0], np.cumsum(np.bincount(arcs // n,
                                                         minlength=n))])
    return offsets, arcs % n


def threshold(q: np.ndarray, eps: float) -> np.ndarray:
    return q - np.maximum(eps, eps * np.abs(q))


def candidates(data: Data, table: dict, eps: float) -> List[np.ndarray]:
    """Sorted candidate ids of every query vertex."""
    n, dim = table["n"], data.vde.shape[1]
    hits = [[] for _ in range(n)]
    for vids, labs, degs, pde in zip(table["vids"], table["labels"],
                                     table["degrees"], table["pde"]):
        thr = threshold(pde, eps).reshape(len(vids), dim)
        ok = [data.passing(int(labs[k]), int(degs[k]),
                           thr[k].astype(data.vde.dtype))
              for k in range(len(vids))]
        for k, found in enumerate(_matches(data, ok)):
            hits[vids[k]].append(found)
    return [np.unique(np.concatenate(h)).astype(np.int64) if h
            else np.zeros(0, np.int64) for h in hits]


def _arcs(data: Data, first: np.ndarray):
    """The vertices where ``first`` holds that have neighbours, their
    degrees, and the targets of their arcs in that order."""
    src = np.nonzero(first & (data.degrees > 0))[0]
    deg = data.degrees[src]
    at = np.repeat(data.offsets[src] - np.cumsum(deg) + deg, deg)
    return src, deg, data.neighbors[at + np.arange(len(at))].astype(np.int64)


def _matches(data: Data, ok: List[np.ndarray]) -> List[np.ndarray]:
    rank = data.rank
    if len(ok) == 2:
        src, deg, dst = _arcs(data, ok[0])
        src = np.repeat(src, deg)
        arc = ok[1][dst] & (rank[src] < rank[dst])
        return [src[arc], dst[arc]]
    if len(ok) != 3:
        raise ValueError(f"paths of {len(ok)} vertices: the reference "
                         "covers 2 and 3")
    b, deg, dst = _arcs(data, ok[1])                # arcs from a middle b
    if not len(b):
        return [np.zeros(0, np.int64)] * 3
    first = np.cumsum(deg) - deg
    is_a, is_c = ok[0][dst], ok[2][dst]
    low_a = np.minimum.reduceat(                    # lowest a of each b
        np.where(is_a, rank[dst], np.iinfo(np.int64).max), first)
    high_c = np.maximum.reduceat(                   # highest c of each b
        np.where(is_c, rank[dst], -1), first)
    a = dst[is_a & (rank[dst] < np.repeat(high_c, deg))]
    c = dst[is_c & (rank[dst] > np.repeat(low_a, deg))]
    return [a, b[low_a < high_c], c]
