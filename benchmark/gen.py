"""The benchmark's data generators, frozen.

Copies of ``powerlaw_graph`` and ``sample_query`` as the program had
them (``gnnpe_tpu_torch/io/datasets.py`` at commit 3cd8d14): the same
draws in the same order, so a seed gives the graph and the queries the
program's own generator gave.  They are kept here because the yardstick
may not move when the program changes.  They work on plain arrays and
import nothing of the program: a graph is ``(edges int64[E, 2], labels
int32[V])``, its adjacency ``csr(...)``'s sorted rows.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np


def derive_seed(seed: int, stream: int) -> int:
    """A 32-bit seed for ``np.random.RandomState`` from a run's ``--seed``
    (any whole number >= 0) and the stream it feeds."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])


def powerlaw_graph(num_vertices: int, num_edges: int, num_labels: int,
                   alpha: float, seed: int,
                   max_degree: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Labelled simple power-law graph: endpoints drawn with weight
    rank^-alpha, self-loops and repeated edges dropped, degrees capped at
    ``max_degree`` (edges dropped in drawing order), zipf labels.
    Returns (edges int64[E, 2], labels int32[V])."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, num_vertices + 1) ** alpha
    cdf = np.cumsum(w / w.sum())
    m = int(num_edges * (1.6 if max_degree else 1.3)) + 16
    draws = rng.rand(m), rng.rand(m)
    with ThreadPoolExecutor(2) as pool:      # numpy's sorts leave the GIL
        u, v = pool.map(lambda r: _search_sorted_keys(cdf, r), draws)
    del draws
    u = np.minimum(u, num_vertices - 1)
    v = np.minimum(v, num_vertices - 1)
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    pairs = np.unique(lo * num_vertices + hi)
    pairs = pairs[rng.permutation(len(pairs))]
    if max_degree is not None:
        pairs = _cap_degrees(pairs, num_vertices, max_degree)
    pairs = pairs[:num_edges]
    edges = np.stack([pairs // num_vertices, pairs % num_vertices], 1)
    lw = 1.0 / np.arange(1, num_labels + 1) ** 1.1
    labels = rng.choice(num_labels, size=num_vertices,
                        p=lw / lw.sum()).astype(np.int32)
    return edges, labels


def _search_sorted_keys(cdf: np.ndarray, keys: np.ndarray) -> np.ndarray:
    order = np.argsort(keys)
    out = np.empty(len(keys), np.int64)
    out[order] = np.searchsorted(cdf, keys[order])
    return out


def _cap_degrees(pairs: np.ndarray, num_vertices: int,
                 max_degree: int) -> np.ndarray:
    """Keep the edges (in the given order) whose endpoints both stay at
    or under ``max_degree``."""
    for _ in range(16):
        u, v = pairs // num_vertices, pairs % num_vertices
        m = len(pairs)
        ids = np.concatenate([u, v])
        deg = np.bincount(ids, minlength=num_vertices)
        over = deg > max_degree
        if not over.any():
            break
        n = np.int64(len(ids))
        order = np.sort(ids * n + np.arange(n)) % n
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(ids,
                                        minlength=num_vertices))])[:-1]
        r = np.empty(len(ids), dtype=np.int64)
        r[order] = np.arange(len(ids)) - starts[ids[order]]
        keep = ((~over[u] | (r[:m] < max_degree)) &
                (~over[v] | (r[m:] < max_degree)))
        pairs = pairs[keep]
    return pairs


def csr(num_vertices: int, edges: np.ndarray
        ) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int64[V+1], neighbors int32[2E]) of an undirected edge
    list, each row sorted ascending."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    v = np.int64(max(num_vertices, 1))
    arcs = np.sort(np.concatenate([edges[:, 0] * v + edges[:, 1],
                                   edges[:, 1] * v + edges[:, 0]]))
    counts = np.bincount(arcs // v, minlength=num_vertices)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return offsets, (arcs % v).astype(np.int32)


def sample_query(offsets: np.ndarray, neighbors: np.ndarray,
                 labels: np.ndarray, num_vertices: int, tree: bool,
                 seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A connected query of ``num_vertices`` vertices by a random walk on
    the data graph, its labels those of the walked vertices (so it has
    matches); ``tree`` keeps only the walk's edges, else every induced
    edge.  Returns (edges int64[E, 2], labels int32[n])."""
    rng = np.random.RandomState(seed)
    nbrs_of = lambda x: neighbors[offsets[x]:offsets[x + 1]]
    start_pool = np.nonzero(np.diff(offsets) > 0)[0]
    if not len(start_pool):
        raise ValueError("data graph has no edges")
    for _ in range(64):
        chosen = [int(rng.choice(start_pool))]
        chosen_set = {chosen[0]}
        tree_edges = []
        while len(chosen) < num_vertices:
            frontier = [v for v in chosen
                        if any(int(u) not in chosen_set for u in nbrs_of(v))]
            if not frontier:
                break
            v = int(rng.choice(frontier))
            nbrs = [int(u) for u in nbrs_of(v) if int(u) not in chosen_set]
            u = int(rng.choice(nbrs))
            chosen.append(u)
            chosen_set.add(u)
            tree_edges.append((v, u))
        if len(chosen) == num_vertices:
            break
    else:
        raise ValueError("could not sample a connected query")
    remap = {v: i for i, v in enumerate(chosen)}
    if tree:
        edges = [[remap[a], remap[b]] for a, b in tree_edges]
    else:
        edges = [[remap[a], remap[int(b)]] for a in chosen
                 for b in nbrs_of(a)
                 if int(b) in remap and remap[a] < remap[int(b)]]
    return (np.array(edges, dtype=np.int64).reshape(-1, 2),
            labels[np.array(chosen)].astype(np.int32))
