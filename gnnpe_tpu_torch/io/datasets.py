"""Dataset ladder: loaders and generators for the benchmark configs.

BASELINE.md's ladder runs Test → Yeast → DBLP/YouTube → US Patents →
synthetic power-law.  The reference ships only Test/ (pre-converted
`.graph` text + the original networkx gpickle); the real datasets are
the SunLab SubgraphMatching suite's `.graph` format, which CSRGraph
already reads.  This module adds:

  * deterministic synthetic generators (labeled power-law and
    Erdős–Rényi graphs) so every ladder rung is runnable without
    downloads (zero-egress environment);
  * random connected query-graph sampling (the standard methodology:
    random walk on the data graph, keep the induced/tree edges);
  * a registry keyed by name with per-rung sizes.
"""

# The port's own copy of gnnpe_tpu/io/datasets.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from gnnpe_tpu_torch.graph.csr import CSRGraph


def powerlaw_graph(num_vertices: int, num_edges: int, num_labels: int,
                   alpha: float = 0.8, seed: int = 0,
                   max_degree: Optional[int] = None) -> CSRGraph:
    """Labeled undirected multigraph-free power-law graph.

    Endpoint sampling ∝ rank^-alpha via inverse-CDF (the same degree
    model as bench.synth_graph), self-loops and duplicate edges
    dropped, labels zipf-distributed (real label frequencies are
    skewed — graph.cpp's reverse index assumes nothing else).

    ``max_degree`` caps per-vertex degree by dropping excess edges (in
    sampling order).  Uncapped rank-zipf sampling at alpha<1 puts
    ~E/Σw on the top vertex — e.g. a degree-33k hub on the DBLP-scale
    rung, where the real DBLP max degree is 343 — which inflates the
    3-vertex path count (Σ deg·(deg-1)) by orders of magnitude beyond
    the real dataset.  The ladder specs below cap at the REAL graph's
    published max degree so path-count scaling is representative.
    """
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, num_vertices + 1) ** alpha
    cdf = np.cumsum(w / w.sum())
    # Oversample: dedup + degree capping remove some pairs.
    m = int(num_edges * (1.6 if max_degree else 1.3)) + 16
    u = np.searchsorted(cdf, rng.rand(m)).astype(np.int64)
    v = np.searchsorted(cdf, rng.rand(m)).astype(np.int64)
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
    return CSRGraph.from_edges(num_vertices, edges, labels)


def _cap_degrees(pairs: np.ndarray, num_vertices: int,
                 max_degree: int) -> np.ndarray:
    """Keep edges (in the given order) whose endpoints both stay at or
    under ``max_degree``.  Vectorized greedy: occurrence ranks per
    endpoint prune most violations in 2-3 rounds."""
    for _ in range(16):
        u, v = pairs // num_vertices, pairs % num_vertices
        m = len(pairs)
        ids = np.concatenate([u, v])   # edge e occurs at e (u) and e+m
        deg = np.bincount(ids, minlength=num_vertices)
        over = (deg > max_degree)
        if not over.any():
            break
        # combined occurrence rank of each incidence within its vertex
        order = np.argsort(ids, kind="stable")
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(ids,
                                        minlength=num_vertices))])[:-1]
        r = np.empty(len(ids), dtype=np.int64)
        r[order] = np.arange(len(ids)) - starts[ids[order]]
        keep = ((~over[u] | (r[:m] < max_degree)) &
                (~over[v] | (r[m:] < max_degree)))
        pairs = pairs[keep]
    return pairs


def sample_query(data_graph: CSRGraph, num_vertices: int,
                 tree: bool = True, seed: int = 0) -> CSRGraph:
    """Connected query sampled by random walk on the data graph —
    the standard benchmark methodology (query labels inherited from
    the walked data vertices, so matches are guaranteed to exist).

    tree=True keeps only the walk tree's edges (the reference's Test
    query is a tree); tree=False keeps all induced edges.
    """
    rng = np.random.RandomState(seed)
    deg = np.diff(data_graph.offsets)
    start_pool = np.nonzero(deg > 0)[0]
    assert len(start_pool), "data graph has no edges"
    for _ in range(64):
        chosen = [int(rng.choice(start_pool))]
        chosen_set = {chosen[0]}
        tree_edges = []
        while len(chosen) < num_vertices:
            frontier = [v for v in chosen
                        if any(int(u) not in chosen_set
                               for u in data_graph.vertex_neighbors(v))]
            if not frontier:
                break
            v = int(rng.choice(frontier))
            nbrs = [int(u) for u in data_graph.vertex_neighbors(v)
                    if int(u) not in chosen_set]
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
        edges = np.array([[remap[a], remap[b]] for a, b in tree_edges])
    else:
        edges = []
        for a in chosen:
            for b in data_graph.vertex_neighbors(a):
                b = int(b)
                if b in remap and remap[a] < remap[b]:
                    edges.append([remap[a], remap[b]])
        edges = np.array(edges)
    labels = data_graph.labels[np.array(chosen)]
    return CSRGraph.from_edges(num_vertices, edges, labels)


# ----------------------------------------------------------------------
# Ladder registry: name → builder.  Sizes follow BASELINE.md; synthetic
# stand-ins mirror each real dataset's scale/label count (the real
# SunLab .graph files drop in via CSRGraph.from_graph_file when
# present on disk).

# max_degree = the REAL dataset's published max degree (SNAP /
# SunLab SubgraphMatching stats: DBLP 343, YouTube 28754, US Patents
# 793) so synthetic path-count scaling matches the real rung; YouTube
# is additionally capped at 4096 because Σdeg² with a 28k hub puts
# ~8e8 3-vertex paths on that single vertex — the real graph's skew,
# but out of reach for a single-chip ladder run (documented cap).
LADDER: Dict[str, dict] = {
    "yeast":    dict(v=3_112, e=12_519, labels=71, alpha=0.75,
                     max_degree=168),
    "dblp":     dict(v=317_080, e=1_049_866, labels=15, alpha=0.8,
                     max_degree=343),
    "youtube":  dict(v=1_134_890, e=2_987_624, labels=25, alpha=0.85,
                     max_degree=4096),
    # The REAL YouTube hub skew: max degree uncapped to the published
    # 28,754 (VERDICT r3 item 2).  The 28k hub alone carries ~8.3e8
    # 3-vertex paths through it; PE copes via streamed mode + cost-
    # balanced enumeration chunks, PGE via the O(V) streamed fold.
    "youtube_skew": dict(v=1_134_890, e=2_987_624, labels=25,
                         alpha=0.85, max_degree=28_754),
    "patents":  dict(v=3_774_768, e=16_518_948, labels=20, alpha=0.7,
                     max_degree=793),
    "synth100m": dict(v=20_000_000, e=100_000_000, labels=32,
                      alpha=0.8, max_degree=1024),
}


def load_dataset(name: str, seed: int = 0,
                 path: Optional[str] = None) -> CSRGraph:
    """Load a ladder rung: real file if given/shipped, else the
    deterministic synthetic stand-in at the same scale."""
    if path:
        return CSRGraph.from_graph_file(path)
    spec = LADDER[name]
    if "path" in spec:
        return CSRGraph.from_graph_file(spec["path"])
    return powerlaw_graph(spec["v"], spec["e"], spec["labels"],
                          alpha=spec["alpha"], seed=seed,
                          max_degree=spec.get("max_degree"))
