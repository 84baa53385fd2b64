"""Path dominance embeddings (PDE) and per-vertex path groups.

Reference:
  * gen_pde (GNN-PE/include/custom.h:546-572): pde = concat of vde over a
    path's vertices; pde_label = concat of raw x.  Here both are a single
    gather + reshape over the path id matrix — no per-path loops.
  * gen_query_pde (custom.h:574-599): adds per-path weight (Σ degrees) and
    search key (-Σ pde).  The greedy path-cover plan lives in
    match/plan.py.
  * PGE path groups (GNN-PGE/src/main.cpp:95-177): per start vertex, the
    [min,max] interval of all its paths' embeddings; vertices with no path
    get a degenerate vde box padded with zeros (main.cpp:105-122).

The host forms (numpy gathers and folds over f64 VDE) are the port's
copy of gnnpe_tpu/embed/pde.py.  ``path_groups_device`` is the
counterpart of gnnpe_tpu's ``path_groups_device``: the paths come from
the device enumerator chunk by chunk and fold into per-vertex boxes
with an f64 segment min/max on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnnpe_tpu_torch.embed.vde import VertexEmbeddings
from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["PathEmbeddings", "gen_pde", "gen_query_pde_table",
           "path_groups", "path_groups_device"]


@dataclass
class PathEmbeddings:
    """Struct-of-arrays replacement for vector<Path> (custom.h:132-140)."""

    vids: np.ndarray       # int32[P, L]
    labels: np.ndarray     # int32[P, L]
    degrees: np.ndarray    # int32[P, L]
    pde: np.ndarray        # f64[P, L*D] concatenated vde
    pde_label: np.ndarray  # f64[P, L*D] concatenated x

    @property
    def num_paths(self) -> int:
        return self.vids.shape[0]

    @property
    def path_length(self) -> int:
        return self.vids.shape[1]


def gen_pde(vertices: VertexEmbeddings, paths: np.ndarray) -> PathEmbeddings:
    """Vectorized gen_pde (custom.h:546-572): one fancy-index gather."""
    paths = np.asarray(paths, dtype=np.int32)
    p, l = paths.shape
    d = vertices.dim
    return PathEmbeddings(
        vids=paths,
        labels=vertices.labels[paths],
        degrees=vertices.degrees[paths],
        pde=vertices.vde[paths].reshape(p, l * d),
        pde_label=vertices.x[paths].reshape(p, l * d),
    )


def gen_query_pde_table(vertices: VertexEmbeddings, paths: np.ndarray):
    """Query-path table with weight and key (custom.h:576-599):
    weight = Σ path-vertex degrees; key = -Σ pde entries.
    Returns (PathEmbeddings, weight int64[P], key f64[P])."""
    pe = gen_pde(vertices, paths)
    weight = pe.degrees.astype(np.int64).sum(axis=1)
    key = -pe.pde.sum(axis=1)
    return pe, weight, key


def path_groups(vertices: VertexEmbeddings, start: np.ndarray,
                paths: np.ndarray, pde_dim: int):
    """PGE per-vertex path groups (GNN-PGE/src/main.cpp:95-177).

    Args:
      vertices: embeddings for the graph.
      start: int32[P] owning (start) vertex of each path.
      paths: int32[P, L] path vertex ids (paths from the same start need
        not be contiguous; we sort internally).
      pde_dim: L*D, used for the zero-padded degenerate boxes.

    Returns (group, label_group): f64[V, 2, pde_dim] where [:,0] is the
    per-dimension minimum and [:,1] the maximum over the vertex's paths.
    Vertices with no path get their own vde (padded with zeros) as a
    degenerate box (main.cpp:105-122).
    """
    v = vertices.num_vertices
    d = vertices.dim
    group = np.zeros((v, 2, pde_dim), dtype=np.float64)
    label_group = np.zeros((v, 2, pde_dim), dtype=np.float64)

    # Degenerate boxes for pathless vertices: vde/x in the first D dims,
    # zeros beyond.
    group[:, 0, :d] = vertices.vde
    group[:, 1, :d] = vertices.vde
    label_group[:, 0, :d] = vertices.x
    label_group[:, 1, :d] = vertices.x

    if len(start):
        pe = gen_pde(vertices, paths)
        order = np.argsort(start, kind="stable")
        s = start[order]
        emb = pe.pde[order]
        lemb = pe.pde_label[order]
        uniq, first = np.unique(s, return_index=True)
        group[uniq, 0] = np.minimum.reduceat(emb, first, axis=0)
        group[uniq, 1] = np.maximum.reduceat(emb, first, axis=0)
        label_group[uniq, 0] = np.minimum.reduceat(lemb, first, axis=0)
        label_group[uniq, 1] = np.maximum.reduceat(lemb, first, axis=0)
    return group, label_group


def path_group_keys(group: np.ndarray) -> np.ndarray:
    """Query-vertex search key: -Σ lower bounds of the path group
    (GNN-PGE/src/main.cpp:325-329)."""
    return -group[:, 0, :].sum(axis=1)


def path_groups_device(vertices, graph, order, num_vertices_per_path: int,
                       pde_dim: int, device):
    """(group, label_group) f64[V, 2, pde_dim] as numpy, bit-equal to
    ``path_groups`` over every directed path from ``order`` (no dedup).

    Each start chunk is enumerated on ``device`` (its size from free
    memory, counting the fold's index and gathered f64 row per path);
    its paths' f64 vde and x rows fold into per-start minima and maxima
    with ``scatter_reduce`` (amin/amax).  Min and max select, so the
    fold is exact in any order; gnnpe_tpu's rank-space detour (f32
    devices) is not needed.  Memory is O(V·pde_dim) plus one chunk.
    Vertices without a path keep the degenerate box of their own vde
    (x) padded with zeros (GNN-PGE/src/main.cpp:105-122)."""
    from gnnpe_tpu_torch.paths.device_enumerate import PathEnumerator
    device = as_device(device)
    v, d = vertices.num_vertices, vertices.dim
    width = num_vertices_per_path * d
    vde = torch.from_numpy(np.asarray(vertices.vde, np.float64)).to(device)
    x = torch.from_numpy(np.asarray(vertices.x, np.float64)).to(device)
    inf = float("inf")
    folds = {name: torch.full((v, width), fill, dtype=torch.float64,
                              device=device)
             for name, fill in (("mn_v", inf), ("mx_v", -inf),
                                ("mn_x", inf), ("mx_x", -inf))}
    has_path = torch.zeros(v, dtype=torch.bool, device=device)
    enum = PathEnumerator(graph, device,
                          row_bytes=8 * (num_vertices_per_path + 1 + width))
    for rows in enum.chunks(order, num_vertices_per_path):
        seg = rows[:, :1].long().expand(-1, width)
        flat = rows.long()
        for name, table, how in (("mn_v", vde, "amin"), ("mx_v", vde, "amax"),
                                 ("mn_x", x, "amin"), ("mx_x", x, "amax")):
            folds[name].scatter_reduce_(0, seg, table[flat].flatten(1), how)
        has_path[rows[:, 0].long()] = True

    group = np.zeros((v, 2, pde_dim), dtype=np.float64)
    label_group = np.zeros((v, 2, pde_dim), dtype=np.float64)
    group[:, 0, :d] = group[:, 1, :d] = vertices.vde
    label_group[:, 0, :d] = label_group[:, 1, :d] = vertices.x
    has = has_path.cpu().numpy()
    for out, side, name in ((group, 0, "mn_v"), (group, 1, "mx_v"),
                            (label_group, 0, "mn_x"),
                            (label_group, 1, "mx_x")):
        out[has, side, :width] = folds[name].cpu().numpy()[has]
    return group, label_group
