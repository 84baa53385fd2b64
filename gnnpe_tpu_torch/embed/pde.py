"""Path dominance embeddings and PGE path groups.

The host forms (numpy gathers and folds over f64 VDE) are re-exported
from gnnpe_tpu.  ``path_groups_device`` is the counterpart of
gnnpe_tpu's ``path_groups_device`` (ROADMAP Queue B7's fold): the paths
come from the device enumerator chunk by chunk and fold into per-vertex
boxes with an f64 segment min/max on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnpe_tpu.embed.pde import (PathEmbeddings, gen_pde,
                                 gen_query_pde_table, path_groups)
from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["PathEmbeddings", "gen_pde", "gen_query_pde_table",
           "path_groups", "path_groups_device"]


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
