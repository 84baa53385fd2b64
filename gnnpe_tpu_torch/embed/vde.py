"""Vertex dominance embeddings (VDE) on the device.

``vde[v] = x[v] + Σ_{u∈N(v)} x[u]`` with x the label-seeded features
(gnnpe_tpu/embed/vde.py).  The label table is gathered on ``device`` and
the hop runs through ``ops.spmm.neighbor_sum`` (the CUDA kernel on a
CUDA device) in f64, so the result is bit-equal to the host ``gen_vde``.
That host version (numpy only) is re-exported as ``gen_vde_host``, the
reference the device VDE is held against.
"""

from __future__ import annotations

import torch

from gnnpe_tpu.embed.vde import VertexEmbeddings
from gnnpe_tpu.embed.vde import gen_vde as gen_vde_host
from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.ops.mt19937 import label_feature_table
from gnnpe_tpu_torch.ops.spmm import neighbor_sum

__all__ = ["VertexEmbeddings", "gen_vde", "gen_vde_host"]


def gen_vde(graph: CSRGraph, vde_dim: int, device) -> VertexEmbeddings:
    """VDE computed on ``device``, returned as f64 numpy arrays (the host
    index build consumes them)."""
    offsets, neighbors, labels, _ = to_device(graph, device)
    table = torch.from_numpy(
        label_feature_table(graph.labels_count, vde_dim)).to(offsets.device)
    x = table[labels.long()]
    nx, vde = neighbor_sum(offsets, neighbors, x, with_vde=True)
    return VertexEmbeddings(labels=graph.labels, degrees=graph.degrees,
                            x=x.cpu().numpy(), nx=nx.cpu().numpy(),
                            vde=vde.cpu().numpy())
