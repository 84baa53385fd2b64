"""Vertex dominance embeddings (VDE).

``vde[v] = x[v] + Σ_{u∈N(v)} x[u]`` with x the label-seeded features
(reference gen_vde, GNN-PE/include/custom.h:513-544).  Dominance: if
u↦v is part of a monomorphism then vde(u) ≤ vde(v) element-wise,
because x depends only on the label and all entries are positive.

Two paths:
  * ``gen_vde_host`` — numpy float64 (the port's copy of gnnpe_tpu's
    ``gen_vde``), bit-identical to the reference; the oracle the device
    VDE is held against.
  * ``gen_vde`` — the label table gathered on ``device`` and the hop run
    through ``ops.spmm.neighbor_sum`` (the CUDA kernel on a CUDA device)
    in f64, bit-equal to ``gen_vde_host``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.ops.mt19937 import label_feature_table
from gnnpe_tpu_torch.ops.spmm import neighbor_sum, neighbor_sum_np

__all__ = ["VertexEmbeddings", "gen_vde", "gen_vde_host"]


@dataclass
class VertexEmbeddings:
    """Struct-of-arrays replacement for the reference's vector<Vertex>
    (custom.h:121-130): labels/degrees plus x, nx, vde tables."""

    labels: np.ndarray    # int32[V]
    degrees: np.ndarray   # int32[V]
    x: np.ndarray         # f64[V, D] label-seeded features
    nx: np.ndarray        # f64[V, D] neighbor sums
    vde: np.ndarray       # f64[V, D] x + nx

    @property
    def num_vertices(self) -> int:
        return len(self.labels)

    @property
    def dim(self) -> int:
        return self.x.shape[1]


def gen_vde_host(graph: CSRGraph, vde_dim: int) -> VertexEmbeddings:
    """Host-exact VDE (parity with custom.h:513-544).

    x is a per-label table gathered to vertices (same-label vertices share
    x by construction); nx is one SpMM hop; vde = x + nx, all float64 with
    the reference's accumulation order.
    """
    table = label_feature_table(graph.labels_count, vde_dim)
    x = table[graph.labels]
    nx = neighbor_sum_np(graph.offsets, graph.neighbors, x)
    return VertexEmbeddings(labels=graph.labels, degrees=graph.degrees,
                            x=x, nx=nx, vde=x + nx)


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
