"""Trained-model embedder: serve a PathGNN through the match engines
(counterpart of gnnpe_tpu/models/embedder.py).

The forward runs in float64 on ``device``.  The filter's epsilon is
absolute (1e-6); trained features can be orders of magnitude larger than
the fixed VDE's, and f32 rounding at that scale exceeds the epsilon and
prunes true matches.  In f64 the rounding gap is ~1e-13·|h|.  With
non-negative weights and a monotone activation the embedding keeps the
dominance property for any trained weights, so candidates stay
match-supersets and refinement stays exact.
"""

from __future__ import annotations

import torch

from gnnpe_tpu_torch.embed.vde import VertexEmbeddings
from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.models.gnn import PathGNN, softplus
from gnnpe_tpu_torch.ops.spmm import neighbor_sum
from gnnpe_tpu_torch.utils.device import as_device


def model_embedder(model: PathGNN, device):
    """callable(graph) -> VertexEmbeddings computed by ``model``'s
    current weights (copied now) on ``device``.

    x = the per-label input features, vde = the model's final vertex
    features, nx = vde − x, as gnnpe_tpu's embedder returns them.  The
    raw parameters are upcast to f64 before softplus; each layer's
    neighbour sum is ``ops.spmm.neighbor_sum`` in f64 (kernel A1 on the
    card, bit-equal to numpy's ``neighbor_sum_np``)."""
    dev = as_device(device)

    def pos(raw):
        raw = raw.detach().to(dev, torch.float64)
        return softplus(raw) if model.nonneg else raw

    w_self = [pos(w) for w in model.w_self]
    w_nbr = [pos(w) for w in model.w_nbr]
    bias = [pos(b) for b in model.bias]
    table = pos(model.embed)

    def act(h):
        if model.activation == "relu":
            return torch.relu(h)
        if model.activation == "softplus":
            return softplus(h)
        return h

    def embed(graph: CSRGraph) -> VertexEmbeddings:
        offsets, neighbors, labels, _ = to_device(graph, dev)
        x = table[labels.long()]
        h = x
        for i in range(model.num_layers):
            nbr = neighbor_sum(offsets, neighbors, h)
            h = act(h @ w_self[i] + nbr @ w_nbr[i] + bias[i])
        return VertexEmbeddings(labels=graph.labels, degrees=graph.degrees,
                                x=x.cpu().numpy(), nx=(h - x).cpu().numpy(),
                                vde=h.cpu().numpy())

    return embed
