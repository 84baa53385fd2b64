"""Trainable GNN for path-dominance embeddings (counterpart of
gnnpe_tpu/models/gnn.py).

Model: K layers of
    h^{k+1} = act( h^k @ W_self + (A h^k) @ W_nbr + b )
with non-negative weights (softplus of raw parameters), which keeps the
monotone-dominance property the index prunes with.  The neighbour sum
``A h`` is injected as ``aggregate``: ``ops.spmm.NeighborSum`` (kernel
A1) or ``ops.ell.binned_aggregate`` (kernel A2, forward and backward).
The label lookup and the path readout take an optional
``ops.gather.GatherRows`` plan each, whose backward runs on the
segment-sum kernel (csrc/segment_sum.cu) instead of scattering (the trainers pass them; the embedder's f64
forward does not).

The raw parameters are those of gnnpe_tpu's ``PathGNNParams``:
``w_self``, ``w_nbr``, ``bias`` (one per layer) and ``embed``.
``params_from_jax`` carries JAX weights across, in the leaf order that
``gnnpe_tpu.models.train.save_checkpoint`` writes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gnnpe_tpu_torch.ops.gather import GatherRows
from gnnpe_tpu_torch.utils.device import as_device

ACTIVATIONS = ("identity", "relu", "softplus")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)``: jax.nn.softplus's and
    numpy's form (torch's ``F.softplus`` turns linear above x = 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class PathGNN(nn.Module):
    """Config and raw parameters in one module.

    The parameters start at zero: fill them with ``init``,
    ``reference_params`` or ``params_from_jax``."""

    def __init__(self, dim: int, num_layers: int = 1,
                 labels_count: int = 0, activation: str = "identity",
                 nonneg: bool = True, *, device):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation!r} not in "
                             f"{ACTIVATIONS}")
        self.dim = dim
        self.num_layers = num_layers
        self.labels_count = labels_count
        self.activation = activation
        self.nonneg = nonneg
        dev = as_device(device)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=dev))

        self.w_self = nn.ParameterList(
            [zeros(dim, dim) for _ in range(num_layers)])
        self.w_nbr = nn.ParameterList(
            [zeros(dim, dim) for _ in range(num_layers)])
        self.bias = nn.ParameterList([zeros(dim) for _ in range(num_layers)])
        self.embed = zeros(labels_count, dim)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    def _raw(self, positive: torch.Tensor) -> torch.Tensor:
        """Inverse of the non-negativity map, in f32 as JAX computes it,
        so ``_pos(_raw(x)) ≈ x``."""
        if not self.nonneg:
            return positive
        return torch.log(torch.expm1(torch.clamp(positive, min=1e-6)))

    def _pos(self, raw: torch.Tensor) -> torch.Tensor:
        return softplus(raw) if self.nonneg else raw

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        if self.activation == "relu":
            return torch.relu(h)
        if self.activation == "softplus":
            return softplus(h)
        return h

    def leaves(self) -> list:
        """The raw parameters in JAX's leaf order: w_self[0..L),
        w_nbr[0..L), bias[0..L), embed."""
        return [*self.w_self, *self.w_nbr, *self.bias, self.embed]

    def _set(self, values: Sequence) -> None:
        """Copy f32 ``values`` (leaf order) into the raw parameters."""
        params = self.leaves()
        if len(values) != len(params):
            raise ValueError(f"{len(values)} values for {len(params)} "
                             "parameters")
        with torch.no_grad():
            for p, v in zip(params, values):
                v = torch.from_numpy(np.array(v, dtype=np.float32))
                if v.shape != p.shape:
                    raise ValueError(f"parameter of shape {tuple(p.shape)} "
                                     f"given {tuple(v.shape)}")
                p.copy_(v)

    def _table(self, label_table) -> torch.Tensor:
        t = torch.from_numpy(np.array(label_table, dtype=np.float32))
        if t.shape != self.embed.shape:
            raise ValueError(f"label table {tuple(t.shape)} for embed "
                             f"{tuple(self.embed.shape)}")
        return t

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             label_table: Optional[np.ndarray] = None) -> "PathGNN":
        """Random init with gnnpe_tpu's distribution, drawn from
        ``generator`` on its own device (a CPU generator gives the same
        weights on every device): weights near identity plus
        |0.01·N(0, 1)|, zero raw bias, and the embedding table seeded
        from ``label_table`` or a softmax of N(0, 1) rows."""
        d, gdev = self.dim, generator.device

        def winit():
            noise = 0.01 * torch.randn((d, d), generator=generator,
                                       device=gdev)
            return self._raw(torch.eye(d, device=gdev) + noise.abs())

        w_self, w_nbr = [], []
        for _ in range(self.num_layers):
            w_self.append(winit())
            w_nbr.append(winit())
        bias = [torch.zeros(d) for _ in range(self.num_layers)]
        if label_table is not None:
            embed = self._raw(self._table(label_table))
        else:
            embed = self._raw(torch.softmax(torch.randn(
                (self.labels_count, d), generator=generator, device=gdev),
                dim=-1))
        self._set([t.cpu() for t in w_self + w_nbr + bias + [embed]])
        return self

    def reference_params(self, label_table: np.ndarray) -> "PathGNN":
        """Load the parameters that reproduce the fixed reference VDE
        (identity weights, zero bias, label-seeded embeddings); returns
        the module."""
        d = self.dim
        eye = self._raw(torch.eye(d) + 1e-9)
        bias = (torch.full((d,), -30.0) if self.nonneg else torch.zeros(d))
        self._set([eye] * (2 * self.num_layers) + [bias] * self.num_layers
                  + [self._raw(self._table(label_table))])
        return self

    # ------------------------------------------------------------------
    def vertex_embeddings(self, labels: torch.Tensor, aggregate: Callable,
                          labels_plan: Optional[GatherRows] = None
                          ) -> torch.Tensor:
        """Per-vertex features after message passing; ``aggregate`` is
        the neighbour sum h ↦ A h.  ``labels_plan``, a ``GatherRows``
        built from ``labels``, makes the label lookup's backward
        scatter-free (the segment-sum kernel on a card); without one it is
        ``embed[labels]``."""
        h = _take(self._pos(self.embed), labels, labels_plan)
        for i in range(self.num_layers):
            ws = self._pos(self.w_self[i])
            wn = self._pos(self.w_nbr[i])
            b = self._pos(self.bias[i])
            h = self._act(h @ ws + aggregate(h) @ wn + b)
        return h

    def path_embeddings(self, labels: torch.Tensor, paths: torch.Tensor,
                        aggregate: Callable,
                        labels_plan: Optional[GatherRows] = None,
                        paths_plan: Optional[GatherRows] = None
                        ) -> torch.Tensor:
        """PDE readout: vertex features concatenated along each path
        row, f32 [P, L·D].  ``paths_plan``, a ``GatherRows`` built from
        ``paths`` read flat, does for the readout what ``labels_plan``
        does for the label lookup."""
        h = self.vertex_embeddings(labels, aggregate, labels_plan)
        p, l = paths.shape
        return _take(h, paths.reshape(-1), paths_plan).reshape(
            p, l * self.dim)


def _take(x: torch.Tensor, idx: torch.Tensor,
          plan: Optional[GatherRows]) -> torch.Tensor:
    """``x[idx]``, through ``plan`` where one is given (built from
    ``idx``: its entry count is checked, not its entries)."""
    if plan is None:
        return x[idx]
    if plan.idx.numel() != idx.numel():
        raise ValueError(f"a plan of {plan.idx.numel()} entries for an "
                         f"index of {idx.numel()}")
    return plan(x)


def pair_rows(pde: torch.Tensor, pairs: Sequence[torch.Tensor]) -> list:
    """``pde[p[:, 0]]``, ``pde[p[:, 1]]`` for each ``p`` of ``pairs``, in
    that order, by one gather: the rows change every batch, so no plan
    pays, and one gather's backward zeroes a ``pde``-sized gradient once
    where four would each zero one and then be added up."""
    cols = [c for p in pairs for c in (p[:, 0], p[:, 1])]
    return list(pde[torch.cat(cols)].split([len(c) for c in cols]))


def dominance_loss(model: PathGNN, labels: torch.Tensor,
                   paths: torch.Tensor, subpath_pairs: torch.Tensor,
                   aggregate: Callable, margin: float = 0.0,
                   negative_pairs: Optional[torch.Tensor] = None,
                   neg_margin: float = 0.1,
                   labels_plan: Optional[GatherRows] = None,
                   paths_plan: Optional[GatherRows] = None) -> torch.Tensor:
    """gnnpe_tpu's self-supervised dominance objective: a squared hinge
    on pde_i ≤ pde_j over ``subpath_pairs`` rows (i, j), an
    anti-collapse term and, with ``negative_pairs``, a softplus reward
    for a scale-normalised dominance violation on provable non-matches.
    ``amax`` splits the gradient among ties evenly, as ``jnp.max``
    does.  The plans go to ``path_embeddings``."""
    pde = model.path_embeddings(labels, paths, aggregate, labels_plan,
                                paths_plan)
    pairs = [subpath_pairs]
    if negative_pairs is not None:
        pairs.append(negative_pairs)
    pi, pj, *neg = pair_rows(pde, pairs)
    violation = torch.clamp(pi - pj + margin, min=0.0)
    anti_collapse = torch.clamp(1.0 - pde.mean(0), min=0.0)
    loss = (violation ** 2).mean() + 0.01 * (anti_collapse ** 2).mean()
    if negative_pairs is not None:
        ni, nj = neg
        sep = torch.amax(ni - nj, dim=1) / (nj.abs().mean(1) + 1e-6)
        loss = loss + softplus(neg_margin - sep).mean()
    return loss


def params_from_jax(model: PathGNN, leaves: Sequence) -> PathGNN:
    """Load gnnpe_tpu ``PathGNNParams`` leaves (numpy, in
    ``jax.tree.flatten`` order: w_self[0..L), w_nbr[0..L), bias[0..L),
    embed) into ``model``; returns it."""
    model._set(leaves)
    return model


def load_jax_checkpoint(path: str, model: PathGNN) -> PathGNN:
    """Load an npz written by ``gnnpe_tpu.models.train.save_checkpoint``
    (leaves ``p0..pn``) into ``model``; returns it."""
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("p"))
        return params_from_jax(model, [z[f"p{i}"] for i in range(n)])
