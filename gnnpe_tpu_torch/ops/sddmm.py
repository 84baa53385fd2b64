"""SDDMM and scatter-free attention aggregation over the uniform-width
ELL (counterpart of gnnpe_tpu/ops/sddmm.py).

SDDMM (sampled dense-dense matmul): per-arc scores
``s[e] = <x[src_e], y[dst_e]>``, the score of attention-style GNNs
(GAT / transformer-conv), as row gathers and a row-wise dot.

One attention hop composes three scatter-free pieces over one
``HierarchicalEll`` (ops/ell.py), whose level-1 slots carry the arc ids
through ``slot_arc``:

  sddmm           per-arc scores                 (gather + dot)
  segment_softmax per-destination softmax        (slot folds, masked)
  weighted_apply  out[v] = Σ_e w_e · x[src_e]    (weighted gather-sum)

The sum folds and the fold levels of ``weighted_apply`` walk the
layout's levels 2+ as ``HierarchicalEll`` does: one launch of the
gather-sum kernel a level on a CUDA tensor, the masked plain form on a
CPU tensor.  The max fold is ``amax`` over -inf pads.

The reference has no attention (SURVEY.md §2.3); this is the trainable
GNN family's kernel, not a reference stage.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnpe_tpu_torch.ops.ell import HierarchicalEll

__all__ = ["arc_endpoints", "attention_aggregate", "sddmm",
           "segment_softmax", "weighted_apply"]


def arc_endpoints(offsets: np.ndarray) -> np.ndarray:
    """int32[E]: destination vertex of each CSR arc."""
    deg = np.diff(np.asarray(offsets, dtype=np.int64))
    return np.repeat(np.arange(len(deg), dtype=np.int32), deg)


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).long()


def sddmm(neighbors, dst_of_arc, x: torch.Tensor, y: torch.Tensor,
          chunk: int = 1 << 20) -> torch.Tensor:
    """Per-arc scores s[e] = <x[neighbors[e]], y[dst_of_arc[e]]>, in
    chunks of ``chunk`` arcs so the gathered rows stay O(chunk·D);
    returns [E] in CSR arc order, on ``x``'s device."""
    nbr = _index(neighbors, x.device)
    dst = _index(dst_of_arc, x.device)
    outs = [(x[nbr[lo:lo + chunk]] * y[dst[lo:lo + chunk]]).sum(-1)
            for lo in range(0, max(len(nbr), 1), chunk)]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _slot_vals(layout: HierarchicalEll, arc_vals: torch.Tensor,
               fill: float) -> torch.Tensor:
    """Per-arc values in the level-1 slot grid [C, K] (``fill`` at pads),
    gathered through the slot→arc map."""
    dev = layout.on(arc_vals.device)
    perm = dev.slot_arc
    vals = torch.where(perm >= 0, arc_vals[perm.clamp(min=0)],
                       torch.full((), fill, dtype=arc_vals.dtype,
                                  device=arc_vals.device))
    return vals.reshape(dev.tables[0].shape)


def _fold_sum(layout: HierarchicalEll, grid: torch.Tensor) -> torch.Tensor:
    """Per-vertex sums of a level-1 slot grid [C, K]: the slots of each
    row added in ascending order, then levels 2+ walked (f32 on the
    card: one kernel launch a level)."""
    h = grid[:, 0].clone()
    for k in range(1, grid.shape[1]):
        h += grid[:, k]
    return layout.on(grid.device).walk(h[:, None].contiguous(), 1)[:, 0]


def _fold_max(layout: HierarchicalEll, grid: torch.Tensor) -> torch.Tensor:
    """Per-vertex maxima of a level-1 slot grid, -inf at pads."""
    dev = layout.on(grid.device)
    h = grid.amax(dim=1)
    ninf = torch.full((), -torch.inf, dtype=grid.dtype, device=grid.device)
    for tbl, rows in zip(dev.tables[1:], dev.src_rows[1:]):
        h = torch.where(tbl < rows, h[tbl.clamp(max=rows - 1)],
                        ninf).amax(dim=1)
    return h


def segment_softmax(layout: HierarchicalEll, scores: torch.Tensor,
                    dst_of_arc) -> torch.Tensor:
    """Softmax of per-arc scores over each destination's incoming arcs,
    by gathers and folds only: per-destination max and sum from the slot
    folds, broadcast back to the arcs through ``dst_of_arc``."""
    dst = _index(dst_of_arc, scores.device)
    m = _fold_max(layout, _slot_vals(layout, scores, -np.inf))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # isolated
    e = torch.exp(scores - m[dst])
    z = _fold_sum(layout, _slot_vals(layout, e, 0.0))
    return e / z[dst].clamp(min=1e-30)


def weighted_apply(layout: HierarchicalEll, x: torch.Tensor,
                   arc_weights: torch.Tensor) -> torch.Tensor:
    """out[v] = Σ_{e into v} w_e · x[src_e]: level 1 gathers and scales
    by the slot-aligned weights (0 at pads), slot by slot in ascending
    order; levels 2+ are the layout's sums."""
    dev = layout.on(x.device)
    w = _slot_vals(layout, arc_weights, 0.0)
    tbl = dev.tables[0].clamp(max=max(dev.src_rows[0] - 1, 0))
    h = torch.zeros((tbl.shape[0], x.shape[1]), dtype=x.dtype,
                    device=x.device)
    for k in range(tbl.shape[1]):
        h += x[tbl[:, k]] * w[:, k, None]
    return dev.walk(h, 1)


def attention_aggregate(layout: HierarchicalEll, neighbors, dst_of_arc,
                        x_key: torch.Tensor, x_query: torch.Tensor,
                        x_value: torch.Tensor) -> torch.Tensor:
    """One GAT-style attention hop: SDDMM scores → per-destination
    softmax → weighted aggregation, all three scatter-free."""
    s = sddmm(neighbors, dst_of_arc, x_key, x_query)
    w = segment_softmax(layout, s, dst_of_arc)
    return weighted_apply(layout, x_value, w)
