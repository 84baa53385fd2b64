"""Scatter-free vertex-partitioned aggregation with overlapped halo
exchange — the production distributed layout (counterpart of
gnnpe_tpu/parallel/binned_halo.py).

parallel/halo.py sums a shard's arcs as one CSR; this module composes
the halo exchange with the degree-binned gather layout:

  * vertices are assigned shard-major rows (``own_pad`` uniform rows
    per shard; a vertex's row is its id rank within its shard);
  * one ``all_to_all`` ships exactly the boundary rows each neighbour
    consumes (O(cut·D));
  * per-shard arcs are split into a LOCAL group (source owned here)
    and a HALO group (source arrives in the exchange), each aggregated
    through a rectangular binned-ELL layout (ops/rect.py): degree
    classes + head chunk-fold + dense hub product on kernel A2 — no
    scatter anywhere, forward or backward.  The per-shard sums are not
    symmetric, so each group's backward runs the same kernel over the
    layout of its transposed arcs (``build_transposed``).

Overlap: the rank's step starts the all_to_all FIRST (``async_op``),
then computes the local-group aggregation — which depends only on owned
rows — while the exchange is in flight; only the (small) halo-group
aggregation waits on it.

The host side (``BinnedHaloPlan.build``) is the port's own copy of
gnnpe_tpu's numpy code.  gnnpe_tpu pads the shards' layouts to one shape
and stacks them so that its ``shard_map`` compiles ONE program.  A rank
of the port runs its own program on its own layout, so the plan keeps the
UNPADDED layouts (``local_layouts``/``halo_layouts``) and nothing
stacked: no pad rows to gather, no identity head levels to walk.
``_stack`` and ``_inv_rows`` (over ops/rect.py's ``pad_rect``) stay as
host functions for a caller that wants gnnpe_tpu's stacked tables; the
plan does not call them.  ``own_pad`` and ``halo_pad`` stay uniform,
because the exchange and the final all-gather want equal splits.
Exactness: equals the dense aggregation row for row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.ops.ell import DEFAULT_WIDTHS
from gnnpe_tpu_torch.ops.rect import (RectBinned, build_binned_rect,
                                      build_transposed, pad_rect,
                                      rect_aggregate, rect_pad_spec)
from gnnpe_tpu_torch.ops.spmm import CsrSum
from gnnpe_tpu_torch.parallel.collectives import AllToAll
from gnnpe_tpu_torch.parallel.halo import send_pair


def _stack(layouts: List[RectBinned]):
    """Pad per-shard layouts to a joint spec and stack every table
    into one leading-[n] array; returns (stacked dict, per-shard
    padded rank arrays, spec)."""
    spec = rect_pad_spec(layouts)
    padded, ranks = [], []
    for lay in layouts:
        p, _ = pad_rect(lay, spec)
        padded.append(p)
        ranks.append(p.rank)

    def stk(get, dtype=None):
        return np.stack([np.asarray(get(p), dtype=dtype)
                         for p in padded])

    st = {
        "head_tables": [stk(lambda p, i=i: p.head_tables[i])
                        for i in range(len(spec.head_levels))],
        "head_padcnt": [stk(lambda p, i=i: (
            p.head_padcnt[i] if p.head_padcnt[i] is not None
            else np.zeros(p.head_tables[i].shape[0], np.float32)))
            for i in range(len(spec.head_levels))],
        "class_tables": [stk(lambda p, i=i: p.class_tables[i])
                         for i in range(len(spec.class_rows))],
        "class_padcnt": [stk(lambda p, i=i: (
            p.class_padcnt[i] if p.class_padcnt[i] is not None
            else np.zeros(p.class_tables[i].shape[0], np.float32)))
            for i in range(len(spec.class_rows))],
    }
    if spec.num_hubs:
        st["hub_rows"] = stk(lambda p: p.hub_rows)
        st["hub_counts"] = stk(lambda p: p.hub_counts)
    return st, ranks, spec


def _inv_rows(ranks: List[np.ndarray], spec, own_pad: int) -> np.ndarray:
    """int32[n, own_pad] for ``_stack``'s (ranks, spec): own row r → its
    position in the padded order space; rows past a shard's real vertices
    → the zero-row sentinel (index ``spec.num_out``)."""
    arr = np.full((len(ranks), own_pad), spec.num_out, dtype=np.int32)
    for t, rank in enumerate(ranks):
        arr[t, :len(rank)] = rank
    return arr


class _TakeRows(torch.autograd.Function):
    """``cat([x, 0])[idx]``: row gather in which ``idx == len(x)`` reads
    a zero row.  Every row of ``x`` is read exactly once, so the backward
    is the gather ``g[back_idx]`` (``back_idx[p]``: where row p went)
    and not a scatter."""

    @staticmethod
    def forward(ctx, x, idx, back_idx):
        ctx.back_idx = back_idx
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[idx]

    @staticmethod
    def backward(ctx, g):
        return g[ctx.back_idx], None, None


@dataclass
class BinnedHaloPlan:
    num_shards: int
    own_pad: int
    halo_pad: int
    counts: np.ndarray          # int64[n] real vertices per shard
    shard_of: np.ndarray        # int64[V]
    local_row: np.ndarray       # int64[V] row within owner shard
    send_idx: np.ndarray        # int32[n, n, halo_pad]; -1 = unused slot
    num_local_arcs: int
    num_halo_arcs: int
    num_slots: int
    # Per shard, the two arc groups' CSRs (offsets, srcs; dst = local
    # row), their layouts, and what built them.
    local_csrs: List
    halo_csrs: List
    local_layouts: List[RectBinned]
    halo_layouts: List[RectBinned]
    rect_args: Dict

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, offsets: np.ndarray, neighbors: np.ndarray,
              membership: np.ndarray, num_shards: int,
              widths: Tuple[int, ...] = DEFAULT_WIDTHS,
              hub_matmul: bool = True,
              feature_dim_hint: int = 128,
              hub_prices: Optional[Tuple[float, float, float]] = None,
              device=None) -> "BinnedHaloPlan":
        """The plan for ``num_shards`` shards of ``membership``; hubs are
        priced with ``hub_prices``, else with the prices of ``device``
        (the device the plan will run on), else with the "cpu" row
        (ops/ell.py:hub_prices_for)."""
        n = num_shards
        v = len(offsets) - 1
        offsets = np.asarray(offsets, dtype=np.int64)
        membership = np.asarray(membership, dtype=np.int64)
        counts = np.bincount(membership, minlength=n)
        own_pad = max(1, int(counts.max()))
        starts = np.cumsum(counts) - counts
        order_v = np.lexsort((np.arange(v), membership))
        local_row = np.empty(v, dtype=np.int64)
        local_row[order_v] = np.arange(v) - np.repeat(starts, counts)

        deg = np.diff(offsets)
        dst_old = np.repeat(np.arange(v), deg)
        src_old = np.asarray(neighbors)
        s_dst = membership[dst_old]
        s_src = membership[src_old]
        cross = s_src != s_dst

        # --- send sets + per-arc halo rows, fully vectorized ---------
        key = ((s_src[cross] * n + s_dst[cross]) * v
               + src_old[cross]).astype(np.int64)
        uk = np.unique(key)
        us = uk // (n * v)
        ut = (uk // v) % n
        uu = uk % v
        pair = us * n + ut
        pcnt = np.bincount(pair, minlength=n * n)
        halo_pad = max(1, int(pcnt.max()))
        pstart = (np.cumsum(pcnt) - pcnt)[pair]
        k_within = np.arange(len(uk)) - pstart
        send_idx = np.full((n, n, halo_pad), -1, dtype=np.int32)
        send_idx[us, ut, k_within] = local_row[uu]
        # Halo-buffer row (on the consumer) of every cross arc's src.
        j = np.searchsorted(uk, key)
        halo_row_of_arc = (us[j] * halo_pad + k_within[j])

        # --- per-shard CSRs for the two arc groups -------------------
        def shard_csrs(arc_mask, src_rows):
            """arc_mask selects arcs; src_rows gives their src index in
            the group's source space.  Returns per-shard (offsets,
            srcs) with dst = local row."""
            d_sh = s_dst[arc_mask]
            d_row = local_row[dst_old[arc_mask]]
            sr = src_rows
            o = np.lexsort((d_row, d_sh))
            d_sh, d_row, sr = d_sh[o], d_row[o], sr[o]
            cuts = np.searchsorted(d_sh, np.arange(n + 1))
            out = []
            for t in range(n):
                lo, hi = cuts[t], cuts[t + 1]
                cnt = np.bincount(d_row[lo:hi],
                                  minlength=max(1, int(counts[t])))
                offs_t = np.concatenate([[0], np.cumsum(cnt)])
                out.append((offs_t, sr[lo:hi].astype(np.int32)))
            return out

        local_csrs = shard_csrs(~cross, local_row[src_old[~cross]])
        halo_csrs = shard_csrs(cross, halo_row_of_arc)

        rect_args = dict(widths=widths, hub_matmul=hub_matmul,
                         feature_dim_hint=feature_dim_hint,
                         hub_prices=hub_prices, device=device)
        locals_ = [build_binned_rect(o, s, own_pad, **rect_args)
                   for o, s in local_csrs]
        halos = [build_binned_rect(o, s, n * halo_pad, **rect_args)
                 for o, s in halo_csrs]

        return cls(
            num_shards=n, own_pad=own_pad, halo_pad=halo_pad,
            counts=counts, shard_of=membership, local_row=local_row,
            send_idx=send_idx,
            num_local_arcs=int((~cross).sum()),
            num_halo_arcs=int(cross.sum()),
            num_slots=sum(l.num_slots for l in locals_ + halos),
            local_csrs=local_csrs, halo_csrs=halo_csrs,
            local_layouts=locals_, halo_layouts=halos, rect_args=rect_args)

    # ------------------------------------------------------------------
    def shard_features(self, x: np.ndarray) -> np.ndarray:
        """Host: [V, D] → [n, own_pad, D] (row = per-shard id rank)."""
        n, d = self.num_shards, x.shape[1]
        out = np.zeros((n, self.own_pad, d), dtype=x.dtype)
        out[self.shard_of, self.local_row] = x
        return out

    def unshard_features(self, shards: np.ndarray) -> np.ndarray:
        return np.asarray(shards)[self.shard_of, self.local_row]

    def row_of_vertex(self) -> np.ndarray:
        """int32[V]: flat row in the all-gathered [n*own_pad, D]."""
        return (self.shard_of * self.own_pad
                + self.local_row).astype(np.int32)

    def own_vertex_ids(self) -> np.ndarray:
        """int32[n, own_pad]: original vertex id at each owned row
        (pad rows → 0; their values are never read downstream)."""
        out = np.zeros((self.num_shards, self.own_pad), np.int32)
        out[self.shard_of, self.local_row] = np.arange(
            len(self.shard_of), dtype=np.int32)
        return out

    # ------------------------------------------------------------------
    def _group(self, rank: int, csrs, layouts, num_src: int, device):
        """One arc group of shard ``rank`` on ``device``: the
        differentiable order-space sum and the gather back to own rows
        (rows past the shard's real vertices read the zero row), and the
        A2 launches of its forward and of its backward."""
        fwd = layouts[rank]
        bwd = build_transposed(fwd, *csrs[rank], num_src, **self.rect_args)
        fwd_d, bwd_d = fwd.on(device), bwd.on(device)
        agg = rect_aggregate(fwd_d, bwd_d)
        v_t = int(self.counts[rank])
        inv = np.full(self.own_pad, fwd.num_dst, np.int64)
        inv[:v_t] = fwd.rank[:v_t]
        inv = torch.from_numpy(inv).to(device)
        order = torch.from_numpy(np.asarray(fwd.order, np.int64)).to(device)
        return (lambda x: _TakeRows.apply(agg(x), inv, order),
                (fwd_d.launches_per_apply, bwd_d.launches_per_apply))

    def make_device_fn(self, group, rank: int, device):
        """This rank's aggregation: x_own [own_pad, D] f32 → [own_pad,
        D], a collective call over ``group`` (the mesh axis's process
        group; ``rank`` is the rank's place along it).  Differentiable,
        and nothing in it or in its backward scatters.  ``agg.launches``
        says what one call launches on a CUDA tensor: ((A1, A2) of the
        forward, (A1, A2) of the backward)."""
        n, hpad = self.num_shards, self.halo_pad
        send = send_pair(self.send_idx[rank], self.own_pad, device)
        local, local_a2 = self._group(rank, self.local_csrs,
                                      self.local_layouts, self.own_pad,
                                      device)
        halo, halo_a2 = self._group(rank, self.halo_csrs, self.halo_layouts,
                                    n * hpad, device)

        def agg(x_own: torch.Tensor) -> torch.Tensor:
            # 1) start the exchange FIRST.  Unused slots ship exact
            # zeros, so the pad corrections downstream cancel exactly.
            send_rows = CsrSum.apply(x_own, send)           # [n·H, D]
            handle = AllToAll.start(send_rows, group)
            # 2) the local group needs owned rows only: it runs while
            # the exchange is in flight.
            local_out = local(x_own)
            # 3) the halo group waits on the exchange.
            halo_buf = AllToAll.finish(send_rows, handle, group)
            return local_out + halo(halo_buf)

        # A1: the send gather; A2: the two groups' launch plans.
        agg.launches = tuple((1, l + h) for l, h in zip(local_a2, halo_a2))
        return agg

    def make_aggregate(self, mesh, device, axis: str = "graph"):
        """The rank's step for ``mesh``'s ``axis``: its [own_pad, D]
        block of ``shard_features`` → the same block aggregated."""
        from gnnpe_tpu_torch.parallel.mesh import axis_group, axis_rank
        return self.make_device_fn(axis_group(mesh, axis),
                                   axis_rank(mesh, axis), device)
