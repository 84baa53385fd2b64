"""Rectangular binned-ELL gather-sum: out[dst] = Σ_{arcs} x[src]
(counterpart of gnnpe_tpu/ops/rect.py).

The square layout (ops/ell.py ``BinnedEll``) assumes input rows == output
rows and fuses its vertex permutation across layers.  The sharded halo
path needs the rectangular generalization: each rank aggregates arcs
whose sources live in another buffer (its own rows, or the halo rows it
received) into its own output rows.  This module builds that layout with
the same scatter-free recipe (degree classes, head chunk-fold, mask-free
pads, optional dense hub product) plus an explicit zero-degree tail:
most rows of a halo-arc group have no arcs, and they cost nothing
instead of padding the smallest class.

The host side (``build_binned_rect``, ``rect_pad_spec``, ``pad_rect``) is
the port's own copy of gnnpe_tpu's numpy code.  Output rows live in the
layout's own class order; ``order``/``rank`` map caller dst ids to
order-space positions.

``RectBinnedDevice`` uploads one layout and gives it kernel A2's
``LaunchPlan`` (ops/ell.py) with a source of ``num_src_rows`` rows: one
launch per dependency level on a CUDA tensor, the same plan walked over
``gather_sum_plain`` on a CPU tensor.  The sums are not symmetric, so the
backward is not the layout itself: ``build_rect_pair`` also builds the
layout of the transposed arcs on the host, and ``rect_aggregate`` runs
the same kernel over it for the cotangent.  Nothing scatters, forward or
backward.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.ops.ell import (DEFAULT_WIDTHS, _HUB_PRECISIONS,
                                     LaunchPlan, _padcnt, _select_hubs,
                                     gather_sum_plain, hub_costs,
                                     hub_prices_for, hub_product,
                                     upload_table)
from gnnpe_tpu_torch.utils.device import as_device

_FOLD_W = 8     # head chunk-fold width (matches BinnedEll)


@dataclass
class RectBinned:
    """Host-built layout (numpy tables); ``on(device)`` uploads it.  The
    device's ``apply(x_src)`` returns ``[num_out, D]`` in order space
    (``out[p]`` is caller dst ``order[p]``) and ``unrank`` gathers that
    back to caller dst order."""
    num_out: int                 # total order-space rows (incl. pads)
    num_dst: int                 # caller dst rows (== len(order))
    order: np.ndarray            # int64[num_dst] order position → dst id
    rank: np.ndarray             # int64[num_dst] dst id → order position
    num_head: int                # head rows (order positions [0, num_head))
    head_tables: List[np.ndarray]    # level 0: src ids; folds: prev rows
    head_padcnt: List[Optional[np.ndarray]]
    class_tables: List[np.ndarray]   # src ids, rows contiguous in order
    class_padcnt: List[Optional[np.ndarray]]
    num_zero: int                # trailing all-zero rows
    num_slots: int
    num_arcs: int
    num_hub_arcs: int = 0
    hub_rows: Optional[np.ndarray] = None    # int32[H] src ids
    hub_counts: Optional[np.ndarray] = None  # int8/16[num_out, H]
    hub_precision: str = "hi_lo"
    num_src_rows: Optional[int] = None   # rows of the source buffer

    def on(self, device) -> "RectBinnedDevice":
        """This layout uploaded to ``device``, with its launch plan."""
        return RectBinnedDevice.from_host(self, device)


@dataclass
class RectBinnedDevice:
    """A ``RectBinned`` on one device with its launch plan.  ``apply``
    launches kernel A2 once per level on a CUDA tensor and walks the plan
    over ``gather_sum_plain`` on a CPU tensor; the hub product is
    ``ops.ell.hub_product``, shared with the square layout."""
    num_out: int
    num_dst: int
    num_src_rows: int
    rank: torch.Tensor               # int64 [num_dst]
    order: torch.Tensor              # int64 [num_dst] (natural layouts)
    hub_rows: Optional[torch.Tensor]     # int64 [H]
    hub_counts: Optional[torch.Tensor]   # f32 [num_out, H]
    hub_precision: str
    plan: LaunchPlan

    @classmethod
    def from_host(cls, layout: RectBinned, device) -> "RectBinnedDevice":
        device = as_device(device)
        n_src = layout.num_src_rows
        if n_src is None:
            raise ValueError("the layout does not say how many rows its "
                             "source buffer has (num_src_rows)")
        head, rows = [], n_src
        for tbl, pc in zip(layout.head_tables, layout.head_padcnt):
            head.append(upload_table(tbl, pc, rows, device))
            rows = tbl.shape[0]
        classes = [upload_table(t, pc, n_src, device)
                   for t, pc in zip(layout.class_tables,
                                    layout.class_padcnt)]
        covered = (layout.num_head + sum(t.shape[0] for t, _ in classes)
                   + layout.num_zero)
        if covered != layout.num_out:
            raise ValueError(f"the tables and the zero tail cover {covered} "
                             f"rows of {layout.num_out}")
        hub_rows = hub_counts = None
        if layout.hub_rows is not None and len(layout.hub_rows):
            hub_rows = torch.from_numpy(
                layout.hub_rows.astype(np.int64)).to(device)
            hub_counts = torch.from_numpy(
                layout.hub_counts.astype(np.float32)).to(device)
        as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
        return cls(num_out=layout.num_out, num_dst=layout.num_dst,
                   num_src_rows=n_src, rank=as_t(layout.rank),
                   order=as_t(layout.order), hub_rows=hub_rows,
                   hub_counts=hub_counts,
                   hub_precision=layout.hub_precision,
                   plan=LaunchPlan.build(head, classes, layout.num_head,
                                         layout.num_out, layout.num_zero))

    @property
    def launches_per_apply(self) -> int:
        return self.plan.launches_per_apply

    def apply(self, x_src: torch.Tensor, gather=None) -> torch.Tensor:
        """[num_out, D] in order space from f32 ``x_src`` [num_src_rows,
        D].  ``gather``, when given, is a per-table gather-sum the plan
        is walked over instead, on any device (the kernel check passes
        ``gather_sum_plain``)."""
        if (x_src.dim() != 2 or x_src.shape[0] != self.num_src_rows
                or x_src.dtype != torch.float32):
            raise ValueError(f"x_src must be float32 [{self.num_src_rows}, "
                             f"D], got {x_src.dtype} {tuple(x_src.shape)}")
        if x_src.device != self.rank.device:
            raise ValueError(f"x_src is on {x_src.device}, the layout on "
                             f"{self.rank.device}")
        x_src = x_src.contiguous()
        if gather is not None:
            out = self.plan.walk(x_src, gather)
        elif x_src.device.type == "cpu":
            out = self.plan.walk(x_src, gather_sum_plain)
        elif x_src.device.type == "cuda":
            out = self.plan.launch(x_src)
        else:
            raise ValueError(f"no gather_sum kernel for device "
                             f"{x_src.device}")
        if self.hub_rows is not None:
            out = out + hub_product(self.hub_counts, x_src[self.hub_rows],
                                    self.hub_precision)
        return out

    def unrank(self, out_order: torch.Tensor) -> torch.Tensor:
        return out_order[self.rank]


def transpose_arcs(dst_offsets: np.ndarray, src_ids: np.ndarray,
                   num_src_rows: int, dst_rows: Optional[np.ndarray] = None):
    """The src-major CSR of a dst-major arc list: (offsets
    int64[num_src_rows + 1], ids) where row s lists the dst of every arc
    out of s, ascending; ``dst_rows`` renames the dst ids (the forward
    layout's ``rank``, so that the transposed sum reads the cotangent in
    order space)."""
    offsets = np.asarray(dst_offsets, dtype=np.int64)
    src_ids = np.asarray(src_ids, dtype=np.int64)
    dst = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    if dst_rows is not None:
        dst = np.asarray(dst_rows, dtype=np.int64)[dst]
    o = np.lexsort((dst, src_ids))
    t_off = np.concatenate(
        [[0], np.cumsum(np.bincount(src_ids, minlength=num_src_rows))])
    return t_off.astype(np.int64), dst[o].astype(np.int32)


def build_transposed(fwd: RectBinned, dst_offsets: np.ndarray,
                     src_ids: np.ndarray, num_src_rows: int,
                     **kw) -> RectBinned:
    """The layout of the transposed arcs of ``fwd`` (built from the same
    arc list): for every source row it sums the order-space rows of the
    forward output that read it, so applied to the cotangent and
    unranked it is the forward's pullback."""
    t_off, t_ids = transpose_arcs(dst_offsets, src_ids, num_src_rows,
                                  dst_rows=fwd.rank)
    return build_binned_rect(t_off, t_ids, fwd.num_out, **kw)


def build_rect_pair(dst_offsets: np.ndarray, src_ids: np.ndarray,
                    num_src_rows: int, **kw) -> Tuple[RectBinned, RectBinned]:
    """(forward, transposed) layouts of one arc list."""
    fwd = build_binned_rect(dst_offsets, src_ids, num_src_rows, **kw)
    return fwd, build_transposed(fwd, dst_offsets, src_ids, num_src_rows,
                                 **kw)


class _RectAggregate(torch.autograd.Function):
    """``fwd.apply`` whose backward is the transposed layout's apply,
    unranked to the source rows: the same kernel, no scatter."""

    @staticmethod
    def forward(ctx, x_src, fwd, bwd):
        ctx.bwd = bwd
        return fwd.apply(x_src)

    @staticmethod
    def backward(ctx, g):
        bwd = ctx.bwd
        return bwd.unrank(bwd.apply(g.contiguous())), None, None


def rect_aggregate(fwd: RectBinnedDevice, bwd: RectBinnedDevice):
    """x_src ↦ ``fwd.apply(x_src)`` (order space), differentiable
    through ``bwd``, the transposed layout of ``build_rect_pair``."""
    return lambda x_src: _RectAggregate.apply(x_src, fwd, bwd)


def build_binned_rect(dst_offsets: np.ndarray, src_ids: np.ndarray,
                      num_src_rows: int,
                      widths: Tuple[int, ...] = DEFAULT_WIDTHS,
                      hub_matmul: bool = True,
                      feature_dim_hint: int = 128,
                      max_hubs: int = 2048,
                      hub_precision: str = "hi_lo",
                      hub_mem_budget: int = 256 << 20,
                      hub_prices: Optional[Tuple[float, float, float]] = None,
                      device=None) -> RectBinned:
    """Build the rectangular layout from a dst-major CSR arc list
    (host, O(arcs)).  ``dst_offsets``: int[num_dst+1]; ``src_ids``:
    indices into the caller's source buffer ``[0, num_src_rows)``.
    ``hub_prices`` and ``device``: what a hub column is priced with, as
    in ``build_binned_ell``."""
    if tuple(sorted(set(widths))) != tuple(widths):
        raise ValueError(f"widths must be strictly increasing: {widths}")
    if hub_precision not in _HUB_PRECISIONS:
        raise ValueError(f"hub_precision {hub_precision!r}")
    offsets = np.asarray(dst_offsets, dtype=np.int64)
    src_ids = np.asarray(src_ids)
    num_dst = len(offsets) - 1
    num_arcs = len(src_ids)
    deg = np.diff(offsets)

    hub_rows = hub_counts = None
    num_hub_arcs = 0
    hubs = np.zeros(0, np.int64)
    if hub_matmul and num_dst and num_arcs:
        costs = hub_costs(device, hub_precision)
        hubs = _select_hubs(num_src_rows, src_ids, feature_dim_hint,
                            max_hubs, hub_mem_budget,
                            hub_prices_for(hub_prices, device), costs)
        # B columns cost scales with num_dst rows, not src rows.
        hubs = hubs[:max(0, hub_mem_budget
                         // max(1, costs[0] * num_dst))] \
            if len(hubs) else hubs
    if len(hubs):
        nh = len(hubs)
        hub_id = np.full(num_src_rows, -1, dtype=np.int64)
        hub_id[hubs] = np.arange(nh)
        arc_dst = np.repeat(np.arange(num_dst), deg)
        j = hub_id[src_ids]
        is_hub = j >= 0
        num_hub_arcs = int(is_hub.sum())
        key = arc_dst[is_hub] * nh + j[is_hub]
        uk, cnt = np.unique(key, return_counts=True)
        cmax = int(cnt.max(initial=0))
        assert cmax <= 32767, f"hub multiplicity {cmax} overflows int16"
        if cmax > 256 and hub_precision != "f32":
            hub_precision = "f32"
        B = np.zeros((num_dst, nh),
                     dtype=np.int8 if cmax <= 127 else np.int16)
        B[uk // nh, uk % nh] = cnt
        hub_counts = B
        hub_rows = hubs.astype(np.int32)
        keep = ~is_hub
        src_ids = src_ids[keep]
        deg = np.bincount(arc_dst[keep], minlength=num_dst)
        offsets = np.concatenate([[0], np.cumsum(deg)])

    wmax = widths[-1]
    order = np.argsort(-deg, kind="stable")
    rank = np.empty(num_dst, dtype=np.int64)
    rank[order] = np.arange(num_dst)
    deg_s = deg[order]
    if hub_counts is not None:
        hub_counts = hub_counts[order]      # B rows live in order space
    num_head = int((deg_s > wmax).sum())
    num_zero = int((deg_s == 0).sum())
    slots = 0

    head_tables: List[np.ndarray] = []
    head_padcnt: List[Optional[np.ndarray]] = []
    if num_head:
        h_deg = deg_s[:num_head]
        chunks_per = -(-h_deg // wmax)
        n_chunks = int(chunks_per.sum())
        tbl0 = np.full((n_chunks, wmax), -1, dtype=np.int32)
        c_start = np.cumsum(chunks_per) - chunks_per
        arc_v = np.repeat(np.arange(num_head), h_deg)
        starts = offsets[order[:num_head]]
        arc_pos = (np.arange(int(h_deg.sum()))
                   - np.repeat(np.cumsum(h_deg) - h_deg, h_deg))
        flat = src_ids[np.repeat(starts, h_deg) + arc_pos]
        tbl0[c_start[arc_v] + arc_pos // wmax, arc_pos % wmax] = flat
        pad0 = tbl0 < 0
        head_tables.append(np.where(pad0, 0, tbl0))
        head_padcnt.append(_padcnt(tbl0, pad0))
        slots += tbl0.size
        counts, start = chunks_per, c_start
        while True:
            kmax = int(counts.max())
            if kmax <= _FOLD_W:
                tbl = np.full((num_head, kmax), -1, dtype=np.int32)
                iv = np.repeat(np.arange(num_head), counts)
                pos = (np.arange(int(counts.sum()))
                       - np.repeat(start, counts))
                tbl[iv, pos] = np.arange(int(counts.sum()))
                pad = tbl < 0
                head_tables.append(np.where(pad, 0, tbl))
                head_padcnt.append(_padcnt(tbl, pad))
                slots += tbl.size
                break
            sub = -(-counts // _FOLD_W)
            s_start = np.cumsum(sub) - sub
            tbl = np.full((int(sub.sum()), _FOLD_W), -1, dtype=np.int32)
            iv = np.repeat(np.arange(num_head), counts)
            pos = np.arange(int(counts.sum())) - np.repeat(start, counts)
            tbl[s_start[iv] + pos // _FOLD_W,
                pos % _FOLD_W] = np.arange(int(counts.sum()))
            pad = tbl < 0
            head_tables.append(np.where(pad, 0, tbl))
            head_padcnt.append(_padcnt(tbl, pad))
            slots += tbl.size
            counts, start = sub, s_start

    class_tables: List[np.ndarray] = []
    class_padcnt: List[Optional[np.ndarray]] = []
    lo = num_head
    lowers = [0] + list(widths[:-1])
    for w, w_lo in zip(widths[::-1], lowers[::-1]):
        hi = lo + int(((deg_s[lo:] <= w) & (deg_s[lo:] > w_lo)).sum())
        n = hi - lo
        tbl = np.full((n, w), -1, dtype=np.int32)
        if n:
            d = deg_s[lo:hi]
            iv = np.repeat(np.arange(n), d)
            pos = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
            starts = offsets[order[lo:hi]]
            tbl[iv, pos] = src_ids[np.repeat(starts, d) + pos]
        pad = tbl < 0
        class_tables.append(np.where(pad, 0, tbl))
        class_padcnt.append(_padcnt(tbl, pad))
        slots += tbl.size
        lo = hi
    assert lo + num_zero == num_dst, (lo, num_zero, num_dst)

    return RectBinned(num_out=num_dst, num_dst=num_dst, order=order,
                      rank=rank, num_head=num_head,
                      head_tables=head_tables, head_padcnt=head_padcnt,
                      class_tables=class_tables,
                      class_padcnt=class_padcnt, num_zero=num_zero,
                      num_slots=int(slots), num_arcs=num_arcs,
                      num_hub_arcs=num_hub_arcs, hub_rows=hub_rows,
                      hub_counts=hub_counts,
                      hub_precision=hub_precision,
                      num_src_rows=num_src_rows)


# ---------------------------------------------------------------------
# SPMD padding: align a group of per-shard layouts to one shape
# (gnnpe_tpu stacks them under one compiled program; a rank of the port
# holds its own layout unpadded, and these stay for callers that stack).

@dataclass(frozen=True)
class RectPadSpec:
    head_levels: Tuple[Tuple[int, int], ...]   # (rows, width) per level
    num_head: int
    class_rows: Tuple[int, ...]
    num_zero: int
    num_hubs: int
    hub_dtype: object
    hub_precision: str

    @property
    def num_out(self) -> int:
        return self.num_head + sum(self.class_rows) + self.num_zero


def rect_pad_spec(layouts: Sequence[RectBinned]) -> RectPadSpec:
    """Joint padding spec: level counts aligned (identity levels appended
    to shallower heads), then per-level/per-class row maxima."""
    max_levels = max((len(l.head_tables) for l in layouts), default=0)
    num_head = max(l.num_head for l in layouts)
    heads = []
    for i in range(max_levels):
        rows = 0
        width = 1
        for l in layouts:
            lv = l.head_tables
            # Aligned view: shallower heads get identity levels at the
            # END, so level i of a depth-k head maps to i if i < k-1,
            # the last real level if i == k-1... identity after.
            if i < len(lv):
                rows = max(rows, lv[i].shape[0])
                width = max(width, lv[i].shape[1])
            else:
                rows = max(rows, l.num_head)
        heads.append((max(rows, num_head if i == max_levels - 1 else rows),
                      width))
    class_rows = tuple(
        max(l.class_tables[c].shape[0] for l in layouts)
        for c in range(len(layouts[0].class_tables)))
    num_zero = max(l.num_zero for l in layouts)
    num_hubs = max((0 if l.hub_rows is None else len(l.hub_rows))
                   for l in layouts)
    hub_dtype = np.int8
    precision = "hi_lo"
    for l in layouts:
        if l.hub_counts is not None and l.hub_counts.dtype == np.int16:
            hub_dtype = np.int16
        if l.hub_precision == "f32":
            precision = "f32"
    return RectPadSpec(head_levels=tuple(heads), num_head=num_head,
                       class_rows=class_rows, num_zero=num_zero,
                       num_hubs=num_hubs, hub_dtype=hub_dtype,
                       hub_precision=precision)


def pad_rect(layout: RectBinned, spec: RectPadSpec
             ) -> Tuple[RectBinned, np.ndarray]:
    """Pad ``layout`` to ``spec``; returns (padded, pos_map) where
    ``pos_map[p]`` is the padded position of natural order position p.
    Pad rows evaluate to exactly zero."""
    def pad_tbl(tbl, pc, rows, width):
        r, w = tbl.shape
        out = np.zeros((rows, width), tbl.dtype)
        out[:r, :w] = tbl
        cnt = np.zeros(rows, np.float32)
        if pc is not None:
            cnt[:r] = pc
        cnt[:r] += width - w          # widened slots are pads
        cnt[r:] = width               # full-pad rows
        return out, (cnt if cnt.any() else None)

    heads, head_pc = [], []
    if spec.head_levels:
        lv = list(zip(layout.head_tables, layout.head_padcnt))
        if not lv:      # no head in this shard: all-pad level 0
            lv = [(np.zeros((0, spec.head_levels[0][1]), np.int32),
                   None)]
        # Append identity levels to align depth.
        while len(lv) < len(spec.head_levels):
            h = lv[-1][0].shape[0] if len(lv) > 1 else layout.num_head
            h = max(h, layout.num_head)
            ident = np.arange(h, dtype=np.int32)[:, None]
            lv.append((ident, None))
        for (tbl, pc), (rows, width) in zip(lv, spec.head_levels):
            t, c = pad_tbl(tbl, pc, rows, width)
            heads.append(t)
            head_pc.append(c)

    classes, class_pc = [], []
    for (tbl, pc), rows in zip(
            zip(layout.class_tables, layout.class_padcnt),
            spec.class_rows):
        t, c = pad_tbl(tbl, pc, rows, tbl.shape[1])
        classes.append(t)
        class_pc.append(c)

    # Natural→padded position map.
    pos_map = np.empty(layout.num_dst, dtype=np.int64)
    off_nat = 0
    off_pad = 0
    segs_nat = [layout.num_head] + [t.shape[0]
                                    for t in layout.class_tables] \
        + [layout.num_zero]
    segs_pad = [spec.num_head] + list(spec.class_rows) + [spec.num_zero]
    for n_nat, n_pad in zip(segs_nat, segs_pad):
        pos_map[off_nat:off_nat + n_nat] = off_pad + np.arange(n_nat)
        off_nat += n_nat
        off_pad += n_pad
    assert off_nat == layout.num_dst

    hub_rows = hub_counts = None
    if spec.num_hubs:
        hub_rows = np.zeros(spec.num_hubs, np.int32)
        hub_counts = np.zeros((spec.num_out, spec.num_hubs),
                              spec.hub_dtype)
        if layout.hub_rows is not None and len(layout.hub_rows):
            h = len(layout.hub_rows)
            hub_rows[:h] = layout.hub_rows
            hub_counts[pos_map, :h] = layout.hub_counts

    new_rank = pos_map[layout.rank]            # dst id → padded pos
    new_order = np.full(spec.num_out, -1, dtype=np.int64)
    new_order[new_rank] = np.arange(layout.num_dst)
    return replace(
        layout, num_out=spec.num_out, num_head=spec.num_head,
        order=new_order, rank=new_rank,
        head_tables=heads, head_padcnt=head_pc, class_tables=classes,
        class_padcnt=class_pc, num_zero=spec.num_zero,
        hub_rows=hub_rows, hub_counts=hub_counts,
        hub_precision=spec.hub_precision), pos_map
