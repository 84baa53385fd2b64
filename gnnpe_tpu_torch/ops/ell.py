"""ELL aggregation: scatter-free neighbour sums, forward and backward
(counterpart of gnnpe_tpu/ops/ell.py).

The uniform-width layout (``build_ell``, ``HierarchicalEll``) chunks
each vertex's adjacency into rows of K neighbours and folds the chunk
rows back per vertex through one or more further tables; pads are -1.
``HierarchicalEll.on(device)`` uploads it once.  On a CUDA tensor each
level is one launch of the gather-sum kernel below: the level's input
gets one zero row past its end and every pad points there, which adds
exactly the 0.0 that the masked plain form adds for a pad; the levels
share one work buffer and their launches are laid out once
(``WalkPlan``).  A rectangular layout (``num_sources``) gathers from
another row count than it writes: ops/gather.py's transposed index.  On a CPU
tensor each level is that masked plain form.

The host layout (``build_binned_ell``, the ``BinnedEll`` tables) is the
port's own copy of gnnpe_tpu's numpy builder.  ``BinnedEllDevice``
uploads it once, lays out a launch plan — one launch per dependency
level: every width class and the first head level read ``h_perm``, each
further head level reads the level before it — and aggregates in the
permuted vertex space.  On a CUDA tensor each level is one launch of the
hand-written kernel (csrc/ell_gather_sum.cu); on a CPU tensor the same
plan is walked table by table over ``gather_sum_plain``; any other
device raises.  Both add a row's slots in ascending order from 0.0 and
subtract the pad correction as a separate multiply and subtract, so on
the card they are bit-equal.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.kernels._build import pack_shape
from gnnpe_tpu_torch.utils.device import as_device
from gnnpe_tpu_torch.utils.device_probe import CPU_ROW, device_constants

__all__ = ["BinnedEll", "BinnedEllDevice", "DEFAULT_WIDTHS", "EllLayout",
           "HUB_PRICES", "HierarchicalEll", "HierarchicalEllDevice",
           "LAUNCHES", "LaunchPlan", "binned_aggregate", "build_binned_ell",
           "build_ell", "ell_neighbor_sum", "gather_sum", "gather_sum_plain",
           "hub_costs", "hub_product", "symmetric_aggregate",
           "upload_table"]

LAUNCHES = 0

# Width classes of the layout (gnnpe_tpu's default).
DEFAULT_WIDTHS = (4, 8, 16, 32, 64)

_HUB_PRECISIONS = ("hi_lo", "bf16", "f32")

# What a hub column is priced with: (memory bytes/s, matmul flop/s,
# gather seconds/row).  A layout built for a named device takes that
# device's prices (``_device_constants``: measured in the run on a CUDA
# device); one built with neither prices nor a device takes gnnpe_tpu's
# "cpu" row, so a host build is the same on every machine.
HUB_PRICES = CPU_ROW
# What the hub product costs where it runs.  On a CUDA device
# ``BinnedEllDevice`` keeps B as f32 (4 bytes a count), and having any hub
# at all costs these passes over the [V, D] f32 output: each product's
# result written (1 or 2), hi and lo added (read 2, write 1), and the hub
# part added to the gathers' sum (read 2, write 1).  Anywhere else
# gnnpe_tpu's model is kept (a count at 1 byte, no fixed cost), so host
# and CPU layouts are gnnpe_tpu's.
CUDA_HUB_ENTRY_BYTES = 4
CUDA_HUB_OUTPUT_PASSES = {"hi_lo": 8, "bf16": 4, "f32": 4}

# csrc/ell_gather_sum.cu: kMaxTables descriptors per launch, kThreads
# threads per block (``_level_fn`` checks both against the built library).
MAX_TABLES = 16
THREADS = 256
# With fewer lanes per row than this, a launch's work units are dealt
# round-robin over its blocks (csrc/ell_gather_sum.cu): measured faster
# with one lane per row and slower from two on (kernels/compare_gather.py).
DEAL_BELOW_LANES = 2


@dataclass
class BinnedEll:
    """Permutation-fused binned layout (+ optional dense hub product), on
    the host: numpy tables, built by ``build_binned_ell``.

    Vertices are relabelled by descending degree (``perm``/``rank``) and
    split into width classes, each one gather table whose rows are a
    contiguous range of the output.  Vertices wider than the widest
    class (the head) are chunked into rows of that width and folded
    back through one or more small second-level tables.

    Mask-free padding: pad slots in every gather table point at row 0,
    and the spurious contribution is removed with a rank-1 correction
    ``out[i] -= padcnt[i] * buf[0]``.

    Hub path: the highest-occurrence *sources* are pulled out of the
    gather tables and their contribution is computed as ``B @ x[hubs]``
    where ``B[i, j]`` counts hub j in N(perm[i]) (int8/int16).  Removing
    hubs also shrinks residual degrees, cutting padding.  Precision per
    mode: ``hi_lo`` (default) is a bf16 hi/lo split, two products with
    f32 accumulation (~1e-3 relative at worst under cancellation: fine
    for training and for candidate filtering, not bit-exact); ``f32`` is
    one f32 product (auto-selected when any multiplicity exceeds 256,
    where bf16 counts would round); ``bf16`` is a single bf16 product.
    """
    perm: np.ndarray            # int64[V]: new row i holds vertex perm[i]
    rank: np.ndarray            # int64[V]: inverse (rank[v] = row of v)
    class_tables: List[np.ndarray]  # int32[n_c, w_c], rows contiguous
    class_padcnt: List[np.ndarray]  # f32[n_c] or None (no padding)
    head_tables: List[np.ndarray]   # chunk fold levels for the head
    head_padcnt: List[np.ndarray]   # f32[rows] or None, per fold level
    num_head: int               # head vertices (first rows of output)
    num_vertices: int
    num_slots: int              # gather slots over RESIDUAL (non-hub) arcs
    num_hub_arcs: int = 0       # arcs routed through the hub product
    hub_rows: np.ndarray = None     # int32[H]: permuted rows of hubs
    hub_counts: np.ndarray = None   # int8/int16[V, H] multiplicity B
    hub_precision: str = "hi_lo"    # see class docstring


def _device_constants(device) -> Tuple[float, float, float]:
    """The hub prices of ``device`` (utils/device_probe.py): the "cpu"
    row on the CPU, measured once per process on a CUDA device."""
    return device_constants(device)


def hub_prices_for(hub_prices, device) -> Tuple[float, float, float]:
    """``hub_prices`` where given, else ``device``'s prices, else the
    "cpu" row."""
    if hub_prices is not None:
        return tuple(hub_prices)
    return HUB_PRICES if device is None else _device_constants(device)


def hub_costs(device, precision: str) -> Tuple[int, int]:
    """(bytes a hub count costs, passes the hub product makes over the
    f32 output) on ``device``: ``CUDA_HUB_ENTRY_BYTES`` and
    ``CUDA_HUB_OUTPUT_PASSES`` on a CUDA device, gnnpe_tpu's (1, 0)
    elsewhere."""
    if device is not None and torch.device(device).type == "cuda":
        return CUDA_HUB_ENTRY_BYTES, CUDA_HUB_OUTPUT_PASSES[precision]
    return 1, 0


def _select_hubs(num_v: int, neighbors: np.ndarray, feature_dim: int,
                 max_hubs: int, hub_mem_budget: int, hub_prices,
                 costs: Tuple[int, int] = (1, 0)):
    """Pick hub sources worth routing through the dense product.

    Include vertex i (by occurrence count in ``neighbors``) while the
    gather time its arcs would cost (per-row cost from the prices)
    exceeds the marginal cost of one more B column: V counts of
    ``costs[0]`` bytes each read from memory plus two [V,1]x[1,D] matmul
    slivers (the hi/lo products) at the prices' matmul rate.  The hub
    count is additionally capped so the dense B matrix fits
    ``hub_mem_budget`` bytes at ``costs[0]`` a count.  The hubs are then
    kept only if the gathers they save outweigh their columns and the
    ``costs[1]`` passes over the f32 [V, D] output that any hub costs."""
    bw, flops, gather_row_s = hub_prices
    entry_bytes, output_passes = costs
    occ = np.bincount(neighbors, minlength=num_v).astype(np.int64)
    col_cost_s = entry_bytes * num_v / bw + 4.0 * num_v * feature_dim / flops
    thresh = max(4.0, col_cost_s / gather_row_s)
    order = np.argsort(-occ, kind="stable")
    n = int((occ[order] > thresh).sum())
    n = min(n, max_hubs, num_v,
            max(0, hub_mem_budget // max(1, entry_bytes * num_v)))
    if n and output_passes:
        saved_s = gather_row_s * occ[order[:n]].sum() - n * col_cost_s
        if saved_s <= output_passes * 4.0 * num_v * feature_dim / bw:
            n = 0
    return order[:n]


def _padcnt(tbl_filled: np.ndarray, pad_mask: np.ndarray):
    """f32 pad-slot count per row, or None when the table is full."""
    cnt = pad_mask.sum(1)
    return cnt.astype(np.float32) if cnt.any() else None


def build_binned_ell(offsets: np.ndarray, neighbors: np.ndarray,
                     widths: Tuple[int, ...] = DEFAULT_WIDTHS,
                     hub_matmul: bool = True,
                     feature_dim_hint: int = 128,
                     max_hubs: int = 2048,
                     hub_precision: str = "hi_lo",
                     hub_mem_budget: int = 256 << 20,
                     hub_prices: Optional[Tuple[float, float, float]] = None,
                     device=None) -> BinnedEll:
    """Build the degree-binned relabeled layout (host, O(E log V)).

    With ``hub_matmul`` the top-occurrence sources are lifted out of
    the gather tables into a dense count matrix contracted as a matrix
    product (see BinnedEll docstring), priced by ``hub_prices`` =
    (memory bytes/s, matmul flop/s, gather seconds/row), else by
    ``device``'s prices; the ELL tables are then built over the
    residual adjacency.  ``feature_dim_hint`` only tunes the hub-count
    economics; any D works at apply time.  ``hub_mem_budget`` caps the
    dense B matrix (bytes at ``hub_costs(device, ...)[0]`` a count) so
    power-law graphs at V≈1e6+ cannot OOM the build.  When any hub multiplicity exceeds 256, a caller-
    supplied bf16 ``hub_precision`` is auto-upgraded to "f32" (bf16
    integer rounding starts at 257); pass hub_matmul=False to opt out.
    """
    if tuple(sorted(set(widths))) != tuple(widths):
        raise ValueError(f"widths must be strictly increasing: {widths}")
    if hub_precision not in _HUB_PRECISIONS:
        raise ValueError(f"hub_precision {hub_precision!r} not in "
                         f"{_HUB_PRECISIONS}")
    num_v = len(offsets) - 1
    offsets = np.asarray(offsets, dtype=np.int64)
    neighbors = np.asarray(neighbors)

    hub_rows = hub_counts = None
    num_hub_arcs = 0
    if hub_matmul and num_v and len(neighbors):
        hubs = _select_hubs(num_v, neighbors, feature_dim_hint,
                            max_hubs, hub_mem_budget,
                            hub_prices_for(hub_prices, device),
                            hub_costs(device, hub_precision))
        if len(hubs):
            nh = len(hubs)
            hub_id = np.full(num_v, -1, dtype=np.int64)
            hub_id[hubs] = np.arange(nh)
            arc_dst = np.repeat(np.arange(num_v),
                                np.diff(offsets).astype(np.int64))
            j = hub_id[neighbors]
            is_hub = j >= 0
            num_hub_arcs = int(is_hub.sum())
            # Sparse count build: O(hub_arcs) transient memory, then a
            # single dense int8/int16 [V, H] fill (the matrix the product
            # needs anyway, capped by hub_mem_budget in _select_hubs).
            key = arc_dst[is_hub] * nh + j[is_hub]
            uk, cnt = np.unique(key, return_counts=True)
            cmax = int(cnt.max(initial=0))
            assert cmax <= 32767, \
                f"hub multiplicity {cmax} overflows int16"
            # bf16 holds integers exactly only up to 256; past that the
            # conversion in apply would silently round multiplicities.
            if cmax > 256 and hub_precision != "f32":
                hub_precision = "f32"
            B = np.zeros((num_v, nh),
                         dtype=np.int8 if cmax <= 127 else np.int16)
            B[uk // nh, uk % nh] = cnt
            hub_counts = B
            # Residual adjacency: drop hub occurrences.
            keep = ~is_hub
            neighbors = neighbors[keep]
            rdeg = np.bincount(arc_dst[keep],
                               minlength=num_v).astype(np.int64)
            offsets = np.concatenate([[0], np.cumsum(rdeg)])
            hub_vertices = hubs

    deg = np.diff(offsets).astype(np.int64)
    wmax = widths[-1]
    # Degree-descending stable order; rank = inverse permutation.
    perm = np.argsort(-deg, kind="stable")
    rank = np.empty(num_v, dtype=np.int64)
    rank[perm] = np.arange(num_v)
    deg_s = deg[perm]
    num_head = int((deg_s > wmax).sum())
    slots = 0

    # ---- head: chunk into width-wmax rows, fold recursively ---------
    head_tables: List[np.ndarray] = []
    head_padcnt: List[np.ndarray] = []
    if num_head:
        h_deg = deg_s[:num_head]
        chunks_per = -(-h_deg // wmax)
        n_chunks = int(chunks_per.sum())
        tbl0 = np.full((n_chunks, wmax), -1, dtype=np.int32)
        c_start = np.cumsum(chunks_per) - chunks_per
        arc_v = np.repeat(np.arange(num_head), h_deg)
        starts = offsets[perm[:num_head]]
        arc_pos = (np.arange(int(h_deg.sum()))
                   - np.repeat(np.cumsum(h_deg) - h_deg, h_deg))
        flat_nbr = neighbors[np.repeat(starts, h_deg) + arc_pos]
        tbl0[c_start[arc_v] + arc_pos // wmax,
             arc_pos % wmax] = rank[flat_nbr]
        pad0 = tbl0 < 0
        head_tables.append(np.where(pad0, 0, tbl0))
        head_padcnt.append(_padcnt(tbl0, pad0))
        slots += tbl0.size
        # Fold chunk rows per head vertex (recursively if very deep).
        counts, start = chunks_per, c_start
        fold_w = 8
        while True:
            kmax = int(counts.max())
            if kmax <= fold_w:
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
            sub = -(-counts // fold_w)
            s_start = np.cumsum(sub) - sub
            tbl = np.full((int(sub.sum()), fold_w), -1, dtype=np.int32)
            iv = np.repeat(np.arange(num_head), counts)
            pos = np.arange(int(counts.sum())) - np.repeat(start, counts)
            tbl[s_start[iv] + pos // fold_w,
                pos % fold_w] = np.arange(int(counts.sum()))
            pad = tbl < 0
            head_tables.append(np.where(pad, 0, tbl))
            head_padcnt.append(_padcnt(tbl, pad))
            slots += tbl.size
            counts, start = sub, s_start

    # ---- width classes over the rest (contiguous ranges) ------------
    class_tables: List[np.ndarray] = []
    class_padcnt: List[np.ndarray] = []
    lo = num_head
    bounds = list(widths[::-1])
    lowers = [0] + list(widths[:-1])
    for w, w_lo in zip(bounds, lowers[::-1]):
        # vertices with w_lo < deg <= w (deg_s descending ⇒ contiguous)
        hi = lo + int(((deg_s[lo:] <= w) & (deg_s[lo:] > w_lo)).sum())
        if w == widths[0]:      # smallest class also takes deg < w_lo+1
            hi = lo + int((deg_s[lo:] <= w).sum())
        n = hi - lo
        if n == 0:
            lo = hi
            continue
        tbl = np.full((n, w), -1, dtype=np.int32)
        d = deg_s[lo:hi]
        iv = np.repeat(np.arange(n), d)
        pos = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        starts = offsets[perm[lo:hi]]
        flat_nbr = neighbors[np.repeat(starts, d) + pos]
        tbl[iv, pos] = rank[flat_nbr]
        pad = tbl < 0
        class_tables.append(np.where(pad, 0, tbl))
        class_padcnt.append(_padcnt(tbl, pad))
        slots += tbl.size
        lo = hi
    assert lo == num_v, (lo, num_v)

    if hub_counts is not None:
        hub_counts = hub_counts[perm]           # rows in permuted space
        hub_rows = rank[hub_vertices].astype(np.int32)
    return BinnedEll(perm=perm, rank=rank, class_tables=class_tables,
                     class_padcnt=class_padcnt, head_tables=head_tables,
                     head_padcnt=head_padcnt, num_head=num_head,
                     num_vertices=num_v, num_slots=int(slots),
                     num_hub_arcs=num_hub_arcs,
                     hub_rows=hub_rows, hub_counts=hub_counts,
                     hub_precision=hub_precision)


# ---- the device side ------------------------------------------------------

def gather_sum_plain(buf: torch.Tensor, tbl: torch.Tensor,
                     padcnt: Optional[torch.Tensor],
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: slot by slot from 0.0, then the pad
    correction as a multiply and a subtract (two roundings)."""
    acc = torch.zeros((tbl.shape[0], buf.shape[1]), dtype=buf.dtype,
                      device=buf.device)
    for k in range(tbl.shape[1]):
        acc += buf[tbl[:, k].long()]
    if padcnt is not None:
        acc = acc - padcnt[:, None] * buf[0]
    if out is None:
        return acc
    out.copy_(acc)
    return out


def _check(buf, tbl, padcnt, out):
    if buf.dtype != torch.float32 or buf.dim() != 2:
        raise TypeError(f"buf must be a 2-D float32 tensor, got {buf.dtype} "
                        f"with {buf.dim()} dims")
    if tbl.dtype != torch.int32 or tbl.dim() != 2:
        raise TypeError(f"tbl must be a 2-D int32 tensor, got {tbl.dtype} "
                        f"with {tbl.dim()} dims")
    named = [("buf", buf), ("tbl", tbl)]
    if padcnt is not None:
        if padcnt.dtype != torch.float32 or padcnt.shape != tbl.shape[:1]:
            raise TypeError(f"padcnt must be float32 [{tbl.shape[0]}], got "
                            f"{padcnt.dtype} {tuple(padcnt.shape)}")
        named.append(("padcnt", padcnt))
    if out is not None:
        if out.dtype != buf.dtype or out.shape != (tbl.shape[0],
                                                   buf.shape[1]):
            raise ValueError(f"out must be {buf.dtype} "
                             f"[{tbl.shape[0]}, {buf.shape[1]}], got "
                             f"{out.dtype} {tuple(out.shape)}")
        named.append(("out", out))
    if tbl.numel() and buf.shape[0] == 0:
        raise ValueError("buf has no rows to gather")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, buf on {buf.device}")


class _CTable(ctypes.Structure):
    """csrc/ell_gather_sum.cu: EllTable."""
    _fields_ = [("tbl", ctypes.c_void_p), ("padcnt", ctypes.c_void_p),
                ("out_row", ctypes.c_longlong), ("rows", ctypes.c_longlong),
                ("width", ctypes.c_int), ("first_unit", ctypes.c_int)]


class _CLevel(ctypes.Structure):
    """csrc/ell_gather_sum.cu: EllLevel."""
    _fields_ = [("n", ctypes.c_int), ("units", ctypes.c_int),
                ("deal", ctypes.c_int), ("t", _CTable * MAX_TABLES)]


@dataclass(frozen=True)
class PlanTable:
    """One gather table of a level and where its rows go: ``out_row`` is
    its first row in the apply's work buffer."""
    tbl: torch.Tensor                 # int32 [rows, width]
    padcnt: Optional[torch.Tensor]    # f32 [rows] or None
    out_row: int

    @property
    def rows(self) -> int:
        return self.tbl.shape[0]

    @property
    def width(self) -> int:
        return self.tbl.shape[1]


@dataclass(frozen=True)
class PlanLevel:
    """Tables that read the same rows: ``h_perm`` when ``src_row`` is
    None, else ``src_rows`` rows of the work buffer from ``src_row``."""
    tables: Tuple[PlanTable, ...]
    src_row: Optional[int]
    src_rows: int

    def descriptors(self, lanes: int) -> List[Tuple[_CLevel, int]]:
        """The level's launches for ``lanes`` lanes per table row: per
        launch at most MAX_TABLES table descriptors, each with its first
        work unit, and the launch's block count.  A unit is a warp's 32
        // lanes consecutive rows of one table; a block's THREADS // 32
        warps take consecutive units or, below DEAL_BELOW_LANES, units
        dealt round-robin over the blocks."""
        rows_per_unit = 32 // lanes
        out = []
        for lo in range(0, len(self.tables), MAX_TABLES):
            level, units = _CLevel(), 0
            chunk = [t for t in self.tables[lo:lo + MAX_TABLES] if t.rows]
            for i, t in enumerate(chunk):
                level.t[i] = _CTable(
                    t.tbl.data_ptr(),
                    None if t.padcnt is None else t.padcnt.data_ptr(),
                    t.out_row, t.rows, t.width, units)
                units += -(-t.rows // rows_per_unit)
            level.n, level.units = len(chunk), units
            level.deal = int(lanes < DEAL_BELOW_LANES)
            if chunk:
                out.append((level, -(-units // (THREADS // 32))))
        return out


@dataclass
class LaunchPlan:
    """The launches of one ``apply_perm``, laid out once per layout.

    The apply's work buffer has ``work_rows`` rows: the first
    ``num_vertices`` are the output, the rest hold the head chain's
    intermediate levels.  Level 0 is every width class (rows in order
    after the head's) and the head's first table; level i > 0 is the
    head's i-th table, reading level i-1's rows.  The last head table
    writes the output's first ``num_head`` rows.

    The rows gathered from (``h_perm``) need not be as many as the
    output's: the rectangular layout (ops/rect.py) reads a source buffer
    of its own row count and ends its output in ``num_zero`` rows that no
    table writes, which are set to zero."""
    levels: List[PlanLevel]
    num_vertices: int
    work_rows: int
    num_zero: int = 0
    _descriptors: Dict[int, list] = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, head, classes, num_head: int, num_vertices: int,
              num_zero: int = 0) -> "LaunchPlan":
        first, lo = [], num_head
        for tbl, pc in classes:
            first.append(PlanTable(tbl, pc, lo))
            lo += tbl.shape[0]
        levels, work_rows = [], num_vertices
        src_row, src_rows = None, num_vertices
        for i, (tbl, pc) in enumerate(head):
            last = i == len(head) - 1
            table = PlanTable(tbl, pc, 0 if last else work_rows)
            tables = tuple(first) + (table,) if i == 0 else (table,)
            levels.append(PlanLevel(tables, src_row, src_rows))
            src_row, src_rows = table.out_row, table.rows
            if not last:
                work_rows += table.rows
        if not head and first:
            levels.append(PlanLevel(tuple(first), None, num_vertices))
        return cls(levels=levels, num_vertices=num_vertices,
                   work_rows=work_rows, num_zero=num_zero)

    def _work(self, h_perm: torch.Tensor) -> torch.Tensor:
        work = torch.empty((self.work_rows, h_perm.shape[1]),
                           dtype=h_perm.dtype, device=h_perm.device)
        if self.num_zero:
            work[self.num_vertices - self.num_zero:self.num_vertices] = 0
        return work

    @property
    def launches_per_apply(self) -> int:
        """Kernel launches of one ``apply_perm`` on a CUDA tensor."""
        return sum(-(-sum(1 for t in lv.tables if t.rows) // MAX_TABLES)
                   for lv in self.levels)

    def descriptors(self, lanes: int) -> list:
        """Per level, ``PlanLevel.descriptors(lanes)``, built once."""
        if lanes not in self._descriptors:
            self._descriptors[lanes] = [lv.descriptors(lanes)
                                        for lv in self.levels]
        return self._descriptors[lanes]

    def walk(self, h_perm: torch.Tensor, gather) -> torch.Tensor:
        """The plan table by table through ``gather(buf, tbl, padcnt,
        out=)``: what the kernel's launches compute, on any device."""
        work = self._work(h_perm)
        for level in self.levels:
            src = h_perm if level.src_row is None else work[
                level.src_row:level.src_row + level.src_rows]
            for t in level.tables:
                gather(src, t.tbl, t.padcnt,
                       out=work[t.out_row:t.out_row + t.rows])
        return work[:self.num_vertices]

    def launch(self, h_perm: torch.Tensor) -> torch.Tensor:
        """One kernel launch per level (per MAX_TABLES tables of it) on
        ``h_perm``'s CUDA device.  Nothing here but the allocation of the
        work buffer and the launches: a step calls it twice."""
        d = h_perm.shape[1]
        work = self._work(h_perm)
        src0, base = h_perm.data_ptr(), work.data_ptr()
        vec, lanes = pack_shape(d, 4, src0, base)
        device = h_perm.device.index
        stream = torch.cuda.current_stream(h_perm.device).cuda_stream
        for level, launches in zip(self.levels, self.descriptors(lanes)):
            src = src0 if level.src_row is None else (
                base + level.src_row * d * 4)
            for desc, blocks in launches:
                _launch(desc, blocks, device, src, base, d, vec, lanes,
                        stream)
        return work[:self.num_vertices]


_LEVEL_FN = None


def _level_fn():
    """The built library's level entry point, checked once against this
    module's constants."""
    global _LEVEL_FN
    from gnnpe_tpu_torch.kernels._build import load
    lib = load("ell_gather_sum")
    if (lib.gnnpe_ell_max_tables(), lib.gnnpe_ell_threads()) != (MAX_TABLES,
                                                                 THREADS):
        raise RuntimeError("ell_gather_sum.cu's kMaxTables/kThreads differ "
                           "from ops/ell.py's MAX_TABLES/THREADS")
    _LEVEL_FN = lib.gnnpe_ell_gather_sum_level_f32
    return _LEVEL_FN


def _launch(desc: _CLevel, blocks: int, device: int, buf: int, out: int,
            d: int, vec: int, lanes: int, stream: int) -> None:
    """One launch over the tables of ``desc``; ``buf`` and ``out`` are
    device addresses, ``out`` the one its ``out_row`` entries count from."""
    global LAUNCHES
    err = (_LEVEL_FN or _level_fn())(device, ctypes.addressof(desc), buf, out,
                                     d, vec, lanes, blocks, stream)
    if err != 0:
        raise RuntimeError(f"ell_gather_sum launch failed: CUDA error {err}")
    LAUNCHES += 1


def gather_sum(buf: torch.Tensor, tbl: torch.Tensor,
               padcnt: Optional[torch.Tensor],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One table: ``out[i] = Σ_k buf[tbl[i, k]] − padcnt[i]·buf[0]`` for a
    row-major f32 ``buf`` [R, D], an int32 ``tbl`` [N, W] with entries in
    [0, R) (pads point at row 0; the caller answers for the bounds) and
    an f32 ``padcnt`` [N] or None.  ``out``, when given, is a contiguous
    [N, D] row range of a larger output.  (``BinnedEllDevice`` does not
    come through here, nor does ``HierarchicalEllDevice``: they launch
    whole levels.)"""
    _check(buf, tbl, padcnt, out)
    if buf.device.type == "cpu":
        return gather_sum_plain(buf, tbl, padcnt, out)
    if buf.device.type != "cuda":
        raise ValueError(f"no gather_sum kernel for device {buf.device}")
    if out is None:
        out = torch.empty((tbl.shape[0], buf.shape[1]), dtype=buf.dtype,
                          device=buf.device)
    if out.numel():
        vec, lanes = pack_shape(buf.shape[1], 4, buf.data_ptr(),
                                out.data_ptr())
        level = PlanLevel((PlanTable(tbl, padcnt, 0),), None, buf.shape[0])
        (desc, blocks), = level.descriptors(lanes)
        _launch(desc, blocks, buf.device.index, buf.data_ptr(),
                out.data_ptr(), buf.shape[1], vec, lanes,
                torch.cuda.current_stream(buf.device).cuda_stream)
    return out


@contextlib.contextmanager
def _full_f32_matmul():
    """TF32 off for the hub products: the hi/lo split relies on each
    f32 product of bf16 values being exact."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def hub_product(hub_counts: torch.Tensor, xh: torch.Tensor,
                precision: str) -> torch.Tensor:
    """``B @ xh`` with JAX's precision per mode: "f32" is one f32
    product; "bf16" and "hi_lo" take the bf16-rounded hi (and lo) parts,
    each multiplied in f32 — JAX's bf16 dot with
    preferred_element_type=f32."""
    with _full_f32_matmul():
        if precision == "f32":
            return hub_counts @ xh
        hi = xh.to(torch.bfloat16)
        out = hub_counts @ hi.float()
        if precision == "hi_lo":
            lo = (xh - hi.float()).to(torch.bfloat16)
            out = out + hub_counts @ lo.float()
    return out


def upload_table(tbl: np.ndarray, pc: Optional[np.ndarray], rows: int,
                 device):
    """One host gather table (and its pad counts) on ``device`` as
    (int32 [N, W], f32 [N] or None), its shape checked and its indices
    checked against the ``rows`` rows it gathers from."""
    if tbl.ndim != 2:
        raise ValueError(f"a gather table must be 2-D, got {tbl.shape}")
    if tbl.size and (tbl.min() < 0 or tbl.max() >= rows):
        raise ValueError(f"table indices outside [0, {rows})")
    if pc is not None and pc.shape != tbl.shape[:1]:
        raise ValueError(f"padcnt {pc.shape} for a table of "
                         f"{tbl.shape[0]} rows")
    return (torch.from_numpy(np.ascontiguousarray(
                tbl, dtype=np.int32)).to(device),
            None if pc is None else torch.from_numpy(
                np.ascontiguousarray(pc, dtype=np.float32)).to(device))


Table = Tuple[torch.Tensor, Optional[torch.Tensor]]


@dataclass
class BinnedEllDevice:
    """A ``BinnedEll`` uploaded to one device, with its launch plan.

    ``apply_perm(h_perm)`` aggregates in the permuted vertex space
    (``h_perm[i] = x[perm[i]]``): the plan's levels, plus the hub
    product.  ``apply(x)`` adds the boundary permutes."""
    perm: torch.Tensor               # int64 [V]
    rank: torch.Tensor               # int64 [V], inverse of perm
    head: List[Table]                # fold levels of the head chain
    classes: List[Table]             # width classes, rows in order
    num_head: int
    num_vertices: int
    num_slots: int
    num_hub_arcs: int
    hub_rows: Optional[torch.Tensor]     # int64 [H]
    hub_counts: Optional[torch.Tensor]   # f32 [V, H] multiplicities
    hub_precision: str
    plan: LaunchPlan = None

    def __post_init__(self):
        if self.plan is None:
            self.plan = LaunchPlan.build(self.head, self.classes,
                                         self.num_head, self.num_vertices)

    @classmethod
    def from_host(cls, layout: BinnedEll, device) -> "BinnedEllDevice":
        """Upload ``layout`` once and lay out its launches; checks every
        table's shape and its indices against the rows it gathers from,
        so ``apply_perm`` checks only ``h_perm``."""
        device = as_device(device)

        def table(tbl, pc, rows):
            return upload_table(tbl, pc, rows, device)

        v = layout.num_vertices
        head, rows = [], v
        for tbl, pc in zip(layout.head_tables, layout.head_padcnt):
            head.append(table(tbl, pc, rows))
            rows = tbl.shape[0]
        if head and rows != layout.num_head:
            raise ValueError(f"the head chain ends in {rows} rows for "
                             f"{layout.num_head} head vertices")
        classes = [table(t, pc, v) for t, pc in zip(layout.class_tables,
                                                     layout.class_padcnt)]
        if layout.num_head + sum(t.shape[0] for t, _ in classes) != v:
            raise ValueError("the tables' rows do not add up to the "
                             f"layout's {v} vertices")
        hub_rows = hub_counts = None
        if layout.hub_rows is not None and len(layout.hub_rows):
            hub_rows = torch.from_numpy(
                layout.hub_rows.astype(np.int64)).to(device)
            # Counts <= 32767 are exact in f32; in the bf16 modes they
            # are <= 256 (the builder switches to "f32" above that), so
            # these are also the bf16 counts JAX multiplies by.
            hub_counts = torch.from_numpy(
                layout.hub_counts.astype(np.float32)).to(device)
        as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
        return cls(perm=as_t(layout.perm), rank=as_t(layout.rank),
                   head=head, classes=classes, num_head=layout.num_head,
                   num_vertices=v, num_slots=layout.num_slots,
                   num_hub_arcs=layout.num_hub_arcs, hub_rows=hub_rows,
                   hub_counts=hub_counts,
                   hub_precision=layout.hub_precision)

    @property
    def launches_per_apply(self) -> int:
        return self.plan.launches_per_apply

    def _hub_part(self, h_perm: torch.Tensor) -> torch.Tensor:
        """``B @ h_perm[hubs]`` (``hub_product``)."""
        return hub_product(self.hub_counts, h_perm[self.hub_rows],
                           self.hub_precision)

    def apply_perm(self, h_perm: torch.Tensor, gather=None) -> torch.Tensor:
        """Aggregated [V, D] in the permuted space.  A CUDA ``h_perm``
        launches the kernel once per level, a CPU one walks the plan
        over ``gather_sum_plain``.  ``gather``, when given, is a
        per-table gather-sum the plan is walked over instead, on any
        device (the kernel check passes ``gather_sum_plain``)."""
        if (h_perm.dim() != 2 or h_perm.shape[0] != self.num_vertices
                or h_perm.dtype != torch.float32):
            raise ValueError(f"h_perm must be float32 [{self.num_vertices}, "
                             f"D], got {h_perm.dtype} "
                             f"{tuple(h_perm.shape)}")
        if h_perm.device != self.perm.device:
            raise ValueError(f"h_perm is on {h_perm.device}, the layout on "
                             f"{self.perm.device}")
        h_perm = h_perm.contiguous()
        if gather is not None:
            out = self.plan.walk(h_perm, gather)
        elif h_perm.device.type == "cpu":
            out = self.plan.walk(h_perm, gather_sum_plain)
        elif h_perm.device.type == "cuda":
            out = self.plan.launch(h_perm)
        else:
            raise ValueError(f"no gather_sum kernel for device "
                             f"{h_perm.device}")
        if self.hub_rows is not None:
            out = out + self._hub_part(h_perm)
        return out

    def permute(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.perm]

    def unpermute(self, h_perm: torch.Tensor) -> torch.Tensor:
        return h_perm[self.rank]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.unpermute(self.apply_perm(self.permute(x)))


class _SymmetricAggregate(torch.autograd.Function):
    """``apply_perm`` with ``apply_perm`` as its backward: for a
    symmetric adjacency the pullback of h ↦ A_perm h is A_perm itself,
    so the gradient reuses the same gather tables and never scatters."""

    @staticmethod
    def forward(ctx, h_perm, layout):
        ctx.layout = layout
        return layout.apply_perm(h_perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.apply_perm(g.contiguous()), None


class _Permute(torch.autograd.Function):
    """``x[idx]`` for a permutation ``idx``, whose backward gathers
    with the inverse permutation ``inv`` instead of scattering."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.inv = inv
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        return g[ctx.inv], None, None


def symmetric_aggregate(layout: BinnedEllDevice):
    """Scatter-free aggregation with a scatter-free gradient, in the
    permuted vertex space (gnnpe_tpu's custom VJP as an
    ``autograd.Function``)."""
    return lambda h_perm: _SymmetricAggregate.apply(h_perm, layout)


def binned_aggregate(layout: BinnedEllDevice):
    """``symmetric_aggregate`` with the permutes in and out at the layer
    boundary (as gnnpe_tpu's fit does); its whole backward gathers."""
    inner = symmetric_aggregate(layout)
    return lambda h: _Permute.apply(
        inner(_Permute.apply(h, layout.perm, layout.rank)),
        layout.rank, layout.perm)


# ---- the uniform-width layout ----------------------------------------------
# ``build_ell`` is the port's own copy of gnnpe_tpu's.

@dataclass
class EllLayout:
    """One gather-sum level: out[i] = Σ_k in[tbl[i,k]] * (tbl[i,k]>=0).
    Index -1 marks padding."""
    tbl: np.ndarray        # int32[N, K]

    @property
    def num_rows(self) -> int:
        return self.tbl.shape[0]


@dataclass
class HierarchicalEll:
    """Uniform-width ELL: level 1 sums each chunk of ≤K neighbours of a
    vertex into one row; each further level sums a vertex's rows of the
    level before through a table of ``level2_width`` slots (recursively
    while a vertex has more rows than that); the last level has one row
    per vertex.  Level 1 reads ``num_sources`` rows: ``num_vertices``
    where None (the square layout of an adjacency), else the rows a
    rectangular layout gathers from (ops/gather.py: one per entry of a
    gather's index)."""
    levels: List[EllLayout]
    num_vertices: int
    num_slots: int          # total gather slots (padding overhead metric)
    slot_arc: np.ndarray = None   # int32[level-1 slots]: CSR arc index
    #                               per slot, -1 pad (ops/sddmm.py)
    num_sources: Optional[int] = None

    def __post_init__(self):
        self._on: Dict[torch.device, "HierarchicalEllDevice"] = {}

    def on(self, device) -> "HierarchicalEllDevice":
        """This layout on ``device``, uploaded at the first call."""
        device = as_device(device)
        if device not in self._on:
            self._on[device] = HierarchicalEllDevice.from_host(self, device)
        return self._on[device]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Aggregated neighbour features [V, D] of ``x`` [V, D]."""
        return self.on(x.device).apply(x)


def build_ell(offsets: np.ndarray, neighbors: np.ndarray,
              width: int = 8, level2_width: int = 8,
              num_sources: Optional[int] = None) -> HierarchicalEll:
    """Build the hierarchical layout from CSR (host, O(E)); with
    ``num_sources`` the neighbours index that many source rows and the
    layout is rectangular."""
    num_v = len(offsets) - 1
    deg = np.diff(offsets).astype(np.int64)

    # ---- level 1: chunks of ≤width neighbors -------------------------
    chunks_per_v = np.maximum(-(-deg // width), 1)
    c_of_v_end = np.cumsum(chunks_per_v)
    c_of_v_start = c_of_v_end - chunks_per_v
    num_chunks = int(c_of_v_end[-1])

    tbl1 = np.full((num_chunks, width), -1, dtype=np.int32)
    # Chunk row r of vertex v covers neighbors [offsets[v]+ (r-start)*W ...]
    arc_v = np.repeat(np.arange(num_v), deg)
    arc_pos = np.arange(len(neighbors)) - np.repeat(offsets[:-1], deg)
    chunk_row = c_of_v_start[arc_v] + arc_pos // width
    slot = arc_pos % width
    tbl1[chunk_row, slot] = neighbors
    slot_arc = np.full(tbl1.size, -1, dtype=np.int32)
    slot_arc[chunk_row * width + slot] = np.arange(len(neighbors))

    levels = [EllLayout(tbl1)]
    slots = tbl1.size

    # ---- level 2+: fold chunk rows per vertex ------------------------
    cur_counts = chunks_per_v
    cur_start = c_of_v_start
    while True:
        kmax = int(cur_counts.max()) if num_v else 1
        if kmax <= level2_width:
            tbl = np.full((num_v, level2_width), -1, dtype=np.int32)
            item_v = np.repeat(np.arange(num_v), cur_counts)
            pos = (np.arange(int(cur_counts.sum()))
                   - np.repeat(cur_start, cur_counts))
            tbl[item_v, pos] = np.arange(int(cur_counts.sum()))
            levels.append(EllLayout(tbl))
            slots += tbl.size
            break
        # Another chunking level over the chunk rows.
        n_items = int(cur_counts.sum())
        sub = np.maximum(-(-cur_counts // level2_width), 1)
        sub_end = np.cumsum(sub)
        sub_start = sub_end - sub
        n_sub = int(sub_end[-1])
        tbl = np.full((n_sub, level2_width), -1, dtype=np.int32)
        item_v = np.repeat(np.arange(num_v), cur_counts)
        pos = np.arange(n_items) - np.repeat(cur_start, cur_counts)
        row = sub_start[item_v] + pos // level2_width
        tbl[row, pos % level2_width] = np.arange(n_items)
        levels.append(EllLayout(tbl))
        slots += tbl.size
        cur_counts = sub
        cur_start = sub_start

    return HierarchicalEll(levels=levels, num_vertices=num_v,
                           num_slots=int(slots), slot_arc=slot_arc,
                           num_sources=num_sources)


def masked_level_plain(h: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """One level in the masked plain form over a kernel table (pads at
    ``len(h)``): gather ``h`` at each slot, 0.0 at a pad, slots added in
    ascending order from 0.0 — gnnpe_tpu's masked sum of its -1 pads."""
    rows = h.shape[0]
    acc = torch.zeros((tbl.shape[0],) + tuple(h.shape[1:]), dtype=h.dtype,
                      device=h.device)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    for k in range(tbl.shape[1]):
        col = tbl[:, k]
        mask = (col < rows).reshape((-1,) + (1,) * (h.dim() - 1))
        acc += torch.where(mask, h[col.clamp(max=max(rows - 1, 0))], zero)
    return acc


@dataclass(frozen=True)
class WalkPlan:
    """The kernel route's launches of one walk, laid out once: every
    level's input and the output in one work buffer of ``work_rows``
    rows, each region starting at a multiple of 4 rows (so each is
    16-byte aligned for any row width), each input followed by the zero
    row its pads read (``zero_rows``).  Per level, its launch
    descriptors and the first rows of its input and its output."""
    levels: Tuple[Tuple[list, int, int], ...]
    zero_rows: torch.Tensor     # int64, on the layout's device
    out_row: int
    work_rows: int


def _round4(rows: int) -> int:
    return -(-rows // 4) * 4


@dataclass
class HierarchicalEllDevice:
    """A ``HierarchicalEll`` on one device.  Per level, ``tables`` holds
    the kernel's table (int32), whose -1 pads point at row ``src_rows``
    of the level's input — the zero row the kernel route appends, and
    the mask of the masked plain form (``tbl < src_rows``).
    ``slot_arc`` is the layout's (int64), where it has one."""
    tables: List[torch.Tensor]
    src_rows: List[int]
    num_vertices: int
    num_slots: int
    slot_arc: Optional[torch.Tensor] = None
    _walks: Dict[Tuple[int, int], WalkPlan] = field(default_factory=dict,
                                                    repr=False)

    @classmethod
    def from_host(cls, layout: HierarchicalEll,
                  device) -> "HierarchicalEllDevice":
        """Upload ``layout`` once; checks every table against the rows
        it gathers from (level 1: ``layout.num_sources``, or a row per
        vertex where that is None) and that the last level has a row per
        vertex."""
        device = as_device(device)
        tables, src_rows = [], []
        rows = (layout.num_vertices if layout.num_sources is None
                else layout.num_sources)
        for lvl in layout.levels:
            tbl = np.asarray(lvl.tbl)
            if tbl.ndim != 2:
                raise ValueError(f"a level's table must be 2-D, got "
                                 f"{tbl.shape}")
            if tbl.size and (tbl.min() < -1 or tbl.max() >= rows):
                raise ValueError(f"table indices outside [-1, {rows})")
            tables.append(torch.from_numpy(np.where(
                tbl < 0, rows, tbl).astype(np.int32)).to(device))
            src_rows.append(rows)
            rows = tbl.shape[0]
        if rows != layout.num_vertices:
            raise ValueError(f"the last level has {rows} rows for "
                             f"{layout.num_vertices} vertices")
        slot_arc = (None if layout.slot_arc is None else torch.from_numpy(
            np.asarray(layout.slot_arc, np.int64)).to(device))
        return cls(tables=tables, src_rows=src_rows,
                   num_vertices=layout.num_vertices,
                   num_slots=layout.num_slots, slot_arc=slot_arc)

    @property
    def launches_per_apply(self) -> int:
        """Kernel launches of one ``apply`` on a CUDA tensor."""
        return sum(1 for t in self.tables if t.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tables[0].device

    def _check(self, x: torch.Tensor, rows: int) -> None:
        if x.dim() != 2 or x.shape[0] != rows:
            raise ValueError(f"x must be [{rows}, D], got {tuple(x.shape)}")
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the layout on "
                             f"{self.device}")

    def walk_plain(self, h: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Levels ``start``... in the masked plain form, on any device."""
        self._check(h, self.src_rows[start])
        for tbl in self.tables[start:]:
            h = masked_level_plain(h, tbl)
        return h

    def walk_plan(self, start: int, lanes: int) -> WalkPlan:
        """The ``WalkPlan`` of levels ``start``... at ``lanes`` lanes a
        row, built at the first call."""
        key = (start, lanes)
        if key not in self._walks:
            levels, zeros = [], []
            in_row, in_rows, row = 0, self.src_rows[start], 0
            for tbl in self.tables[start:]:
                zeros.append(in_row + in_rows)
                row = _round4(in_row + in_rows + 1)
                level = PlanLevel((PlanTable(tbl, None, 0),), None, in_rows)
                levels.append((level.descriptors(lanes), in_row, row))
                in_row, in_rows = row, tbl.shape[0]
            self._walks[key] = WalkPlan(
                levels=tuple(levels), zero_rows=torch.tensor(
                    zeros, dtype=torch.int64, device=self.device),
                out_row=in_row, work_rows=in_row + in_rows)
        return self._walks[key]

    def walk(self, h: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Levels ``start``... from ``h``: one launch of the gather-sum
        kernel per level on a CUDA tensor (f32), through the
        ``walk_plan`` laid out once, the masked plain form on a CPU
        tensor; any other device raises."""
        self._check(h, self.src_rows[start])
        if h.device.type == "cpu":
            return self.walk_plain(h, start)
        if h.device.type != "cuda":
            raise ValueError(f"no gather_sum kernel for device {h.device}")
        if h.dtype != torch.float32:
            raise TypeError(f"the kernel route takes float32, got {h.dtype}")
        d = h.shape[1]
        vec, lanes = pack_shape(d, 4)
        plan = self.walk_plan(start, lanes)
        work = torch.empty((plan.work_rows, d), dtype=h.dtype,
                           device=h.device)
        if not work.numel():
            return work[plan.out_row:]
        base = work.data_ptr()
        if pack_shape(d, 4, base) != (vec, lanes):
            raise RuntimeError("the walk's work buffer is not 16-byte "
                               "aligned")
        work[:h.shape[0]] = h
        work.index_fill_(0, plan.zero_rows, 0.0)
        device = h.device.index
        stream = torch.cuda.current_stream(h.device).cuda_stream
        for launches, in_row, out_row in plan.levels:
            for desc, blocks in launches:
                _launch(desc, blocks, device, base + in_row * d * 4,
                        base + out_row * d * 4, d, vec, lanes, stream)
        return work[plan.out_row:]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Aggregated neighbour features [V, D] of ``x`` [V, D]."""
        return self.walk(x.contiguous())

    def apply_plain(self, x: torch.Tensor) -> torch.Tensor:
        """``apply`` in the masked plain form, on any device."""
        return self.walk_plain(x)


def ell_neighbor_sum(layout, x: torch.Tensor) -> torch.Tensor:
    """``layout.apply(x)`` (a ``HierarchicalEll`` or one ``on`` a device)."""
    return layout.apply(x)
