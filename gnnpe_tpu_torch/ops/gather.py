"""Row gathers with a planned, scatter-free backward.

``GatherRows`` is ``x.index_select(0, idx)`` for an index ``idx`` [N]
into the ``R`` rows of ``x`` that is fixed before training starts (the
trainer's label lookup and path readout; gnnpe_tpu's ``jnp.take``).  Its
backward, ``grad_x[r] = Σ_{k: idx[k] = r} g[k]``, is not a scatter: the
plan holds the transposed index (``perm``, the stable argsort of
``idx``, and ``offsets``, its CSR row pointer), and the backward is the
segment sum ``out[r] = Σ_{j=offsets[r]}^{offsets[r+1]-1} g[perm[j]]``:
``segment_sum``, on a CUDA tensor one launch of csrc/segment_sum.cu (f32
or f64, any width, ``N·D`` past 2^31, an empty index), on a CPU tensor
``segment_sum_plain``; any other device raises.

Why: torch's backward of ``x[idx]`` sorts the index and then, at a narrow
row, adds each index's duplicates one after another, so a row named 10^5
times (a frequent label) is a chain of 10^5 dependent adds; ``index_add_``
uses atomics, whose order changes from run to run.  The kernel splits the
sorted entries into tiles of ``threads / lanes`` slots of ``WINDOW ·
lanes`` entries (``lanes``, the lanes that share one entry's row, 16
bytes each, follows from D and the type: ``slot_shape``) and adds in an
order fixed by those: each slot's runs left to right, a segmented scan over the
slots of a warp (shuffles carrying the slots' tail flags), the warps in
warp order, and a row's pieces from earlier tiles by a fixed tree in the
block of its last tile.  So one hot row is spread over many blocks with
no chain of dependent adds longer than a window and a few tree levels,
the result is deterministic, and ``segment_sum_plain`` repeats it bit for
bit.  What bounds it on the card is bytes: the cotangent [N, D] and
``perm`` read once, the gradient written once.

The plan holds what the order needs beside the index, built once (by
``fit`` before its steps): ``entries``, ``perm`` with bit 31 set on each
row's last entry (``N < 2^31`` leaves the bit free, so the kernel finds
its row edges in the words it loads anyway), ``window_runs`` (the run,
that is the non-empty row counted in order, of each window's first
entry) and ``run_rows`` (the non-empty rows in order, then the empty
ones).  Per (D, type) it keeps a ``SegmentLaunch``: the tiles of that
width, the row each tile takes in from earlier tiles, the scratch of the
carries and a flag a tile (zeroed and left zeroed by every launch, so a
CUDA graph replays it), and the kernel's argument struct.

``WINDOW`` and ``THREADS`` were chosen with ``python -m
gnnpe_tpu_torch.kernels.readout_sweep`` (the trainer's dblp label and
path plans, f32 D=2, windows 4-16 × 64-512 threads) on an NVIDIA H100
80GB HBM3 at 700 W: (8, 128) took the least time on the card for the two
plans together, 0.0288 ms (labels 0.0077, paths 0.0211), (4, 128)
0.0289 and (4, 256) 0.0293; by events a call is bound by the host, which
varies too much between points to rank them.  At one lane an entry the
slot sums 8 entries and a tile holds 1,024; at f32 D=12 (4 lanes) 16 and
512.  PERF.md §6 has the run and what bounds each shape.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from gnnpe_tpu_torch.kernels._build import pack_shape
from gnnpe_tpu_torch.utils.device import as_device
from gnnpe_tpu_torch.utils.profiling import annotate

__all__ = ["GatherRows", "PlanCache", "SegmentLaunch", "THREADS", "WINDOW",
           "segment_sum", "segment_sum_plain", "slot_shape", "tile_layout"]

WINDOW = 8       # sorted entries a slot of one lane sums (4, 8 or 16)
THREADS = 128    # threads a block (a multiple of 32 up to 512)
MAX_SLOT_WINDOW = 16   # entries a slot sums at most

LAUNCHES = 0

# The cotangent types the kernel is built for, and its C entry of each.
KERNEL_DTYPES = {torch.float32: "gnnpe_segment_sum_f32",
                 torch.float64: "gnnpe_segment_sum_f64"}

_TAIL = -2 ** 31   # bit 31 of an int32 entry: the last entry of its row


def slot_shape(d: int, elem_size: int, window: int = WINDOW,
               threads: int = THREADS) -> tuple:
    """(lanes, slot window, slots a tile) of the kernel's order for rows
    of ``d`` elements of ``elem_size`` bytes: ``lanes`` share one entry's
    row, the power of two that covers its 16-byte packs, at most 32
    (``pack_shape`` of ``d`` and the element size alone, so that the
    order depends on the shape and never on where the tensors lie); a
    slot of ``lanes`` lanes sums ``window · lanes`` entries, at most
    ``MAX_SLOT_WINDOW``, so that a tile keeps ``window · threads``
    entries up to 4 lanes an entry; a block of ``threads`` holds
    ``threads / lanes`` slots."""
    lanes = pack_shape(max(d, 1), elem_size)[1]
    return lanes, min(MAX_SLOT_WINDOW, window * lanes), threads // lanes


def _check_tile(window: int, threads: int) -> None:
    if window not in (4, 8, 16):
        raise ValueError(f"window must be 4, 8 or 16, got {window}")
    if threads < 32 or threads > 512 or threads % 32:
        raise ValueError(f"threads must be a multiple of 32 up to 512, got "
                         f"{threads}")


def tile_layout(offsets: np.ndarray, window: int = WINDOW,
                threads: int = THREADS) -> dict:
    """What the kernel's fixed order needs of the CSR ``offsets`` [R+1]
    of a transposed index, whatever the width: ``ends`` (the sorted
    position of each non-empty row's last entry, the entries tagged in
    bit 31), ``window_runs`` (the run of each window's first entry: the
    ends before it), ``run_rows`` (the non-empty rows in order, then the
    empty ones), all int32, and ``runs`` (the non-empty rows)."""
    _check_tile(window, threads)
    offsets = np.asarray(offsets, np.int64)
    n = int(offsets[-1])
    counts = np.diff(offsets)
    ends = offsets[1:][counts > 0] - 1
    window_runs = np.searchsorted(ends, np.arange(0, n, window), "left")
    run_rows = np.concatenate([np.flatnonzero(counts > 0),
                               np.flatnonzero(counts == 0)])
    return dict(ends=ends.astype(np.int32),
                window_runs=window_runs.astype(np.int32),
                run_rows=run_rows.astype(np.int32), runs=len(ends))


def _tree(p: torch.Tensor) -> torch.Tensor:
    """The bottom-up pairwise sum of ``p`` [M, S, D] over its S (a power
    of two) slots: (p0 + p1) + (p2 + p3), ..."""
    while p.shape[1] > 1:
        p = p[:, 0::2] + p[:, 1::2]
    return p[:, 0]


def segment_sum_plain(g: torch.Tensor, perm: torch.Tensor,
                      offsets: torch.Tensor, window: int = WINDOW,
                      threads: int = THREADS,
                      lanes: Optional[int] = None) -> torch.Tensor:
    """``out[r] = Σ_{j=offsets[r]}^{offsets[r+1]-1} g[perm[j]]`` in the
    kernel's order (csrc/segment_sum.cu), vectorised over slots and rows.
    Tiles of ``threads / lanes`` slots of ``min(16, window · lanes)``
    sorted entries (``slot_shape``: ``lanes`` from D and the type; a
    column slice of a wider cotangent passes the full width's),
    ``32 / lanes`` slots a warp:

    (1) each slot sums its runs left to right from 0.0; a run that ends
        after the slot's first row end is a whole row;
    (2) a Kogge-Stone segmented inclusive scan over the warp's slots
        (``v[i] = v[i-h] + v[i]`` unless slot i holds a row end, for h =
        1, 2, 4, ...) of each slot's trailing piece;
    (3) the warps' totals folded left to right into each warp's carry,
        restarting at a warp that holds a row end;
    (4) a slot's first run ends its row: carry into the slot + the run;
    (5) a row that comes in from earlier tiles: their carries (each the
        tile's scan at its end) summed into ``threads / lanes`` slots,
        slot i taking tiles i, i + S, ... left to right, then a pairwise
        tree over the slots, and this tile's piece added last.

    The loops run over the slots of a window, the scan's levels, the
    warps of a tile and the rounds of the fold."""
    if g.dim() != 2:
        raise ValueError(f"g must be 2-D, got {tuple(g.shape)}")
    rows, n, d = offsets.numel() - 1, perm.numel(), g.shape[1]
    dev, dt = g.device, g.dtype
    out = torch.zeros((rows, d), dtype=dt, device=dev)
    if n == 0 or d == 0:
        return out
    if lanes is None:
        lanes = slot_shape(d, g.element_size())[0]
    _check_tile(window, threads)
    window = min(MAX_SLOT_WINDOW, window * lanes)
    slots, per_warp, warps = threads // lanes, 32 // lanes, threads // 32
    tile = slots * window
    tiles = -(-n // tile)
    nslots = tiles * slots
    offsets = offsets.long()
    counts = offsets[1:] - offsets[:-1]
    key = torch.zeros(tiles * tile, dtype=torch.long, device=dev)
    key[:n] = torch.repeat_interleave(torch.arange(rows, device=dev), counts)
    tail = torch.zeros(tiles * tile, dtype=torch.bool, device=dev)
    tail[offsets[1:][counts > 0] - 1] = True
    vals = torch.zeros((tiles * tile, d), dtype=dt, device=dev)
    vals[:n] = g[perm.long()]
    vals, tail, key = (vals.view(nslots, window, d),
                       tail.view(nslots, window), key.view(nslots, window))

    # (1) Each slot's runs, entry by entry.
    acc = torch.zeros((nslots, d), dtype=dt, device=dev)
    first = torch.zeros_like(acc)
    first_row = torch.zeros(nslots, dtype=torch.long, device=dev)
    seen = torch.zeros(nslots, dtype=torch.bool, device=dev)
    for k in range(window):
        acc = acc + vals[:, k]
        ends = tail[:, k]
        whole = ends & seen
        out[key[whole, k]] = acc[whole]
        opens = ends & ~seen
        first[opens] = acc[opens]
        first_row[opens] = key[opens, k]
        seen |= ends
        acc = torch.where(ends[:, None], torch.zeros((), dtype=dt,
                                                     device=dev), acc)

    # (2) The segmented scan over each warp's slots.
    f = seen.view(tiles * warps, per_warp)
    v = acc.view(tiles * warps, per_warp, d)
    h = 1
    while h < per_warp:
        nv, nf = v.clone(), f.clone()
        nv[:, h:] = torch.where(f[:, h:, None], v[:, h:],
                                v[:, :-h] + v[:, h:])
        nf[:, h:] = f[:, h:] | f[:, :-h]
        v, f, h = nv, nf, 2 * h
    xv, xf = torch.zeros_like(v), torch.zeros_like(f)
    xv[:, 1:], xf[:, 1:] = v[:, :-1], f[:, :-1]

    # (3) The carry into each warp, warp by warp.
    agg = v[:, -1].reshape(tiles, warps, d)
    agg_f = f[:, -1].reshape(tiles, warps)
    carry_in = torch.zeros_like(agg)
    carry_f = torch.zeros_like(agg_f)
    for w in range(1, warps):
        carry_in[:, w] = torch.where(agg_f[:, w - 1, None], agg[:, w - 1],
                                     carry_in[:, w - 1] + agg[:, w - 1])
        carry_f[:, w] = carry_f[:, w - 1] | agg_f[:, w - 1]
    cw = carry_in.view(tiles * warps, 1, d)
    x = torch.where(xf[..., None], xv, cw + xv).view(nslots, d)

    # (4) Each slot's first run closes its row, unless the row came in
    # from an earlier tile (the tile's first row end): then it is the
    # tile's own piece of that row.
    total = x + first
    t_slot = torch.arange(nslots, device=dev) // slots
    starts = torch.arange(tiles, device=dev) * tile
    in_row = key.view(-1)[starts]
    incoming = offsets[in_row] < starts
    own_slot = (seen & ~xf.view(nslots)
                & ~carry_f.view(tiles * warps, 1).expand(-1, per_warp)
                .reshape(nslots) & incoming[t_slot])
    closes = seen & ~own_slot
    out[first_row[closes]] = total[closes]

    # (5) The rows that came in: the carries of their earlier tiles by
    # the fixed tree, this tile's piece last.
    ts = t_slot[own_slot]
    if ts.numel():
        carry = torch.where(agg_f[:, -1, None], agg[:, -1],
                            carry_in[:, -1] + agg[:, -1])
        t0 = offsets[in_row[ts]] // tile
        m = ts - t0
        width = min(slots, 1 << (int(m.max()) - 1).bit_length())
        lane_k = torch.arange(width, device=dev)
        p = torch.zeros((len(ts), width, d), dtype=dt, device=dev)
        for j in range(0, int(m.max()), slots):
            k = j + lane_k[None, :]
            have = k < m[:, None]
            p = p + torch.where(have[..., None],
                                carry[(t0[:, None] + k).clamp(max=tiles - 1)],
                                torch.zeros((), dtype=dt, device=dev))
        out[in_row[ts]] = _tree(p) + total[own_slot]
    return out


class _SegmentPlan(ctypes.Structure):
    """csrc/segment_sum.cu's SegmentPlan: the plan's pointers and sizes,
    handed to the kernel as one argument."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "entries", "window_runs", "run_rows", "tile_in", "scratch",
        "flags")] + [("n", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("rows", "runs", "window",
                                          "slot_window", "threads", "lanes",
                                          "tiles")]


_KERNELS: dict = {}


def _kernel(dtype: torch.dtype):
    if dtype not in _KERNELS:
        from gnnpe_tpu_torch.kernels._build import load
        _KERNELS[dtype] = getattr(load("segment_sum"), KERNEL_DTYPES[dtype])
    return _KERNELS[dtype]


def check_kernel_shape(n: int, d: int, dtype: torch.dtype) -> None:
    """Raise unless csrc/segment_sum.cu takes a cotangent of ``n``
    entries of width ``d`` and type ``dtype``: f32 or f64, any ``d >=
    0``, ``n < 2^31`` (``perm`` and ``offsets`` are int32; ``n·d`` may
    pass 2^31, the kernel's addresses are 64-bit)."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the segment_sum kernel takes float32 or float64, "
                        f"got {dtype}")
    if not 0 <= n < 2 ** 31 or d < 0:
        raise ValueError(f"the segment_sum kernel takes N < 2^31 entries "
                         f"and D >= 0, got N={n}, D={d}")


@dataclass
class SegmentLaunch:
    """What a plan's kernel launch keeps for one (D, type), made once by
    ``GatherRows.launch_state``: ``lanes`` and ``slot_window`` (the
    order's lanes an entry and entries a slot, ``slot_shape``), ``vec``
    (elements a lane loads where the tensors are aligned to it), ``tile``
    and ``tiles``, ``tile_in`` (int32 [tiles, 2]: the row each
    tile takes in from earlier tiles and the first tile of that row, or
    -1 and the tile itself), ``scratch`` (2 · tiles · D elements of the
    type: each tile's carry, then its own piece of the row it takes in),
    ``flags`` (one a tile, zero between launches), and ``args``, the
    kernel's struct over them."""
    lanes: int
    slot_window: int
    vec: int
    tile: int
    tiles: int
    tile_in: torch.Tensor
    scratch: torch.Tensor
    flags: torch.Tensor
    args: _SegmentPlan = field(repr=False)


def segment_sum(g: torch.Tensor, plan: "GatherRows") -> torch.Tensor:
    """The segment sum of the cotangent ``g`` [N, D] over ``plan``'s
    transposed index: one launch of csrc/segment_sum.cu on a CUDA tensor
    (``check_kernel_shape`` says which; an empty index is one launch
    too, D = 0 returns the empty [R, 0] output without one),
    ``segment_sum_plain`` on a CPU tensor; any other device raises.  The
    output is allocated with ``torch.empty``: the kernel writes every
    row."""
    global LAUNCHES
    n = plan.perm.numel()
    if g.dim() != 2 or g.shape[0] != n:
        raise ValueError(f"g must be [{n}, D], got {tuple(g.shape)}")
    if not g.dtype.is_floating_point:
        raise TypeError(f"g must be a floating tensor, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    device = g.device
    if device != plan.device:
        raise ValueError(f"g is on {device}, the plan on {plan.device}")
    if device.type == "cpu":
        return segment_sum_plain(g, plan.perm, plan.offsets, plan.window,
                                 plan.threads)
    if device.type != "cuda":
        raise ValueError(f"no segment_sum kernel for device {device}")
    d = g.shape[1]
    check_kernel_shape(n, d, g.dtype)
    out = torch.empty((plan.num_rows, d), dtype=g.dtype, device=device)
    if d == 0:
        return out
    launch = plan.launch_state(d, g.dtype)
    vec, size = launch.vec, g.element_size()
    if (g.data_ptr() | out.data_ptr()) % (vec * size):
        vec, _ = pack_shape(d, size, g.data_ptr(), out.data_ptr(),
                            launch.scratch.data_ptr())
    err = _kernel(g.dtype)(device.index, ctypes.addressof(launch.args),
                           g.data_ptr(), out.data_ptr(), d, vec,
                           torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


@dataclass
class GatherRows:
    """The plan of one fixed gather: ``idx`` int64 [N] on the device, the
    ``num_rows`` rows it reads from, and its transposed index for the
    backward: ``perm`` (int32, the stable argsort of ``idx``),
    ``offsets`` (int32 [num_rows + 1]), and ``tile_layout``'s fields on
    the device: ``entries`` (``perm`` with bit 31 set on each row's last
    entry), ``window_runs``, ``run_rows`` and ``runs``, for windows of
    ``window`` entries and blocks of ``threads``.  ``launch_state`` adds
    what a launch needs per (D, type).  ``name`` labels its backward in
    profiler timelines (``<name>.backward``)."""
    idx: torch.Tensor
    num_rows: int
    perm: torch.Tensor
    offsets: torch.Tensor
    entries: torch.Tensor
    window_runs: torch.Tensor
    run_rows: torch.Tensor
    runs: int
    window: int = WINDOW
    threads: int = THREADS
    name: str = "gather_rows"
    _launches: dict = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, idx, num_rows: int, device, window: int = WINDOW,
              threads: int = THREADS,
              name: str = "gather_rows") -> "GatherRows":
        """Plan the gather of ``idx`` (any integer array or tensor, read
        flat) into ``num_rows`` rows, built once: the stable sort of the
        index on ``device`` (``torch.sort``, the permutation of numpy's
        stable argsort), the offsets and the layout on the host, the
        row-end tags on the device."""
        if torch.is_tensor(idx):
            idx = idx.detach().cpu().numpy()
        idx = np.asarray(idx).reshape(-1).astype(np.int64)
        if num_rows < 1:
            raise ValueError(f"a gather reads at least one row, got "
                             f"num_rows={num_rows}")
        if idx.size and (idx.min() < 0 or idx.max() >= num_rows):
            raise ValueError(f"gather indices outside [0, {num_rows})")
        if idx.size >= 2 ** 31:
            raise ValueError(f"{idx.size} entries: the plan indexes them "
                             "in int32")
        device = as_device(device)
        idx_t = torch.from_numpy(idx).to(device)
        order = torch.sort(idx_t, stable=True)[1].to(torch.int32)
        offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(idx, minlength=num_rows))])
        lay = tile_layout(offsets, window, threads)
        up = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device)
        ends = up(lay["ends"]).long()
        entries = order.clone()
        entries[ends] = entries[ends] | _TAIL
        return cls(idx=idx_t, num_rows=num_rows, perm=order,
                   offsets=up(offsets), entries=entries,
                   window_runs=up(lay["window_runs"]),
                   run_rows=up(lay["run_rows"]), runs=lay["runs"],
                   window=window, threads=threads, name=name)

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def launch_state(self, d: int,
                     dtype: torch.dtype = torch.float32) -> SegmentLaunch:
        """The ``SegmentLaunch`` of cotangents of width ``d`` and type
        ``dtype``, made at the first call of that (D, type) and kept."""
        key = (d, dtype)
        if key not in self._launches:
            size = torch.empty((), dtype=dtype).element_size()
            lanes, slot_window, slots = slot_shape(d, size, self.window,
                                                   self.threads)
            vec = pack_shape(d, size)[0]
            n, dev = self.perm.numel(), self.device
            tile = slots * slot_window
            tiles = max(1, -(-n // tile))
            starts = torch.arange(tiles, device=dev) * tile
            offsets = self.offsets.long()
            row = (torch.searchsorted(offsets, starts, right=True) - 1
                   ).clamp(0, self.num_rows - 1)
            begin = offsets[row]
            takes = (begin < starts) & (starts < n)
            tile_in = torch.stack(
                [torch.where(takes, row, -1),
                 torch.where(takes, begin // tile,
                             torch.arange(tiles, device=dev))], 1
            ).to(torch.int32).contiguous()
            scratch = torch.empty(2 * tiles * d, dtype=dtype, device=dev)
            flags = torch.zeros(tiles, dtype=torch.int32, device=dev)
            args = _SegmentPlan(
                self.entries.data_ptr(), self.window_runs.data_ptr(),
                self.run_rows.data_ptr(), tile_in.data_ptr(),
                scratch.data_ptr(), flags.data_ptr(),
                n, self.num_rows, self.runs, self.window, slot_window,
                self.threads, lanes, tiles)
            self._launches[key] = SegmentLaunch(
                lanes=lanes, slot_window=slot_window, vec=vec, tile=tile,
                tiles=tiles, tile_in=tile_in, scratch=scratch, flags=flags,
                args=args)
        return self._launches[key]

    @property
    def launches_per_backward(self) -> int:
        """``segment_sum`` kernel launches of one backward on a CUDA
        tensor."""
        return 1

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x.index_select(0, idx)``, differentiable in ``x``."""
        if x.dim() < 1 or x.shape[0] != self.num_rows:
            raise ValueError(f"x must have {self.num_rows} rows, got "
                             f"{tuple(x.shape)}")
        return _Gather.apply(x, self)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        """``grad_x`` [num_rows, D] of the cotangent ``g`` [N, D]: one
        ``segment_sum`` launch on a CUDA tensor (none at D = 0),
        ``segment_sum_plain`` on a CPU tensor.  Under a profiler the call
        is the range ``<name>.backward``; without one it opens no range,
        which would cost more host time than the label lookup's kernel
        takes on the card."""
        if not torch._C._autograd._profiler_enabled():
            return segment_sum(g, self)
        with annotate(f"{self.name}.backward", g.device):
            return segment_sum(g, self)

    def backward_plain(self, g: torch.Tensor,
                       lanes: Optional[int] = None) -> torch.Tensor:
        """``backward`` as ``segment_sum_plain``, on any device; a column
        slice of a wider cotangent passes that width's ``lanes``."""
        return segment_sum_plain(g.contiguous(), self.perm, self.offsets,
                                 self.window, self.threads, lanes)


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.shape = plan, x.shape
        return x.index_select(0, plan.idx)

    @staticmethod
    def backward(ctx, g):
        # The width from the saved shape, not -1: an empty index (or a
        # row of no elements) leaves -1 nothing to infer from.
        rows = g.reshape(g.shape[0], math.prod(ctx.shape[1:])).contiguous()
        return ctx.plan.backward(rows).reshape(ctx.shape), None


class PlanCache:
    """A one-entry cache of the ``GatherRows`` plan for an index tensor:
    ``cache(key)`` returns the plan built for ``select(key)`` (``key``
    itself without ``select``), rebuilt only when handed another tensor
    or one changed in place since."""

    def __init__(self, num_rows: int, device, name: str,
                 select=None):
        self.num_rows, self.device, self.name = num_rows, device, name
        self.select = select
        self._key: Optional[torch.Tensor] = None
        self._version = -1
        self.plan: Optional[GatherRows] = None

    def __call__(self, key: torch.Tensor) -> GatherRows:
        if self._key is not key or self._version != key._version:
            idx = key if self.select is None else self.select(key)
            self.plan = GatherRows.build(idx, self.num_rows, self.device,
                                         name=self.name)
            self._key, self._version = key, key._version
        return self.plan
