"""Row gathers with a planned, scatter-free backward.

``GatherRows`` is ``x.index_select(0, idx)`` for an index ``idx`` [N]
into the ``R`` rows of ``x`` that is fixed before training starts (the
trainer's label lookup and path readout; gnnpe_tpu's ``jnp.take``).  Its
backward, ``grad_x[r] = Σ_{k: idx[k] = r} g[k]``, is not a scatter: the
plan holds the transposed index (``perm``, the stable argsort of
``idx``, and ``offsets``, its CSR row pointer), and the backward is the
segment sum ``out[r] = Σ_{j=offsets[r]}^{offsets[r+1]-1} g[perm[j]]``:
``segment_sum``, on a CUDA tensor one launch of csrc/segment_sum.cu, on a
CPU tensor ``segment_sum_plain``; any other device raises.

Why: torch's backward of ``x[idx]`` sorts the index and then, at a narrow
row, adds each index's duplicates one after another, so a row named 10^5
times (a frequent label) is a chain of 10^5 dependent adds; ``index_add_``
uses atomics, whose order changes from run to run.  The kernel splits the
sorted entries into tiles of ``WINDOW · THREADS`` and every tile into
windows of ``WINDOW``, one a thread, and adds in an order fixed by those
(csrc/segment_sum.cu: windows left to right, a row's window pieces left to
right within a tile, its tile pieces left to right by the block of its
last tile), so one hot row is spread over many blocks, the result is
deterministic and ``segment_sum_plain`` repeats it bit for bit.  What
bounds it on the card is bytes: the cotangent [N, D] and ``perm`` read
once, the gradient written once.  The plan holds what the kernel's order
needs beside the index: the row of each window's first entry, the first
row each tile owns (its empty rows are written 0.0 there), and the
scratch of the rows that cross tiles (a carry of D floats a tile, a flag
a tile and the counter the blocks take their tiles from), which every
launch leaves zeroed.

``WINDOW`` and ``THREADS`` were chosen with
``python -m gnnpe_tpu_torch.kernels.readout_sweep`` (the trainer's dblp
label and path plans, f32 D=2, windows 4-16 × 64-512 threads) on an
NVIDIA H100 80GB HBM3 at 700 W: (4, 256) took the least time on the card
alone for the two plans together, 0.0348 ms (labels 0.0096, paths
0.0251), (4, 128) 0.0362 and every window of 8 or 16 at least 0.0391.
By events a
call is bound by the host (the profiler range and the launch, 25-50 us),
which varies too much between points to rank them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from gnnpe_tpu_torch.kernels._build import pack_shape
from gnnpe_tpu_torch.utils.device import as_device
from gnnpe_tpu_torch.utils.profiling import annotate

__all__ = ["GatherRows", "PlanCache", "THREADS", "WINDOW", "segment_sum",
           "segment_sum_plain", "tile_layout"]

WINDOW = 4       # sorted entries a thread sums (4, 8 or 16)
THREADS = 256    # threads a block (a multiple of 32 up to 512)

LAUNCHES = 0


def tile_layout(offsets: np.ndarray, window: int = WINDOW,
                threads: int = THREADS) -> dict:
    """What the kernel's fixed order needs of the CSR ``offsets`` [R+1]
    of a transposed index, as int32 arrays: ``window_rows`` (the row of
    each window's first entry), ``tile_rows`` [tiles + 1] (the first row
    each tile owns: the rows whose first offset lies in it, the last tile
    also those at N; the last entry is R)."""
    if window not in (4, 8, 16):
        raise ValueError(f"window must be 4, 8 or 16, got {window}")
    if threads < 32 or threads > 512 or threads % 32:
        raise ValueError(f"threads must be a multiple of 32 up to 512, got "
                         f"{threads}")
    offsets = np.asarray(offsets, np.int64)
    n, rows = int(offsets[-1]), len(offsets) - 1
    tile = window * threads
    tiles = max(1, -(-n // tile))
    window_rows = np.searchsorted(offsets, np.arange(0, n, window),
                                  side="right") - 1
    tile_rows = np.append(np.searchsorted(offsets[:-1],
                                          np.arange(tiles) * tile), rows)
    return dict(window_rows=window_rows.astype(np.int32),
                tile_rows=tile_rows.astype(np.int32))


def _runs(start: torch.Tensor) -> tuple:
    """(group of each element, its place in the group) for a bool mask
    that marks each group's first element."""
    group = torch.cumsum(start.long(), 0) - 1
    heads = torch.nonzero(start).squeeze(1)
    return group, torch.arange(start.numel(), device=start.device) \
        - heads[group]


def segment_sum_plain(g: torch.Tensor, perm: torch.Tensor,
                      offsets: torch.Tensor, window: int = WINDOW,
                      threads: int = THREADS) -> torch.Tensor:
    """``out[r] = Σ_{j=offsets[r]}^{offsets[r+1]-1} g[perm[j]]`` in the
    kernel's order, vectorised over rows: (1) each row's run of a window
    of ``window`` sorted entries left to right from 0.0, (2) a row's
    window pieces left to right within a tile of ``window · threads``
    entries, (3) its tile pieces left to right in tile order.  The loops
    run over the slots of a window, the windows of a tile and the tiles a
    row spans."""
    if g.dim() != 2:
        raise ValueError(f"g must be 2-D, got {tuple(g.shape)}")
    rows, n = offsets.numel() - 1, perm.numel()
    out = torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device)
    if n == 0:
        return out
    offsets = offsets.long()
    key = torch.repeat_interleave(torch.arange(rows, device=g.device),
                                  offsets[1:] - offsets[:-1])
    vals = g[perm.long()]
    pos = torch.arange(n, device=g.device)
    win, tile = pos // window, pos // (window * threads)
    new = torch.ones(n, dtype=torch.bool, device=g.device)

    # (1) A row's run in a window, slot by slot.
    new[1:] = (key[1:] != key[:-1]) | (win[1:] != win[:-1])
    piece, _ = _runs(new)
    pieces = torch.zeros((int(piece[-1]) + 1, g.shape[1]), dtype=g.dtype,
                         device=g.device)
    for slot in range(window):
        at = pos % window == slot
        ids = piece[at]
        pieces[ids] = pieces[ids] + vals[at]

    # (2) A row's window pieces within a tile, window by window.
    first = torch.nonzero(new).squeeze(1)
    p_key, p_tile = key[first], tile[first]
    new_t = torch.ones(len(first), dtype=torch.bool, device=g.device)
    new_t[1:] = (p_key[1:] != p_key[:-1]) | (p_tile[1:] != p_tile[:-1])
    group, place = _runs(new_t)
    tiled = torch.zeros((int(group[-1]) + 1, g.shape[1]), dtype=g.dtype,
                        device=g.device)
    for k in range(int(place.max()) + 1):
        at = place == k
        ids = group[at]
        tiled[ids] = tiled[ids] + pieces[at]

    # (3) A row's tile pieces, tile by tile.
    t_key = p_key[new_t]
    new_r = torch.ones(len(t_key), dtype=torch.bool, device=g.device)
    new_r[1:] = t_key[1:] != t_key[:-1]
    _, place = _runs(new_r)
    for k in range(int(place.max()) + 1):
        at = place == k
        ids = t_key[at]
        out[ids] = out[ids] + tiled[at]
    return out


class _SegmentPlan(ctypes.Structure):
    """csrc/segment_sum.cu's SegmentPlan: the plan's pointers and sizes,
    handed to the kernel as one argument."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "perm", "offsets", "window_rows", "tile_rows", "carry", "flags",
        "counter")] + [("n", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("rows", "window", "threads",
                                          "tiles")]


_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        from gnnpe_tpu_torch.kernels._build import load
        _KERNEL = load("segment_sum").gnnpe_segment_sum_f32
    return _KERNEL


def segment_sum(g: torch.Tensor, plan: "GatherRows") -> torch.Tensor:
    """The segment sum of the cotangent ``g`` [N, D] over ``plan``'s
    transposed index: one launch of csrc/segment_sum.cu on a CUDA tensor
    (f32), ``segment_sum_plain`` on a CPU tensor; any other device
    raises.  The output is allocated with ``torch.empty``: the kernel
    writes every row."""
    global LAUNCHES
    n = plan.perm.numel()
    if g.dim() != 2 or g.shape[0] != n:
        raise ValueError(f"g must be [{n}, D], got {tuple(g.shape)}")
    if not g.dtype.is_floating_point:
        raise TypeError(f"g must be a floating tensor, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if g.device != plan.perm.device:
        raise ValueError(f"g is on {g.device}, the plan on "
                         f"{plan.perm.device}")
    if g.device.type == "cpu":
        return segment_sum_plain(g, plan.perm, plan.offsets, plan.window,
                                 plan.threads)
    if g.device.type != "cuda":
        raise ValueError(f"no segment_sum kernel for device {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"the segment_sum kernel takes float32, got "
                        f"{g.dtype}")
    d = g.shape[1]
    if n * d >= 2 ** 31 or not 0 < d < 4096:
        raise ValueError(f"the segment_sum kernel takes 0 < D < 4096 and "
                         f"N·D < 2^31, got N={n}, D={d}")
    out = torch.empty((plan.num_rows, d), dtype=g.dtype, device=g.device)
    args = plan.kernel_args(d)
    vec, _ = pack_shape(d, 4, g.data_ptr(), out.data_ptr())
    err = _kernel()(g.device.index, ctypes.addressof(args), g.data_ptr(),
                    out.data_ptr(), d, vec,
                    torch._C._cuda_getCurrentRawStream(g.device.index))
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


@dataclass
class GatherRows:
    """The plan of one fixed gather: ``idx`` int64 [N] on the device, the
    ``num_rows`` rows it reads from, and its transposed index for the
    backward: ``perm`` (int32, the stable argsort of ``idx``),
    ``offsets`` (int32 [num_rows + 1]), ``tile_layout``'s
    ``window_rows`` and ``tile_rows`` for the tiles of ``window ·
    threads`` entries, and the scratch of the rows that cross tiles:
    ``flags`` (int32, one a tile) and ``counter`` (int32 [1]), zeroed and
    left zeroed by every launch, and ``carry`` (f32, D a tile, allocated
    by the first backward on a card of that D).  ``name`` labels its
    backward in profiler timelines (``<name>.backward``)."""
    idx: torch.Tensor
    num_rows: int
    perm: torch.Tensor
    offsets: torch.Tensor
    window_rows: torch.Tensor
    tile_rows: torch.Tensor
    flags: torch.Tensor
    counter: torch.Tensor
    window: int = WINDOW
    threads: int = THREADS
    name: str = "gather_rows"
    carry: Optional[torch.Tensor] = field(default=None, repr=False)
    _args: Optional[_SegmentPlan] = field(default=None, repr=False)

    @classmethod
    def build(cls, idx, num_rows: int, device, window: int = WINDOW,
              threads: int = THREADS,
              name: str = "gather_rows") -> "GatherRows":
        """Plan the gather of ``idx`` (any integer array or tensor, read
        flat) into ``num_rows`` rows, built once on the host and uploaded
        to ``device``."""
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
        order = np.argsort(idx, kind="stable")
        offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(idx, minlength=num_rows))])
        tiles = tile_layout(offsets, window, threads)
        device = as_device(device)
        up = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device)
        return cls(idx=torch.from_numpy(idx).to(device), num_rows=num_rows,
                   perm=up(order), offsets=up(offsets),
                   window_rows=up(tiles["window_rows"]),
                   tile_rows=up(tiles["tile_rows"]),
                   flags=torch.zeros(len(tiles["tile_rows"]) - 1,
                                     dtype=torch.int32, device=device),
                   counter=torch.zeros(1, dtype=torch.int32, device=device),
                   window=window, threads=threads, name=name)

    @property
    def tiles(self) -> int:
        return self.flags.numel()

    def kernel_args(self, d: int) -> _SegmentPlan:
        """The kernel's plan struct for cotangents of width ``d``, made
        once (and again when a wider ``d`` needs a larger carry)."""
        if self.carry is None or self.carry.numel() < self.tiles * d:
            self.carry = torch.empty(self.tiles * d, dtype=torch.float32,
                                     device=self.perm.device)
            self._args = None
        if self._args is None:
            self._args = _SegmentPlan(
                self.perm.data_ptr(), self.offsets.data_ptr(),
                self.window_rows.data_ptr(), self.tile_rows.data_ptr(),
                self.carry.data_ptr(), self.flags.data_ptr(),
                self.counter.data_ptr(), self.perm.numel(), self.num_rows,
                self.window, self.threads, self.tiles)
        return self._args

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
        ``segment_sum`` launch on a CUDA tensor, ``segment_sum_plain`` on
        a CPU tensor."""
        with annotate(f"{self.name}.backward", g.device):
            return segment_sum(g, self)

    def backward_plain(self, g: torch.Tensor) -> torch.Tensor:
        """``backward`` as ``segment_sum_plain``, on any device."""
        return segment_sum_plain(g.contiguous(), self.perm, self.offsets,
                                 self.window, self.threads)


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.shape = plan, x.shape
        return x.index_select(0, plan.idx)

    @staticmethod
    def backward(ctx, g):
        rows = g.reshape(g.shape[0], -1).contiguous()
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
