"""Degree-binned ELL aggregation: scatter-free neighbour sums, forward
and backward (counterpart of gnnpe_tpu/ops/ell.py's ``BinnedEll``).

The host layout (``build_binned_ell``, the ``BinnedEll`` tables) is
gnnpe_tpu's numpy builder, re-exported.  ``BinnedEllDevice`` uploads it
once and aggregates in the permuted vertex space with ``gather_sum``:
the hand-written CUDA kernel (csrc/ell_gather_sum.cu) for a CUDA tensor,
``gather_sum_plain`` for a CPU tensor; any other device raises.  Both
add a row's slots in ascending order from 0.0 and subtract the pad
correction as a separate multiply and subtract, so on the card they are
bit-equal.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from gnnpe_tpu.ops import ell as _host
from gnnpe_tpu.ops.ell import DEFAULT_WIDTHS, BinnedEll
from gnnpe_tpu.utils.device_probe import _table_lookup
from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["BinnedEll", "BinnedEllDevice", "DEFAULT_WIDTHS", "LAUNCHES",
           "binned_aggregate", "build_binned_ell", "gather_sum",
           "gather_sum_plain", "symmetric_aggregate"]

LAUNCHES = 0

# The port has no device probe.  gnnpe_tpu prices hub columns with
# utils/device_probe.device_constants(), which imports JAX and falls
# back to the table's "cpu" row where that import fails, as it does on
# the card.  The port pins that row, so it builds the same layout on
# every machine and never imports JAX.
HUB_PRICES = _table_lookup("cpu")
_HUB_PRICES_LOCK = threading.Lock()


def build_binned_ell(offsets: np.ndarray, neighbors: np.ndarray,
                     **kwargs) -> BinnedEll:
    """gnnpe_tpu's ``build_binned_ell`` (same arguments), with hubs
    priced by ``HUB_PRICES``."""
    with _HUB_PRICES_LOCK:
        saved = _host._device_constants
        _host._device_constants = lambda: HUB_PRICES
        try:
            return _host.build_binned_ell(offsets, neighbors, **kwargs)
        finally:
            _host._device_constants = saved


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


def gather_sum(buf: torch.Tensor, tbl: torch.Tensor,
               padcnt: Optional[torch.Tensor],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = Σ_k buf[tbl[i, k]] − padcnt[i]·buf[0]`` for a row-major
    f32 ``buf`` [R, D], an int32 ``tbl`` [N, W] with entries in [0, R)
    (pads point at row 0; ``BinnedEllDevice.from_host`` checks the
    bounds once) and an f32 ``padcnt`` [N] or None.  ``out``, when
    given, is a contiguous [N, D] row range of a larger output."""
    global LAUNCHES
    _check(buf, tbl, padcnt, out)
    if buf.device.type == "cpu":
        return gather_sum_plain(buf, tbl, padcnt, out)
    if buf.device.type != "cuda":
        raise ValueError(f"no gather_sum kernel for device {buf.device}")
    if out is None:
        out = torch.empty((tbl.shape[0], buf.shape[1]), dtype=buf.dtype,
                          device=buf.device)
    if out.numel():
        from gnnpe_tpu_torch.kernels._build import load
        fn = load("ell_gather_sum").gnnpe_ell_gather_sum_f32
        err = fn(buf.device.index, tbl.data_ptr(),
                 None if padcnt is None else padcnt.data_ptr(),
                 buf.data_ptr(), out.data_ptr(), tbl.shape[0], tbl.shape[1],
                 buf.shape[1],
                 torch.cuda.current_stream(buf.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ell_gather_sum launch failed: CUDA error "
                               f"{err}")
        LAUNCHES += 1
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


Table = Tuple[torch.Tensor, Optional[torch.Tensor]]


@dataclass
class BinnedEllDevice:
    """A ``BinnedEll`` uploaded to one device.

    ``apply_perm(h_perm)`` aggregates in the permuted vertex space
    (``h_perm[i] = x[perm[i]]``): the head chain through every fold
    level, then each width class into its contiguous row range, plus the
    hub product.  ``apply(x)`` adds the boundary permutes."""
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

    @classmethod
    def from_host(cls, layout: BinnedEll, device) -> "BinnedEllDevice":
        """Upload ``layout`` once; checks every table's indices against
        the rows it gathers from."""
        device = as_device(device)

        def table(tbl, pc, rows):
            if tbl.size and (tbl.min() < 0 or tbl.max() >= rows):
                raise ValueError(f"table indices outside [0, {rows})")
            return (torch.from_numpy(np.ascontiguousarray(
                        tbl, dtype=np.int32)).to(device),
                    None if pc is None else torch.from_numpy(
                        np.asarray(pc, dtype=np.float32)).to(device))

        v = layout.num_vertices
        head, rows = [], v
        for tbl, pc in zip(layout.head_tables, layout.head_padcnt):
            head.append(table(tbl, pc, rows))
            rows = tbl.shape[0]
        classes = [table(t, pc, v) for t, pc in zip(layout.class_tables,
                                                     layout.class_padcnt)]
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

    def _hub_part(self, h_perm: torch.Tensor) -> torch.Tensor:
        """``B @ h_perm[hubs]`` with JAX's precision per mode: "f32" is
        one f32 product; "bf16" and "hi_lo" take the bf16-rounded hi
        (and lo) parts, each multiplied in f32 — JAX's bf16 dot with
        preferred_element_type=f32."""
        xh = h_perm[self.hub_rows]
        with _full_f32_matmul():
            if self.hub_precision == "f32":
                return self.hub_counts @ xh
            hi = xh.to(torch.bfloat16)
            out = self.hub_counts @ hi.float()
            if self.hub_precision == "hi_lo":
                lo = (xh - hi.float()).to(torch.bfloat16)
                out = out + self.hub_counts @ lo.float()
        return out

    def apply_perm(self, h_perm: torch.Tensor,
                   gather=gather_sum) -> torch.Tensor:
        """Aggregated [V, D] in the permuted space.  ``gather`` is the
        per-table gather-sum; ``gather_sum_plain`` gives the plain
        version on any device (the kernel check compares the two)."""
        if h_perm.shape[0] != self.num_vertices:
            raise ValueError(f"h_perm has {h_perm.shape[0]} rows for "
                             f"{self.num_vertices} vertices")
        h_perm = h_perm.contiguous()
        out = torch.empty(h_perm.shape, dtype=h_perm.dtype,
                          device=h_perm.device)
        if self.num_head:
            cur = h_perm
            for tbl, pc in self.head[:-1]:
                cur = gather(cur, tbl, pc)
            gather(cur, *self.head[-1], out=out[:self.num_head])
        lo = self.num_head
        for tbl, pc in self.classes:
            gather(h_perm, tbl, pc, out=out[lo:lo + tbl.shape[0]])
            lo += tbl.shape[0]
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
