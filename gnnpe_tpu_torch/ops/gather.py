"""Row gathers with a planned, scatter-free backward.

``GatherRows`` is ``x.index_select(0, idx)`` for an index ``idx`` [N]
into the ``R`` rows of ``x`` that is fixed before training starts (the
trainer's label lookup and path readout; gnnpe_tpu's ``jnp.take``).  Its
backward, ``grad_x[r] = Σ_{k: idx[k] = r} g[k]``, is not a scatter: the
plan holds the transposed index as a rectangular uniform-width ELL
(``ops/ell.py:build_ell`` over a CSR with one row per row of ``x``, whose
entries are the positions ``k`` with ``idx[k] = r`` in ascending order),
and the backward walks it with ``HierarchicalEllDevice.walk``: on a CUDA
tensor one launch of kernel A2 (csrc/ell_gather_sum.cu, which replaces
``experiments/pallas_blocked_spmm.py:106``) a level, on a CPU tensor the
masked plain form; any other device raises.

Why: torch's backward of ``x[idx]`` sorts the index and then, at a narrow
row, adds each index's duplicates one after another, so a row named 10^5
times (a frequent label) is a chain of 10^5 dependent adds.  The layout
cuts every row into chunks of at most ``width`` entries and folds the
chunk rows in further levels of ``level2_width`` slots, so the longest
chain is ``width + level2_width·(levels − 2)`` adds and every level is
one wide launch.  What bounds it on the card is bytes: the cotangent
[N, D] read once (and copied once beside a zero row for the pads), each
level's table read once and its rows written once.  Rows that no entry
names get one all-pad chunk and sum to 0.0.  A2 adds a row's slots in
ascending order from 0.0, as the masked plain form does, so on the card
the two are bit-equal and the gradient is deterministic.

``WIDTH`` and ``LEVEL2_WIDTH`` were chosen with
``python -m gnnpe_tpu_torch.kernels.readout_sweep`` (the trainer's dblp
label and path plans, f32 D=2, over widths 4-32 and 2-16) on an NVIDIA
H100 80GB HBM3 at 700 W: (8, 8) took the least time on the card alone
for the two plans together, 0.0741 ms (6 + 4 launches), and (4, 8) was
within 0.5 % of it; narrower second levels add launches, wider ones
pads.  By events the backward is bound by the host's launches (about
20 us each), which vary too much between points to rank them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gnnpe_tpu_torch.ops.ell import HierarchicalEllDevice, build_ell
from gnnpe_tpu_torch.utils.device import as_device
from gnnpe_tpu_torch.utils.profiling import annotate

__all__ = ["GatherRows", "LEVEL2_WIDTH", "PlanCache", "WIDTH"]

WIDTH = 8
LEVEL2_WIDTH = 8


@dataclass
class GatherRows:
    """The plan of one fixed gather: ``idx`` int64 [N] on the device, the
    ``num_rows`` rows it reads from, and ``back``, the transposed index as
    a rectangular uniform-width ELL (N source rows → ``num_rows`` rows).
    ``name`` labels its backward in profiler timelines
    (``<name>.backward``)."""
    idx: torch.Tensor
    num_rows: int
    back: HierarchicalEllDevice
    name: str = "gather_rows"

    @classmethod
    def build(cls, idx, num_rows: int, device, width: int = WIDTH,
              level2_width: int = LEVEL2_WIDTH,
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
        order = np.argsort(idx, kind="stable")
        offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(idx, minlength=num_rows))])
        layout = build_ell(offsets, order, width, level2_width,
                           num_sources=len(idx))
        device = as_device(device)
        return cls(idx=torch.from_numpy(idx).to(device), num_rows=num_rows,
                   back=layout.on(device), name=name)

    @property
    def launches_per_backward(self) -> int:
        """Kernel A2 launches of one backward on a CUDA tensor."""
        return self.back.launches_per_apply

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x.index_select(0, idx)``, differentiable in ``x``."""
        if x.dim() < 1 or x.shape[0] != self.num_rows:
            raise ValueError(f"x must have {self.num_rows} rows, got "
                             f"{tuple(x.shape)}")
        return _Gather.apply(x, self)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        """``grad_x`` [num_rows, D] of the cotangent ``g`` [N, D]: one A2
        launch a level on a CUDA tensor, the masked plain form on a CPU
        tensor."""
        with annotate(f"{self.name}.backward", g.device):
            return self.back.apply(g)

    def backward_plain(self, g: torch.Tensor) -> torch.Tensor:
        """``backward`` in the masked plain form, on any device."""
        return self.back.apply_plain(g.contiguous())


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.shape = plan, x.shape
        return x.index_select(0, plan.idx)

    @staticmethod
    def backward(ctx, g):
        rows = g.reshape(g.shape[0], -1)
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
