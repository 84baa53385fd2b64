"""CSR neighbour-sum SpMM, ``nx[v] = Σ_{u∈N(v)} x[u]`` — the whole
"GNN" of the exact query (one fixed hop, gnnpe_tpu/ops/spmm.py).

``neighbor_sum`` launches the hand-written CUDA kernel
(csrc/spmm_csr.cu) for a CUDA tensor and runs ``neighbor_sum_plain``
for a CPU tensor; any other device raises.  Both add strictly left to
right in ascending neighbour order from 0.0, as the host reference
``neighbor_sum_np`` does, so their f64 results are bit-equal to it.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnpe_tpu_torch.kernels._build import pack_shape

LAUNCHES = 0

# What the launch is shaped by, measured on an H100 at the dblp rung
# (kernels/compare_gather.py --sweep).  Read at call time.
# A row gets at least this many lanes where its width allows: two 8-byte
# lanes beat one 16-byte lane at the VDE's f64 D=2.
MIN_LANES = 2
# Rows of at most this many lanes are "narrow": their warps' units are
# dealt round-robin over the blocks, and rows with more than LONG_ROWS
# neighbours are queued for a whole warp (csrc/spmm_csr.cu, "the degree
# tail"); wider rows measured slower with either.  A negative LONG_ROWS
# turns the queue off; the choice changes the schedule, never a sum.
NARROW_LANES = 2
LONG_ROWS = 64

_KERNELS = {torch.float64: "gnnpe_spmm_csr_f64",
            torch.float32: "gnnpe_spmm_csr_f32"}


# The host f64 reference (the port's copy of gnnpe_tpu/ops/spmm.py's).
def neighbor_sum_np(offsets: np.ndarray, neighbors: np.ndarray,
                    x: np.ndarray) -> np.ndarray:
    """nx[v] = Σ_{u∈N(v)} x[u] in float64 on host.

    Matches the reference accumulation order (custom.h:523-534): ascending
    neighbor order per row (rows are sorted), left-to-right summation —
    np.add.reduceat reduces in index order, so sums are bit-identical.
    """
    x = np.asarray(x, dtype=np.float64)
    gathered = x[neighbors]
    deg = np.diff(offsets).astype(np.int64)
    out = np.zeros((len(deg), x.shape[1]), dtype=np.float64)
    if len(neighbors) == 0:
        return out
    # Strictly left-to-right accumulation per row, vectorized across
    # rows: iterate the neighbor *position*, adding the j-th neighbor of
    # every row that has one.  (np.add.reduceat / np.sum use pairwise
    # summation, which drifts from the reference by ulps at degree ≥ ~10.)
    starts = offsets[:-1].astype(np.int64)
    max_deg = int(deg.max())
    active = np.nonzero(deg > 0)[0]
    for j in range(max_deg):
        if j > 0:
            active = active[deg[active] > j]
        out[active] += gathered[starts[active] + j]
    return out


def neighbor_sum_plain(offsets: torch.Tensor, neighbors: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the position loop of ``neighbor_sum_np``
    on tensors — step j adds the j-th neighbour of every row that has
    one.  (index_add_/scatter_add_ do not fix the summation order.)"""
    deg = (offsets[1:] - offsets[:-1]).long()
    out = torch.zeros((deg.numel(), x.shape[1]), dtype=x.dtype,
                      device=x.device)
    if neighbors.numel() == 0:
        return out
    starts = offsets[:-1].long()
    active = torch.nonzero(deg > 0).squeeze(1)
    for j in range(int(deg.max())):
        if j > 0:
            active = active[deg[active] > j]
        out[active] += x[neighbors[starts[active] + j].long()]
    return out


def _check(offsets, neighbors, x):
    for name, t in (("offsets", offsets), ("neighbors", neighbors)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{t.dtype} with {t.dim()} dims")
    if x.dtype not in _KERNELS or x.dim() != 2:
        raise TypeError(f"x must be a 2-D float32/float64 tensor, got "
                        f"{x.dtype} with {x.dim()} dims")
    if offsets.numel() != x.shape[0] + 1:
        raise ValueError(f"offsets has {offsets.numel()} entries for "
                         f"{x.shape[0]} rows of x")
    for name, t in (("offsets", offsets), ("neighbors", neighbors),
                    ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def neighbor_sum(offsets: torch.Tensor, neighbors: torch.Tensor,
                 x: torch.Tensor, with_vde: bool = False):
    """nx (and, with ``with_vde``, the pair (nx, x + nx)) for int32 CSR
    ``offsets``/``neighbors`` and a row-major f32/f64 ``x`` [V, D]."""
    global LAUNCHES
    _check(offsets, neighbors, x)
    if x.device.type == "cpu":
        nx = neighbor_sum_plain(offsets, neighbors, x)
        return (nx, x + nx) if with_vde else nx
    if x.device.type != "cuda":
        raise ValueError(f"no neighbor_sum kernel for device {x.device}")
    nx = torch.empty_like(x)
    vde = torch.empty_like(x) if with_vde else None
    if x.numel():
        from gnnpe_tpu_torch.kernels._build import load
        fn = getattr(load("spmm_csr"), _KERNELS[x.dtype])
        vec, lanes = pack_shape(
            x.shape[1], x.element_size(), x.data_ptr(), nx.data_ptr(),
            *([vde.data_ptr()] if with_vde else []), min_lanes=MIN_LANES)
        narrow = lanes <= NARROW_LANES
        err = fn(x.device.index, offsets.data_ptr(),
                 neighbors.data_ptr(), x.data_ptr(), nx.data_ptr(),
                 vde.data_ptr() if with_vde else None, x.shape[0],
                 x.shape[1], vec, lanes,
                 LONG_ROWS if narrow else -1, int(narrow),
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"spmm_csr launch failed: CUDA error {err}")
        LAUNCHES += 1
    return (nx, vde) if with_vde else nx


class NeighborSum(torch.autograd.Function):
    """``neighbor_sum`` as a differentiable op (f32 or f64) — the port of
    gnnpe_tpu's ``aggregation="segment"`` under ``jax.grad``.  The
    adjacency is symmetric, so the cotangent's pullback is the same
    neighbour sum: the backward launches the same kernel.

    Use as ``NeighborSum.apply(offsets, neighbors, x)``."""

    @staticmethod
    def forward(ctx, offsets, neighbors, x):
        ctx.save_for_backward(offsets, neighbors)
        return neighbor_sum(offsets, neighbors, x)

    @staticmethod
    def backward(ctx, g):
        offsets, neighbors = ctx.saved_tensors
        return None, None, neighbor_sum(offsets, neighbors, g.contiguous())
