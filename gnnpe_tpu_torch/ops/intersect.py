"""Sorted-set intersection and bitset operations (counterpart of
gnnpe_tpu/ops/intersect.py).

The host (numpy) forms are the port's own copies of gnnpe_tpu's.  The
device forms are torch, on any device:
  * the merge intersection as one ``searchsorted`` wave with valid
    masks, no data-dependent loop;
  * bitsets: a vertex set over [0, V) packs into ceil(V/32) 32-bit
    words, gnnpe_tpu's ``uint32`` layout.  torch's ``uint32`` has few
    kernels (no shifts or popcount on most devices), so the device forms
    take the words as ``int32`` (a numpy ``uint32`` array or a torch
    ``uint32`` tensor is reinterpreted bit for bit), widen them to
    ``int64`` and count bits with the SWAR popcount; every result equals
    gnnpe_tpu's ``uint32`` one.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GALLOP_RATIO", "array_and_bitset", "bitset_and", "bitset_count",
           "bitset_from_ids", "bitset_to_ids", "intersect_auto_np",
           "intersect_count_np", "intersect_mask", "intersect_sorted_device",
           "intersect_sorted_np"]


# ---------------------------------------------------------------------
# Host (numpy) forms — exact, used by the refinement path.

def intersect_sorted_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two sorted unique int arrays (galloping
    equivalent: np.intersect1d with assume_unique)."""
    return np.intersect1d(a, b, assume_unique=True)


def intersect_count_np(a: np.ndarray, b: np.ndarray) -> int:
    if len(a) > len(b):
        a, b = b, a
    idx = np.searchsorted(b, a)
    idx = np.minimum(idx, len(b) - 1) if len(b) else idx
    return int((len(b) > 0) and (b[idx] == a).sum())


def bitset_from_ids(ids: np.ndarray, num_vertices: int) -> np.ndarray:
    """Host: pack a vertex id set into uint32[ceil(V/32)]."""
    words = -(-num_vertices // 32)
    out = np.zeros(words, dtype=np.uint32)
    ids = np.asarray(ids, dtype=np.int64)
    np.bitwise_or.at(out, ids // 32,
                     (np.uint32(1) << (ids % 32).astype(np.uint32)))
    return out


def bitset_to_ids(bits: np.ndarray) -> np.ndarray:
    """Host: unpack to sorted vertex ids."""
    mat = ((bits[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
           & 1).astype(bool)
    word, bit = np.nonzero(mat)
    return np.sort(word * 32 + bit).astype(np.int64)


GALLOP_RATIO = 32      # |b|/|a| beyond which searchsorted beats merge


def intersect_auto_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host hybrid: galloping via searchsorted when skewed, merge
    otherwise — same contract either way."""
    if len(a) > len(b):
        a, b = b, a
    if len(a) == 0:
        return a.copy()
    if len(b) >= GALLOP_RATIO * len(a):
        idx = np.searchsorted(b, a)
        idx = np.minimum(idx, len(b) - 1)
        return a[b[idx] == a]
    return np.intersect1d(a, b, assume_unique=True)


# ---------------------------------------------------------------------
# Device (torch) forms — static shapes, mask semantics.

def intersect_mask(a: torch.Tensor, a_valid: torch.Tensor, b: torch.Tensor,
                   b_valid: torch.Tensor) -> torch.Tensor:
    """For each element of ``a``, is it present in the sorted set ``b``?

    a: int[N] padded, a_valid: bool[N]; b: int[M] SORTED and padded
    (pad with INT32_MAX so the order holds), b_valid: bool[M].  Returns
    the bool[N] membership mask, one searchsorted wave."""
    m = b.shape[0]
    if m == 0:
        return torch.zeros_like(a_valid)
    idx = torch.searchsorted(b, a.to(b.dtype)).clamp(max=m - 1)
    return (b[idx] == a) & b_valid[idx] & a_valid


def intersect_sorted_device(a: torch.Tensor, a_valid: torch.Tensor,
                            b: torch.Tensor, b_valid: torch.Tensor):
    """Sorted-set intersection with the static output shape [N]:
    (values int[N], valid bool[N]) — the elements of ``a`` found in
    ``b``, moved to the front in their order (a stable sort on
    "not found")."""
    hit = intersect_mask(a, a_valid, b, b_valid)
    order = torch.argsort((~hit).to(torch.int8), stable=True)
    return a[order], hit[order]


def _words(bits) -> torch.Tensor:
    """The 32-bit words of a bitset as non-negative int64 values."""
    if isinstance(bits, np.ndarray):
        bits = torch.from_numpy(np.ascontiguousarray(bits).view(np.int32))
    elif bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    return bits.to(torch.int64) & 0xFFFFFFFF


def bitset_and(a, b):
    """Intersection of packed sets (numpy arrays or tensors alike)."""
    return a & b


def bitset_count(bits) -> torch.Tensor:
    """Popcount over the packed set: the SWAR bit count on int64 words
    (a 0-dim int64 tensor on the words' device)."""
    v = _words(bits)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).sum()


def array_and_bitset(ids: torch.Tensor, ids_valid: torch.Tensor,
                     bits) -> torch.Tensor:
    """Membership of each valid id in a packed set, as a bool mask (the
    reference's intersectArrayBitset form)."""
    words = _words(bits).to(ids.device)
    ids = torch.where(ids_valid, ids, torch.zeros_like(ids)).long()
    return (((words[ids // 32] >> (ids % 32)) & 1) == 1) & ids_valid
