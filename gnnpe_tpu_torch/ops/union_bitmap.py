"""The index search's candidate union as a bit-packed bitmap: one row of
``ceil(V / 32)`` 32-bit words per output row (a query vertex), bit
``v & 31`` of word ``v >> 5`` set where vertex ``v`` is a candidate.

``scatter`` ORs one phase-2 chunk's hits into the words, and ``compact``
turns the words into each row's sorted vertex ids.  On a CUDA tensor each
launches the hand-written kernels of csrc/union_bitmap.cu; on a CPU tensor
each runs its plain version (``scatter_plain``, ``compact_plain``), which
builds a bool bitmap, packs it into the same words and compacts with
``nonzero``.  Any other device raises.  The words are int32 tensors read
as unsigned by the kernels.  ``unite`` is every search's finish: the
words OR-ed over the ranks of a sharded search, then compacted and split
into one list a row.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.parallel.collectives import or_words_

LAUNCHES = 0

# The compaction cuts each row into segments of this many words, one
# thread block a (row, segment); passed to both of its entry points.
SEG_WORDS = 4096

_BITS = torch.arange(8, dtype=torch.uint8)


def row_words(num_vertices: int) -> int:
    return -(-num_vertices // 32)


def new_words(rows: int, num_vertices: int, device) -> torch.Tensor:
    """An empty bitmap: int32 [rows, ceil(num_vertices / 32)] zeros."""
    return torch.zeros((rows, row_words(num_vertices)), dtype=torch.int32,
                       device=device)


# ``pack`` and ``unpack`` go through the words' bytes in memory order,
# which is the bits' order on a little-endian host, as the CPUs and the
# card the port runs on are.

def pack(bits: torch.Tensor) -> torch.Tensor:
    """bool [R, 32·W] → its int32 [R, W] words (bit k of word w is column
    32·w + k)."""
    r = bits.shape[0]
    b = bits.reshape(r, -1, 8).to(torch.uint8) << _BITS.to(bits.device)
    return b.sum(-1, dtype=torch.uint8).view(torch.int32)


def unpack(words: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """int32 [R, W] words → bool [R, num_vertices]."""
    r = words.shape[0]
    b = (words.view(torch.uint8)[..., None] >> _BITS.to(words.device)) & 1
    return b.reshape(r, -1)[:, :num_vertices].bool()


def _check_scatter(words, num_vertices, mask, gate, vids, out_ids, hits):
    rows, cols = mask.shape
    for name, t, dtype, dim in (("mask", mask, torch.bool, 2),
                                ("gate", gate, torch.bool, 2),
                                ("vids", vids, torch.int32, 2),
                                ("out_ids", out_ids, torch.int32, 2),
                                ("words", words, torch.int32, 2),
                                ("hits", hits, torch.int64, 1)):
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f"{name} must be a {dim}-D {dtype} tensor, got "
                            f"{t.dtype} with {t.dim()} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on "
                             f"{words.device}")
    k = gate.shape[1]
    if gate.shape[0] != rows or (cols % k if k else cols):
        raise ValueError(f"gate {tuple(gate.shape)} does not cut mask "
                         f"{tuple(mask.shape)} into whole blocks")
    if vids.shape[0] != cols or out_ids.shape != (rows, vids.shape[1]):
        raise ValueError(f"vids {tuple(vids.shape)} and out_ids "
                         f"{tuple(out_ids.shape)} do not match mask "
                         f"{tuple(mask.shape)}")
    if words.shape[1] != row_words(num_vertices) or hits.numel() != 1:
        raise ValueError(f"words {tuple(words.shape)} are not a bitmap of "
                         f"{num_vertices} vertices, or hits has "
                         f"{hits.numel()} entries")


def scatter_plain(words, num_vertices, mask, gate, vids, out_ids,
                  hits) -> None:
    """Plain PyTorch version of ``scatter``: the gated hits in a bool
    bitmap, packed and OR-ed into ``words``."""
    rows, cols = mask.shape
    if cols == 0 or rows == 0:
        return
    m = mask & gate.repeat_interleave(cols // gate.shape[1], dim=1)
    hits += m.any(0).sum()
    qi, col = torch.nonzero(m, as_tuple=True)
    o = out_ids[qi].reshape(-1).long()
    v = vids[col].reshape(-1).long()
    keep = (o >= 0) & (o < words.shape[0]) & (v >= 0) & (v < num_vertices)
    bits = torch.zeros((words.shape[0], 32 * words.shape[1]),
                       dtype=torch.bool, device=words.device)
    bits[o[keep], v[keep]] = True
    words |= pack(bits)


def scatter(words: torch.Tensor, num_vertices: int, mask: torch.Tensor,
            gate: torch.Tensor, vids: torch.Tensor, out_ids: torch.Tensor,
            hits: torch.Tensor) -> None:
    """OR one phase-2 chunk's hits into ``words`` (int32 [nq, W], a
    bitmap of ``num_vertices`` vertices), in place and without waiting.

    mask: bool [Q, K·B], the chunk's leaf test; gate: bool [Q, K], its
    per-(row, block) survival, applied here; vids: int32 [K·B, L'], each
    column's vertex ids; out_ids: int32 [Q, L'], the output row of each
    row's position.  A hit (q, c) sets vertex ``vids[c, j]`` in row
    ``out_ids[q, j]`` for every j; ids outside the bitmap are skipped.
    hits: int64 [1] on the same device, to which the columns with any
    hit are added."""
    global LAUNCHES
    _check_scatter(words, num_vertices, mask, gate, vids, out_ids, hits)
    if words.device.type == "cpu":
        return scatter_plain(words, num_vertices, mask, gate, vids, out_ids,
                             hits)
    if words.device.type != "cuda":
        raise ValueError(f"no union kernel for device {words.device}")
    rows, cols = mask.shape
    if rows == 0 or cols == 0:
        return
    from gnnpe_tpu_torch.kernels._build import load
    err = load("union_bitmap").gnnpe_union_scatter(
        words.device.index, mask.data_ptr(), gate.data_ptr(),
        vids.data_ptr(), out_ids.data_ptr(), words.data_ptr(),
        hits.data_ptr(), cols, rows, cols // gate.shape[1], gate.shape[1],
        vids.shape[1], words.shape[0], num_vertices, words.shape[1],
        torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"union scatter launch failed: CUDA error {err}")
    LAUNCHES += 1


def compact_plain(words: torch.Tensor,
                  num_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain PyTorch version of ``compact``."""
    bits = unpack(words, num_vertices)
    counts = bits.sum(1)
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int64)
    torch.cumsum(counts, 0, out=offsets[1:])
    ids = torch.nonzero(bits)[:, 1].to(torch.int32)
    return offsets.numpy(), ids.numpy()


def compact(words: torch.Tensor,
            num_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
    """The set bits of every row of ``words`` on the host: (offsets
    int64 [nq + 1], ids int32 [offsets[-1]]), row r's ids ascending in
    ``ids[offsets[r]:offsets[r + 1]]``.  On a card: the count and scan
    launches, one copy of ``offsets`` back (the wait), the write launch
    into a buffer of ``offsets[-1]`` ids, and one copy of those into
    page-locked memory."""
    global LAUNCHES
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError(f"words must be a 2-D int32 tensor, got "
                        f"{words.dtype} with {words.dim()} dims")
    if not words.is_contiguous() or words.shape[1] != row_words(
            num_vertices):
        raise ValueError(f"words {tuple(words.shape)} are not a contiguous "
                         f"bitmap of {num_vertices} vertices")
    if words.device.type == "cpu":
        return compact_plain(words, num_vertices)
    if words.device.type != "cuda":
        raise ValueError(f"no union kernel for device {words.device}")
    rows, w = words.shape
    if rows == 0 or w == 0:
        return np.zeros(rows + 1, np.int64), np.zeros(0, np.int32)
    from gnnpe_tpu_torch.kernels._build import load
    lib = load("union_bitmap")
    dev, stream = words.device, torch.cuda.current_stream(
        words.device).cuda_stream
    segments = -(-w // SEG_WORDS)
    counts = torch.empty(2 * rows * segments + rows + 1, dtype=torch.int64,
                         device=dev)
    seg_offsets = counts[rows * segments:2 * rows * segments]
    offsets = counts[2 * rows * segments:]
    err = lib.gnnpe_union_offsets(dev.index, words.data_ptr(), rows, w,
                                  SEG_WORDS, counts.data_ptr(),
                                  seg_offsets.data_ptr(), offsets.data_ptr(),
                                  stream)
    if err != 0:
        raise RuntimeError(f"union offsets launch failed: CUDA error {err}")
    LAUNCHES += 2
    host_offsets = offsets.cpu().numpy()
    total = int(host_offsets[-1])
    if total == 0:
        return host_offsets, np.zeros(0, np.int32)
    dev_ids = torch.empty(total, dtype=torch.int32, device=dev)
    err = lib.gnnpe_union_write(dev.index, words.data_ptr(), rows, w,
                                SEG_WORDS, seg_offsets.data_ptr(),
                                dev_ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"union write launch failed: CUDA error {err}")
    LAUNCHES += 1
    ids = torch.empty(total, dtype=torch.int32, pin_memory=True)
    ids.copy_(dev_ids)
    return host_offsets, ids.numpy()


def split(offsets: np.ndarray, ids: np.ndarray) -> List[np.ndarray]:
    """``compact``'s result as one sorted int64 array a row."""
    return np.split(ids.astype(np.int64), offsets[1:-1])


def unite(words: torch.Tensor, num_vertices: int,
          group=None) -> Tuple[List[np.ndarray], int]:
    """The candidate lists of ``words``: OR-ed in place over ``group``'s
    ranks (``or_words_``; None or one rank leaves them), compacted, one
    sorted int64 array a row; and the bytes of offsets and ids that came
    back to the host.  On a sharded search a collective call."""
    or_words_(words, group)
    offsets, ids = compact(words, num_vertices)
    return split(offsets, ids), offsets.nbytes + ids.nbytes
