"""PE phase 2 fused: the leaf test of the surviving index blocks' vid rows
against every gated query row, each hit OR-ed into the candidate union's
bit-packed bitmap (ops/union_bitmap.py's words) on the way.

``scatter`` takes the table layout's vid table, the surviving blocks and
their gate, and the per-vertex tables the leaf test reads through.  On a
CUDA tensor it launches the hand-written kernel of csrc/leaf_scatter.cu
once; on a CPU tensor it runs its plain version (``scatter_plain``): the
tables' gathers, ``pe_mask_exact`` and ``union_bitmap.scatter_plain``,
the chain the kernel replaces.  Any other device raises.  Every path
width and VDE width launches the kernel: paths of 1 to 4 vertices with
VDEs of 1 to 4 columns hold each row's vertex records in registers, other
shapes read them again for each gated query row.  ``leaf_mask`` is the
plain version's leaf test alone, the mask that U's scatter takes.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from gnnpe_tpu_torch.match.device_filter import pe_mask_exact
from gnnpe_tpu_torch.ops import union_bitmap

LAUNCHES = 0


def _check(words, num_vertices, vids, blocks, block_size, gate, labels,
           degrees, vde, q_labels, q_degrees, q_thresh, out_ids, hits):
    for name, t, dtype, dim in (
            ("words", words, torch.int32, 2), ("vids", vids, torch.int32, 2),
            ("blocks", blocks, torch.int64, 1), ("gate", gate, torch.bool, 2),
            ("labels", labels, torch.int32, 1),
            ("degrees", degrees, torch.int32, 1),
            ("vde", vde, torch.float64, 2),
            ("q_labels", q_labels, torch.int32, 2),
            ("q_degrees", q_degrees, torch.int32, 2),
            ("q_thresh", q_thresh, torch.float64, 2),
            ("out_ids", out_ids, torch.int32, 2),
            ("hits", hits, torch.int64, 1)):
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f"{name} must be a {dim}-D {dtype} tensor, got "
                            f"{t.dtype} with {t.dim()} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on "
                             f"{words.device}")
    rows, width = q_labels.shape
    dim = vde.shape[1]
    if block_size < 1 or vids.shape[0] % block_size or vids.shape[1] != width:
        raise ValueError(f"vids {tuple(vids.shape)} are not whole blocks of "
                         f"{block_size} rows of {width} vertices")
    if gate.shape != (blocks.numel(), rows):
        raise ValueError(f"gate {tuple(gate.shape)} is not [blocks "
                         f"{blocks.numel()}, query rows {rows}]")
    if (q_degrees.shape != (rows, width) or out_ids.shape != (rows, width)
            or q_thresh.shape != (rows, width * dim)):
        raise ValueError(f"query rows {tuple(q_labels.shape)}, "
                         f"{tuple(q_degrees.shape)}, {tuple(out_ids.shape)} "
                         f"and thresholds {tuple(q_thresh.shape)} disagree")
    if (labels.shape[0] != num_vertices + 1
            or degrees.shape[0] != num_vertices + 1
            or vde.shape[0] != num_vertices + 1):
        raise ValueError(f"the vertex tables are not {num_vertices} rows "
                         "and the sentinel")
    if (words.shape[1] != union_bitmap.row_words(num_vertices)
            or hits.numel() != 1):
        raise ValueError(f"words {tuple(words.shape)} are not a bitmap of "
                         f"{num_vertices} vertices, or hits has "
                         f"{hits.numel()} entries")


def leaf_mask(num_vertices, vids, blocks, block_size, gate, labels,
              degrees, vde, q_labels, q_degrees, q_thresh):
    """The leaf test of ``scatter``'s blocks in plain PyTorch: the blocks
    in the table kept, their rows gathered, their vertices' fields
    gathered through the tables (ids outside [0, num_vertices] read the
    sentinel row) and ``pe_mask_exact``.  Returns the mask bool
    [Q, K'·B], the kept blocks' gate as bool [Q, K'] and their vid rows
    int32 [K'·B, L], the arguments of ``union_bitmap.scatter``; None
    where no block or no query row is left."""
    b = block_size
    keep = (blocks >= 0) & (blocks < vids.shape[0] // b)
    blocks, gate = blocks[keep], gate[keep]
    if blocks.numel() == 0 or gate.shape[1] == 0:
        return None
    rows = (blocks[:, None] * b
            + torch.arange(b, device=blocks.device)[None]).reshape(-1)
    v = vids[rows]
    t = torch.where((v < 0) | (v > num_vertices), num_vertices, v).long()
    leaf = pe_mask_exact(labels[t], degrees[t], vde[t].reshape(len(t), -1),
                         q_labels, q_degrees, q_thresh)
    return leaf, gate.t().contiguous(), v


def scatter_plain(words, num_vertices, vids, blocks, block_size, gate,
                  labels, degrees, vde, q_labels, q_degrees, q_thresh,
                  out_ids, hits) -> None:
    """Plain PyTorch version of ``scatter``: ``leaf_mask``, then
    ``union_bitmap.scatter_plain`` of the mask under the gate."""
    tested = leaf_mask(num_vertices, vids, blocks, block_size, gate,
                       labels, degrees, vde, q_labels, q_degrees, q_thresh)
    if tested is not None:
        union_bitmap.scatter_plain(words, num_vertices, *tested, out_ids,
                                   hits)


def scatter(words: torch.Tensor, num_vertices: int, vids: torch.Tensor,
            blocks: torch.Tensor, block_size: int, gate: torch.Tensor,
            labels: torch.Tensor, degrees: torch.Tensor, vde: torch.Tensor,
            q_labels: torch.Tensor, q_degrees: torch.Tensor,
            q_thresh: torch.Tensor, out_ids: torch.Tensor,
            hits: torch.Tensor) -> None:
    """Leaf-test the index blocks ``blocks`` and OR their hits into
    ``words`` (int32 [nq, W], a bitmap of ``num_vertices`` vertices), in
    place and without waiting.

    vids: int32 [NB·B, L], the vid table in blocks of ``block_size``
    rows; blocks: int64 [K], the blocks tested (blocks outside the table
    are skipped); gate: bool [K, Q], the query rows each block is tested
    against; labels, degrees: int32 [V + 1] and vde: f64 [V + 1, D], the
    per-vertex tables with the sentinel row at V = ``num_vertices``;
    q_labels, q_degrees: int32 [Q, L] and q_thresh: f64 [Q, L·D], the
    query rows; out_ids: int32 [Q, L], the output row of each row's
    position.  Row r of block k passes query row q where q is gated on
    for k, every label equals, every query degree is at most the data
    degree and every data VDE is at least the threshold; a pass sets
    vertex ``vids[r, j]`` in row ``out_ids[q, j]`` for every j (ids
    outside the bitmap are skipped).  hits: int64 [1], to which the rows
    with any gated pass are added."""
    global LAUNCHES
    _check(words, num_vertices, vids, blocks, block_size, gate, labels,
           degrees, vde, q_labels, q_degrees, q_thresh, out_ids, hits)
    if words.device.type == "cpu":
        return scatter_plain(words, num_vertices, vids, blocks, block_size,
                             gate, labels, degrees, vde, q_labels, q_degrees,
                             q_thresh, out_ids, hits)
    if words.device.type != "cuda":
        raise ValueError(f"no leaf kernel for device {words.device}")
    rows, width = q_labels.shape
    if blocks.numel() == 0 or rows == 0:
        return
    from gnnpe_tpu_torch.kernels._build import load
    err = load("leaf_scatter").gnnpe_leaf_scatter(
        words.device.index, vids.data_ptr(), blocks.data_ptr(),
        gate.data_ptr(), labels.data_ptr(), degrees.data_ptr(),
        vde.data_ptr(), q_labels.data_ptr(), q_degrees.data_ptr(),
        q_thresh.data_ptr(), out_ids.data_ptr(), words.data_ptr(),
        hits.data_ptr(), blocks.numel(), vids.shape[0] // block_size,
        block_size, rows, width, vde.shape[1], words.shape[0], num_vertices,
        words.shape[1], torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"leaf scatter launch failed: CUDA error {err}")
    LAUNCHES += 1
