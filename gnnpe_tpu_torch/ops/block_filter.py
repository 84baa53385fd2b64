"""PE phase 1 fused: every index block's summary tested against every
query row and the row's signature run, the blocks that survive for any
row listed in block order with their gate rows, and the two counts the
search reports.

``filter`` takes the table layout's f32 block summaries, the query rows
and each row's run of blocks.  On a CUDA tensor it launches the
hand-written kernels of csrc/block_filter.cu (count and scan, one wait
for the two counts, then write); on a CPU tensor it runs its plain version
(``filter_plain``): the box tests in chunks (``box_mask``), the phase-1
count, the runs' compares, ``any``, ``nonzero`` and the gather of the
gate rows, the chain the kernels replace.  Any other device raises.
Summaries of paths of 1 to 4 vertices with VDEs of 1 to 4 columns are
held in registers, others of up to 94 columns read again for each query
row; a wider summary (32 query rows past a thread block's 48 KB of shared
memory) raises on a card.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import torch

LAUNCHES = 0

# Bound on the elements of one [Q, blocks, W] compare of the plain version.
CHUNK_ELEMS = 1 << 27


def box_mask(ub, llo, lhi, deg, thresh, label, degrees) -> torch.Tensor:
    """bool [Q, n]: the box tests of n block summaries (ub, llo, lhi
    [n, W], deg [n, L]) against Q query rows (thresh, label [Q, W],
    degrees [Q, L]): every summary upper bound at least the threshold,
    every label feature inside [llo, lhi], every query degree at most the
    block's.  f32 summaries widen to f64 exactly in the compares."""
    dom = (ub[None] >= thresh[:, None]).all(-1)
    inside = ((label[:, None] >= llo[None]) & (lhi[None] >= label[:, None])
              ).all(-1)
    return dom & inside & (degrees[:, None] <= deg[None]).all(-1)


def _check(ub, llo, lhi, deg, thresh, label, degrees, runs):
    for name, t, dtype in (("ub", ub, torch.float32),
                           ("llo", llo, torch.float32),
                           ("lhi", lhi, torch.float32),
                           ("deg", deg, torch.int32),
                           ("thresh", thresh, torch.float64),
                           ("label", label, torch.float64),
                           ("degrees", degrees, torch.int32),
                           ("runs", runs, torch.int64)):
        if t.dtype != dtype or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D {dtype} tensor, got "
                            f"{t.dtype} with {t.dim()} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ub.device:
            raise ValueError(f"{name} is on {t.device}, ub on {ub.device}")
    (nb, w), (rows, l) = ub.shape, degrees.shape
    if llo.shape != ub.shape or lhi.shape != ub.shape or deg.shape != (nb, l):
        raise ValueError(f"summaries {tuple(ub.shape)}, {tuple(llo.shape)}, "
                         f"{tuple(lhi.shape)} and degrees {tuple(deg.shape)} "
                         "disagree")
    if (l < 1 or w % l or thresh.shape != (rows, w)
            or label.shape != (rows, w) or runs.shape != (2, rows)):
        raise ValueError(f"query rows {tuple(thresh.shape)}, "
                         f"{tuple(label.shape)}, {tuple(degrees.shape)} and "
                         f"runs {tuple(runs.shape)} do not fit summaries of "
                         f"width {w} over {l} positions")


def filter_plain(ub, llo, lhi, deg, thresh, label, degrees, runs):
    """Plain PyTorch version of ``filter``: ``box_mask`` over chunks of
    blocks under ``CHUNK_ELEMS``, joined into bool [Q, NB], the phase-1
    count, the mask kept on each row's run, then ``nonzero`` and the
    survivors' gate rows."""
    nb, rows = ub.shape[0], thresh.shape[0]
    step = max(1, CHUNK_ELEMS // max(1, rows * ub.shape[1]))
    bmask = torch.cat([box_mask(ub[lo:lo + step], llo[lo:lo + step],
                                lhi[lo:lo + step], deg[lo:lo + step], thresh,
                                label, degrees)
                       for lo in range(0, nb, step)], dim=1)
    phase1 = int(bmask.any(0).sum())
    cols = torch.arange(nb, device=ub.device)[None]
    bmask &= (cols >= runs[0][:, None]) & (cols < runs[1][:, None])
    sel = torch.nonzero(bmask.any(0)).squeeze(1)
    return sel, bmask.t()[sel].contiguous(), phase1, sel.numel()


def filter(ub: torch.Tensor, llo: torch.Tensor, lhi: torch.Tensor,
           deg: torch.Tensor, thresh: torch.Tensor, label: torch.Tensor,
           degrees: torch.Tensor, runs: torch.Tensor):
    """The blocks that survive phase 1 and the signature-run prune for
    any query row: (sel int64 [n], gate bool [n, Q], phase1, survived).

    ub, llo, lhi: f32 [NB, W] and deg: int32 [NB, L], the block
    summaries (W = L·D); thresh, label: f64 [Q, W] and degrees: int32
    [Q, L], the query rows; runs: int64 [2, Q], each row's run [lo, hi)
    of block ids.  Block k survives for row q where it passes the box
    tests (``box_mask``) and lo[q] <= k < hi[q]; sel lists the blocks
    that survive for any row in ascending order, gate[i, q] says whether
    block sel[i] survives for row q.  phase1 counts the blocks that pass
    the box tests for any row, survived is n.  On a card the caller's
    stream waits once, for the two counts."""
    global LAUNCHES
    _check(ub, llo, lhi, deg, thresh, label, degrees, runs)
    (nb, w), (rows, l) = ub.shape, degrees.shape
    dev = ub.device
    if nb == 0 or rows == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros((0, rows), dtype=torch.bool, device=dev), 0, 0)
    if dev.type == "cpu":
        return filter_plain(ub, llo, lhi, deg, thresh, label, degrees, runs)
    if dev.type != "cuda":
        raise ValueError(f"no block filter kernel for device {dev}")
    from gnnpe_tpu_torch.kernels._build import load
    lib = load("block_filter")
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = -(-nb // lib.gnnpe_block_filter_threads())
    bits = torch.empty((nb, -(-rows // 32)), dtype=torch.int32, device=dev)
    scratch = torch.empty(3 * tiles + 2, dtype=torch.int64, device=dev)
    counts, offsets, counters = (scratch[:2 * tiles],
                                 scratch[2 * tiles:3 * tiles],
                                 scratch[3 * tiles:])
    err = lib.gnnpe_block_filter_count(
        dev.index, ub.data_ptr(), llo.data_ptr(), lhi.data_ptr(),
        deg.data_ptr(), thresh.data_ptr(), label.data_ptr(),
        degrees.data_ptr(), runs.data_ptr(), bits.data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), counters.data_ptr(), nb,
        rows, l, w // l, stream)
    if err != 0:
        raise RuntimeError(f"block filter count launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 2
    phase1, survived = counters.tolist()        # the one wait
    sel = torch.empty(survived, dtype=torch.int64, device=dev)
    gate = torch.empty((survived, rows), dtype=torch.bool, device=dev)
    if survived:
        err = lib.gnnpe_block_filter_write(
            dev.index, bits.data_ptr(), offsets.data_ptr(), nb, rows,
            sel.data_ptr(), gate.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"block filter write launch failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
    return sel, gate, phase1, survived
