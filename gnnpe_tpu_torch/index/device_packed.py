"""Device-resident packed dominance index with its two-phase search,
for PE (one entry per path) and PGE (one entry per vertex), on one
device.

Counterpart of gnnpe_tpu/index/device_packed.py's
``DevicePackedPESearch`` and ``DevicePackedPGESearch``.  PE has three
classes, one per layout:

  ``DevicePackedPESearch`` (array mode) — the constructor takes the
    gnnpe_tpu host index (its fields are numpy arrays) and uploads
    labels, degrees, vids and f64 pde for every entry;
  ``TablePESearch`` (table mode) — ``build_from_paths`` builds the index
    on the device from the paths and the f64 vertex embeddings: the
    composite sort key, its stable order (``stable_order``, sorting
    bounded ranges), and the permute-fold of the block summaries
    (ROADMAP Queue B4).  Only the int32 vid row is
    stored per entry; labels, degrees and vde are gathered through
    per-vertex tables.  ``save``/``load`` write and read gnnpe_tpu's own
    npz format.
  ``StreamedPESearch`` (streamed mode) — table mode for an index past
    device memory: the sorted vid table stays on the host (pinned memory,
    or an ``np.memmap`` on disk), built there by ``build_from_paths`` or
    by index/bucket_build.py; the device keeps the per-vertex tables, the
    summaries and, in ``DeviceChunkCache``, a fixed pool of leaf blocks
    under LRU.  A chunk's vid rows reach the leaf test from the pool, or
    with the cache off by a per-chunk upload.  ``auto_resident`` says
    which of the two an index of a given size gets on a given device.

The three differ in how a chunk's vid rows reach the leaf test (array
mode's ``_chunk_vids``; the table layouts' ``_vid_blocks``, a vid table
on the device and the chunk's blocks in it) and in how they are built.
Every class answers one protocol, ``search(query)``:

  phase 1 — every query row against every block summary (label window,
    degree bound, upper-bound dominance).
  range prune — blocks outside a query row's contiguous run of possible
    exact-label matches go: PGE's blocks are label-sorted, table-mode
    and streamed PE's are sorted by label signature.
  selection — the blocks that survive for any row, and each one's gate:
    the rows it survives for.  The PE table layouts run the three as one
    kernel (ops/block_filter.py, csrc/block_filter.cu) that reads each
    block summary once, tests every query row and its signature run in
    registers and writes the survivors' ids and gate rows in block order,
    after one wait for its two counts; no mask over [Q, NB] is made.  The
    array layout and PGE build a bool mask [Q, NB] from chunked compares,
    prune it and take its ``nonzero``.
  phase 2 — the surviving blocks' rows are leaf-tested, gated by
    per-(row, block) survival, and every gated hit is OR-ed into a
    bit-packed bitmap [nq, ⌈V/32⌉] on the device, without a wait
    (ops/union_bitmap.py).  The PE table layouts fuse the leaf test and
    the scatter into one launch (ops/leaf_scatter.py,
    csrc/leaf_scatter.cu) over every surviving block (streamed: a launch
    a chunk, bounded by its pool), which writes no mask.  The array
    layout and PGE gather and test each chunk's rows (``_leaf_mask``)
    and scatter the mask (``union_bitmap.scatter``, csrc/union_bitmap.cu),
    in chunks sized so that the [Q, K·B, width] compare stays under
    ``CHUNK_ELEMS``.
  union — ``union_bitmap.unite``: on a sharded index the ranks' words
    are OR-ed (``or_words_``), then the bitmap is compacted on the device
    into each query vertex's sorted ids, which come back in one copy.

Each search times three spans on the host clock, each also a profiler
range (``search.filter``: phase 1, the prune and the selection, ending
on the wait for the fused filter's counts or on ``nonzero``;
``search.phase2``: the chunks' leaf tests and scatters and, last, the
read of the scatter's hit counter; ``search.extract``: the union, with
the wait in its collective on a sharded index, the compaction and the
copies of its offsets and ids).  Their edges fall on calls that wait for
the device anyway, so they add no synchronisation.  ``last_stats`` holds
their ms (``filter_ms``, ``phase2_ms``, ``extract_ms``) beside the
counters ``hit_rows`` (the columns with any gated hit, summed over
chunks, counted by the scatter), ``copied_bytes`` (what crosses to the
host: the compacted offsets and ids), ``cand_ids`` (the candidates
returned, summed over query vertices), ``leaf_fused_rows`` (the vid
rows the fused leaf test took, survived × B; 0 in the array layout and
PGE) and ``filter_fused_blocks`` (the blocks the fused filter scanned,
NB; 0 in the array layout and PGE); PGE's also ``label_run_blocks`` (the
blocks its label-run prune lets through).

Every leaf decision is a native f64 compare against thresholds computed
on the host with ``eps_threshold``, so candidate sets equal the f64 host
filter.  Table-mode summaries are outward-rounded f32 (gnnpe_tpu's
layout); they widen to f64 exactly in the phase-1 compare and can only
keep more blocks, never lose a candidate.  What the TPU version needed
and this one drops: uint32 mask packing, the fixed K chunk and
power-of-two query, path and vertex buckets (they only avoided
recompiles), the fused single dispatch, ``warm()``, the three-limb
tables, and the ±3e38 pad sentinels — pad rows carry label -2, which no
query label equals.  Of the streamed mode: the cache's scratch slot and
power-of-two upload buckets (fixed compiled shapes), buffer donation,
the chunk uploader, and every environment variable — budgets are
arguments, and ``None`` means a share of the device's free memory.
"""

from __future__ import annotations

import os
import shutil
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.embed.pde import PathEmbeddings
from gnnpe_tpu_torch.match.device_filter import (pe_mask_exact,
                                                 pge_mask_exact)
from gnnpe_tpu_torch.match.filter import eps_threshold
from gnnpe_tpu_torch.ops import block_filter, leaf_scatter, union_bitmap
from gnnpe_tpu_torch.parallel.collectives import (barrier, dist_rank,
                                                  gather_objects)
from gnnpe_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                           shard_bounds)
from gnnpe_tpu_torch.utils.device import as_device, free_bytes
from gnnpe_tpu_torch.utils.timers import StageTimer

__all__ = ["CHUNK_ELEMS", "DeviceChunkCache", "DevicePackedPESearch",
           "DevicePackedPGESearch", "PEQuery", "PGEQuery", "StreamedPESearch",
           "TablePESearch", "auto_resident", "builds_resident",
           "composite_sort_key",
           "composite_sort_key_device", "fold_blocks_host", "key_tables",
           "key_tables_device", "load", "path_sig", "permute_fold",
           "sig_radix_of"]

# ---- host sort-key helpers (numpy): the port's copy of gnnpe_tpu's -----


def _outward(x: np.ndarray, up: bool, pad_rows: int = 0) -> np.ndarray:
    """Conservatively-rounded f32 copy of an f64 table (outward nudge)
    + optional zero pad rows."""
    u = x.astype(np.float32)
    if up:
        bump = u.astype(np.float64) < x
        u[bump] = np.nextafter(u[bump], np.float32("inf"))
    else:
        bump = u.astype(np.float64) > x
        u[bump] = np.nextafter(u[bump], np.float32("-inf"))
    if pad_rows:
        u = np.concatenate(
            [u, np.zeros((pad_rows, x.shape[1]), np.float32)])
    return u


def sig_radix_of(vertices) -> int:
    """Radix of the label-signature fold — one definition shared by the
    index build and the query-side signature (path_sig)."""
    return int(vertices.labels.max(initial=0)) + 3


def path_sig(labels_rows: np.ndarray, sig_radix: int) -> np.ndarray:
    """int64[N] label signature of each row of int[N, L] per-position
    labels — the EXACT fold composite_sort_key uses, so equal label
    vectors always produce equal signatures (collisions from the 2^30
    wrap only ever ADD candidates block ranges, never drop them)."""
    sig = np.zeros(len(labels_rows), np.int64)
    r = np.int64(sig_radix)
    for j in range(labels_rows.shape[1]):
        sig = ((sig * r + (labels_rows[:, j].astype(np.int64) + 2))
               & ((1 << 30) - 1))
    return sig


def key_tables(vertices):
    """Precomputed per-vertex tables for composite_sort_key — hoist out
    of chunk loops: recomputing the outward-rounded vde copy is an
    O(V·D) nextafter pass PER CALL, which at the synth100m rung's 1220
    chunks was ~all of the recorded 903 s 'enumeration' time."""
    return (_outward(vertices.vde, True),
            np.int64(sig_radix_of(vertices)),
            vertices.labels.astype(np.int64))


def composite_sort_key(paths: np.ndarray, vertices,
                       tables=None) -> np.ndarray:
    """int64[P] index sort key: (label signature mod 2^30) << 32 |
    order-preserving bits of -Σpde f32.  Pure host numpy — chunkable,
    GIL-releasing, and independent across path chunks, which is what
    lets the pipelined offline stage overlap key computation with
    enumeration (paths/pipeline.py).  The key shapes block quality
    only, never correctness — EXCEPT that the high 32 bits (the label
    signature) also drive the per-query contiguous block-range prune
    (TablePESearch.search), which is conservative by the
    path_sig collision argument.

    ``tables``: optional key_tables(vertices) result; pass it when
    calling per chunk (see key_tables on why)."""
    p, l = paths.shape
    vde_up, sig_radix, lab_all = (key_tables(vertices)
                                  if tables is None else tables)
    sig = np.zeros(p, np.int64)
    s32 = np.zeros(p, np.float32)
    for j in range(l):
        col = paths[:, j]
        sig = (sig * sig_radix + (lab_all[col] + 2)) & ((1 << 30) - 1)
        s32 = s32 + vde_up[col].sum(axis=1)
    bi = (-s32).view(np.int32).astype(np.int64) & 0xFFFFFFFF
    u = np.where(bi >= (1 << 31), 0xFFFFFFFF - bi, bi | (1 << 31))
    return (sig << 32) | u


# Bound on the elements of one [Q, rows, width] compare (phase 1 and
# each phase-2 chunk): 128M bools.  Read at search time.
CHUNK_ELEMS = 1 << 27
# Blocks folded per step of ``permute_fold`` (bounds its gathers).
FOLD_BLOCKS = 1 << 16
# Rows of one step of the table-mode build's sort key, and the most rows
# ``stable_order`` sorts at once; with the fold's, the build's device
# bytes a row of each step's temporaries (``table_build_bytes``: the key's
# int64 columns and f32 sums; a sort's index, keys, sorted keys,
# permutation and the sort's own double buffers; the fold's int64 rows
# and one gathered column).
KEY_ROWS = 1 << 24
SORT_ROWS = 1 << 25
KEY_ROW_BYTES = 96
SORT_ROW_BYTES = 64
# A saved vid table larger than this goes to a raw ``.vids.bin`` sidecar
# (gnnpe_tpu's rule: np.savez would buffer the whole table).
SIDECAR_BYTES = 1 << 30
# Bytes a table-mode build holds a path through its sort, beyond the
# paths themselves: the int64 key, the int32 permutation and the sort's
# two bool masks (``table_build_bytes``).  Measured on an NVIDIA H100
# 80GB HBM3 at 700 W with ``torch.cuda.max_memory_allocated`` (the paths
# allocated before the build; chip_smoke.py's build accounting): the dblp
# build of 60,779,769 paths peaked at 2,458,406,400 B, 28.45 B a path
# beyond the padded table; youtube's, 1,170,203,040 paths, at
# 20,580,449,792 B, 5.59 B a path beyond the table (its fold).
BUILD_BYTES_PER_PATH = 14
# Shares of the device's free memory taken where a budget is left None:
# gnnpe_tpu's ``hbm_budget_bytes`` gives a resident vid table 0.35 of the
# device (the rest is for summaries, vertex tables and search buffers) and
# its ``cache_budget_bytes`` gives the streamed mode's block pool 0.55 (no
# table is resident beside it).
RESIDENT_SHARE = 0.35
CACHE_SHARE = 0.55
# Host-to-device staging of streamed leaf blocks: a ring of STAGING_RING
# pinned buffers of STAGING_ROWS vid rows each (``_StagingRing``).
STAGING_ROWS = 1 << 19
STAGING_RING = 4
# Blocks one ``DeviceChunkCache.prefill`` step uploads.
PREFILL_BLOCKS = 1024
# Signature range of a pad block in a file gnnpe_tpu saved.
PAD_SIG = 1 << 62


def key_tables_device(vertices, device):
    """``key_tables`` on ``device``: (outward-rounded f32 vde [V, D],
    signature radix, int64 labels [V])."""
    vde_up, radix, labels = key_tables(vertices)
    return (torch.from_numpy(vde_up).to(device), int(radix),
            torch.from_numpy(labels).to(device))


def composite_sort_key_device(paths: torch.Tensor, vertices,
                              tables=None) -> torch.Tensor:
    """int64[P] ``composite_sort_key`` of int32[P, L] paths, on their
    device and bit-equal to the numpy one: the signature fold in int64,
    Σ vde_up in f32 position by position with each position's D columns
    added left to right as numpy does for D < 8, the f32 bits of -Σ
    read as int32 and folded to an order-preserving unsigned value in
    int64.  ``tables``: ``key_tables_device(vertices, device)``."""
    vde_up, radix, labels = (key_tables_device(vertices, paths.device)
                             if tables is None else tables)
    p, l = paths.shape
    sig = torch.zeros(p, dtype=torch.int64, device=paths.device)
    s32 = torch.zeros(p, dtype=torch.float32, device=paths.device)
    for j in range(l):
        col = paths[:, j].long()
        sig = (sig * radix + (labels[col] + 2)) & ((1 << 30) - 1)
        g = vde_up[col]
        row = g[:, 0]
        for k in range(1, g.shape[1]):
            row = row + g[:, k]
        s32 = s32 + row
    bits = (-s32).view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(bits >= (1 << 31), 0xFFFFFFFF - bits, bits | (1 << 31))
    return (sig << 32) | u


def sort_key_steps(paths: torch.Tensor, tables) -> torch.Tensor:
    """``composite_sort_key_device`` of every path, computed ``KEY_ROWS``
    paths at a time into one int64[P], so that its per-column
    temporaries stay one step's."""
    key = torch.empty(len(paths), dtype=torch.int64, device=paths.device)
    for lo in range(0, len(paths), KEY_ROWS):
        key[lo:lo + KEY_ROWS] = composite_sort_key_device(
            paths[lo:lo + KEY_ROWS], None, tables)
    return key


def _in_range(key: torch.Tensor, lo, hi) -> torch.Tensor:
    """bool mask of lo <= key < hi (None: unbounded)."""
    if lo is None and hi is None:
        return torch.ones_like(key, dtype=torch.bool)
    if lo is None:
        return key < hi
    m = key >= lo
    if hi is not None:
        m &= key < hi
    return m


def stable_order(key: torch.Tensor) -> torch.Tensor:
    """numpy's stable argsort of the int64 ``key`` (int32, or int64 past
    2^31 entries), sorting at most ``SORT_ROWS`` keys at once: so the
    build holds no sorted copy of the key and no full-size sort buffers
    beside it, only the order and two bool masks.

    The key range is cut into ranges of at most ``SORT_ROWS`` entries and
    the ranges sorted in key order, each stably over its entries in index
    order, so their concatenation is the global stable order.  A range
    with more entries is cut at quantiles of a strided sample of its
    keys (at most ``SORT_ROWS``, or where the stride meets none of them,
    the range's keys among the first ``SORT_ROWS`` that hold any), every
    sampled value becoming a one-value range of its own (so
    every cut makes progress, however many keys tie); a one-value range
    is already in order and is written as its indices, ``SORT_ROWS`` at a
    time."""
    n = len(key)
    order = torch.empty(n, dtype=torch.int32 if n < 2 ** 31 else torch.int64,
                        device=key.device)
    if n <= SORT_ROWS:
        order.copy_(torch.sort(key, stable=True)[1])
        return order
    stride = max(1, n // min(SORT_ROWS, 1 << 20))
    pos, ranges = 0, [(None, None)]
    while ranges:
        lo, hi = ranges.pop()
        m = _in_range(key, lo, hi)
        # Counted in slices: a bool tensor's sum first casts it to int64.
        count = sum(int(m[s0:s0 + SORT_ROWS].sum())
                    for s0 in range(0, n, SORT_ROWS))
        if count == 0:
            continue
        one_value = lo is not None and hi is not None and hi - lo == 1
        if count > SORT_ROWS and not one_value:
            sample = key[::stride][m[::stride]]
            for s0 in range(0, n if not len(sample) else 0, SORT_ROWS):
                sample = key[s0:s0 + SORT_ROWS][m[s0:s0 + SORT_ROWS]]
                if len(sample):
                    break
            if len(sample):
                parts = -(-count // (SORT_ROWS // 2))
                sample = torch.sort(sample)[0]
                cuts = torch.unique(sample[
                    (torch.arange(1, parts, device=key.device) * len(sample))
                    // parts]).tolist() or [int(sample[0])]
                sub, start = [], lo
                for v in cuts:
                    sub += [(start, v), (v, v + 1)]
                    start = v + 1
                sub.append((start, hi))
                ranges.extend(reversed(sub))
                continue
        if one_value:
            for s0 in range(0, n, SORT_ROWS):
                idx = torch.nonzero(m[s0:s0 + SORT_ROWS]).squeeze(1) + s0
                order[pos:pos + len(idx)] = idx
                pos += len(idx)
            continue
        idx = torch.nonzero(m).squeeze(1)
        del m
        perm = torch.sort(key[idx], stable=True)[1]
        order[pos:pos + count] = idx[perm]
        pos += count
    return order


def _vertex_tables_host(vertices) -> dict:
    """Per-vertex numpy tables with one sentinel row at index V (label
    -2, degree 0, zero embeddings) that pad rows gather through: the
    leaf test's labels, degrees and f64 vde, and the fold's
    outward-rounded f32 vde and x."""
    def put(a, fill):
        pad = np.full((1,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad])

    return dict(
        labels=put(vertices.labels.astype(np.int32), -2),
        degrees=put(vertices.degrees.astype(np.int32), 0),
        vde=put(np.asarray(vertices.vde, np.float64), 0.0),
        vde_up=put(_outward(vertices.vde, True), 0.0),
        x_up=put(_outward(vertices.x, True), 0.0),
        x_dn=put(_outward(vertices.x, False), 0.0))


def _vertex_tables(vertices, device, host: dict = None) -> dict:
    """``_vertex_tables_host`` (or ``host``, already made) on ``device``."""
    host = _vertex_tables_host(vertices) if host is None else host
    return {k: torch.from_numpy(a).to(device) for k, a in host.items()}


def permute_fold(paths: torch.Tensor, order: torch.Tensor, tables: dict,
                 block_size: int):
    """The sorted vid table and its block summaries (gnnpe_tpu's
    ``_compiled_permute_fold``, ROADMAP Queue B4), on the paths' device.

    vids int32[NB·B, L] are ``paths[order]`` (``order`` int32 or int64)
    padded with the sentinel
    vertex V; per block: max of vde_up, min of x_dn and max of x_up
    (f32 [NB, L·D], position-major) and max degree (int32 [NB, L]).
    Max and min select, so the summaries equal gnnpe_tpu's bit for bit,
    pad rows included."""
    p, l = paths.shape
    b = block_size
    v = tables["labels"].shape[0] - 1
    nb = -(-p // b)
    dev = paths.device
    vids = torch.full((nb * b, l), v, dtype=torch.int32, device=dev)
    torch.index_select(paths, 0, order, out=vids[:p])
    d = tables["vde_up"].shape[1]
    ub = torch.empty((nb, l * d), dtype=torch.float32, device=dev)
    llo, lhi = torch.empty_like(ub), torch.empty_like(ub)
    deg = torch.empty((nb, l), dtype=torch.int32, device=dev)
    for lo in range(0, nb, FOLD_BLOCKS):
        hi = min(lo + FOLD_BLOCKS, nb)
        rows = vids[lo * b:hi * b].long()
        for j in range(l):
            col, cs = rows[:, j], slice(j * d, (j + 1) * d)
            ub[lo:hi, cs] = tables["vde_up"][col].view(-1, b, d).amax(1)
            lhi[lo:hi, cs] = tables["x_up"][col].view(-1, b, d).amax(1)
            llo[lo:hi, cs] = tables["x_dn"][col].view(-1, b, d).amin(1)
            deg[lo:hi, j] = tables["degrees"][col].view(-1, b).amax(1)
    return vids, (ub, llo, lhi, deg)


def _check_fits(need: int, device, what: str) -> None:
    """Raise unless ``need`` bytes are free on ``device``; a table that
    does not fit is served by ``StreamedPESearch``."""
    free = free_bytes(device)
    if need > free:
        raise MemoryError(
            f"{what} needs {need} B and {device} has {free} B free; an "
            "index past device memory is served streamed "
            "(StreamedPESearch; build_index(table=True, resident=False))")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """``t`` in host memory as numpy: one copy into pinned memory from a
    CUDA tensor, a view of a CPU one."""
    if t.device.type == "cpu":
        return t.numpy()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h.numpy()


# ---- the index past device memory: host table, budgets, block cache ----


def auto_resident(p: int, l: int, block_size: int, device,
                  budget_bytes: Optional[float] = None) -> bool:
    """Capacity model (gnnpe_tpu's ``auto_resident``): a PE index of
    ``p`` paths of ``l`` vertices is device-resident iff its vid table,
    padded to whole blocks, fits ``budget_bytes``; ``None`` means
    ``RESIDENT_SHARE`` of the memory now free on ``device``."""
    if budget_bytes is None:
        budget_bytes = RESIDENT_SHARE * free_bytes(device)
    return -(-p // block_size) * block_size * l * 4 <= budget_bytes


def table_build_bytes(p: int, l: int, block_size: int,
                      paths_allocated: bool, num_vertices: int,
                      dim: int) -> int:
    """Device bytes ``TablePESearch.build_from_paths`` of ``p`` paths of
    ``l`` vertices allocates at its peak, beyond what is allocated before
    it: the vertex tables (``num_vertices`` + 1 rows at VDE width
    ``dim``), the paths where they are not yet allocated (uploaded from
    the host, or to be enumerated on the device first), and the largest
    of the build's three stages —
      key:  the int64 key and one step's temporaries;
      sort: the key, ``BUILD_BYTES_PER_PATH`` in all with the
            permutation and the sort's masks, and one sort's temporaries;
      fold: the permutation, the padded vid table and one fold step's
            int64 rows, gathered column and the gather's own copy of
            its index;
    and per block its summaries and signature range with their
    temporaries.  The key is dropped before the fold, and nothing else
    is held at full size, so this is the whole peak but for the
    allocator's rounding."""
    rows = -(-p // block_size) * block_size
    order = p * (4 if p < 2 ** 31 else 8)
    key = p * 8 + KEY_ROW_BYTES * min(p, KEY_ROWS)
    sort = (p * (BUILD_BYTES_PER_PATH - 4) + order
            + SORT_ROW_BYTES * min(p, SORT_ROWS))
    fold = (order + rows * l * 4
            + (8 * l + 16 * dim) * min(rows, FOLD_BLOCKS * block_size))
    blocks = rows // block_size * (12 * l * dim + 4 * l + 64)
    tables = (num_vertices + 1) * (8 + 20 * dim)
    return (tables + blocks + max(key, sort, fold)
            + (0 if paths_allocated else p * l * 4))


def builds_resident(p: int, l: int, block_size: int, device,
                    paths_allocated: bool, num_vertices: int, dim: int,
                    budget_bytes: Optional[float] = None) -> bool:
    """What ``resident=None`` means where an index is built: resident iff
    ``auto_resident`` says so and the build on the device
    (``table_build_bytes``, the paths counted unless ``paths_allocated``)
    fits the memory now free there."""
    return (auto_resident(p, l, block_size, device, budget_bytes)
            and table_build_bytes(p, l, block_size, paths_allocated,
                                  num_vertices, dim)
            <= free_bytes(device))


def _host_table(rows: int, l: int, device, table_path: Optional[str]):
    """An int32[rows, l] host table for the sorted vids: an ``np.memmap``
    of ``table_path`` (the disk tier) where one is named, page-locked
    memory beside a CUDA device, plain memory beside the CPU."""
    if table_path is not None:
        return np.memmap(table_path, dtype=np.int32, mode="w+",
                         shape=(rows, l))
    if torch.device(device).type == "cuda" and rows:
        return torch.empty((rows, l), dtype=torch.int32,
                           pin_memory=True).numpy()
    return np.empty((rows, l), np.int32)


def fold_blocks_host(rows: np.ndarray, g0: int, g1: int, b: int,
                     tabs: dict, out) -> None:
    """Summaries of blocks [g0, g1) into ``out`` = (ub, llo, lhi, deg)
    from ``rows``, the [g0·b, g1·b) slice of the sorted vid table, on
    the host: ``permute_fold``'s maxima and minima in numpy (gnnpe_tpu's
    ``_fold_blocks``).  ``tabs``: ``_vertex_tables_host``."""
    if g1 <= g0:
        return
    ub, llo, lhi, deg = out
    d = tabs["vde_up"].shape[1]
    for j in range(rows.shape[1]):
        col, cs = rows[:, j], slice(j * d, (j + 1) * d)
        ub[g0:g1, cs] = tabs["vde_up"][col].reshape(-1, b, d).max(1)
        lhi[g0:g1, cs] = tabs["x_up"][col].reshape(-1, b, d).max(1)
        llo[g0:g1, cs] = tabs["x_dn"][col].reshape(-1, b, d).min(1)
        deg[g0:g1, j] = tabs["degrees"][col].reshape(-1, b).max(1)


def empty_summaries(nb: int, l: int, d: int):
    """Unfilled host summaries (ub, llo, lhi f32[nb, l·d], deg int32
    [nb, l]) for ``fold_blocks_host``."""
    return (np.empty((nb, l * d), np.float32), np.empty((nb, l * d),
            np.float32), np.empty((nb, l * d), np.float32),
            np.empty((nb, l), np.int32))


def _host_fold_summaries(hv: np.ndarray, tabs: dict, b: int,
                         workers: int = 2):
    """Block summaries folded on the host over the whole sorted vid
    table, in block-aligned pieces of about 8M rows on ``workers``
    threads (numpy's gathers release the GIL)."""
    rows, l = hv.shape
    out = empty_summaries(rows // b, l, tabs["vde_up"].shape[1])
    step = max(b, ((1 << 23) // b) * b)

    def work(lo):
        hi = min(lo + step, rows)
        fold_blocks_host(hv[lo:hi], lo // b, hi // b, b, tabs, out)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(work, range(0, rows, step)))
    return out


class _StagingRing:
    """Leaf blocks from the host table to the device through a ring of
    ``STAGING_RING`` staging buffers of about ``STAGING_ROWS`` vid rows
    each, page-locked beside a CUDA device.

    ``pieces`` gathers a piece's blocks from the host table into the
    next buffer with one index (an ``np.memmap`` faults its pages in
    there) and queues its copy to the device without waiting.  Each
    buffer carries the event of its last copy, and the host waits on
    that event before it fills the buffer again, so a queued copy never
    reads rows of a later piece.  What is in flight is bounded by the
    ring: at most ``STAGING_RING`` pieces of page-locked memory, and on
    the device the pieces not yet consumed on the stream."""

    def __init__(self, device, block_size: int, l: int):
        self.device = device
        self._cuda = device.type == "cuda"
        self.blocks = max(1, STAGING_ROWS // block_size)
        self._bufs = [torch.empty((self.blocks, block_size, l),
                                  dtype=torch.int32, pin_memory=self._cuda)
                      for _ in range(STAGING_RING)]
        self._events = [None] * STAGING_RING
        self._turn = 0
        self.uploaded_bytes = 0

    def pieces(self, host_blocks: np.ndarray, blks: np.ndarray):
        """Yields (lo, int32[n, B, L] on the device) for consecutive
        pieces ``blks[lo:lo + n]`` of the block ids ``blks``;
        ``host_blocks``: the host table as [NB, B, L]."""
        for lo in range(0, len(blks), self.blocks):
            i = self._turn
            self._turn = (i + 1) % STAGING_RING
            if self._events[i] is not None:
                self._events[i].synchronize()
            part = blks[lo:lo + self.blocks]
            buf = self._bufs[i][:len(part)]
            np.take(host_blocks, part, axis=0, out=buf.numpy(), mode="clip")
            self.uploaded_bytes += buf.numel() * 4
            if self._cuda:
                dev = buf.to(self.device, non_blocking=True)
                self._events[i] = torch.cuda.Event()
                self._events[i].record()
            else:
                dev = buf.clone()
            yield lo, dev


class DeviceChunkCache:
    """LRU cache of streamed leaf blocks on the device (gnnpe_tpu's
    ``DeviceChunkCache`` on one shard): a fixed pool of ``capacity``
    block slots, int32[capacity·B, L], an ``OrderedDict`` from block id
    to slot in LRU order on the host, and only the misses are uploaded.

    The pool is written in place (``index_copy_``) on the stream the
    search runs on, and the leaf test gathers from it on the same
    stream.  So a gather queued before a later chunk's upload reads the
    slots as they were, and eviction never takes a block the chunk being
    filled selects (``protect``): that is all the ordering the cache
    needs.  A caller that searches on several streams must order them
    itself.

    Dropped from gnnpe_tpu's, which needed them for fixed compiled
    shapes and donated buffers: the scratch slot for upload padding, the
    power-of-two upload buckets, buffer donation and the shard axis."""

    def __init__(self, device, l: int, block_size: int, num_blocks: int,
                 budget_bytes: float, ring: _StagingRing):
        self.device = device
        self.l, self.b = l, block_size
        self.budget_bytes = budget_bytes
        per_slot = block_size * l * 4
        self.capacity = max(0, min(int(budget_bytes // per_slot),
                                   num_blocks))
        if self.capacity == 0 and num_blocks:
            raise ValueError(
                f"a block cache of {budget_bytes} B holds no block of "
                f"{per_slot} B; give it more or search with cache=False")
        # Raises CUDA's out-of-memory error where the pool does not fit.
        self.buf = torch.zeros((self.capacity * block_size, l),
                               dtype=torch.int32, device=device)
        self._ring = ring
        self.map: "OrderedDict[int, int]" = OrderedDict()
        self.next_free = 0
        self.hits = self.misses = self.evictions = 0

    def _alloc(self, protect) -> int:
        if self.next_free < self.capacity:
            self.next_free += 1
            return self.next_free - 1
        # Evict in LRU order, skipping the blocks the current chunk
        # selects (this very chunk's gather is about to read them).
        for blk in self.map:
            if blk not in protect:
                self.evictions += 1
                return self.map.pop(blk)
        raise RuntimeError("chunk larger than cache capacity")

    def ensure(self, blks: np.ndarray, host_vids: np.ndarray) -> np.ndarray:
        """Make every block of ``blks`` (at most ``capacity`` distinct
        ids) pool-resident and return its slots int64[len(blks)];
        uploads the misses, all gathered from ``host_vids`` by one index
        per staging piece."""
        slots = np.empty(len(blks), np.int64)
        miss = []
        for i, blk in enumerate(blks.tolist()):
            got = self.map.get(blk)
            if got is None:
                miss.append(i)
            else:
                self.map.move_to_end(blk)
                slots[i] = got
        self.hits += len(blks) - len(miss)
        self.misses += len(miss)
        if not miss:
            return slots
        protect = set(blks.tolist())
        miss = np.asarray(miss, np.int64)
        for i in miss.tolist():
            slots[i] = self.map[int(blks[i])] = self._alloc(protect)
        pool = self.buf.view(self.capacity, self.b, self.l)
        for lo, dev in self._ring.pieces(
                host_vids.reshape(-1, self.b, self.l), blks[miss]):
            into = torch.from_numpy(slots[miss[lo:lo + len(dev)]])
            pool.index_copy_(0, into.to(self.device), dev)
        return slots

    def prefill(self, host_vids: np.ndarray, block_order: np.ndarray,
                max_seconds: float = 1e9) -> int:
        """Load the first ``capacity`` blocks of ``block_order`` that the
        pool lacks (over the least recently used ones where it is full),
        or fewer if ``max_seconds`` pass, before any query needs them;
        returns the blocks loaded.  Prefilled blocks count as neither
        hits nor misses."""
        todo = [g for g in np.asarray(block_order).tolist()
                if g not in self.map][:self.capacity]
        t0 = time.perf_counter()
        loaded = 0
        step = max(1, min(PREFILL_BLOCKS, self.capacity))
        for lo in range(0, len(todo), step):
            part = np.asarray(todo[lo:lo + step], np.int64)
            self.ensure(part, host_vids)
            loaded += len(part)
            if time.perf_counter() - t0 > max_seconds:
                break
        self.hits = self.misses = 0
        return loaded


@dataclass
class PEQuery:
    """PE search input: the rows ``plan_rows`` of a query path table
    whose ``vids`` are query-vertex ids in [0, num_query_vertices)."""
    pde: PathEmbeddings
    plan_rows: np.ndarray
    num_query_vertices: int


@dataclass
class PGEQuery:
    """PGE search input: one row per query vertex (candidates come back
    in row order)."""
    labels: np.ndarray        # int[Q]
    degrees: np.ndarray       # int[Q]
    group: np.ndarray         # f64[Q, 2, D]
    label_group: np.ndarray   # f64[Q, 2, D]


class _PackedSearch:
    """The two-phase search shared by both variants.  Subclasses set
    the fields below and supply ``_prepare`` (whose query carries
    ``out_ids``, int32 [Q, L']: the query vertex of each position of a
    row), ``_phase1`` and ``_prune``, or where the layout fuses them
    (``fuses_filter``) ``_filter``, and phase 2: ``_chunk_vids`` (a
    chunk's vertex ids [K·B, L']) and ``_leaf_mask``, or where the layout
    fuses it (``fuses_leaf``, which takes the fused filter's gate rows)
    ``_fused_chunk`` and ``_leaf_scatter``."""

    device: torch.device
    block_size: int
    num_blocks: int
    num_vertices: int
    width: int              # embedding columns of one entry
    # Whether phase 1, the range prune and the selection run as one fused
    # filter (``_filter``) instead of ``_phase1``, ``_prune`` and
    # ``nonzero``, and whether phase 2 runs as one fused leaf test and
    # scatter (``_leaf_scatter``) instead of ``_leaf_mask`` and the union's
    # scatter: properties of the layout, whatever the shapes.
    fuses_filter = False
    fuses_leaf = False

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload(self, a: np.ndarray, rows: int, fill) -> torch.Tensor:
        """``a`` padded with ``fill`` to ``rows`` rows, straight into
        device memory (no padded host copy)."""
        out = torch.full((rows,) + a.shape[1:], fill,
                         dtype=torch.from_numpy(a[:0]).dtype,
                         device=self.device)
        out[:len(a)] = self._put(a)
        return out

    def resident_tensors(self) -> dict:
        """The index tensors this search keeps on its device."""
        return {k: v for k, v in vars(self).items()
                if isinstance(v, torch.Tensor)}

    def _chunk_limit(self, k: int) -> int:
        """The blocks one phase-2 chunk may hold, at most ``k``."""
        return k

    # ---- sharding over a mesh axis -------------------------------------
    # Per-entry device tensors, per-block device tensors or host arrays,
    # and per-entry host arrays: what ``shard`` cuts to the rank's blocks.
    _ROW_FIELDS: tuple = ()
    _BLOCK_FIELDS: tuple = ()
    _HOST_ROW_FIELDS: tuple = ()
    group = None            # the axis's process group once sharded
    block_range = None      # (lo, hi) of the index's blocks held here

    def shard(self, mesh, axis: str = "graph"):
        """Keep this rank's contiguous range of the blocks and drop the
        rest (gnnpe_tpu splits the blocks over the mesh axis the same
        way); ``search`` then runs the two phases over the rank's blocks
        and unites the ranks' answers with one collective, so it must be
        called on every rank of the axis with the same query.  Ranges are
        uneven where the ranks do not divide the blocks, and a rank may
        hold none.  Returns self."""
        if self.block_range is not None:
            raise RuntimeError("this index is sharded already")
        n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
        lo, hi = shard_bounds(self.num_blocks, n, r)
        self._narrow(lo, hi)
        self.group = axis_group(mesh, axis)
        return self

    def _narrow(self, lo: int, hi: int) -> None:
        # A part of a device tensor is copied so that the rest can go; the
        # whole range (a mesh of one) keeps the tensor as it is.
        b = self.block_size
        whole = (lo, hi) == (0, self.num_blocks)
        cut = lambda t, a, z: t[a:z] if whole else t[a:z].clone()
        for name in self._ROW_FIELDS:
            if getattr(self, name, None) is not None:
                setattr(self, name, cut(getattr(self, name), lo * b, hi * b))
        for name in self._BLOCK_FIELDS:
            t = getattr(self, name)
            setattr(self, name, cut(t, lo, hi) if isinstance(
                t, torch.Tensor) else t[lo:hi])
        for name in self._HOST_ROW_FIELDS:
            setattr(self, name, getattr(self, name)[lo * b:hi * b])
        self.block_range = (lo, hi)
        self.num_blocks = hi - lo

    def search(self, query) -> List[np.ndarray]:
        """Sorted candidate vertex ids per query vertex.  On a sharded
        index this is a collective call that returns the same lists on
        every rank: the local part over the rank's blocks, the packed
        bitmaps' OR, and the same compaction.  ``last_stats`` holds this
        call's counters and its spans' ms (the module's docstring), or
        None where the query has no rows or this rank holds no block."""
        q = self._prepare(query)
        self.last_stats = None
        if q.rows == 0 or q.num_out == 0:       # the same on every rank
            return [np.zeros(0, dtype=np.int64) for _ in range(q.num_out)]
        spans = StageTimer()        # no device: its edges never synchronise
        words = self._search_local(q, spans)
        with spans.stage("search.extract"):
            out = self._union(q, words)
        if self.last_stats is not None:
            self.last_stats.update(
                {f"{s}_ms": spans.times_ms.get(f"search.{s}", 0.0)
                 for s in ("filter", "phase2", "extract")})
            self.last_stats["cand_ids"] = sum(len(c) for c in out)
        return out

    def _union(self, q, words) -> List[np.ndarray]:
        """The candidate lists from ``_search_local``'s words, through
        the ranks' OR on a sharded index."""
        if words is None and self.group is not None:
            words = union_bitmap.new_words(q.num_out, self.num_vertices,
                                           self.device)
        if words is None:
            return [np.zeros(0, dtype=np.int64) for _ in range(q.num_out)]
        out, copied = union_bitmap.unite(words, self.num_vertices,
                                         self.group)
        if self.last_stats is not None:
            self.last_stats["copied_bytes"] += copied
        return out

    def _search_local(self, q, spans: StageTimer):
        """Phase 1, the range prune and phase 2 over the blocks held
        here, timed in ``spans``: the packed bitmap on the device, or
        None where no block survives.  No collective in here: the chunk
        loop's length differs from rank to rank."""
        if self.num_blocks == 0:
            return None
        nb, b = self.num_blocks, self.block_size
        with spans.stage("search.filter"):
            if self.fuses_filter:
                sel, gate, phase1, n_sel = self._filter(q)
            else:
                step = max(1, CHUNK_ELEMS // (q.rows * self.width))
                bmask = torch.cat([self._phase1(q, lo, min(lo + step, nb))
                                   for lo in range(0, nb, step)], dim=1)
                phase1 = int(bmask.any(0).sum())
                bmask = self._prune(q, bmask)
                sel = torch.nonzero(bmask.any(0)).squeeze(1)
                n_sel = sel.numel()
        k = self._chunk_limit(max(1, CHUNK_ELEMS // (q.rows * b * self.width)))
        fused = self.fuses_leaf
        if fused:
            k = self._fused_chunk(k, n_sel)
        st = self.last_stats = dict(
            blocks=nb, phase1=phase1, survived=n_sel, chunks=-(-n_sel // k),
            hit_rows=0, copied_bytes=0,
            leaf_fused_rows=n_sel * b if fused else 0,
            filter_fused_blocks=nb if self.fuses_filter else 0)
        if n_sel == 0:
            return None
        offs = torch.arange(b, device=self.device)
        words = union_bitmap.new_words(q.num_out, self.num_vertices,
                                       self.device)
        hits = torch.zeros(1, dtype=torch.int64, device=self.device)
        for lo in range(0, n_sel, k):
            with spans.stage("search.phase2"):
                blk = sel[lo:lo + k]
                if fused:
                    self._leaf_scatter(q, gate[lo:lo + k], blk, words, hits)
                    continue
                rows = (blk[:, None] * b + offs[None]).reshape(-1)
                vids = self._chunk_vids(blk, rows)
                union_bitmap.scatter(
                    words, self.num_vertices, self._leaf_mask(q, rows, vids),
                    bmask[:, blk], vids.reshape(len(rows), -1), q.out_ids,
                    hits)
        with spans.stage("search.phase2"):
            st["hit_rows"] = int(hits)      # waits for the chunks
        return words


class _PESearch(_PackedSearch):
    """What the PE modes share: the query rows and phase 1 over the
    block summaries (f64 in array mode; table mode's f32 widen to f64
    exactly in each compare).  A mode supplies phase 2."""

    def _prepare(self, query: PEQuery):
        rows = np.asarray(query.plan_rows, dtype=np.int64)
        t = query.pde
        return SimpleNamespace(
            rows=len(rows), num_out=query.num_query_vertices,
            host_labels=t.labels[rows],
            labels=self._put(t.labels[rows]),
            degrees=self._put(t.degrees[rows]),
            thresh=self._put(eps_threshold(t.pde[rows],
                                           self.base_epsilon)),
            pde_label=self._put(t.pde_label[rows]),
            out_ids=self._put(t.vids[rows].astype(np.int32)))

    def _phase1(self, q, lo: int, hi: int) -> torch.Tensor:
        return block_filter.box_mask(
            self.b_ub[lo:hi], self.b_llo[lo:hi], self.b_lhi[lo:hi],
            self.b_deg[lo:hi], q.thresh, q.pde_label, q.degrees)

    def _prune(self, q, bmask: torch.Tensor) -> torch.Tensor:
        return bmask


class DevicePackedPESearch(_PESearch):
    """PE packed index resident on ``device`` in array mode, uploaded
    from a ``PackedDominanceIndex``: labels, degrees and vids int32[P,
    L] and pde f64[P, L·D] per entry, and f64 block summaries."""

    _ROW_FIELDS = ("d_labels", "d_degrees", "d_vids", "d_pde")
    _BLOCK_FIELDS = ("b_ub", "b_llo", "b_lhi", "b_deg")

    def __init__(self, index, device, base_epsilon: float = EPSILON):
        self.device = as_device(device)
        self.base_epsilon = base_epsilon
        self.block_size = b = index.block_size
        self.num_blocks = nb = len(index.blk_ub)
        self.width = index.pde.shape[1]
        rows = nb * b
        self.d_labels = self._upload(index.labels, rows, -2)
        self.d_degrees = self._upload(index.degrees, rows, 0)
        self.d_vids = self._upload(index.vids, rows, 0)
        self.d_pde = self._upload(index.pde, rows, 0.0)
        self.b_ub = self._put(index.blk_ub)
        self.b_llo = self._put(index.blk_label_lo)
        self.b_lhi = self._put(index.blk_label_hi)
        self.b_deg = self._put(index.blk_max_deg)
        self.num_vertices = int(index.vids.max(initial=0)) + 1
        self.last_stats = None

    def _chunk_vids(self, blk, rows) -> torch.Tensor:
        return self.d_vids[rows]

    def _leaf_mask(self, q, rows, vids) -> torch.Tensor:
        return pe_mask_exact(self.d_labels[rows], self.d_degrees[rows],
                             self.d_pde[rows], q.labels, q.degrees, q.thresh)


class _TableLayout(_PESearch):
    """What table mode and streamed mode share: the per-vertex tables
    ``t_labels``, ``t_degrees`` and ``t_vde`` (f64) with a sentinel row
    at V, through which the leaf test gathers a chunk's vid rows; f32
    block summaries; the per-block signature ranges of the sort key,
    which prune blocks after phase 1; the sorted vid table on the host
    (``_host_vids``); ``save`` and ``load``; phase 1, the prune and the
    selection as the fused filter, and phase 2 as the fused leaf test.  A
    mode supplies ``_vid_blocks`` (a vid table on the device and the
    chunk's blocks in it)."""

    streamed = False
    fuses_filter = True
    fuses_leaf = True
    _ROW_FIELDS = ("d_vids",)
    _BLOCK_FIELDS = ("b_ub", "b_llo", "b_lhi", "b_deg", "_blk_sig_first",
                     "_blk_sig_last")
    _HOST_ROW_FIELDS = ("_host_vids",)

    def _init_layout(self, vertices, tables, host_vids, summaries,
                     sig_first, sig_last, sig_radix, num_entries,
                     block_size, base_epsilon) -> None:
        self.device = tables["labels"].device
        self.base_epsilon = base_epsilon
        self.block_size = block_size
        self.num_entries = num_entries
        self.num_blocks = summaries[0].shape[0]
        self.width = summaries[0].shape[1]
        self.num_vertices = vertices.num_vertices
        self.t_labels = tables["labels"]
        self.t_degrees = tables["degrees"]
        self.t_vde = tables["vde"]
        self.b_ub, self.b_llo, self.b_lhi, self.b_deg = summaries
        self._host_vids = host_vids
        self._blk_sig_first = sig_first
        self._blk_sig_last = sig_last
        self._sig_radix = sig_radix
        self.build_phase_ms = None
        self.last_stats = None

    def save(self, path: str) -> None:
        """Write the index in gnnpe_tpu's npz format (its ``save``): the
        sorted vid table, the f32 summaries, the signature ranges and
        ``meta`` = [entries, block size, blocks, blocks per shard,
        streamed, signature radix, sidecar, L].  A table above
        ``SIDECAR_BYTES``, and any table that is an ``np.memmap``, goes
        raw to ``<path>.vids.bin`` in bounded pieces.  The per-vertex
        tables are not stored: ``load`` rebuilds them from the
        embeddings.

        On a sharded index this is a collective call over a file system
        the ranks share: the table always goes to the sidecar, each rank
        writing its own block range at its offset, and rank 0 writes the
        npz with every rank's summaries.  The
        port's shards carry no pad blocks, so the file is the one a
        single device would write, whatever the mesh's width."""
        hv = self._host_vids
        l = hv.shape[1]
        sharded = self.group is not None
        big = (sharded or isinstance(hv, np.memmap)
               or hv.nbytes > SIDECAR_BYTES)
        # Per-block arrays and block counts of every rank, in rank order.
        blocks = gather_objects(
            [self.b_ub.cpu().numpy(), self.b_llo.cpu().numpy(),
             self.b_lhi.cpu().numpy(), self.b_deg.cpu().numpy(),
             np.asarray(self._blk_sig_first), np.asarray(self._blk_sig_last)],
            self.group)
        first = self.block_range[0] if sharded else 0
        writer = dist_rank(self.group) == 0
        total = sum(len(part[0]) for part in blocks)
        if big:
            if writer:
                with open(path + ".vids.bin", "wb") as f:
                    f.truncate(total * self.block_size * l * 4)
            barrier(self.group)
            step = max(1, (1 << 26) // l)
            with open(path + ".vids.bin", "r+b") as f:
                f.seek(first * self.block_size * l * 4)
                for lo in range(0, len(hv), step):
                    f.write(np.ascontiguousarray(hv[lo:lo + step]).tobytes())
            barrier(self.group)
        if writer:
            cat = [np.concatenate([part[i] for part in blocks])
                   for i in range(6)]
            np.savez(path, blk_ub=cat[0], blk_llo=cat[1], blk_lhi=cat[2],
                     blk_deg=cat[3], blk_sig_first=cat[4],
                     blk_sig_last=cat[5],
                     meta=np.array([self.num_entries, self.block_size, total,
                                    max(len(part[0]) for part in blocks),
                                    int(self.streamed), self._sig_radix,
                                    int(big), l], np.int64),
                     host_vids=(np.zeros((0, l), np.int32) if big
                                else np.asarray(hv)))
        barrier(self.group)         # the file is whole when save returns

    @staticmethod
    def load(path: str, vertices, device, base_epsilon: float = EPSILON,
             cache_bytes: Optional[float] = None, cache: bool = True,
             mesh=None, axis: str = "graph"):
        """The index from a file ``save`` wrote, here or in gnnpe_tpu
        (with any number of shards: its pad blocks carry the signature
        range 2^62 and never survive), as the class the file names: a
        ``TablePESearch``, which raises ``MemoryError`` where it does
        not fit, or for a streamed file a ``StreamedPESearch`` (with
        ``cache_bytes`` and ``cache``) over an ``np.memmap`` of the
        sidecar, or over the table in the file.  ``vertices`` are the
        embeddings the index was built from.

        With ``mesh`` every rank of ``axis`` reads its own block range
        of the file (of the sidecar's rows, where there is one) and
        holds nothing else.  gnnpe_tpu insists on the mesh width a file
        was saved with because its shards are padded to one size; the
        port's are not, so a file loads at any width."""
        device = as_device(device)
        with np.load(path) as z:
            meta = [int(x) for x in z["meta"]]
            arrays = {k: z[k] for k in z.files}
        p, b, streamed, sig_radix = meta[0], meta[1], meta[4], meta[5]
        if not (len(meta) > 6 and meta[6]):
            hv = arrays["host_vids"]
        elif streamed:
            hv = np.memmap(path + ".vids.bin", dtype=np.int32,
                           mode="r").reshape(-1, meta[7])
        else:
            hv = np.fromfile(path + ".vids.bin", dtype=np.int32).reshape(
                -1, meta[7])
        nb = len(arrays["blk_ub"])
        if len(hv) != nb * b:
            raise ValueError(f"{path}: {len(hv)} vid rows for {nb} blocks "
                             f"of {b}")
        block_range = None
        if mesh is not None:
            lo, hi = block_range = shard_bounds(
                nb, axis_size(mesh, axis), axis_rank(mesh, axis))
            hv = hv[lo * b:hi * b]
            for k in ("blk_ub", "blk_llo", "blk_lhi", "blk_deg",
                      "blk_sig_first", "blk_sig_last"):
                arrays[k] = arrays[k][lo:hi]
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if not streamed:
            _check_fits(hv.nbytes, device, f"loading {path}")
        tables = _vertex_tables(vertices, device)
        layout = (tuple(put(arrays[k]) for k in ("blk_ub", "blk_llo",
                                                 "blk_lhi", "blk_deg")),
                  arrays["blk_sig_first"], arrays["blk_sig_last"], sig_radix,
                  p, b, base_epsilon)
        if streamed:
            self = StreamedPESearch(vertices, tables, hv, *layout,
                                    cache_bytes=cache_bytes, cache=cache)
        else:
            self = TablePESearch(vertices, tables, put(hv), hv, *layout)
        if mesh is not None:
            self.block_range = block_range
            self.group = axis_group(mesh, axis)
        return self

    def _filter(self, q):
        """Phase 1, the prune and the selection in one call of
        ``block_filter.filter``: (sel, gate rows, phase1, survived).  A
        row's exact-label matches lie in the run of blocks whose
        signature range holds its signature (conservative: equal labels
        give equal signatures), found on the host."""
        qsig = path_sig(q.host_labels, self._sig_radix)
        runs = np.stack([
            np.searchsorted(self._blk_sig_last, qsig, side="left"),
            np.searchsorted(self._blk_sig_first, qsig, side="right")])
        return block_filter.filter(
            self.b_ub, self.b_llo, self.b_lhi, self.b_deg, q.thresh,
            q.pde_label, q.degrees.int(), self._put(runs.astype(np.int64)))

    def _fused_chunk(self, k: int, n_sel: int) -> int:
        """The blocks one fused launch takes: every surviving block where
        the table is resident; streamed mode keeps its chunk, bounded by
        its pool."""
        return k if self.streamed else max(1, n_sel)

    def _leaf_scatter(self, q, gate, blk, words, hits) -> None:
        """The blocks ``blk`` leaf-tested against the query rows of their
        gate rows ``gate`` (bool [len(blk), Q], the fused filter's) and
        their hits OR-ed into ``words`` by one launch of
        ``leaf_scatter.scatter``: no gathered table, mask or row index is
        made."""
        vids, ids = self._vid_blocks(blk)
        leaf_scatter.scatter(
            words, self.num_vertices, vids, ids, self.block_size, gate,
            self.t_labels, self.t_degrees, self.t_vde, q.labels.int(),
            q.degrees.int(), q.thresh, q.out_ids, hits)


load = _TableLayout.load


class TablePESearch(_TableLayout):
    """PE packed index resident on ``device`` in table mode, built there
    by ``build_from_paths`` or read by ``load``: the layout of
    ``_TableLayout`` with the vid table int32[NB·B, L] on the device
    (``d_vids``), which the fused leaf test reads."""

    def __init__(self, vertices, tables, vids, host_vids, summaries,
                 sig_first, sig_last, sig_radix, num_entries, block_size,
                 base_epsilon: float = EPSILON):
        self._init_layout(vertices, tables, host_vids, summaries, sig_first,
                          sig_last, sig_radix, num_entries, block_size,
                          base_epsilon)
        self.d_vids = vids

    def _vid_blocks(self, blk):
        return self.d_vids, blk

    @classmethod
    def build_from_paths(cls, paths, vertices, device,
                         block_size: int = 512,
                         base_epsilon: float = EPSILON) -> "TablePESearch":
        """The index built on ``device`` (gnnpe_tpu's
        ``DevicePackedPESearch.build_from_paths``, resident).

        paths: int32[P, L], numpy or a tensor (on ``device`` it is used
        in place); vertices: the f64 ``VertexEmbeddings``.  The
        composite sort key, computed in steps, is ordered by
        ``stable_order`` (numpy's stable argsort), the vid table is
        permuted and folded into block summaries, and one copy of the
        sorted table comes back for ``save``.  Stage
        times (ms, the device synchronised at each edge) land in
        ``build_phase_ms``.  Raises ``MemoryError`` when the build does
        not fit ``device``.  (Over a mesh every rank builds the whole
        index — the sort is global — and ``shard`` keeps its block
        range.)"""
        device = as_device(device)
        if block_size < 1:
            raise ValueError(f"block_size must be positive: {block_size}")
        p, l = paths.shape
        nb = -(-p // block_size)
        on_device = (isinstance(paths, torch.Tensor)
                     and paths.device == device)
        _check_fits(table_build_bytes(p, l, block_size, on_device,
                                      vertices.num_vertices, vertices.dim),
                    device, f"a table-mode build of {p} paths")
        t = StageTimer(device)
        with t.stage("tables"):
            tables = _vertex_tables(vertices, device)
        with t.stage("upload"):
            paths = torch.as_tensor(paths, dtype=torch.int32, device=device)
        with t.stage("key"):
            key = sort_key_steps(paths, (tables["vde_up"],
                                         sig_radix_of(vertices),
                                         tables["labels"].long()))
        with t.stage("sort"):
            order = stable_order(key)
        with t.stage("sig_ranges"):
            # The sorted key's signature at each block's first and last
            # row; the key goes before the fold allocates the table.
            first = torch.arange(nb, device=device) * block_size
            last = torch.clamp(first + block_size, max=p) - 1
            sig_first, sig_last = (
                (key[order[i].long()] >> 32).cpu().numpy()
                for i in (first, last))
            del key, first, last
        with t.stage("permute_fold"):
            vids, summaries = permute_fold(paths, order, tables, block_size)
            del order
        with t.stage("d2h"):
            host_vids = _host_copy(vids)
        self = cls(vertices, tables, vids, host_vids, summaries, sig_first,
                   sig_last, sig_radix_of(vertices), p, block_size,
                   base_epsilon)
        self.build_phase_ms = t.times_ms
        return self


class StreamedPESearch(_TableLayout):
    """PE packed index past device memory: ``_TableLayout`` with the
    sorted vid table on the host only (``_host_vids``: page-locked
    memory, or an ``np.memmap`` for the disk tier), so the index is
    bounded by host memory or disk and not by the device.  Built on the
    host by ``build_from_paths`` or bucket by bucket by
    index/bucket_build.py, or read by ``load``.

    ``_vid_blocks`` brings a chunk's vid rows to the device: from the
    ``DeviceChunkCache`` pool by slot, after the chunk's misses were
    uploaded, or with ``cache=False`` by an upload of the chunk's
    host-gathered rows.  Both go through one ring of page-locked staging
    buffers (``_StagingRing``), which is what bounds the host memory in
    flight; the pool has one copy, written in place on the stream the
    search runs on.

    cache_bytes: the pool's budget; ``None`` means ``CACHE_SHARE`` of
    the device's free memory when the pool is first needed.  A chunk
    never holds more blocks than the pool (``_chunk_limit``), so a small
    pool makes more chunks and is never switched off; a budget under
    one block raises, and so does a pool that the device cannot
    allocate (``degrade_cache`` shrinks the budget for a retry).
    ``last_stats`` gains ``cache_hits``, ``cache_misses`` and
    ``uploaded_bytes`` per search."""

    streamed = True

    def __init__(self, vertices, tables, host_vids, summaries, sig_first,
                 sig_last, sig_radix, num_entries, block_size,
                 base_epsilon: float = EPSILON,
                 cache_bytes: Optional[float] = None, cache: bool = True,
                 owned_table_path: Optional[str] = None,
                 owned_dir: Optional[str] = None):
        self._init_layout(vertices, tables, host_vids, summaries, sig_first,
                          sig_last, sig_radix, num_entries, block_size,
                          base_epsilon)
        self.cache_bytes = cache_bytes
        self.use_cache = cache
        self._cache = None
        self._ring = _StagingRing(self.device, block_size,
                                  host_vids.shape[1])
        # The disk-tier table of a bucketed build, and the build's own
        # directory, belong to the index and go with ``close`` (``save``
        # writes its own sidecar).
        self._owned_table_path = owned_table_path
        self._owned_dir = owned_dir

    @classmethod
    def build_from_paths(cls, paths, vertices, device,
                         block_size: int = 512,
                         base_epsilon: float = EPSILON,
                         cache_bytes: Optional[float] = None,
                         cache: bool = True,
                         workers: int = 2) -> "StreamedPESearch":
        """The index built on the host in one piece (gnnpe_tpu's
        ``build_from_paths(resident=False)``): the numpy composite sort
        key, one stable argsort, the permutation gather into the host
        table, the signature ranges, and the summaries folded on the
        host; only the summaries and the per-vertex tables go to
        ``device``.  The vid table, the summaries and the ranges equal
        ``TablePESearch.build_from_paths``'s.  Stage times (ms) land in
        ``build_phase_ms``.  (After ``shard`` the rank's host table, its
        cache pool and its uploads cover its block range only.)"""
        device = as_device(device)
        if block_size < 1:
            raise ValueError(f"block_size must be positive: {block_size}")
        paths = (paths.cpu().numpy() if isinstance(paths, torch.Tensor)
                 else np.asarray(paths))
        p, l = paths.shape
        nb = -(-p // block_size)
        t = StageTimer()
        with t.stage("tables"):
            host_tabs = _vertex_tables_host(vertices)
        with t.stage("host_sort"):
            key = composite_sort_key(paths, vertices)
            order = np.argsort(key, kind="stable")
        with t.stage("host_vids"):
            hv = _host_table(nb * block_size, l, device, None)
            np.take(paths, order, axis=0, out=hv[:p], mode="clip")
            hv[p:] = vertices.num_vertices
            sig = key[order] >> 32
            first = np.arange(nb) * block_size
            sig_first = sig[first]
            sig_last = sig[np.minimum(first + block_size, p) - 1]
            del key, order, sig
        with t.stage("host_fold"):
            summaries = _host_fold_summaries(hv, host_tabs, block_size,
                                             workers)
        with t.stage("summaries_put"):
            self = cls(vertices, _vertex_tables(vertices, device, host_tabs),
                       hv, tuple(torch.from_numpy(a).to(device)
                                 for a in summaries),
                       sig_first, sig_last, sig_radix_of(vertices), p,
                       block_size, base_epsilon, cache_bytes, cache)
        self.build_phase_ms = t.times_ms
        return self

    def resident_tensors(self) -> dict:
        out = super().resident_tensors()
        if self._cache is not None:
            out["cache_pool"] = self._cache.buf
        return out

    def _ensure_cache(self) -> Optional[DeviceChunkCache]:
        """The block cache, made at first use; None with ``cache=False``."""
        if self.use_cache and self._cache is None:
            budget = (CACHE_SHARE * free_bytes(self.device)
                      if self.cache_bytes is None else self.cache_bytes)
            self._cache = DeviceChunkCache(
                self.device, self._host_vids.shape[1], self.block_size,
                self.num_blocks, budget, self._ring)
        return self._cache

    def degrade_cache(self, factor: float = 0.5) -> float:
        """Free the pool and shrink its budget by ``factor`` for the next
        search, which makes the pool anew: what a caller does when the
        device runs out of memory beside a full pool.  Returns the new
        budget in bytes."""
        if self._cache is not None:
            cur = self._cache.budget_bytes
        elif self.cache_bytes is not None:
            cur = self.cache_bytes
        else:
            cur = CACHE_SHARE * free_bytes(self.device)
        self._cache = None
        self.cache_bytes = cur * factor
        return self.cache_bytes

    def prefill_cache(self, max_seconds: float = 1e9,
                      order: str = "popular") -> int:
        """Load blocks into the pool before queries run, up to its
        capacity.  ``order="popular"`` takes the longest runs of blocks
        of one label signature first (query label sequences follow the
        data's, so long runs are likelier to be touched and cost more to
        miss), ``"index"`` takes blocks in index order.  Returns the
        blocks loaded, 0 with the cache off."""
        if order not in ("popular", "index"):
            raise ValueError(f"order must be 'popular' or 'index', "
                             f"got {order!r}")
        self._check_open()
        cache = self._ensure_cache()
        if cache is None:
            return 0
        # Pad blocks of a file gnnpe_tpu saved are never searched.
        real = np.nonzero(np.asarray(self._blk_sig_first) < PAD_SIG)[0]
        if order == "popular" and len(real):
            sig = np.asarray(self._blk_sig_first)[real]
            new_run = np.ones(len(real), bool)
            np.not_equal(sig[1:], sig[:-1], out=new_run[1:])
            run_id = np.cumsum(new_run) - 1
            run_len = np.bincount(run_id)
            real = real[np.argsort(-run_len[run_id], kind="stable")]
        return cache.prefill(self._host_vids, real, max_seconds)

    def close(self) -> None:
        """Free the device's pool, tables and summaries, drop the host
        table, unlink the disk-tier file a bucketed build left and
        remove the build's directory (the index owns both; a mapped
        file's space is freed at the last unmap).  A closed index raises
        on ``search``."""
        self._cache = None
        self._ring = None
        self.t_labels = self.t_degrees = self.t_vde = None
        self.b_ub = self.b_llo = self.b_lhi = self.b_deg = None
        self._host_vids = None
        if self._owned_table_path is not None:
            tp, self._owned_table_path = self._owned_table_path, None
            try:
                os.unlink(tp)
            except OSError:
                pass
        if self._owned_dir is not None:
            d, self._owned_dir = self._owned_dir, None
            shutil.rmtree(d, ignore_errors=True)

    def _check_open(self) -> None:
        if self._host_vids is None:
            raise RuntimeError("this StreamedPESearch was closed")

    def search(self, query) -> List[np.ndarray]:
        self._check_open()
        cache = self._ensure_cache()
        before = (cache.hits, cache.misses) if cache else None
        uploaded = self._ring.uploaded_bytes
        out = super().search(query)
        if self.last_stats is not None:
            self.last_stats["uploaded_bytes"] = (self._ring.uploaded_bytes
                                                 - uploaded)
            if cache:
                self.last_stats.update(cache_hits=cache.hits - before[0],
                                       cache_misses=cache.misses - before[1])
        return out

    def _narrow(self, lo: int, hi: int) -> None:
        # A pool made before the cut maps the whole index's block ids to
        # its slots; the next search makes one over the rank's range.
        super()._narrow(lo, hi)
        self._cache = None

    def _chunk_limit(self, k: int) -> int:
        return min(k, self._cache.capacity) if self._cache else k

    def _vid_blocks(self, blk):
        blks = blk.cpu().numpy()
        b, l = self.block_size, self._host_vids.shape[1]
        if self._cache is not None:
            return self._cache.buf, torch.from_numpy(self._cache.ensure(
                blks, self._host_vids)).to(self.device)
        out = torch.empty((len(blks), b, l), dtype=torch.int32,
                          device=self.device)
        for lo, dev in self._ring.pieces(
                self._host_vids.reshape(-1, b, l), blks):
            out[lo:lo + len(dev)] = dev
        return out.view(-1, l), torch.arange(len(blks), device=self.device)


class DevicePackedPGESearch(_PackedSearch):
    """PGE packed vertex index (``PGEPackedIndex``) resident on
    ``device``: per-vertex labels, degrees, group upper bounds and
    label-group boxes, the entry→vertex order, and block summaries."""

    _ROW_FIELDS = ("d_labels", "d_degrees", "d_ghi", "d_llo", "d_lhi",
                   "d_order")
    _BLOCK_FIELDS = ("b_gub", "b_llo", "b_lhi", "b_deg", "_blk_lab_first",
                     "_blk_lab_last")

    def __init__(self, index, device, base_epsilon: float = EPSILON):
        self.device = as_device(device)
        self.base_epsilon = base_epsilon
        self.block_size = b = index.block_size
        self.num_blocks = nb = len(index.blk_group_ub)
        self.width = index.group.shape[2]
        rows = nb * b
        self.d_labels = self._upload(index.labels, rows, -2)
        self.d_degrees = self._upload(index.degrees, rows, 0)
        self.d_ghi = self._upload(index.group[:, 1, :], rows, 0.0)
        self.d_llo = self._upload(index.label_group[:, 0, :], rows, 0.0)
        self.d_lhi = self._upload(index.label_group[:, 1, :], rows, 0.0)
        self.d_order = self._upload(index.order.astype(np.int32), rows, -1)
        self.b_gub = self._put(index.blk_group_ub)
        self.b_llo = self._put(index.blk_lgroup_lo)
        self.b_lhi = self._put(index.blk_lgroup_hi)
        self.b_deg = self._put(index.blk_max_deg)
        # Entries are label-sorted, so a query vertex's exact-label
        # matches live in one contiguous block run [first, last].
        nv = len(index.order)
        lab = index.labels.astype(np.int64)
        self._blk_lab_first = lab[np.arange(nb) * b]
        self._blk_lab_last = lab[np.minimum(np.arange(1, nb + 1) * b,
                                            nv) - 1]
        self.num_vertices = int(index.order.max(initial=0)) + 1
        self.last_stats = None

    def close(self) -> None:
        """Release the device tensors (gnnpe_tpu's ``close``).  A closed
        index raises on ``search``."""
        for name in self._ROW_FIELDS + self._BLOCK_FIELDS[:4]:
            setattr(self, name, None)
        self.num_blocks = None

    def _prepare(self, query: PGEQuery):
        if self.num_blocks is None:
            raise RuntimeError("this DevicePackedPGESearch was closed")
        return SimpleNamespace(
            rows=len(query.labels), num_out=len(query.labels),
            host_labels=np.asarray(query.labels, dtype=np.int64),
            labels=self._put(query.labels),
            degrees=self._put(query.degrees),
            glo=self._put(eps_threshold(query.group[:, 0, :],
                                        self.base_epsilon)),
            llo=self._put(query.label_group[:, 0, :]),
            lhi=self._put(query.label_group[:, 1, :]),
            out_ids=torch.arange(len(query.labels), dtype=torch.int32,
                                 device=self.device)[:, None])

    def _phase1(self, q, lo: int, hi: int) -> torch.Tensor:
        dom = (self.b_gub[None, lo:hi] >= q.glo[:, None]).all(-1)
        overlap = ((self.b_lhi[None, lo:hi] >= q.llo[:, None]) &
                   (q.lhi[:, None] >= self.b_llo[None, lo:hi])).all(-1)
        deg = q.degrees[:, None] <= self.b_deg[None, lo:hi]
        return dom & overlap & deg

    def _prune(self, q, bmask: torch.Tensor) -> torch.Tensor:
        """A query vertex's exact-label matches lie in its label's run
        of blocks.  The runs' lengths, summed over the rows, are what
        the prune lets through (``label_run_blocks``)."""
        lab = q.host_labels
        lo = np.searchsorted(self._blk_lab_last, lab, side="left")
        hi = np.searchsorted(self._blk_lab_first, lab, side="right")
        q.label_run_blocks = int(np.maximum(hi - lo, 0).sum())
        cols = torch.arange(bmask.shape[1], device=self.device)[None]
        return (bmask & (cols >= self._put(lo)[:, None])
                & (cols < self._put(hi)[:, None]))

    def _search_local(self, q, spans: StageTimer):
        """The shared search, whose ``last_stats`` gains
        ``label_run_blocks``: ``phase1`` counts the blocks the box tests
        keep, this the blocks inside the rows' label runs, ``survived``
        the blocks both keep."""
        out = super()._search_local(q, spans)
        if self.last_stats is not None:
            self.last_stats["label_run_blocks"] = q.label_run_blocks
        return out

    def _chunk_vids(self, blk, rows) -> torch.Tensor:
        return self.d_order[rows]

    def _leaf_mask(self, q, rows, vids) -> torch.Tensor:
        return pge_mask_exact(self.d_labels[rows], self.d_degrees[rows],
                              self.d_ghi[rows], self.d_llo[rows],
                              self.d_lhi[rows], q.labels, q.degrees,
                              q.glo, q.llo, q.lhi)
