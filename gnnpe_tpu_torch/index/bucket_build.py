"""Bucketed out-of-core build of the streamed PE index, on the host
(the port's numpy copy of gnnpe_tpu/index/bucket_build.py).

The monolithic streamed build (``StreamedPESearch.build_from_paths``)
is one global stable argsort and one permutation gather over the whole
path table, all of it in host memory.  This module replaces it with a
range-partitioned bucket sort, so that neither the paths nor the sorted
table need fit host memory:

  * While paths arrive chunk by chunk, each chunk's (rows, keys) are
    partitioned into contiguous key-range buckets (boundaries from a key
    sample taken beforehand).  Partitioning runs on worker threads;
    appends are cheap and serial.  In disk mode the partitions are
    appended to per-bucket files.
  * Then the buckets sort independently (one stable argsort each, on
    worker threads), write their sorted segment straight into the final
    table (an ``np.memmap`` where a disk tier is named), record the
    signature ranges of their blocks and fold the summaries of the
    blocks they hold whole.  Blocks that straddle a bucket boundary are
    folded in a last small pass.

The result equals the monolithic build, row for row: the range partition
respects key order (equal keys land in one bucket, ``side="right"``),
the stable sort of a bucket keeps arrival order within equal keys, and
chunks are fed in enumeration order.  So the concatenated segments are
the global stable argsort, which is also what ``TablePESearch`` sorts on
the device.

Dropped from gnnpe_tpu's: the ``mesh`` argument and the 32-aligned
per-shard block count (one device, no mask packing), and every
environment override — the spill directory is an argument, and nothing
is written where the caller did not say.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.index.device_packed import (StreamedPESearch,
                                                 _host_table,
                                                 _vertex_tables,
                                                 _vertex_tables_host,
                                                 composite_sort_key,
                                                 empty_summaries,
                                                 fold_blocks_host, key_tables,
                                                 sig_radix_of)
from gnnpe_tpu_torch.paths.enumerate import (dedup_orientations_streaming,
                                             enumerate_paths_from,
                                             start_ranks)
from gnnpe_tpu_torch.utils.device import as_device

# Path rows of one chunk a streamed build keys and partitions at once
# (the engine and the pipeline cut larger pieces to it).
BUILD_CHUNK_PATHS = 1 << 22
# Paths per bucket that gnnpe_tpu aims at, and its bounds on the count.
BUCKET_PATHS = 32_000_000
MIN_BUCKETS, MAX_BUCKETS = 8, 1024
# Shares of host memory past which the partitions (rows and keys) and
# the sorted table need the disk tier (gnnpe_tpu's 0.4 and 0.3).
SPILL_SHARE = 0.4
TABLE_SHARE = 0.3


def host_ram_bytes() -> float:
    """Physical host memory."""
    try:
        return float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError):
        return 64e9


def num_buckets(p: int) -> int:
    """Buckets for ``p`` paths: about ``BUCKET_PATHS`` a bucket."""
    return int(max(MIN_BUCKETS, min(MAX_BUCKETS, p // BUCKET_PATHS + 1)))


def sample_key_boundaries(graph, order: np.ndarray, l: int, vertices,
                          n_buckets: int, sample_starts: int = 8192,
                          seed: int = 0) -> np.ndarray:
    """Bucket boundaries int64[n_buckets - 1]: quantiles of the
    composite sort key over the paths of a uniform random sample of
    starts.  They shape only how even the buckets are, never the result
    (the range partition is exact whatever the boundaries)."""
    rng = np.random.RandomState(seed)
    take = min(sample_starts, len(order))
    starts = np.asarray(order)[rng.choice(len(order), size=take,
                                          replace=False)]
    rank = start_ranks(order, graph.num_vertices)
    ktabs = key_tables(vertices)
    keys: List[np.ndarray] = []
    for batch in np.array_split(starts, max(1, take // 256)):
        rows = enumerate_paths_from(graph, batch, l)
        rows = rows[dedup_orientations_streaming(rows, rank)]
        if len(rows):
            keys.append(composite_sort_key(rows, vertices, tables=ktabs))
    if not keys:
        return np.zeros(0, np.int64)
    k = np.concatenate(keys)
    k.sort()
    return k[len(k) * np.arange(1, n_buckets) // n_buckets]


class BucketSpill:
    """Range-partitioned spill of (path rows int32[*, l], keys
    int64[*]).  ``partition`` may run on worker threads (its argsort
    releases the GIL); ``append`` is the cheap serial step, and the
    order of appends is the order of arrival that ties keep.  With
    ``spill_dir`` each bucket's bytes are appended to its own pair of
    files there and host memory is freed; without, the partitioned
    chunks stay in memory."""

    def __init__(self, boundaries: np.ndarray, l: int,
                 spill_dir: Optional[str] = None):
        self.boundaries = np.asarray(boundaries, np.int64)
        self.nb = len(self.boundaries) + 1
        self.l = l
        self.dir = spill_dir
        self.counts = np.zeros(self.nb, np.int64)
        self.total = 0
        self.spilled_bytes = 0
        self._chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._files: dict = {}
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def partition(self, rows: np.ndarray, keys: np.ndarray):
        """A chunk's rows grouped by bucket, stably: (rows, keys,
        offsets int64[nb + 1]).  A key equal to a boundary goes to the
        bucket above it, so equal keys share a bucket."""
        bi = np.searchsorted(self.boundaries, keys, side="right")
        order = np.argsort(bi, kind="stable")
        offs = np.searchsorted(bi[order],
                               np.arange(self.nb + 1, dtype=np.int64))
        return rows[order], keys[order], offs

    def append(self, part) -> None:
        """Record one partitioned chunk (call in enumeration order)."""
        rows, keys, offs = part
        self.counts += offs[1:] - offs[:-1]
        self.total += len(rows)
        if self.dir is None:
            self._chunks.append((rows, keys, offs))
            return
        for b in range(self.nb):
            lo, hi = offs[b], offs[b + 1]
            if hi <= lo:
                continue
            fr, fk = self._handles(b)
            fr.write(np.ascontiguousarray(rows[lo:hi]).tobytes())
            fk.write(np.ascontiguousarray(keys[lo:hi]).tobytes())
        self.spilled_bytes += rows.nbytes + keys.nbytes

    def _handles(self, b: int):
        if b not in self._files:
            self._files[b] = (
                open(os.path.join(self.dir, f"rows_{b}.bin"), "wb"),
                open(os.path.join(self.dir, f"keys_{b}.bin"), "wb"))
        return self._files[b]

    def bucket(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """All rows and keys of bucket ``b`` in arrival order."""
        empty = (np.zeros((0, self.l), np.int32), np.zeros(0, np.int64))
        if self.dir is None:
            rs = [c[0][c[2][b]:c[2][b + 1]] for c in self._chunks]
            ks = [c[1][c[2][b]:c[2][b + 1]] for c in self._chunks]
            rs = [r for r in rs if len(r)]
            ks = [k for k in ks if len(k)]
            if not rs:
                return empty
            return np.concatenate(rs), np.concatenate(ks)
        if b not in self._files:
            return empty
        for f in self._files[b]:
            f.close()
        return (np.fromfile(os.path.join(self.dir, f"rows_{b}.bin"),
                            np.int32).reshape(-1, self.l),
                np.fromfile(os.path.join(self.dir, f"keys_{b}.bin"),
                            np.int64))

    def free(self, b: int) -> None:
        """Disk mode: delete bucket ``b``'s files once its sorted
        segment is written (bounds the disk in use)."""
        if self.dir is None or b not in self._files:
            return
        del self._files[b]
        for name in (f"rows_{b}.bin", f"keys_{b}.bin"):
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass

    def close(self) -> None:
        for pair in self._files.values():
            for f in pair:
                if not f.closed:
                    f.close()


def build_streamed_bucketed(spill: BucketSpill, vertices, l: int, device,
                            block_size: int = 512,
                            table_path: Optional[str] = None,
                            base_epsilon: float = EPSILON, workers: int = 2,
                            cache_bytes: Optional[float] = None,
                            cache: bool = True,
                            owned_dir: Optional[str] = None
                            ) -> StreamedPESearch:
    """A fed ``BucketSpill`` made into a ``StreamedPESearch``.

    The sorted vid table lands in ``table_path`` (an ``np.memmap``, the
    disk tier, which the index then owns and unlinks on ``close``, and
    ``owned_dir`` with it) where one is given, else in host memory, and
    equals
    ``StreamedPESearch.build_from_paths``'s either way.  Bucket jobs
    (sort, segment write, signature ranges, fold of the blocks held
    whole) run on ``workers`` threads; straddling and tail blocks fold
    in a last pass.  Stage times (ms) land in ``build_phase_ms``."""
    device = as_device(device)
    p = int(spill.total)
    b = block_size
    v = vertices.num_vertices
    nb = -(-p // b)

    t0 = time.perf_counter()
    tabs = _vertex_tables_host(vertices)
    t_tables = time.perf_counter() - t0

    t0 = time.perf_counter()
    hv = _host_table(nb * b, l, device, table_path)
    hv[p:] = v                       # sentinel pad tail
    offs = np.concatenate([[0], np.cumsum(spill.counts)])
    assert offs[-1] == p, (offs[-1], p)
    blk_first = np.empty(nb, np.int64)
    blk_last = np.empty(nb, np.int64)
    out = empty_summaries(nb, l, tabs["vde_up"].shape[1])

    def job(bi: int):
        rows, keys = spill.bucket(bi)
        r0, r1 = int(offs[bi]), int(offs[bi + 1])
        assert len(rows) == r1 - r0
        if r1 == r0:
            spill.free(bi)
            return
        o = np.argsort(keys, kind="stable")
        sr = rows[o]
        sk = keys[o] >> 32
        del rows, keys, o
        hv[r0:r1] = sr
        spill.free(bi)
        # Signature ranges of the blocks whose anchor rows lie in
        # [r0, r1): block g's first row is g·b, its last is
        # min((g+1)·b, p) − 1 (the tail block's last real row).
        for g in range(-(-r0 // b), -(-r1 // b)):
            if g * b < r1:
                blk_first[g] = sk[g * b - r0]
        for g in range(r0 // b, -(-r1 // b)):
            last_row = min((g + 1) * b, p) - 1
            if r0 <= last_row < r1:
                blk_last[g] = sk[last_row - r0]
        g0, g1 = -(-r0 // b), r1 // b
        fold_blocks_host(sr[g0 * b - r0:g1 * b - r0], g0, g1, b, tabs, out)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(job, range(spill.nb)))
    spill.close()
    t_sortw = time.perf_counter() - t0

    # Blocks with a bucket boundary inside them, and the partial tail
    # block: folded from the written table, in contiguous runs.
    t0 = time.perf_counter()
    done = np.zeros(nb, bool)
    for bi in range(spill.nb):
        r0, r1 = int(offs[bi]), int(offs[bi + 1])
        if r1 > r0:
            done[-(-r0 // b):r1 // b] = True
    todo = np.nonzero(~done)[0]
    if len(todo):
        run_starts = np.concatenate(
            [[0], np.nonzero(np.diff(todo) > 1)[0] + 1])
        run_ends = np.concatenate([run_starts[1:], [len(todo)]])
        for s, e in zip(run_starts, run_ends):
            g0, g1 = int(todo[s]), int(todo[e - 1]) + 1
            fold_blocks_host(np.asarray(hv[g0 * b:g1 * b]), g0, g1, b, tabs,
                             out)
    t_straddle = time.perf_counter() - t0

    t0 = time.perf_counter()
    self = StreamedPESearch(
        vertices, _vertex_tables(vertices, device, tabs), hv,
        tuple(torch.from_numpy(a).to(device) for a in out), blk_first,
        blk_last, sig_radix_of(vertices), p, b, base_epsilon, cache_bytes,
        cache, owned_table_path=table_path, owned_dir=owned_dir)
    t_put = time.perf_counter() - t0
    self.build_phase_ms = {
        "tables": t_tables * 1e3,
        "bucket_sort_write_fold": t_sortw * 1e3,
        "straddle_fold": t_straddle * 1e3,
        "summaries_put": t_put * 1e3,
    }
    return self


def build_streamed_from_chunks(chunks: Iterable[np.ndarray], p: int, graph,
                               order: np.ndarray, l: int, vertices, device,
                               block_size: int = 512,
                               spill_dir: Optional[str] = None,
                               workers: int = 4, **search_kw):
    """The bucketed streamed build end to end: boundaries sampled from
    ``graph`` over ``order``, every chunk of ``chunks`` (int32[n, l]
    path rows in enumeration order, ``p`` rows in all) keyed and
    partitioned on ``workers`` threads and appended in order, then
    ``build_streamed_bucketed``.

    spill_dir: where the partitions and the sorted table go: a directory
    of the call's own made in it (``spill_<random>``: per-bucket files,
    and ``leaf_table.bin`` as an ``np.memmap``), which the index owns
    and ``close`` removes, so that builds in one process or in several
    never write each other's files; ``None`` keeps both in host memory,
    and raises ``MemoryError`` where they would pass ``SPILL_SHARE`` or
    ``TABLE_SHARE`` of it — nothing is written where the caller did not
    say.  A build that fails removes its directory.  ``search_kw`` goes
    to the ``StreamedPESearch`` (``base_epsilon``, ``cache_bytes``,
    ``cache``).
    Returns (the index, timings in s and the bucket and spill counts)."""
    t_all = time.perf_counter()
    if spill_dir is None:
        ram = host_ram_bytes()
        if (p * (l * 4 + 8) > SPILL_SHARE * ram
                or p * l * 4 > TABLE_SHARE * ram):
            raise MemoryError(
                f"a streamed build of {p} paths does not fit host memory "
                f"({ram:.3g} B); name a spill_dir for the disk tier")
    own = None
    if spill_dir is not None:
        os.makedirs(spill_dir, exist_ok=True)
        own = tempfile.mkdtemp(prefix="spill_", dir=spill_dir)
    spill = None
    try:
        t0 = time.perf_counter()
        bounds = sample_key_boundaries(graph, order, l, vertices,
                                       num_buckets(p))
        spill = BucketSpill(bounds, l, own)
        t_sample = time.perf_counter() - t0

        t0 = time.perf_counter()
        ktabs = key_tables(vertices)

        def work(rows):
            rows = np.ascontiguousarray(rows, dtype=np.int32)
            return spill.partition(rows, composite_sort_key(
                rows, vertices, tables=ktabs))

        # At most ``workers`` chunks are being partitioned, and appends
        # are made in arrival order.
        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for rows in chunks:
                pending.append(pool.submit(work, rows))
                if len(pending) > workers:
                    spill.append(pending.popleft().result())
            while pending:
                spill.append(pending.popleft().result())
        if spill.total != p:
            raise ValueError(f"{spill.total} path rows were fed, {p} "
                             f"announced")
        t_partition = time.perf_counter() - t0

        t0 = time.perf_counter()
        table_path = os.path.join(own, "leaf_table.bin") if own else None
        idx = build_streamed_bucketed(spill, vertices, l, device,
                                      block_size=block_size,
                                      table_path=table_path, workers=workers,
                                      owned_dir=own, **search_kw)
    except BaseException:
        if own is not None:
            if spill is not None:
                spill.close()
            shutil.rmtree(own, ignore_errors=True)
        raise
    timings = {"sample_s": t_sample, "partition_s": t_partition,
               "build_s": time.perf_counter() - t0,
               "total_s": time.perf_counter() - t_all,
               "n_buckets": spill.nb, "spilled_bytes": spill.spilled_bytes,
               "table_memmap": table_path is not None, "mode": "streamed"}
    return idx, timings
