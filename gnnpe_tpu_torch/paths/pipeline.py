"""The offline stage on the device under gnnpe_tpu/paths/pipeline.py's
names.

``offline_pipelined`` enumerates paths and gathers their f32 PDE rows
from a VDE computed once by kernel A1.  ``offline_build_pipelined`` is
the engine's PE device build — the calls ``PEEngine.offline(device=
True)`` and ``build_index(table=True)`` make — on a given start order
and embedding: paths enumerated and deduplicated on the device chunk by
chunk, then the table-mode index built from them.  Its output equals
the sequential ``enumerate_paths(dedup=True)`` plus ``build_from_paths``:
chunks partition the start order and the dedup rule is local to a row.
Where the table does not fit the device (``resident``), the chunks go
to the host as they are enumerated and the streamed index is built from
them bucket by bucket (index/bucket_build.py), so the device never holds
all paths either.

gnnpe_tpu overlapped the stages with a worker pool, streamed the
unsorted table through a chunk uploader and prewarmed the fold on a
thread; CUDA queues work asynchronously, so none of that is needed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.index.bucket_build import (BUILD_CHUNK_PATHS,
                                                build_streamed_from_chunks)
from gnnpe_tpu_torch.index.device_packed import (StreamedPESearch,
                                                 TablePESearch,
                                                 builds_resident,
                                                 table_build_bytes)
from gnnpe_tpu_torch.ops.spmm import neighbor_sum
from gnnpe_tpu_torch.paths.device_enumerate import (dedup_chunks,
                                                    enumerate_dedup_device,
                                                    enumerate_paths_device,
                                                    known_path_count)
from gnnpe_tpu_torch.utils.device import as_device, free_bytes
from gnnpe_tpu_torch.utils.timers import StageTimer


def offline_pipelined(graph: CSRGraph, order: np.ndarray,
                      num_vertices_per_path: int, label_table, device):
    """(paths int32[P, L], pde f32[P, L·D]) on ``device``: the paths
    from ``order`` (no dedup) and their concatenated f32 VDE rows.

    label_table: f32[num_labels, D] per-label features; x[v] =
    table[label[v]] and vde = x + Σ_nbr x run once on the device
    (kernel A1 in f32), then the PDE rows are gathered."""
    device = as_device(device)
    offsets, neighbors, labels, _ = to_device(graph, device)
    table = torch.as_tensor(np.asarray(label_table, np.float32),
                            device=device)
    _, vde = neighbor_sum(offsets, neighbors, table[labels.long()],
                          with_vde=True)
    paths = enumerate_paths_device(graph, order, num_vertices_per_path,
                                   device)
    return paths, vde[paths.long()].flatten(1)


def offline_build_pipelined(graph: CSRGraph, order: np.ndarray,
                            num_vertices_per_path: int, vertices, device,
                            block_size: int = 512, resident=None,
                            spill_dir=None, cache_bytes=None,
                            cache: bool = True, budget_bytes=None):
    """PE offline stage through the table-mode index on ``device``.

    resident: True builds the resident ``TablePESearch`` (``MemoryError``
    where it does not fit).  None decides before anything is enumerated:
    resident iff ``builds_resident`` says so with the path count known
    beforehand, the paths counted as still to be allocated (the
    enumeration writes them into one table on the device, which the
    build then holds beside its own peak) and ``budget_bytes`` as
    ``auto_resident``'s; paths of more than 3 vertices, whose count is
    not known, build resident.  Between enumeration and build the
    enumeration's cached chunk buffers go back to the device.  False
    builds the ``StreamedPESearch``: bucketed where the count is known,
    every enumerated chunk copied to the host in pieces of
    ``BUILD_CHUNK_PATHS`` rows, keyed and partitioned (into ``spill_dir``
    where one is named), else in one piece on the host (gnnpe_tpu also
    builds 2-vertex paths in one piece; the index is the same).
    ``cache_bytes`` and ``cache`` are the streamed search's.

    Returns (paths int32[P, L]: on the device in enumeration order after
    a resident build, the index's host table in index order after a
    streamed one — the same rows; the search, whose ``build_phase_ms``
    holds the build's stages; timings in s: ``enumerate_s`` (with the
    dedup), ``build_s`` and ``total_s``, ``mode``, and where the rule
    decided, ``rule_need_bytes`` (``table_build_bytes``) and
    ``rule_free_bytes``; after a streamed build bucket_build's
    counts)."""
    device = as_device(device)
    l = num_vertices_per_path
    t_all = time.perf_counter()
    known_p = known_path_count(graph, l)
    rule = {}
    if resident is None and known_p is not None:
        rule = dict(rule_need_bytes=table_build_bytes(
            known_p, l, block_size, False, vertices.num_vertices,
            vertices.dim), rule_free_bytes=free_bytes(device))
        resident = builds_resident(known_p, l, block_size, device, False,
                                   vertices.num_vertices, vertices.dim,
                                   budget_bytes)
    elif resident is None:
        resident = True
    if not resident and known_p is not None:
        chunks = (piece.cpu().numpy()
                  for rows in dedup_chunks(graph, order, l, device)
                  for piece in rows.split(BUILD_CHUNK_PATHS))
        idx, timings = build_streamed_from_chunks(
            chunks, known_p, graph, order, l, vertices, device,
            block_size=block_size, spill_dir=spill_dir,
            cache_bytes=cache_bytes, cache=cache)
        # The enumeration runs inside the partition stage.
        timings["enumerate_s"] = timings["partition_s"]
        timings["total_s"] = time.perf_counter() - t_all
        timings.update(rule)
        return idx._host_vids[:known_p], idx, timings
    t = StageTimer(device)
    with t.stage("enumerate"):
        paths = enumerate_dedup_device(graph, order, l, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with t.stage("build"):
        if resident:
            idx = TablePESearch.build_from_paths(paths, vertices, device,
                                                 block_size=block_size)
        else:
            idx = StreamedPESearch.build_from_paths(
                paths, vertices, device, block_size=block_size,
                cache_bytes=cache_bytes, cache=cache)
    timings = {f"{k}_s": v / 1e3 for k, v in t.times_ms.items()}
    timings["total_s"] = time.perf_counter() - t_all
    timings["mode"] = "resident" if resident else "streamed"
    timings.update(rule)
    return paths, idx, timings
