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

gnnpe_tpu overlapped the stages with a worker pool, streamed the
unsorted table through a chunk uploader and prewarmed the fold on a
thread; CUDA queues work asynchronously, so none of that is needed.  The
streamed (bucketed) branch waits for the streamed mode (ROADMAP Queue
A 9).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.index.device_packed import TablePESearch
from gnnpe_tpu_torch.ops.spmm import neighbor_sum
from gnnpe_tpu_torch.paths.device_enumerate import (enumerate_dedup_device,
                                                    enumerate_paths_device)
from gnnpe_tpu_torch.utils.device import as_device
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
                            block_size: int = 512):
    """PE offline stage through the resident table-mode index on
    ``device``.  Returns (paths int32[P, L] on the device, in
    enumeration order; the ``TablePESearch``, whose ``build_phase_ms``
    holds the build's stages; timings in s: ``enumerate_s`` (with the
    dedup), ``build_s`` and ``total_s``)."""
    device = as_device(device)
    t_all = time.perf_counter()
    t = StageTimer(device)
    with t.stage("enumerate"):
        paths = enumerate_dedup_device(graph, order, num_vertices_per_path,
                                       device)
    with t.stage("build"):
        idx = TablePESearch.build_from_paths(paths, vertices, device,
                                             block_size=block_size)
    timings = {f"{k}_s": v / 1e3 for k, v in t.times_ms.items()}
    timings["total_s"] = time.perf_counter() - t_all
    return paths, idx, timings
