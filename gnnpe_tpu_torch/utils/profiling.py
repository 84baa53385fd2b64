"""Profiling and observability (counterpart of
gnnpe_tpu/utils/profiling.py).

  * :func:`trace` — a ``torch.profiler`` capture of a region, written as
    a Chrome trace (host ops, and on a CUDA device the kernels on the
    card);
  * :func:`annotate` — a named range over the enclosed work: a
    ``record_function`` in the trace, and on a CUDA device also an NVTX
    range for external profilers (the CPU build of torch has no NVTX);
  * :class:`MetricsLog` — structured (JSON-lines) metrics with a
    relative time stamp, in place of bare prints.

The engine's stages (``utils/timers.StageTimer``) open ``annotate``, so
``query_plan``, ``search``, ``refine`` show up by name in any trace.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Optional

import torch

from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["MetricsLog", "annotate", "trace"]

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(logdir: str, device):
    """Profile the enclosed region and write it as a Chrome trace into
    ``logdir`` (created if needed).  Yields the profiler; after the
    region its ``key_averages()`` hold the op table and its
    ``trace_path`` attribute names the file written.  CUDA activity is
    recorded only for a CUDA ``device``, whose work is synchronised
    before the capture ends."""
    dev = as_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.trace_path = os.path.join(
        logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str, device=None):
    """Label the enclosed work ``name`` in profiler timelines; with a
    CUDA ``device`` also as an NVTX range.  The ``record_function`` range
    opens only while a torch profiler runs: outside one it records nothing,
    yet its two profiler ops cost more than the rest of a ``StageTimer``
    stage."""
    rf = (torch.profiler.record_function(name)
          if torch.autograd.profiler._is_profiler_enabled
          else contextlib.nullcontext())
    with rf:
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


class MetricsLog:
    """Append-only JSON-lines metrics (one object per event)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"t": round(time.time() - self._t0, 6),
               "event": event, **fields}
        line = json.dumps(rec, sort_keys=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
