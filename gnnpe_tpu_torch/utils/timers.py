"""Stage timing for the engine: named wall-clock stages.

On a CUDA device each stage edge synchronises the device first, so a
stage's time covers the device work it queued.  (gnnpe_tpu's timer
opens a jax.profiler annotation per stage and so imports JAX.)
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StageTimer:
    def __init__(self, device=None):
        self.times_ms: Dict[str, float] = {}
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = device

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = (time.perf_counter() - t0) * 1e3
            self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
