"""Stage timing for the engine: named wall-clock stages.

On a CUDA device each stage edge synchronises the device first, so a
stage's time covers the device work it queued.  Every stage also opens
``utils/profiling.annotate`` (as gnnpe_tpu's timer does), so the stages
appear by name in a trace whenever one is being captured.  A stage may
open inside another (``refine.explore`` inside ``refine``); ``times_ms``
keeps the stages in the order they were first opened, so an outer
stage comes before its parts.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from gnnpe_tpu_torch.utils.profiling import annotate


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
        self.times_ms.setdefault(name, 0.0)
        self._sync()
        t0 = time.perf_counter()
        try:
            with annotate(name, self._device if self._cuda else None):
                yield
                self._sync()
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.times_ms[name] += dt

    @property
    def total_ms(self) -> float:
        return sum(self.times_ms.values())

    def __repr__(self):
        parts = ", ".join(f"{k}={v:.2f}ms" for k, v in self.times_ms.items())
        return f"StageTimer({parts})"
