"""Measured device constants for hub pricing (counterpart of
gnnpe_tpu/utils/device_probe.py).

``ops/ell.py:_select_hubs`` prices a hub column against gather time with
(memory bytes/s, matmul flop/s, gather seconds/row).

On a CUDA device the three are measured in the run, once per process
and device, with gnnpe_tpu's three probes: a dense stream ``h + 1`` over
2^17 x 128 f32 rows, a row gather of 4 x 2^17 indices drawn with
replacement (adjacency slot lists hit rows with multiplicity), and a
2048^3 matmul.  Each is timed with CUDA events after a warm-up.
gnnpe_tpu's matmul probe is bf16, the type of its hub product; the
port's hub product (``ops/ell.py:hub_product``) multiplies in f32 with
TF32 off, so that is the product the probe times: prices describe the
product that runs.
gnnpe_tpu differenced a long and a short loop to cancel the fixed
dispatch cost of its relay; events time the device's work alone, so
there is nothing to cancel and the differencing is dropped.

On the CPU the "cpu" row of gnnpe_tpu's table is returned unchanged, so
every CPU layout is the one gnnpe_tpu builds without a probe.

Nothing is cached on disk and no environment variable is read.  A
measured value that is not finite or not positive raises.  gnnpe_tpu
instead clamped each value to within 8x of its table, whose row for any
non-TPU device is the CPU's: on a GPU that would keep the CPU's numbers.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["CPU_ROW", "device_constants"]

# gnnpe_tpu's table row for the CPU: (bytes/s, flop/s, gather s/row).
CPU_ROW = (50e9, 1e12, 2e-9)

ROWS = 1 << 17
WIDTH = 128
MATMUL_N = 2048
NAMES = ("memory bytes/s", "f32 matmul flop/s", "gather s/row")


def _event_s(fn, iters: int) -> float:
    """Seconds of one ``fn()`` on the current CUDA stream: the mean of
    ``iters`` calls between two events, after one untimed call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e-3


def _probe(device: torch.device) -> Tuple[float, float, float]:
    """The three probes on ``device`` (a CUDA device)."""
    gen = torch.Generator().manual_seed(0)
    with torch.cuda.device(device):
        h = torch.rand((ROWS, WIDTH), generator=gen).to(device)
        # The stream reads and writes every element once.
        bw = 2 * ROWS * WIDTH * 4 / _event_s(lambda: h + 1.0, 64)
        idx = torch.randint(0, ROWS, (4 * ROWS,), generator=gen).to(device)
        gather_row_s = _event_s(lambda: h.index_select(0, idx), 32) / len(idx)
        a = torch.rand((MATMUL_N, MATMUL_N), generator=gen).to(device)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            flops = 2 * MATMUL_N ** 3 / _event_s(lambda: a @ a, 16)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return float(bw), float(flops), float(gather_row_s)


def _check(values) -> Tuple[float, float, float]:
    """``values`` if each is finite and positive; raises otherwise."""
    for name, v in zip(NAMES, values):
        if not (math.isfinite(v) and v > 0):
            raise RuntimeError(f"device probe: {name} measured as {v!r}")
    return tuple(values)


@functools.lru_cache(maxsize=None)
def _measured(device: torch.device) -> Tuple[float, float, float]:
    return _check(_probe(device))


def device_constants(device) -> Tuple[float, float, float]:
    """(memory bytes/s, matmul flop/s, gather s/row) of ``device``: the
    "cpu" row for the CPU, measured once per process on a CUDA device
    (raising where a probe gives a value that is not finite and
    positive); any other device raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPU_ROW
    if dev.type != "cuda":
        raise ValueError(f"no device probe for {dev}")
    return _measured(as_device(dev))
