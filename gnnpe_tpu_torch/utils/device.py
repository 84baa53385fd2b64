"""Device argument checking.  Nothing here chooses a device: callers
name one, and asking for CUDA where there is none raises."""

from __future__ import annotations

import torch


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a bare ``cuda`` resolved to the
    current CUDA device; raises if it names CUDA and no CUDA device is
    available (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available()"
                " is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
