"""Device argument checking.  Nothing here chooses a device: callers
name one, and asking for CUDA where there is none raises."""

from __future__ import annotations

import os

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


def free_bytes(device) -> int:
    """Memory free for new tensors on ``device``: for CUDA the card's
    free memory (``torch.cuda.mem_get_info``) and the segments PyTorch's
    caching allocator holds wholly unused (it gives those back before it
    fails an allocation; the free pieces of segments that still hold
    live blocks, ``inactive_split_bytes``, it cannot), for the CPU
    available host RAM."""
    dev = as_device(device)
    if dev.type == "cuda":
        split = torch.cuda.memory_stats(dev).get(
            "inactive_split_bytes.all.current", 0)
        return int(torch.cuda.mem_get_info(dev)[0]
                   + torch.cuda.memory_reserved(dev)
                   - torch.cuda.memory_allocated(dev) - split)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
