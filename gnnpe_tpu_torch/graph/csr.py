"""CSR graph core: the host ``CSRGraph`` is re-exported from gnnpe_tpu;
``to_device`` replaces its JAX-only ``device_arrays``."""

from __future__ import annotations

import torch

from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["CSRGraph", "to_device"]


def to_device(graph: CSRGraph, device):
    """(offsets, neighbors, labels, degrees) as int32 tensors on
    ``device`` — the layout the CSR kernels take."""
    device = as_device(device)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (graph.offsets, graph.neighbors, graph.labels,
                           graph.degrees))
