"""Process-group set-up and the device mesh (counterpart of
gnnpe_tpu/parallel/mesh.py).

One process is one rank.  ``maybe_distributed_init`` joins the default
process group from the launcher's environment (``torchrun`` sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), or from
an explicit ``init_method`` (a ``file://`` or ``tcp://`` store) with
``rank`` and ``world_size``.  The backend follows the device the caller
names for the group: NCCL for a CUDA device, gloo for the CPU.  Nothing
is guessed and nothing is switched after a failure.  Ranks that compute
on a CUDA device but were joined over gloo (several ranks on one card,
which NCCL refuses) have their collectives staged through the host by
parallel/collectives.py; that follows from the group's backend alone.

Axes, as in gnnpe_tpu:
  "graph" — shards of the data graph or of the index
  "batch" — data parallelism over path minibatches / queries
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def maybe_distributed_init(device, init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout_s: float = 600.0) -> bool:
    """Join the default process group; returns whether one is up.

    Without ``init_method`` the launcher's environment is read, and
    where it names no ``RANK`` this is a no-op (single process, no
    group).  ``device`` names the group's device type and so its
    backend; it has no default: the CPU is asked for by name."""
    if dist.is_initialized():
        return True
    backend = BACKENDS[torch.device(device).type]
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
        return True
    if "RANK" not in os.environ:
        return False
    dist.init_process_group(backend, timeout=timeout)
    return True


@contextlib.contextmanager
def process_group(device):
    """The default process group for the enclosed work: the one that is
    up, the launcher's, or else a group of one made here (a ``file://``
    store in a temporary directory), which is destroyed at the end."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory(prefix="gnnpe_group_") as tmp:
        if not maybe_distributed_init(device):
            store = "file://" + os.path.join(tmp, "store")
            maybe_distributed_init(device, init_method=store, rank=0,
                                   world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("graph", "batch"),
              shape: Optional[Sequence[int]] = None, *, device):
    """A ``DeviceMesh`` over the default group's ranks with gnnpe_tpu's
    axis names; an axis is a process group (``mesh.get_group("graph")``).

    ``n_devices`` must be the world size (a rank is a device here; None
    means all).  With 2 axes and no explicit shape, n factors as (graph,
    batch) with the graph axis taking the larger factor.  ``device``
    names the groups' device type, as in ``maybe_distributed_init``
    (required, by keyword).
    Collective: every rank calls it with the same arguments."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call maybe_distributed_init "
                           "(a single process gives init_method, rank=0 and "
                           "world_size=1)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            g = _largest_factor_leq_sqrt_complement(n)
            shape = (g, n // g)
    shape = tuple(int(s) for s in shape)
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axes[:len(shape)]))


def _largest_factor_leq_sqrt_complement(n: int) -> int:
    """Largest divisor g of n with g >= n//g (graph axis gets more)."""
    best = n
    for g in range(1, int(n ** 0.5) + 1):
        if n % g == 0:
            best = n // g
    return best


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh does not have."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where the mesh lacks it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def axis_group(mesh, axis: str):
    """The process group of ``axis``, None where the mesh lacks it."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_group(axis) if axis in names else None


def shard_bounds(rows: int, n: int, r: int) -> Tuple[int, int]:
    """[lo, hi) of ``rows`` items held by rank ``r`` of ``n``: contiguous
    runs of ceil(rows / n), the last ones shorter or empty.  Nothing is
    padded: a rank computes over the rows it has."""
    per = -(-max(rows, 1) // n)
    lo = min(r * per, rows)
    return lo, min(lo + per, rows)
