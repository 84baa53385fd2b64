"""Distributed message passing and training over a mesh of ranks
(counterpart of gnnpe_tpu/parallel/dist.py).

Three aggregation backends behind one seam, with the same numerics:

  * ``"psum"`` — edge-parallel baseline: the directed arcs are split
    over the "graph" axis, x is replicated, each rank sums its arc shard
    into a full-width vertex buffer and the partial sums combine with an
    ``all_reduce``.  Exact, O(V·D) collective volume per hop.
  * ``"halo"`` — vertex-partitioned (parallel/halo.py): per hop one
    all_to_all of boundary rows only (O(cut·D)), local arcs on kernel A1.
  * ``"binned_halo"`` — the production path (parallel/binned_halo.py):
    the same exchange, the arcs through the degree-binned layouts on
    kernel A2, and the all_to_all started before the local gathers so
    that it overlaps them.

Path minibatches split over the "batch" axis.  Every rank runs the same
program on its own shard; the collectives are differentiable
(parallel/collectives.py) and each rank backpropagates its own loss.
The step then reports the loss averaged over the axes and applies the
gradient SUMMED over the batch shards, which is what gnnpe_tpu's step
computes: under ``shard_map`` the gradient with respect to replicated
parameters is already reduced over every axis the loss varies on, and
the ``pmean`` that follows leaves it as it is.  (Ranks of the graph axis
that share one batch shard hold the same loss; their sum counts it once.)
The optimizer is a ``torch.optim`` one, stepped identically everywhere,
so the replicas' parameters stay equal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.models.gnn import PathGNN, pair_rows
from gnnpe_tpu_torch.ops.gather import PlanCache
from gnnpe_tpu_torch.ops.spmm import CsrPair, CsrSum
from gnnpe_tpu_torch.parallel.binned_halo import BinnedHaloPlan
from gnnpe_tpu_torch.parallel.collectives import (AllGatherRows,
                                                  AllReduceSum, all_reduce_,
                                                  group_size)
from gnnpe_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

BACKENDS = ("psum", "halo", "binned_halo")


def shard_edges(src: np.ndarray, dst: np.ndarray, n_shards: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the arc list to a multiple of n_shards and reshape to
    [n_shards, E_pad].  Padding arcs point at vertex 0 with src -1; the
    aggregation masks them out."""
    e = len(src)
    per = -(-e // n_shards)
    pad = per * n_shards - e
    src_p = np.concatenate([src, np.full(pad, -1, dtype=src.dtype)])
    dst_p = np.concatenate([dst, np.zeros(pad, dtype=dst.dtype)])
    return (src_p.reshape(n_shards, per), dst_p.reshape(n_shards, per))


def replicate(mesh, arr, device) -> torch.Tensor:
    """``arr`` whole on this rank's ``device`` (every rank holds it)."""
    return torch.as_tensor(arr).to(device)


def shard_along(mesh, arr, axis_name: str, device=None):
    """This rank's block of ``arr``, its leading dim split evenly over
    one mesh axis (the leading dim is kept, as a sharded array's
    per-device block has it); a tensor on ``device`` where one is named,
    else a view of the host array."""
    n, r = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    if len(arr) % n:
        raise ValueError(f"{len(arr)} rows do not split over {n} ranks")
    per = len(arr) // n
    block = arr[r * per:(r + 1) * per]
    return block if device is None else torch.as_tensor(block).to(device)


def _arc_pair(src_shard, dst_shard, num_vertices: int, device) -> CsrPair:
    """One arc shard (padded arcs have src < 0) as a CSR pair."""
    src = np.asarray(src_shard).reshape(-1)
    dst = np.asarray(dst_shard).reshape(-1)
    valid = src >= 0
    return CsrPair.from_arcs(dst[valid], src[valid], num_vertices,
                             num_vertices, device)


def distributed_neighbor_sum(mesh, src_shards, dst_shards, x: torch.Tensor,
                             num_vertices: int, axis: str = "graph"
                             ) -> torch.Tensor:
    """Edge-parallel aggregation: out[v] = Σ_{(u→v)} x[u], with
    ``src_shards``/``dst_shards`` the [n, E_pad] arrays of
    ``shard_edges``, of which the rank sums its own row on kernel A1, and
    x replicated.  The ``all_reduce`` is the only collective."""
    pair = _arc_pair(shard_along(mesh, src_shards, axis),
                     shard_along(mesh, dst_shards, axis), num_vertices,
                     x.device)
    return AllReduceSum.apply(CsrSum.apply(x, pair), axis_group(mesh, axis))


def pair_loss(pde: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """The dominance objective on path embeddings: a squared hinge on
    pde_i ≤ pde_j over ``pairs`` rows (i, j) and the anti-collapse
    term."""
    pi, pj = pair_rows(pde, [pairs])
    violation = torch.clamp(pi - pj, min=0.0)
    anti_collapse = torch.clamp(1.0 - pde.mean(0), min=0.0)
    return (violation ** 2).mean() + 0.01 * (anti_collapse ** 2).mean()


def make_distributed_train_step(model: PathGNN, mesh, optimizer,
                                num_vertices: int,
                                graph_axis: str = "graph",
                                batch_axis: Optional[str] = "batch",
                                backend: Optional[str] = None,
                                plan=None, arcs=None):
    """One training step over the mesh with a pluggable aggregation
    backend (see the module docstring).

    ``model`` holds the parameters and ``optimizer`` (a ``torch.optim``
    one over them) the state, both on the rank's device; what gnnpe_tpu
    passes in and out of its pure step lives there.  ``arcs`` =
    ``shard_edges``'s (src_shards, dst_shards) for "psum"; ``plan`` a
    ``HaloPlan`` or ``BinnedHaloPlan`` built for this graph and the
    graph axis's size for the halo backends, which keep the vertex
    features sharded through every layer and all-gather once for the
    path readout.  The default backend is "binned_halo" or "halo" by the
    plan's type where one is given, else "psum".

    Returns ``step(labels, paths, pairs) -> loss``: ``labels`` int64[V]
    whole on the device, ``paths`` int64[B, L] and ``pairs`` int64[B', 2]
    this rank's shard of the batch (pair indices are rows of that
    shard).  The loss returned is the mean over the axes; the gradient
    applied is the sum over the batch shards (see the module
    docstring).  The label lookup and the path readout go through
    ``GatherRows`` plans (ops/gather.py: their backward is kernel A2's
    walk of the transposed index, no scatter), each kept in a one-entry
    cache keyed on the ``labels`` and ``paths`` tensors the step is
    handed, so a step given the same tensors again builds nothing.
    ``step.launches`` is the (A1, A2) kernel launches of one step on a
    CUDA device, forward and backward: the aggregation's, plus the
    plans' of the last call (the aggregation's alone before the
    first)."""
    names = mesh.mesh_dim_names or ()
    axes = []
    for a in (graph_axis, batch_axis):
        if a and a in names and a not in axes:
            axes.append(a)
    if backend is None:
        backend = "psum" if plan is None else (
            "binned_halo" if isinstance(plan, BinnedHaloPlan) else "halo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    device = model.device
    group = axis_group(mesh, graph_axis)
    rank = axis_rank(mesh, graph_axis)

    if backend == "psum":
        if arcs is None:
            raise ValueError("backend 'psum' needs arcs=(src_shards, "
                             "dst_shards)")
        pair = _arc_pair(shard_along(mesh, arcs[0], graph_axis),
                         shard_along(mesh, arcs[1], graph_axis),
                         num_vertices, device)
        aggregate = lambda h: AllReduceSum.apply(CsrSum.apply(h, pair),
                                                 group)
        per_hop = (2, 0)        # the arc shard's sum and its transpose
        labels_cache = PlanCache(model.labels_count, device,
                                 "readout.labels")

        def vertex_embeddings(labels, labels_plan):
            return model.vertex_embeddings(labels, aggregate, labels_plan)
    else:
        if plan is None:
            raise ValueError(f"backend {backend!r} needs plan=")
        if plan.num_shards != axis_size(mesh, graph_axis):
            raise ValueError(f"a plan of {plan.num_shards} shards on an "
                             f"axis of {axis_size(mesh, graph_axis)}")
        dev_fn = plan.make_device_fn(group, rank, device)
        per_hop = tuple(f + b for f, b in zip(*dev_fn.launches))
        own_vids = torch.from_numpy(
            plan.own_vertex_ids()[rank].astype(np.int64)).to(device)
        rows_v = torch.from_numpy(
            plan.row_of_vertex().astype(np.int64)).to(device)
        labels_cache = PlanCache(model.labels_count, device,
                                 "readout.labels",
                                 select=lambda labels: labels[own_vids])

        def vertex_embeddings(labels, labels_plan):
            h_own = model.vertex_embeddings(labels[own_vids], dev_fn,
                                            labels_plan)
            return AllGatherRows.apply(h_own, group)[rows_v]
    paths_cache = PlanCache(num_vertices, device, "readout.paths")

    params = list(model.parameters())
    groups = [axis_group(mesh, a) for a in axes]
    ranks = int(np.prod([group_size(g) for g in groups]))
    # Ranks that hold one and the same batch shard, and so the same loss.
    sharing = (axis_size(mesh, graph_axis)
               if graph_axis in axes and batch_axis != graph_axis else 1)

    def step(labels, paths, pairs) -> torch.Tensor:
        labels_plan, paths_plan = labels_cache(labels), paths_cache(paths)
        step.launches = (agg_launches[0], agg_launches[1]
                         + labels_plan.launches_per_backward
                         + paths_plan.launches_per_backward)
        optimizer.zero_grad(set_to_none=True)
        h = vertex_embeddings(labels, labels_plan)
        rows, length = paths.shape
        loss = pair_loss(paths_plan(h).reshape(rows, length * model.dim),
                         pairs)
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().reshape(1)])
        for g in groups:
            all_reduce_(flat, g)
        flat[:-1] /= sharing
        lo = 0
        for p in params:
            p.grad.copy_(flat[lo:lo + p.numel()].view_as(p))
            lo += p.numel()
        optimizer.step()
        return flat[-1] / ranks

    agg_launches = tuple(model.num_layers * k for k in per_hop)
    step.launches = agg_launches
    return step
