"""The multi-rank dry run: every distributed path once, on tiny shapes
(counterpart of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n, device, group_device)`` starts n ranks on this
machine (parallel/launch.py).  ``device`` is where a rank computes and
``group_device`` the process group's device type, both named by the
caller: ``("cpu", "cpu")`` is plain PyTorch over gloo, ``("cuda",
"cuda")`` one card per rank over NCCL.  Each rank checks, against what a
single device computes:

  * a "psum" train step over a (graph × batch) mesh;
  * halo and binned-halo aggregation against ``neighbor_sum_np``;
  * the engines: the index built on the mesh (``build_index`` then
    ``attach_mesh``), flat PE and PGE, ``online`` and ``online_many``;
  * the table-mode and the streamed index sharded by block range, the
    block cache on and off (by argument);
  * packed PGE;
  * a "binned_halo" train step.

``python -m gnnpe_tpu_torch.parallel.dryrun DEVICE [N]`` runs it on N
(default 2) ranks that compute and communicate on DEVICE.  Under a
launcher (``torchrun`` sets ``RANK``) the ranks exist already, and the
same command runs the rank's part in the launcher's group.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gnnpe_tpu_torch.graph.csr import CSRGraph


def toy_graph(num_vertices=64, num_labels=8, avg_degree=4, seed=0):
    rng = np.random.RandomState(seed)
    e = num_vertices * avg_degree // 2
    edges = rng.randint(0, num_vertices, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    labels = rng.randint(0, num_labels, size=num_vertices)
    return CSRGraph.from_edges(num_vertices, edges, labels)


def _same(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), what


def dryrun_rank(rank: int, world: int, device: str,
                group_device: str) -> None:
    """One rank's part of the dry run (collective: every rank runs it)."""
    from gnnpe_tpu_torch.config import PEConfig, PGEConfig
    from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
    from gnnpe_tpu_torch.graph.partition import partition_graph
    from gnnpe_tpu_torch.index.device_packed import (DevicePackedPGESearch,
                                                     StreamedPESearch,
                                                     TablePESearch)
    from gnnpe_tpu_torch.index.packed import PGEPackedIndex
    from gnnpe_tpu_torch.io.datasets import sample_query
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.ops.spmm import neighbor_sum_np
    from gnnpe_tpu_torch.parallel.binned_halo import BinnedHaloPlan
    from gnnpe_tpu_torch.parallel.collectives import gather_objects
    from gnnpe_tpu_torch.parallel.dist import (make_distributed_train_step,
                                               replicate, shard_along,
                                               shard_edges)
    from gnnpe_tpu_torch.parallel.halo import HaloPlan
    from gnnpe_tpu_torch.parallel.mesh import (axis_group, axis_size,
                                               make_mesh)

    n = world
    g = toy_graph(num_vertices=48, num_labels=6)
    labels = replicate(None, g.labels.astype(np.int64), device)

    def model_and_optimizer():
        model = PathGNN(dim=8, num_layers=2, labels_count=6,
                        activation="softplus", device=device)
        model.init(torch.Generator().manual_seed(0))
        return model, torch.optim.Adam(model.parameters(), lr=1e-3)

    # 1. One "psum" step over graph × batch.
    mesh = make_mesh(n, axes=("graph", "batch"), device=group_device)
    n_batch = axis_size(mesh, "batch")
    rng = np.random.RandomState(0)
    per_rank = 8
    paths = rng.randint(0, g.num_vertices, (per_rank * n_batch, 3))
    pairs = rng.randint(0, per_rank, (per_rank * n_batch, 2))
    model, opt = model_and_optimizer()
    step = make_distributed_train_step(
        model, mesh, opt, g.num_vertices,
        arcs=shard_edges(*g.coo(), axis_size(mesh, "graph")))
    loss = step(labels, shard_along(mesh, paths, "batch", device),
                shard_along(mesh, pairs, "batch", device))
    assert np.isfinite(float(loss)), f"non-finite loss: {loss}"

    # 2. Halo and binned-halo aggregation against the dense sum.
    mesh1 = make_mesh(n, axes=("graph",), shape=(n,), device=group_device)
    membership = partition_graph(g, n)
    x = np.random.RandomState(1).rand(g.num_vertices, 8).astype(np.float32)
    want = neighbor_sum_np(g.offsets, g.neighbors, x.astype(np.float64))
    plans = {}
    for cls, kw in ((HaloPlan, {}), (BinnedHaloPlan, dict(device=device))):
        plan = plans[cls] = cls.build(g.offsets, g.neighbors, membership, n,
                                      **kw)
        agg = plan.make_aggregate(mesh1, device)
        own = agg(torch.from_numpy(plan.shard_features(x)[rank]).to(device))
        got = _gather_blocks(own, mesh1)
        assert np.allclose(plan.unshard_features(got), want, rtol=1e-4,
                           atol=1e-4), f"{cls.__name__} mismatch"

    # 3. The engines: built here, attached to the mesh, against the
    # single-device engines.
    qs = [sample_query(g, 3, tree=True, seed=s) for s in (5, 6)]
    q = qs[0]
    pge1 = PGEEngine(PGEConfig.from_cli(l=1, e=2, p=2), g, device).offline()
    pge1.build_index(block_size=8).attach_device(device)
    want_pge = pge1.online(q, engine="python")
    assert want_pge.answer_count >= 1
    pge = PGEEngine(PGEConfig.from_cli(l=1, e=2, p=2), g, device,
                    membership=membership).offline().build_index(block_size=8)
    for packed in (False, True):
        pge.attach_mesh(mesh1, packed=packed)
        r = pge.online(q, engine="python")
        assert r.answer_count == want_pge.answer_count
        _same(r.candidates, want_pge.candidates, f"PGE packed={packed}")

    pe1 = PEEngine(PEConfig.from_cli(l=1, e=2, p=2), g, device).offline()
    pe1.build_index(block_size=16).attach_device(device)
    want_pe = pe1.online(q, engine="python")
    want_many = pe1.online_many(qs, engine="python")
    pe = PEEngine(PEConfig.from_cli(l=1, e=2, p=2), g, device,
                  membership=membership).offline()
    pe.build_index(block_size=16, packed=False).attach_mesh(mesh1)
    r = pe.online(q, engine="python")
    assert r.answer_count == want_pe.answer_count
    _same(r.candidates, want_pe.candidates, "flat PE")
    for got, ref in zip(pe.online_many(qs, engine="python"), want_many):
        assert got.answer_count == ref.answer_count
        _same(got.candidates, ref.candidates, "flat PE online_many")

    # 4. Table mode and streamed mode by block range, cache on and off.
    query = pe._stack([pe._query_table(q)])
    searches = {
        "table": TablePESearch.build_from_paths(
            pe.paths, pe.vertices, device, block_size=16).shard(mesh1),
        "streamed cached": StreamedPESearch.build_from_paths(
            pe.paths, pe.vertices, device, block_size=16,
            cache_bytes=4 * 16 * 2 * 4).shard(mesh1),
        "streamed uncached": StreamedPESearch.build_from_paths(
            pe.paths, pe.vertices, device, block_size=16,
            cache=False).shard(mesh1)}
    for name, search in searches.items():
        _same(search.search(query), want_pe.candidates,
              f"{name} != single-device search")
    cache = searches["streamed cached"]._cache
    touched = 0 if cache is None else cache.hits + cache.misses
    assert sum(gather_objects(touched, axis_group(mesh1, "graph"))) > 0
    for name in ("streamed cached", "streamed uncached"):
        searches[name].close()

    # 5. Packed PGE on the mesh.
    psearch = DevicePackedPGESearch(
        PGEPackedIndex.build(pge.vertices.labels, pge.vertices.degrees,
                             pge.group, pge.label_group, block_size=8),
        device, base_epsilon=pge.config.epsilon).shard(mesh1)
    pq = pge._stack([pge._query_table(q)])
    _same(psearch.search(pq), want_pge.candidates,
          "packed PGE != single-device search")
    psearch.close()

    # 6. A "binned_halo" step, the path batch split over the graph axis.
    rows_per = 2
    paths_l = rng.randint(0, g.num_vertices, (rows_per * n, 3))
    pairs_l = rng.randint(0, rows_per, (rows_per * n, 2))
    model, opt = model_and_optimizer()
    bstep = make_distributed_train_step(
        model, mesh1, opt, g.num_vertices, batch_axis="graph",
        backend="binned_halo", plan=plans[BinnedHaloPlan])
    loss1 = bstep(labels, shard_along(mesh1, paths_l, "graph", device),
                  shard_along(mesh1, pairs_l, "graph", device))
    assert np.isfinite(float(loss1)), f"binned_halo loss: {loss1}"
    print(f"dryrun rank {rank}/{world} OK")


def _gather_blocks(own: torch.Tensor, mesh) -> np.ndarray:
    """[n, own_pad, D] on the host from every rank's [own_pad, D]."""
    from gnnpe_tpu_torch.parallel.collectives import all_gather_rows
    from gnnpe_tpu_torch.parallel.mesh import axis_group, axis_size
    n = axis_size(mesh, "graph")
    rows = all_gather_rows(own.detach(), axis_group(mesh, "graph"))
    return rows.cpu().numpy().reshape(n, own.shape[0], own.shape[1])


def dryrun_multichip(n_devices: int, device: str, group_device: str,
                     timeout_s: float = 300.0) -> None:
    """Start ``n_devices`` ranks here and run ``dryrun_rank`` on each;
    raises if any rank fails.  ``device`` is where the ranks compute,
    ``group_device`` the process group's device type (several ranks on
    one CUDA device need "cpu": NCCL takes one rank per device)."""
    from gnnpe_tpu_torch.parallel.launch import run_ranks
    outs = run_ranks(n_devices, "gnnpe_tpu_torch.parallel.dryrun:dryrun_rank",
                     dict(device=device, group_device=group_device),
                     group_device=group_device, timeout_s=timeout_s)
    for r, out in enumerate(outs):
        if f"dryrun rank {r}/{n_devices} OK" not in out:
            raise RuntimeError(f"rank {r} did not finish:\n{out}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m gnnpe_tpu_torch.parallel.dryrun "
                 "DEVICE [N]   (DEVICE: cuda or cpu)")
    device = sys.argv[1]
    if "RANK" in os.environ:
        import torch.distributed as dist
        from gnnpe_tpu_torch.parallel.mesh import maybe_distributed_init
        maybe_distributed_init(device)
        dryrun_rank(dist.get_rank(), dist.get_world_size(), device, device)
        dist.destroy_process_group()
    else:
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 2
        dryrun_multichip(n, device, device)
        print(f"dryrun_multichip({n}) OK")
