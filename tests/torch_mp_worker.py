"""Rank-side cases of tests/test_torch_parallel.py.

Each function is one rank's part of a multi-process run started by
``gnnpe_tpu_torch.parallel.launch.run_ranks`` over gloo on the CPU.  The
test process computes what gnnpe_tpu answers and leaves it in a pickle;
a rank loads it, computes the single-device port's answer itself, runs
the sharded path with its peers and compares.  Nothing here imports JAX
or gnnpe_tpu (the launcher checks).
"""

import os
import pickle

import numpy as np
import torch

from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.embed.pde import PathEmbeddings
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.index.device_packed import (DevicePackedPESearch,
                                                 DevicePackedPGESearch,
                                                 StreamedPESearch,
                                                 TablePESearch)
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.models.gnn import PathGNN, params_from_jax
from gnnpe_tpu_torch.ops.spmm import NeighborSum, neighbor_sum_np
from gnnpe_tpu_torch.parallel.binned_halo import BinnedHaloPlan
from gnnpe_tpu_torch.ops import union_bitmap
from gnnpe_tpu_torch.parallel.collectives import (all_gather_rows,
                                                  gather_objects, or_words_)
from gnnpe_tpu_torch.parallel.dist import (distributed_neighbor_sum,
                                           make_distributed_train_step,
                                           pair_loss, shard_along,
                                           shard_edges)
from gnnpe_tpu_torch.parallel.dryrun import toy_graph
from gnnpe_tpu_torch.parallel.halo import HaloPlan
from gnnpe_tpu_torch.parallel.mesh import axis_group, axis_size, make_mesh
from gnnpe_tpu_torch.parallel.query import ShardedPESearch
from gnnpe_tpu_torch.graph.csr import to_device

GRAPH = dict(num_vertices=600, num_edges=2400, num_labels=8, seed=0,
             max_degree=40)
QUERY_SEEDS = (0, 1, 2)


def search_graph():
    g = powerlaw_graph(**GRAPH)
    return g, [sample_query(g, 5, seed=s) for s in QUERY_SEEDS]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same(got, want, what):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b)), what


def _check(result, single, ref, what):
    """One MatchResult against the single-device port's and against
    gnnpe_tpu's (candidates, count)."""
    assert result.answer_count == single.answer_count == ref[1], what
    _same(result.candidates, single.candidates, what + " vs single device")
    _same(result.candidates, ref[0], what + " vs gnnpe_tpu")


def search(rank, world, expected):
    """Every sharded search on ``world`` ranks: flat and packed, PE
    (array, table, streamed with the cache on and off) and PGE, both
    unions, ``online`` and ``online_many``, sharded ``save``/``load``,
    and shards with no rows."""
    exp = _load(expected)
    g, queries = search_graph()
    mesh = make_mesh(world, axes=("graph",), shape=(world,),
                     device="cpu")
    group = axis_group(mesh, "graph")
    tmp = os.path.dirname(expected)

    pe_cfg, pge_cfg = PEConfig.from_cli(l=2, e=2), PGEConfig.from_cli(l=2,
                                                                      e=2)
    single = {"pe": PEEngine(pe_cfg, g, "cpu").offline().build_index(
                  block_size=32).attach_device("cpu"),
              "pge": PGEEngine(pge_cfg, g, "cpu").offline().build_index(
                  block_size=16).attach_device("cpu")}
    want = {v: [single[v].online(q, engine="python") for q in queries]
            for v in single}
    want_many = {v: single[v].online_many(queries, engine="python")
                 for v in single}

    def attach(variant, how):
        if variant == "pge":
            eng = PGEEngine(pge_cfg, g, "cpu").offline().build_index(
                block_size=16)
            return eng.attach_mesh(mesh, packed=how == "packed")
        eng = PEEngine(pe_cfg, g, "cpu").offline()
        if how in ("flat", "packed"):
            eng.build_index(block_size=32, packed=how == "packed")
            return eng.attach_mesh(mesh, packed=how == "packed")
        kw = {"table": dict(resident=True),
              "streamed": dict(resident=False, cache_bytes=6 * 32 * 3 * 4),
              "streamed_nocache": dict(resident=False, cache=False),
              "streamed_disk": dict(resident=False, cache_bytes=6 * 32 * 3 * 4,
                                    spill_dir=os.path.join(
                                        tmp, f"spill{world}_{rank}"))}[how]
        eng.build_index(block_size=32, table=True, **kw)
        return eng.attach_mesh(mesh, packed=True)

    cases = [("pge", "flat"), ("pge", "packed"), ("pe", "flat"),
             ("pe", "packed"), ("pe", "table"), ("pe", "streamed"),
             ("pe", "streamed_nocache"), ("pe", "streamed_disk")]
    for variant, how in cases:
        eng = attach(variant, how)
        if how != "flat":
            lo, hi = eng.searcher.block_range
            assert eng.searcher.num_blocks == hi - lo
        for union in ("host", "device"):
            for i, q in enumerate(queries):
                _check(eng.online(q, engine="python", union=union),
                       want[variant][i], exp[variant][i],
                       f"{variant} {how} {union} query {i}")
            many = eng.online_many(queries, engine="python", union=union)
            for i, r in enumerate(many):
                _check(r, want_many[variant][i], exp[variant][i],
                       f"{variant} {how} {union} online_many {i}")
        if how == "table":
            # Collective save: one file, as a single device writes it.
            path = os.path.join(tmp, f"index{world}.npz")
            eng.searcher.save(path)
            whole = device_packed.load(path, eng.vertices, "cpu")
            assert isinstance(whole, TablePESearch)
            assert whole.num_blocks == sum(gather_objects(
                eng.searcher.num_blocks, group))
            part = device_packed.load(path, eng.vertices, "cpu", mesh=mesh)
            assert part.block_range == eng.searcher.block_range
            assert torch.equal(part.d_vids, eng.searcher.d_vids)
            query = eng._stack([eng._query_table(queries[0])])
            for s in (whole, part):
                _same(s.search(query, union="device"),
                      want["pe"][0].candidates, "loaded index")
        if how.startswith("streamed"):
            assert isinstance(eng.searcher, StreamedPESearch)
            spill = os.path.join(tmp, f"spill{world}_{rank}")
            eng.searcher.close()
            if how == "streamed_disk":
                assert os.listdir(spill) == []

    # A streamed index that served and pooled blocks BEFORE it was cut:
    # the pool of the whole index must not outlive the cut.
    eng = PEEngine(pe_cfg, g, "cpu").offline().build_index(
        block_size=32, table=True, resident=False, cache_bytes=1 << 22)
    _same(eng.online(queries[0], engine="python").candidates,
          want["pe"][0].candidates, "streamed before the cut")
    eng.searcher.prefill_cache()        # the pool holds every block
    eng.attach_mesh(mesh, packed=True)
    assert eng.searcher.block_range is not None
    for union in ("host", "device"):
        for i, q in enumerate(queries):
            _check(eng.online(q, engine="python", union=union),
                   want["pe"][i], exp["pe"][i],
                   f"streamed, pooled then cut, {union} query {i}")
    eng.searcher.close()

    # Shards without rows: fewer paths (blocks, vertices) than ranks.
    pe = single["pe"]
    few = PathEmbeddings(**{k: getattr(pe.data_pde, k)[:3] for k in (
        "vids", "labels", "degrees", "pde", "pde_label")})
    query = pe._stack([pe._query_table(queries[0])])
    tiny_flat = ShardedPESearch(mesh, few, "cpu",
                                base_epsilon=pe_cfg.epsilon)
    from gnnpe_tpu_torch.index.packed import PackedDominanceIndex
    tiny_index = PackedDominanceIndex.build(few, block_size=2)
    tiny_single = DevicePackedPESearch(tiny_index, "cpu",
                                       base_epsilon=pe_cfg.epsilon)
    tiny_packed = DevicePackedPESearch(
        tiny_index, "cpu", base_epsilon=pe_cfg.epsilon).shard(mesh)
    if world == 4:
        assert tiny_flat.row_range == (3, 3) if rank == 3 else True
        assert tiny_packed.num_blocks == (1 if rank < 2 else 0)
    for union in ("host", "device"):
        ref = tiny_single.search(query, union=union)
        _same(tiny_flat.search(query, union=union), ref, "tiny flat")
        _same(tiny_packed.search(query, union=union), ref, "tiny packed")
    print(f"search rank {rank}/{world} OK")


def packed_or(rank, world):
    """The device union's packed bitmaps OR-ed over the ranks, exactly:
    random words (bit 31 set, so negative int32s, included) against
    numpy's OR of every rank's, then a table-mode PE index and a PGE
    index cut into block ranges, whose device union equals the unsharded
    search's, one query at a time and stacked, with the ranks' hit rows
    summing to the unsharded search's."""
    mesh = make_mesh(world, axes=("graph",), shape=(world,), device="cpu")
    group = axis_group(mesh, "graph")
    mine = lambda r: np.random.RandomState(100 + r).randint(
        -2 ** 31, 2 ** 31, (5, 7)).astype(np.int32)
    words = torch.from_numpy(mine(rank))
    or_words_(words, group)
    want = np.bitwise_or.reduce([mine(r) for r in range(world)])
    assert np.array_equal(words.numpy(), want)

    g, queries = search_graph()
    pe = PEEngine(PEConfig.from_cli(l=2, e=2), g, "cpu").offline(
        device=True).build_index(block_size=32, table=True, resident=True)
    pge = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, "cpu").offline(
        ).build_index(block_size=16).attach_device("cpu")
    for name, eng in (("pe", pe), ("pge", pge)):
        tables = [eng._stack([eng._query_table(q)]) for q in queries]
        tables.append(eng._stack([eng._query_table(q) for q in queries]))
        whole = [eng.searcher.search(t) for t in tables]
        whole_hits = []
        for t in tables:
            eng.searcher.search(t)
            whole_hits.append(eng.searcher.last_stats["hit_rows"])
        sharded = (eng.searcher.shard(mesh) if name == "pge" else
                   eng.attach_mesh(mesh, packed=True).searcher)
        for i, t in enumerate(tables):
            launches = union_bitmap.LAUNCHES
            _same(sharded.search(t), whole[i], f"{name} packed OR {i}")
            st = sharded.last_stats
            hits = gather_objects(st["hit_rows"] if st else 0, group)
            assert sum(hits) == whole_hits[i], (name, i, hits, whole_hits)
            assert st is None or st["union"] == "device"
            assert union_bitmap.LAUNCHES == launches    # CPU: plain path
    print(f"packed_or rank {rank}/{world} OK")


def aggregate(rank, world, expected):
    """Halo and binned-halo aggregation and the edge-parallel sum on
    ``world`` ranks against the dense f64 sum (rtol 1e-4 / atol 1e-4)
    and against gnnpe_tpu's output for the same plan (rtol 1e-5 / atol
    1e-5; with hubs 2e-3 relative), forward and backward."""
    exp = _load(expected)
    mesh = make_mesh(world, axes=("graph",), shape=(world,),
                     device="cpu")
    group = axis_group(mesh, "graph")
    offsets, neighbors, membership, x = (exp[k] for k in (
        "offsets", "neighbors", "membership", "x"))
    v = len(offsets) - 1
    want = neighbor_sum_np(offsets, neighbors, x.astype(np.float64))
    cot = np.random.RandomState(3).rand(*x.shape).astype(np.float32)
    dst = np.repeat(np.arange(v), np.diff(offsets))
    want_grad = np.zeros(x.shape)
    np.add.at(want_grad, neighbors, cot[dst].astype(np.float64))
    for name, cls, kw in (("halo", HaloPlan, {}),
                          ("binned", BinnedHaloPlan, {}),
                          ("binned_nohub", BinnedHaloPlan,
                           dict(hub_matmul=False))):
        plan = cls.build(offsets, neighbors, membership, world, **kw)
        agg = plan.make_aggregate(mesh, "cpu")
        own = torch.from_numpy(plan.shard_features(x)[rank]).requires_grad_()
        out = agg(own)
        blocks = all_gather_rows(out.detach(), group).numpy().reshape(
            world, plan.own_pad, -1)
        got = plan.unshard_features(blocks)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        tol = (dict(rtol=2e-3, atol=1e-4) if name == "binned"
               else dict(rtol=1e-5, atol=1e-5))
        np.testing.assert_allclose(got, exp[name], **tol)
        out.backward(torch.from_numpy(plan.shard_features(cot)[rank]))
        grads = all_gather_rows(own.grad, group).numpy().reshape(
            world, plan.own_pad, -1)
        np.testing.assert_allclose(plan.unshard_features(grads), want_grad,
                                   rtol=2e-3 if name == "binned" else 1e-4,
                                   atol=1e-4)
    if world == 1:
        # One shard of everything is the graph itself: the halo sum is
        # the single device's neighbour sum bit for bit.
        off_t, nbr_t = (torch.from_numpy(a.astype(np.int32))
                        for a in (offsets, neighbors))
        plan = HaloPlan.build(offsets, neighbors, membership, 1)
        xt = torch.from_numpy(plan.shard_features(x)[0])
        assert torch.equal(plan.make_aggregate(mesh, "cpu")(xt)[plan.rank],
                           NeighborSum.apply(off_t, nbr_t,
                                             torch.from_numpy(x)))
    src = np.repeat(np.arange(v, dtype=np.int32), np.diff(offsets))
    ss, ds = shard_edges(neighbors.astype(np.int32), src, world)
    got = distributed_neighbor_sum(mesh, ss, ds, torch.from_numpy(x), v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    print(f"aggregate rank {rank}/{world} OK")


def train(rank, world, expected):
    """One SGD step of each backend on ``world`` ranks from gnnpe_tpu's
    weights: loss within 1e-5 and updated parameters within rtol 1e-4 /
    atol 1e-5 of the single-device port's step, of each other and of
    gnnpe_tpu's ``make_distributed_train_step``."""
    exp = _load(expected)
    mesh = make_mesh(world, axes=("graph",), shape=(world,),
                     device="cpu")
    g = toy_graph(num_vertices=48, num_labels=6, seed=3)
    assert np.array_equal(g.neighbors, exp["neighbors"])
    labels = torch.from_numpy(g.labels.astype(np.int64))
    paths, pairs = exp["paths"].astype(np.int64), exp["pairs"].astype(
        np.int64)
    membership = exp["membership"]

    def fresh():
        model = PathGNN(dim=8, num_layers=2, labels_count=6,
                        activation="softplus", device="cpu")
        params_from_jax(model, exp["leaves"])
        return model, torch.optim.SGD(model.parameters(), lr=1e-2)

    # The single device's step: the shards' losses averaged for the
    # report and summed for the gradient, as gnnpe_tpu's step has it.
    model, opt = fresh()
    off, nbr, _, _ = to_device(g, "cpu")
    agg = lambda h: NeighborSum.apply(off, nbr, h)
    per = len(paths) // world
    loss = sum(pair_loss(model.path_embeddings(
        labels, torch.from_numpy(paths[r * per:(r + 1) * per]), agg),
        torch.from_numpy(pairs[r * per:(r + 1) * per]))
        for r in range(world))
    loss.backward()
    opt.step()
    single = (float(loss) / world, [p.detach().numpy().copy()
                            for p in model.leaves()])

    results = {}
    for backend in ("psum", "halo", "binned_halo"):
        model, opt = fresh()
        kw = {}
        if backend == "psum":
            kw["arcs"] = shard_edges(*g.coo(), world)
        else:
            kw["plan"] = (HaloPlan if backend == "halo"
                          else BinnedHaloPlan).build(
                g.offsets, g.neighbors, membership, world)
        step = make_distributed_train_step(
            model, mesh, opt, g.num_vertices, batch_axis="graph",
            backend=None if backend != "psum" else "psum", **kw)
        loss = step(labels, shard_along(mesh, paths, "graph", "cpu"),
                    shard_along(mesh, pairs, "graph", "cpu"))
        results[backend] = (float(loss), [p.detach().numpy().copy()
                                          for p in model.leaves()])
    for backend, (loss, leaves) in results.items():
        for name, (want_loss, want_leaves) in (
                ("single device", single), ("psum", results["psum"]),
                ("gnnpe_tpu", exp["result"][backend])):
            assert abs(loss - want_loss) < 1e-5, (backend, name, loss,
                                                  want_loss)
            for a, b in zip(leaves, want_leaves):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{backend} vs {name}")
    if "psum_2axis" in exp["result"]:
        mesh2 = make_mesh(world, axes=("graph", "batch"), device="cpu")
        model, opt = fresh()
        step = make_distributed_train_step(
            model, mesh2, opt, g.num_vertices,
            arcs=shard_edges(*g.coo(), axis_size(mesh2, "graph")))
        loss = step(labels, shard_along(mesh2, paths, "batch", "cpu"),
                    shard_along(mesh2, pairs, "batch", "cpu"))
        want_loss, want_leaves = exp["result"]["psum_2axis"]
        assert abs(float(loss) - want_loss) < 1e-5
        for a, b in zip(model.leaves(), want_leaves):
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                       atol=1e-5, err_msg="graph x batch")
    print(f"train rank {rank}/{world} OK")


def readout(rank, world, seed):
    """Three steps of each backend through the readout plan caches, on
    paths that all run through vertex 0 (72 entries of one row a rank at
    4 ranks, 288 at one): losses within 1e-5 and parameters within rtol
    1e-4 / atol 1e-5 of the single device's three steps with the plans
    (``fit``'s inner loop, the shards' losses summed) and without them
    (``x[idx]``).  Each plan is built once for the tensors handed in
    again, once more for a new ``paths`` tensor, and ``step.launches``
    gives the plans' segment-sum launches beside the aggregation's."""
    from gnnpe_tpu_torch.ops import gather
    from gnnpe_tpu_torch.ops.gather import GatherRows
    mesh = make_mesh(world, axes=("graph",), shape=(world,), device="cpu")
    g = toy_graph(num_vertices=48, num_labels=6, seed=3)
    rng = np.random.RandomState(seed)
    paths = rng.randint(0, g.num_vertices, (288, 3))
    paths[:, 1] = 0
    pairs = rng.randint(0, 288 // 4, (64, 2))
    labels = torch.from_numpy(g.labels.astype(np.int64))
    per, ppr = len(paths) // world, len(pairs) // world

    def fresh():
        model = PathGNN(dim=8, num_layers=2, labels_count=6,
                        activation="softplus", device="cpu")
        model.init(torch.Generator().manual_seed(seed))
        return model, torch.optim.SGD(model.parameters(), lr=1e-2)

    off, nbr, _, _ = to_device(g, "cpu")
    agg = lambda h: NeighborSum.apply(off, nbr, h)
    shards = [torch.from_numpy(paths[r * per:(r + 1) * per])
              for r in range(world)]
    labels_plan = GatherRows.build(labels, 6, "cpu")
    singles = {}
    for planned in (True, False):
        model, opt = fresh()
        plans = [GatherRows.build(s, g.num_vertices, "cpu") for s in shards]
        for _ in range(3):
            opt.zero_grad()
            loss = sum(pair_loss(model.path_embeddings(
                labels, s, agg, labels_plan if planned else None,
                p if planned else None),
                torch.from_numpy(pairs[r * ppr:(r + 1) * ppr]))
                for r, (s, p) in enumerate(zip(shards, plans)))
            loss.backward()
            opt.step()
        singles[planned] = (float(loss) / world,
                            [p.detach().numpy().copy()
                             for p in model.leaves()])

    builds = []
    build = GatherRows.build

    def counted(cls, idx, *args, **kw):
        builds.append(int(np.prod(idx.shape)))
        return build(idx, *args, **kw)

    gather.GatherRows.build = classmethod(counted)
    paths_t = shard_along(mesh, paths, "graph", "cpu")
    pairs_t = shard_along(mesh, pairs, "graph", "cpu")
    for backend in ("psum", "halo", "binned_halo"):
        model, opt = fresh()
        kw = {}
        if backend == "psum":
            kw["arcs"] = shard_edges(*g.coo(), world)
            own = labels
        else:
            plan = (HaloPlan if backend == "halo" else BinnedHaloPlan).build(
                g.offsets, g.neighbors, np.arange(48) % world, world)
            kw["plan"] = plan
            own = labels[torch.from_numpy(
                plan.own_vertex_ids()[rank].astype(np.int64))]
        step = make_distributed_train_step(
            model, mesh, opt, g.num_vertices, batch_axis="graph",
            backend=backend, **kw)
        agg_launches = step.launches[:2]
        assert step.launches[2] == 0, (backend, step.launches)
        del builds[:]
        for _ in range(3):
            loss = float(step(labels, paths_t, pairs_t))
        assert builds == [len(own), paths_t.numel()], (backend, builds)
        readout_launches = (build(own, 6, "cpu").launches_per_backward
                            + build(paths_t, 48, "cpu").launches_per_backward)
        assert step.launches == (*agg_launches, readout_launches), (
            backend, step.launches)
        leaves = [p.detach().numpy() for p in model.leaves()]
        for planned, (want_loss, want_leaves) in singles.items():
            assert abs(loss - want_loss) < 1e-5, (backend, planned, loss,
                                                  want_loss)
            for a, b in zip(leaves, want_leaves):
                np.testing.assert_allclose(
                    a, b, rtol=1e-4, atol=1e-5,
                    err_msg=f"{backend} vs single device, plans={planned}")
        step(labels, paths_t.clone(), pairs_t)
        assert builds == [len(own), paths_t.numel(), paths_t.numel()]
    gather.GatherRows.build = build
    print(f"readout rank {rank}/{world} OK")
