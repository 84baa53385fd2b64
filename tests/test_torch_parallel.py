"""The port's multi-device layer (gnnpe_tpu_torch/parallel/, the sharded
searches and ``attach_mesh``) on 1, 2 and 4 gloo ranks on the CPU.

This process computes what gnnpe_tpu answers on the same numpy-seeded
generated graphs (its sharded code on the 8 virtual CPU devices that
tests/conftest.py sets up) and leaves it in a pickle; the ranks
(tests/torch_mp_worker.py, started by parallel/launch.py over a
``file://`` store under ``tmp_path``, one torch thread each, with a
timeout of their own) compute the single-device port's answer, run the
sharded path and compare.  Candidates and counts are equal; aggregation
is held to the dense f64 sum at rtol 1e-4 / atol 1e-4; a train step's
loss within 1e-5 and its parameters within rtol 1e-4 / atol 1e-5.  The
host plans (``HaloPlan.build``, ``BinnedHaloPlan.build``) are bit-equal
field by field.
"""

import dataclasses
import pickle

import numpy as np
import pytest

from gnnpe_tpu_torch.parallel.launch import run_ranks

RANKS = (1, 2, 4)
TIMEOUT_S = 240


def _toy(seed):
    from __graft_entry__ import _toy_graph
    return _toy_graph(num_vertices=48, num_labels=6, seed=seed)


def _random_csr(rng, v, e):
    src = rng.randint(0, v, e).astype(np.int32)
    dst = rng.randint(0, v, e).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    deg = np.bincount(dst, minlength=v)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return offsets, src[order]


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def _ran(outs, case, n):
    for r, out in enumerate(outs):
        assert f"{case} rank {r}/{n} OK" in out, out


# ---- host plans, bit-equal ---------------------------------------------------

def _same_field(a, b, name):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), name
        for k in a:
            _same_field(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            _same_field(x, y, name)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    else:
        assert a == b, name


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("plan", ["halo", "binned_halo"])
def test_plan_fields_bit_equal(plan, n):
    """Every field of gnnpe_tpu's plan equals the port's, and so do the
    host helpers; membership is random, so shards differ in size.  The
    port's binned plan keeps no stacked padded tables (a rank runs its
    own layout): gnnpe_tpu's are held to ``_stack`` and ``_inv_rows``
    over the port's per-shard layouts."""
    import importlib
    rng = np.random.RandomState(7)
    offsets, neighbors = _random_csr(rng, 300, 2500)
    membership = rng.randint(0, n, 300)
    built = []
    for pkg in ("gnnpe_tpu", "gnnpe_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.parallel.{plan}")
        cls = mod.HaloPlan if plan == "halo" else mod.BinnedHaloPlan
        built.append(cls.build(offsets, neighbors, membership, n))
    ref, port = built
    stacked = {}
    if plan == "binned_halo":
        for s, layouts in (("l", port.local_layouts),
                           ("h", port.halo_layouts)):
            st, ranks, spec = mod._stack(layouts)
            stacked.update({
                {"l": "local_stack", "h": "halo_stack"}[s]: st,
                {"l": "inv_local", "h": "inv_halo"}[s]: mod._inv_rows(
                    ranks, spec, port.own_pad),
                f"num_zero_{s}": spec.num_zero, f"num_out_{s}": spec.num_out,
                f"hub_precision_{s}": spec.hub_precision})
    names = [f.name for f in dataclasses.fields(ref)]
    assert set(stacked) <= set(names)
    for name in names:
        _same_field(getattr(ref, name), stacked[name] if name in stacked
                    else getattr(port, name), name)
    x = rng.rand(300, 4).astype(np.float32)
    for fn, args in (("shard_features", (x,)), ("own_vertex_ids", ()),
                     ("row_of_vertex", ())):
        _same_field(getattr(ref, fn)(*args), getattr(port, fn)(*args), fn)
    shards = ref.shard_features(x)
    assert np.array_equal(port.unshard_features(shards), x)


def test_mesh_factoring_and_row_helpers():
    from gnnpe_tpu.parallel import dist as ref_dist, mesh as ref_mesh, \
        query as ref_query
    from gnnpe_tpu_torch.parallel import dist, mesh, query
    for n in range(1, 33):
        assert mesh._largest_factor_leq_sqrt_complement(n) == \
            ref_mesh._largest_factor_leq_sqrt_complement(n)
    src = np.arange(10, dtype=np.int32)
    for a, b in zip(ref_dist.shard_edges(src, src[::-1].copy(), 4),
                    dist.shard_edges(src, src[::-1].copy(), 4)):
        assert np.array_equal(a, b)
    arr = np.arange(14).reshape(7, 2)
    for n, fill in ((4, -2), (7, 0), (3, -1)):
        assert np.array_equal(ref_query.pad_rows(arr, n, fill),
                              query.pad_rows(arr, n, fill))
    assert [mesh.shard_bounds(10, 4, r) for r in range(4)] == \
        [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert [mesh.shard_bounds(2, 4, r) for r in range(4)] == \
        [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert mesh.maybe_distributed_init("cpu") is False    # no launcher


# ---- sharded search ------------------------------------------------------------

@pytest.fixture(scope="module")
def search_expected(tmp_path_factory):
    """gnnpe_tpu's candidates and counts per query, PE and PGE, through
    its own sharded searches on a 2-device mesh (flat PE with the device
    union, packed PGE)."""
    from gnnpe_tpu.config import PEConfig, PGEConfig
    from gnnpe_tpu.engine import PEEngine, PGEEngine
    from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
    from gnnpe_tpu.parallel.mesh import make_mesh
    from tests.torch_mp_worker import GRAPH, QUERY_SEEDS
    g = powerlaw_graph(GRAPH["num_vertices"], GRAPH["num_edges"],
                       GRAPH["num_labels"], seed=GRAPH["seed"],
                       max_degree=GRAPH["max_degree"])
    queries = [sample_query(g, 5, seed=s) for s in QUERY_SEEDS]
    mesh = make_mesh(2, axes=("graph",), shape=(2,))
    pe = PEEngine(PEConfig.from_cli(l=2, e=2), g).offline().build_index(
        packed=False).attach_mesh(mesh)
    pge = PGEEngine(PGEConfig.from_cli(l=2, e=2), g).offline().attach_mesh(
        mesh, packed=True)
    exp = {"pe": [], "pge": []}
    for q in queries:
        r = pe.online(q, engine="python", union="device")
        exp["pe"].append(([np.asarray(c) for c in r.candidates],
                          r.answer_count))
        r = pge.online(q, engine="python")
        exp["pge"].append(([np.asarray(c) for c in r.candidates],
                           r.answer_count))
    assert all(c > 0 for _, c in exp["pe"] + exp["pge"])
    return _dump(tmp_path_factory.mktemp("search") / "expected.pkl", exp)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_search(search_expected, tmp_path, n):
    _ran(run_ranks(n, "tests.torch_mp_worker:search",
                   dict(expected=search_expected), group_device="cpu",
                   timeout_s=TIMEOUT_S, store_dir=str(tmp_path)), "search", n)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_packed_or(tmp_path, n):
    """The search's bit-packed bitmaps OR-ed over n ranks equal the
    unsharded search's (ops/union_bitmap.py, ``or_words_``)."""
    _ran(run_ranks(n, "tests.torch_mp_worker:packed_or", {},
                   group_device="cpu", timeout_s=TIMEOUT_S,
                   store_dir=str(tmp_path)), "packed_or", n)


# ---- aggregation -----------------------------------------------------------------

@pytest.mark.parametrize("n", RANKS)
def test_sharded_aggregation(tmp_path, n):
    """gnnpe_tpu's ``make_aggregate`` outputs on an n-device mesh for a
    random membership are what the ranks are held to."""
    import jax.numpy as jnp
    from gnnpe_tpu.parallel.binned_halo import BinnedHaloPlan
    from gnnpe_tpu.parallel.halo import HaloPlan
    from gnnpe_tpu.parallel.mesh import make_mesh
    rng = np.random.RandomState(11 + n)
    offsets, neighbors = _random_csr(rng, 300, 2500)
    membership = rng.randint(0, n, 300)
    x = rng.rand(300, 16).astype(np.float32)
    mesh = make_mesh(n, axes=("graph",), shape=(n,))
    exp = dict(offsets=offsets, neighbors=neighbors, membership=membership,
               x=x)
    for name, cls, kw in (("halo", HaloPlan, {}),
                          ("binned", BinnedHaloPlan, {}),
                          ("binned_nohub", BinnedHaloPlan,
                           dict(hub_matmul=False))):
        plan = cls.build(offsets, neighbors, membership, n, **kw)
        out = plan.make_aggregate(mesh)(jnp.asarray(plan.shard_features(x)))
        exp[name] = plan.unshard_features(np.asarray(out))
    path = _dump(tmp_path / "expected.pkl", exp)
    _ran(run_ranks(n, "tests.torch_mp_worker:aggregate", dict(expected=path),
                   group_device="cpu", timeout_s=TIMEOUT_S,
                   store_dir=str(tmp_path)), "aggregate", n)


# ---- the distributed train step --------------------------------------------------

@pytest.mark.parametrize("n", RANKS)
def test_distributed_train_step(tmp_path, n):
    """gnnpe_tpu's ``make_distributed_train_step`` on an n-device mesh,
    three backends, one SGD step from ``model.init``'s weights; the
    ranks start from the same weights (``params_from_jax``)."""
    import jax
    import jax.numpy as jnp
    import optax
    from gnnpe_tpu.graph.partition import partition_graph
    from gnnpe_tpu.models.gnn import PathGNN
    from gnnpe_tpu.parallel.binned_halo import BinnedHaloPlan
    from gnnpe_tpu.parallel.dist import (make_distributed_train_step,
                                         replicate, shard_along, shard_edges)
    from gnnpe_tpu.parallel.halo import HaloPlan
    from gnnpe_tpu.parallel.mesh import make_mesh
    toy = _toy(3)
    mesh = make_mesh(n, axes=("graph",), shape=(n,))
    model = PathGNN(dim=8, num_layers=2, labels_count=6,
                    activation="softplus")
    params = model.init(jax.random.key(0), labels_count=6)
    optimizer = optax.sgd(1e-2)
    opt_state = optimizer.init(params)
    src, dst = toy.coo()
    membership = partition_graph(toy, n)
    rng = np.random.RandomState(0)
    paths = rng.randint(0, toy.num_vertices, size=(32, 3)).astype(np.int32)
    pairs = rng.randint(0, 32 // n, size=(32, 2)).astype(np.int32)
    labels_d = replicate(mesh, jnp.asarray(toy.labels))
    paths_d = shard_along(mesh, jnp.asarray(paths), "graph")
    pairs_d = shard_along(mesh, jnp.asarray(pairs), "graph")
    result = {}
    for backend in ("psum", "halo", "binned_halo"):
        sd = dd = plan = None
        if backend == "psum":
            ss, ds = shard_edges(src, dst, n)
            sd = shard_along(mesh, jnp.asarray(ss), "graph")
            dd = shard_along(mesh, jnp.asarray(ds), "graph")
        else:
            plan = (HaloPlan if backend == "halo" else BinnedHaloPlan).build(
                toy.offsets, toy.neighbors, membership, n)
        step = make_distributed_train_step(
            model, mesh, optimizer, toy.num_vertices, batch_axis="graph",
            backend=backend, plan=plan)
        p2, _, loss = step(replicate(mesh, params), labels_d, sd, dd,
                           paths_d, pairs_d, replicate(mesh, opt_state))
        result[backend] = (float(loss), [np.asarray(a)
                                         for a in jax.tree.leaves(p2)])
    if n == 4:
        # Graph × batch: each batch shard is shared by two graph ranks.
        mesh2 = make_mesh(4, axes=("graph", "batch"))
        ss, ds = shard_edges(src, dst, mesh2.shape["graph"])
        step = make_distributed_train_step(model, mesh2, optimizer,
                                           toy.num_vertices)
        p2, _, loss = step(
            replicate(mesh2, params), replicate(mesh2, jnp.asarray(toy.labels)),
            shard_along(mesh2, jnp.asarray(ss), "graph"),
            shard_along(mesh2, jnp.asarray(ds), "graph"),
            shard_along(mesh2, jnp.asarray(paths), "batch"),
            shard_along(mesh2, jnp.asarray(pairs), "batch"),
            replicate(mesh2, opt_state))
        result["psum_2axis"] = (float(loss), [np.asarray(a)
                                              for a in jax.tree.leaves(p2)])
    exp = dict(neighbors=toy.neighbors, membership=membership, paths=paths,
               pairs=pairs, result=result,
               leaves=[np.asarray(a) for a in jax.tree.leaves(params)])
    path = _dump(tmp_path / "expected.pkl", exp)
    _ran(run_ranks(n, "tests.torch_mp_worker:train", dict(expected=path),
                   group_device="cpu", timeout_s=TIMEOUT_S,
                   store_dir=str(tmp_path)), "train", n)


# ---- the launcher ----------------------------------------------------------------

def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="a rank failed"):
        run_ranks(2, "tests.torch_mp_worker:no_such_case", {},
                  group_device="cpu", timeout_s=60, store_dir=str(tmp_path))


@pytest.mark.parametrize("n", RANKS)
def test_dryrun_multichip(n):
    from gnnpe_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(n, "cpu", "cpu", timeout_s=TIMEOUT_S)
