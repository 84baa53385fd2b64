"""The trainer's fixed gathers (``ops/gather.py:GatherRows``: forward
``index_select``, backward the transposed index walked as a rectangular
uniform-width ELL) against gnnpe_tpu's ``jnp.take`` readout, on the CPU,
with numpy-seeded inputs.  On the CPU the backward is the masked plain
form; the kernel route (one A2 launch a level) runs only on a card.

Tolerances: the forward is a gather, so equal; the backward adds a row's
entries in another order than JAX's scatter-add, so gradients are held
at rtol 1e-4 / atol 1e-6 and exactly on integer-valued cotangents; fit
histories at rtol 1e-3 / atol 1e-5 (tests/test_torch_models.py's);
distributed steps at a loss within 1e-5 and parameters within rtol 1e-4
/ atol 1e-5 (tests/test_torch_parallel.py's).  JAX is imported inside
the tests that use it, so the CUDA case collects on a machine without
it.
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.models import gnn, train
from gnnpe_tpu_torch.ops import ell
from gnnpe_tpu_torch.ops.gather import (LEVEL2_WIDTH, WIDTH, GatherRows,
                                        PlanCache)
from gnnpe_tpu_torch.parallel.launch import run_ranks

CFG = dict(dim=4, num_layers=2, labels_count=6, activation="softplus")
TIMEOUT_S = 240


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def skewed_index(seed, rows=300, width=WIDTH, level2=LEVEL2_WIDTH):
    """An index into ``rows`` rows in which row 0 is named 10^4 times,
    rows 1-3 exactly ``width``, ``width + 1`` and ``width·level2 + 1``
    times, a few rows never, and the rest at random; shuffled."""
    rng = np.random.RandomState(seed)
    named = [np.zeros(10_000, np.int64), np.full(width, 1),
             np.full(width + 1, 2), np.full(width * level2 + 1, 3),
             rng.randint(10, rows, 2_000)]
    idx = np.concatenate(named)
    rng.shuffle(idx)
    return idx


def _toy():
    from __graft_entry__ import _toy_graph
    return _toy_graph(num_vertices=48, num_labels=6, seed=3)


def _skewed_paths(g, seed, num=320):
    """``num`` random paths of 3 vertices, every one through vertex 0
    (320 entries for one row: three levels at the default widths)."""
    paths = np.random.RandomState(seed).randint(0, g.num_vertices, (num, 3))
    paths[:, 1] = 0
    return paths.astype(np.int32)


# ---- the plan ------------------------------------------------------------

@pytest.mark.parametrize("width,level2", [(WIDTH, LEVEL2_WIDTH), (4, 2),
                                          (16, 4), (2, 2)])
@pytest.mark.parametrize("d", [1, 2, 5])
def test_plan_matches_jax_take(width, level2, d):
    """Forward equal to ``jnp.take``, backward within rtol 1e-4 / atol
    1e-6 of ``jax.vjp`` of it, on a skewed index."""
    import jax
    import jax.numpy as jnp
    rows = 300
    idx = skewed_index(d, rows, width, level2)
    rng = np.random.RandomState(10 + d)
    x = rng.randn(rows, d).astype(np.float32)
    g = rng.randn(len(idx), d).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0),
                        jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    plan = GatherRows.build(idx, rows, "cpu", width, level2)
    xt = torch.from_numpy(x).requires_grad_()
    out = plan(xt)
    out.backward(torch.from_numpy(g))
    assert torch.equal(out.detach(), torch.from_numpy(np.array(want)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-6)
    counts = np.bincount(idx, minlength=rows)
    assert (counts[4:10] == 0).all() and (xt.grad[4:10] == 0).all()


@pytest.mark.parametrize("width,level2", [(WIDTH, LEVEL2_WIDTH), (4, 2)])
def test_plan_backward_exact_on_integers(width, level2):
    """On integer-valued f32 cotangents every order of adds is exact:
    equal to ``np.add.at``."""
    rows = 300
    idx = skewed_index(7, rows, width, level2)
    g = np.random.RandomState(1).randint(-8, 9, (len(idx), 3)).astype(
        np.float32)
    want = np.zeros((rows, 3), np.float32)
    np.add.at(want, idx, g)
    plan = GatherRows.build(idx, rows, "cpu", width, level2)
    assert np.array_equal(plan.backward(torch.from_numpy(g)).numpy(), want)


def test_plan_layout_and_checks():
    """The layout is rectangular (N entries in, ``num_rows`` rows out),
    has the levels the longest row needs, and one A2 launch a level;
    bad indices, row counts and devices raise."""
    idx = skewed_index(0)
    plan = GatherRows.build(torch.from_numpy(idx), 300, "cpu")
    back = plan.back
    assert back.src_rows[0] == len(idx) and back.num_vertices == 300
    assert back.tables[-1].shape == (300, LEVEL2_WIDTH)
    chunks = -(-10_000 // WIDTH)
    levels = 1
    while chunks > LEVEL2_WIDTH:
        chunks, levels = -(-chunks // LEVEL2_WIDTH), levels + 1
    assert len(back.tables) == levels + 1 == plan.launches_per_backward
    with pytest.raises(ValueError, match="outside"):
        GatherRows.build(np.array([0, 300]), 300, "cpu")
    with pytest.raises(ValueError, match="outside"):
        GatherRows.build(np.array([-1]), 300, "cpu")
    with pytest.raises(ValueError, match="rows"):
        plan(torch.zeros(299, 2))
    # A square layout still takes its source rows to be its vertices.
    square = ell.build_ell(np.array([0, 1, 2]), np.array([1, 2]))
    with pytest.raises(ValueError, match="outside"):
        square.on("cpu")
    # Neither the CPU nor CUDA: no gather_sum kernel, no plain fallback.
    meta = GatherRows.build(idx, 300, "meta")
    with pytest.raises(ValueError, match="no gather_sum kernel"):
        meta.backward(torch.zeros(len(idx), 2, device="meta"))


def test_plan_cache_rebuilds_only_on_a_new_index():
    cache = PlanCache(300, "cpu", "readout.test")
    idx = torch.from_numpy(skewed_index(1))
    plan = cache(idx)
    assert cache(idx) is plan
    other = idx.clone()
    assert cache(other) is not plan
    again = cache(other)
    other[0] = 5
    assert cache(other) is not again
    assert torch.equal(cache.plan.idx, other)
    sel = PlanCache(300, "cpu", "readout.test", select=lambda t: t[:10])
    assert torch.equal(sel(idx).idx, idx[:10])


# ---- the trainer's two gathers ---------------------------------------------

@pytest.mark.parametrize("aggregation", ["segment", "binned"])
def test_fit_gathers_match_jax_loss_and_grads(aggregation):
    """``dominance_loss`` through ``readout_plans`` against gnnpe_tpu's
    loss and ``jax.grad`` on the toy graph, every path through one
    vertex; and equal to the port's own loss without plans."""
    import jax
    import jax.numpy as jnp
    from gnnpe_tpu.models import gnn as jgnn
    from gnnpe_tpu_torch.ops.ell import (BinnedEllDevice, binned_aggregate,
                                         build_binned_ell)
    from gnnpe_tpu_torch.ops.spmm import NeighborSum
    g = _toy()
    jm = jgnn.PathGNN(**CFG)
    params = jm.init(jax.random.key(0), labels_count=6)
    port = gnn.params_from_jax(gnn.PathGNN(**CFG, device="cpu"),
                               [np.asarray(l) for l in
                                jax.tree.flatten(params)[0]])
    paths = _skewed_paths(g, 0)
    rng = np.random.RandomState(4)
    pairs = rng.randint(0, len(paths), (64, 2)).astype(np.int32)
    neg = rng.randint(0, len(paths), (48, 2)).astype(np.int32)
    src, dst = g.coo()
    want, jgrads = jax.value_and_grad(lambda p: jgnn.dominance_loss(
        jm, p, jnp.asarray(g.labels), jnp.asarray(src), jnp.asarray(dst),
        g.num_vertices, jnp.asarray(paths), jnp.asarray(pairs),
        negative_pairs=jnp.asarray(neg)))(params)
    if aggregation == "segment":
        off, nbr = torch.from_numpy(g.offsets), torch.from_numpy(g.neighbors)
        agg = lambda h: NeighborSum.apply(off, nbr, h)
    else:
        agg = binned_aggregate(BinnedEllDevice.from_host(
            build_binned_ell(g.offsets, g.neighbors), "cpu"))
    labels_plan, paths_plan = train.readout_plans(port, g, paths)
    assert paths_plan.launches_per_backward == 3
    args = (port, torch.from_numpy(g.labels).long(),
            torch.from_numpy(paths).long(), torch.from_numpy(pairs).long(),
            agg)
    kw = dict(negative_pairs=torch.from_numpy(neg).long())
    loss = gnn.dominance_loss(*args, labels_plan=labels_plan,
                              paths_plan=paths_plan, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = [p.grad.clone() for p in port.leaves()]
    for got, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)
    port.zero_grad()
    plain = gnn.dominance_loss(*args, **kw)
    plain.backward()
    assert plain.item() == loss.item()
    for got, p in zip(grads, port.leaves()):
        torch.testing.assert_close(got, p.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("aggregation", ["segment", "binned"])
def test_fit_history_matches_jax_on_skewed_paths(aggregation):
    """``fit`` (which builds both plans) against gnnpe_tpu's ``fit`` from
    the same parameters on paths that all share one vertex."""
    import jax
    import optax
    from gnnpe_tpu.models import gnn as jgnn
    from gnnpe_tpu.models import train as jtrain
    g = _toy()
    jm = jgnn.PathGNN(**CFG)
    params = jm.init(jax.random.key(1), labels_count=6)
    paths = _skewed_paths(g, 1)
    kw = dict(num_steps=12, batch_size=64, seed=0, learning_rate=1e-2,
              aggregation=aggregation, negatives=True)
    want = jtrain.fit(jm, g, paths, state=jtrain.TrainState(
        params=params, opt_state=optax.adam(1e-2).init(params)), **kw)
    port = gnn.params_from_jax(gnn.PathGNN(**CFG, device="cpu"),
                               [np.asarray(l) for l in
                                jax.tree.flatten(params)[0]])
    got = train.fit(port, g, paths, state=train.TrainState(params=port),
                    device="cpu", **kw)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_distributed_step_with_plans_equals_single_device(tmp_path, n):
    """Three steps of each backend through the plan caches on ``n`` gloo
    ranks, held to the single device's steps (tests/torch_mp_worker.py:
    ``readout``)."""
    outs = run_ranks(n, "tests.torch_mp_worker:readout", dict(seed=0),
                     group_device="cpu", timeout_s=TIMEOUT_S,
                     store_dir=str(tmp_path))
    for r, out in enumerate(outs):
        assert f"readout rank {r}/{n} OK" in out, out


# ---- the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 16])
def test_backward_bit_equal_on_card(cuda_device, d):
    """One A2 launch a level, bit-equal to the masked plain form run on
    the card; the forward equal to ``x[idx]``."""
    idx = skewed_index(d)
    plan = GatherRows.build(idx, 300, cuda_device)
    rng = np.random.RandomState(d)
    x = torch.from_numpy(rng.rand(300, d).astype(np.float32)).to(
        cuda_device).requires_grad_()
    g = torch.from_numpy(rng.rand(len(idx), d).astype(np.float32)).to(
        cuda_device)
    out = plan(x)
    assert torch.equal(out.detach(), x.detach()[plan.idx])
    before = ell.LAUNCHES
    out.backward(g)
    assert ell.LAUNCHES - before == plan.launches_per_backward
    assert torch.equal(x.grad, plan.backward_plain(g))
    want = torch.zeros_like(x).index_add_(0, plan.idx, g)
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)
