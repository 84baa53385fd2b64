"""The trainer's fixed gathers (``ops/gather.py:GatherRows``: forward
``index_select``, backward the fixed-order segment sum over the
transposed index) against gnnpe_tpu's ``jnp.take`` readout, on the CPU,
with numpy-seeded inputs.  On the CPU the backward is
``segment_sum_plain``; the kernel (csrc/segment_sum.cu, one launch a
backward) runs only on a card.

Tolerances: the forward is a gather, so equal; the backward adds a row's
entries in another order than JAX's scatter-add, so gradients are held
at rtol 1e-4 / atol 1e-6 and exactly on integer-valued cotangents; the
plain segment sum against a float64 ``np.add.at`` and A1's plain CSR sum
at rtol 1e-5 / atol 1e-4 (f32 sums of up to ~900 standard normal terms,
whose rounding in any order is ~sqrt(n)·2^-24·max|partial sum|, and
whose totals may cancel to near 0), exactly on integers; in f64 the
plan's backward against JAX's (x64) and ``np.add.at`` at rtol 1e-12 /
atol 1e-12 (~100 ulp of sums of up to 10^4 terms); fit histories
at rtol 1e-3 / atol 1e-5 (tests/test_torch_models.py's); distributed
steps at a loss within 1e-5 and parameters within rtol 1e-4 / atol 1e-5
(tests/test_torch_parallel.py's).  JAX is imported inside the tests that
use it, so the CUDA cases collect on a machine without it.
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.models import gnn, train
from gnnpe_tpu_torch.ops import gather
from gnnpe_tpu_torch.ops.gather import (THREADS, WINDOW, GatherRows,
                                        PlanCache, check_kernel_shape,
                                        segment_sum, segment_sum_plain,
                                        tile_layout)
from gnnpe_tpu_torch.ops.spmm import neighbor_sum_plain
from gnnpe_tpu_torch.parallel.launch import run_ranks

CFG = dict(dim=4, num_layers=2, labels_count=6, activation="softplus")
TIMEOUT_S = 240


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def skewed_index(seed, rows=300, window=WINDOW, threads=THREADS):
    """An index into ``rows`` rows in which row 0 is named 10^4 times,
    rows 1-3 exactly ``window``, ``window + 1`` and ``window·threads + 1``
    times (a tile and one more), a few rows never, and the rest at
    random; shuffled."""
    rng = np.random.RandomState(seed)
    named = [np.zeros(10_000, np.int64), np.full(window, 1),
             np.full(window + 1, 2), np.full(window * threads + 1, 3),
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

TILE_SHAPES = [(WINDOW, THREADS), (4, 32), (16, 64), (4, 512)]


@pytest.mark.parametrize("window,threads", TILE_SHAPES)
@pytest.mark.parametrize("d", [1, 2, 5])
def test_plan_matches_jax_take(window, threads, d):
    """Forward equal to ``jnp.take``, backward within rtol 1e-4 / atol
    1e-6 of ``jax.vjp`` of it, on a skewed index."""
    import jax
    import jax.numpy as jnp
    rows = 300
    idx = skewed_index(d, rows, window, threads)
    rng = np.random.RandomState(10 + d)
    x = rng.randn(rows, d).astype(np.float32)
    g = rng.randn(len(idx), d).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0),
                        jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    plan = GatherRows.build(idx, rows, "cpu", window, threads)
    xt = torch.from_numpy(x).requires_grad_()
    out = plan(xt)
    out.backward(torch.from_numpy(g))
    assert torch.equal(out.detach(), torch.from_numpy(np.array(want)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-6)
    counts = np.bincount(idx, minlength=rows)
    assert (counts[4:10] == 0).all() and (xt.grad[4:10] == 0).all()


@pytest.mark.parametrize("window,threads", TILE_SHAPES[:2])
def test_plan_backward_exact_on_integers(window, threads):
    """On integer-valued f32 cotangents every order of adds is exact:
    equal to ``np.add.at``."""
    rows = 300
    idx = skewed_index(7, rows, window, threads)
    g = np.random.RandomState(1).randint(-8, 9, (len(idx), 3)).astype(
        np.float32)
    want = np.zeros((rows, 3), np.float32)
    np.add.at(want, idx, g)
    plan = GatherRows.build(idx, rows, "cpu", window, threads)
    assert np.array_equal(plan.backward(torch.from_numpy(g)).numpy(), want)


@pytest.mark.parametrize("shape", [(7, 3), (7, 2, 3)])
def test_empty_index_backward_matches_jax(shape):
    """A gather with an empty index: forward of shape [0, ...] and a
    backward of zeros, equal to ``jax.vjp`` of ``jnp.take``."""
    import jax
    import jax.numpy as jnp
    idx = np.zeros(0, np.int64)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0),
                        jnp.asarray(x))
    (want_grad,) = vjp(jnp.zeros(want.shape, jnp.float32))
    plan = GatherRows.build(idx, shape[0], "cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out = plan(xt)
    assert out.shape == want.shape == (0,) + shape[1:]
    out.sum().backward()
    assert xt.grad.shape == shape
    assert np.array_equal(xt.grad.numpy(), np.asarray(want_grad))
    assert not xt.grad.any()


def test_plan_backward_f64_matches_jax_x64():
    """The plan in f64: forward equal to ``jnp.take`` and backward within
    rtol 1e-12 of ``jax.vjp`` of it under x64 and of a float64
    ``np.add.at``, on a skewed index of [R, L, D] rows."""
    import jax
    import jax.numpy as jnp
    rows, d = 300, 3
    idx = skewed_index(11, rows, 4, 32)
    rng = np.random.RandomState(12)
    x = rng.randn(rows, 2, d)
    g = rng.randn(len(idx), 2, d)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0),
                            jnp.asarray(x))
        (want_grad,) = vjp(jnp.asarray(g))
        want, want_grad = np.asarray(want), np.asarray(want_grad)
    assert want_grad.dtype == np.float64
    plan = GatherRows.build(idx, rows, "cpu", 4, 32)
    xt = torch.from_numpy(x).requires_grad_()
    out = plan(xt)
    out.backward(torch.from_numpy(g))
    assert xt.grad.dtype == torch.float64
    assert np.array_equal(out.detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-12,
                               atol=1e-12)
    added = np.zeros_like(x)
    np.add.at(added, idx, g)
    np.testing.assert_allclose(xt.grad.numpy(), added, rtol=1e-12,
                               atol=1e-12)


def test_segment_sum_plain_wide_rows():
    """D = 4,100 (past the kernel's earlier cap of 4,096) on an index
    whose hot row spans tiles: ``segment_sum_plain`` against a float64
    ``np.add.at`` within rtol 1e-5 / atol 1e-4, and exactly on integer
    cotangents; ``segment_sum`` on the CPU is the plain version."""
    window, threads, rows, d = 4, 32, 40, 4100
    rng = np.random.RandomState(5)
    idx = rng.permutation(np.concatenate([np.full(300, 7),
                                          rng.randint(0, rows, 200)]))
    plan = GatherRows.build(idx, rows, "cpu", window, threads)
    for g in (rng.randn(len(idx), d).astype(np.float32),
              rng.randint(-8, 9, (len(idx), d)).astype(np.float32)):
        gt = torch.from_numpy(g)
        got = segment_sum_plain(gt, plan.perm, plan.offsets, window,
                                threads)
        want = np.zeros((rows, d))
        np.add.at(want, idx, g.astype(np.float64))
        if np.array_equal(g, np.round(g)):
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-4)
        assert torch.equal(segment_sum(gt, plan), got)


def test_kernel_acceptance_rule():
    """What the wrapper hands a CUDA tensor's kernel (``check_kernel_shape``
    passes): f32 and f64, any D (0, 2, past 4,096), N·D past 2^31, an
    empty index; what still raises: integer and half types, N >= 2^31;
    and a device that is neither the CPU nor CUDA (no plain fallback)."""
    for dtype in (torch.float32, torch.float64):
        for n, d in ((0, 2), (5, 0), (1_000, 2), (1_000, 4_100),
                     (2 ** 24 + 1_000, 128), (182_339_307, 12),
                     (2 ** 31 - 1, 1)):
            check_kernel_shape(n, d, dtype)
    assert (2 ** 24 + 1_000) * 128 >= 2 ** 31
    for dtype in (torch.int32, torch.int64, torch.float16, torch.bfloat16):
        with pytest.raises(TypeError, match="float32 or float64"):
            check_kernel_shape(1_000, 2, dtype)
    for n in (2 ** 31, 2 ** 33):
        with pytest.raises(ValueError, match="2\\^31"):
            check_kernel_shape(n, 2, torch.float32)
    idx = np.zeros(0, np.int64)
    meta = GatherRows.build(idx, 3, "meta")
    with pytest.raises(ValueError, match="no segment_sum kernel"):
        meta.backward(torch.zeros(0, 2, device="meta", dtype=torch.float64))
    # On the CPU the same inputs take the plain version.
    cpu = GatherRows.build(idx, 3, "cpu")
    for dtype in (torch.float32, torch.float64):
        for d in (0, 2):
            out = segment_sum(torch.zeros(0, d, dtype=dtype), cpu)
            assert out.shape == (3, d) and out.dtype == dtype
            assert not out.any()


def _segment_case(case, window, threads):
    """(index, rows) of one shape the kernel's order has to get right."""
    tile = window * threads
    rng = np.random.RandomState(len(case))
    if case == "one_row_many_tiles":
        return np.concatenate([np.full(7 * tile + 3, 2),
                               rng.randint(0, 5, 300)]), 5
    if case == "window_and_tile_edges":
        # Rows of exactly a window, two, a tile, a tile and a window, and
        # single entries, so that rows end on window and tile edges.
        counts = np.tile([window, 2 * window, tile, tile + window, 1,
                          window - 1, 0], 6)
        return np.repeat(np.arange(len(counts)), counts), len(counts)
    if case == "empty_rows":
        return rng.choice([3, 50, 51, 52, 400, 998], 5_000), 1_000
    if case == "n_below_threads":
        return rng.randint(0, 40, threads - 5), 40
    if case == "one_row":
        return np.zeros(3 * tile + 1, np.int64), 1
    if case == "no_entries":
        return np.zeros(0, np.int64), 7
    raise ValueError(case)


SEGMENT_CASES = ["one_row_many_tiles", "window_and_tile_edges",
                 "empty_rows", "n_below_threads", "one_row", "no_entries"]


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("d", [1, 2, 5, 16])
def test_segment_sum_plain_against_oracles(case, d):
    """``segment_sum_plain`` against a float64 ``np.add.at`` and A1's
    plain CSR sum (strictly left to right) over the same ``perm`` and
    ``offsets``, within rtol 1e-5 / atol 1e-4; on integer-valued
    cotangents equal to both."""
    window, threads = 4, 32
    idx, rows = _segment_case(case, window, threads)
    idx = np.random.RandomState(d).permutation(idx)
    plan = GatherRows.build(idx, rows, "cpu", window, threads)
    rng = np.random.RandomState(d + 100)
    for g in (rng.randn(len(idx), d).astype(np.float32),
              rng.randint(-8, 9, (len(idx), d)).astype(np.float32)):
        gt = torch.from_numpy(g)
        got = segment_sum_plain(gt, plan.perm, plan.offsets, window,
                                threads)
        assert got.shape == (rows, d) and got.dtype == torch.float32
        want = np.zeros((rows, d))
        np.add.at(want, idx, g.astype(np.float64))
        csr = neighbor_sum_plain(plan.offsets, plan.perm, gt)
        if np.array_equal(g, np.round(g)):
            assert np.array_equal(got.numpy(), want)
            assert torch.equal(got, csr)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-4)
            torch.testing.assert_close(got, csr, rtol=1e-5, atol=1e-4)
        assert torch.equal(segment_sum(gt, plan), got)
    counts = np.bincount(idx, minlength=rows)
    assert (got.numpy()[counts == 0] == 0).all()


def test_segment_sum_plain_keeps_the_tile_order():
    """The order is the kernel's: one row of 5,000 terms of mixed
    magnitude summed per window, then per tile, then over the tiles,
    equal to that order written out by hand and not to the strictly
    left-to-right CSR sum of the same terms."""
    rng = np.random.RandomState(3)
    g = torch.from_numpy((rng.randn(5_000, 2) * 10.0 ** rng.randint(
        -3, 4, (5_000, 1))).astype(np.float32))
    perm = torch.arange(5_000, dtype=torch.int32)
    offsets = torch.tensor([0, 5_000], dtype=torch.int32)
    one = segment_sum_plain(g, perm, offsets, 4, 32)
    assert torch.equal(one, segment_sum_plain(g, perm, offsets, 4, 32))
    # By hand: windows of 4 left to right, a tile's 32 windows left to
    # right, then the 40 tiles (the last one partial) left to right.
    pieces = []
    for s in range(0, 5_000, 4):
        acc = torch.zeros(2)
        for row in g[s:s + 4]:
            acc = acc + row
        pieces.append(acc)
    total = None
    for t in range(0, len(pieces), 32):
        tile = pieces[t]
        for p in pieces[t + 1:t + 32]:
            tile = tile + p
        total = tile if total is None else total + tile
    assert torch.equal(one[0], total)
    assert not torch.equal(one, neighbor_sum_plain(offsets, perm, g))


def test_tile_layout_fields():
    """The row of each window's first entry and the rows each tile owns
    (every row once), against a direct count."""
    idx = skewed_index(2, 300, 4, 32)
    counts = np.bincount(idx, minlength=300)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    lay = tile_layout(offsets, 4, 32)
    n, tile = len(idx), 4 * 32
    key = np.repeat(np.arange(300), counts)
    assert np.array_equal(lay["window_rows"], key[::4])
    tiles = -(-n // tile)
    assert lay["tile_rows"][0] == 0 and lay["tile_rows"][-1] == 300
    assert len(lay["tile_rows"]) == tiles + 1
    for t in range(tiles):
        own = np.arange(lay["tile_rows"][t], lay["tile_rows"][t + 1])
        assert ((offsets[own] >= t * tile).all()
                and (t == tiles - 1 or (offsets[own] < (t + 1) * tile).all()))
    assert (np.diff(lay["tile_rows"]) >= 0).all()
    assert all(a.dtype == np.int32 for a in lay.values())
    empty = tile_layout(np.zeros(4, np.int64))
    assert empty["window_rows"].shape == (0,)
    assert empty["tile_rows"].tolist() == [0, 3]
    for bad in (dict(window=6), dict(threads=48), dict(threads=1024)):
        with pytest.raises(ValueError):
            tile_layout(offsets, **bad)


def test_kernel_args_struct():
    """The ctypes mirror of csrc/segment_sum.cu's SegmentPlan: 7
    pointers, the entry count and 4 ints (80 bytes, no padding), filled
    from the plan; its carry is the plan's scratch (a carry and an own
    piece of D elements a tile); a wider D or another type takes a new
    scratch and a new struct."""
    import ctypes
    plan = GatherRows.build(skewed_index(4), 300, "cpu", 4, 64)
    args = plan.kernel_args(2)
    assert ctypes.sizeof(args) == 80
    assert (args.n, args.rows, args.window, args.threads, args.tiles) == (
        plan.perm.numel(), 300, 4, 64, plan.tiles)
    assert args.perm == plan.perm.data_ptr()
    assert args.carry == plan.scratch.data_ptr()
    assert plan.scratch.numel() == 2 * plan.tiles * 2
    assert plan.scratch.dtype == torch.float32
    assert plan.kernel_args(1) is args
    wide = plan.kernel_args(5)
    assert wide is not args and plan.scratch.numel() == 2 * plan.tiles * 5
    assert wide.carry == plan.scratch.data_ptr()
    f64 = plan.kernel_args(5, torch.float64)
    assert f64 is not wide and plan.scratch.dtype == torch.float64
    assert f64.carry == plan.scratch.data_ptr()


def test_plan_layout_and_checks():
    """The plan holds the transposed index (int32 ``perm`` and
    ``offsets``), the tile layout of its (``window``, ``threads``), zeroed
    flags (one a tile) and counter, no carry before a card's first
    backward, and one launch a backward; bad indices, row counts,
    cotangents and devices raise."""
    idx = skewed_index(0)
    plan = GatherRows.build(torch.from_numpy(idx), 300, "cpu")
    assert (plan.window, plan.threads) == (WINDOW, THREADS)
    assert plan.perm.dtype == plan.offsets.dtype == torch.int32
    assert torch.equal(plan.perm.long(), torch.from_numpy(
        np.argsort(idx, kind="stable")))
    assert plan.offsets.numel() == 301 and plan.offsets[-1] == len(idx)
    lay = tile_layout(plan.offsets.numpy(), WINDOW, THREADS)
    for name in ("window_rows", "tile_rows"):
        assert np.array_equal(getattr(plan, name).numpy(), lay[name])
    assert plan.tiles == len(lay["tile_rows"]) - 1 == -(-len(idx) // (
        WINDOW * THREADS))
    assert plan.flags.dtype == plan.counter.dtype == torch.int32
    assert not plan.flags.any() and plan.counter.tolist() == [0]
    assert plan.scratch is None
    assert plan.launches_per_backward == 1
    with pytest.raises(ValueError, match="outside"):
        GatherRows.build(np.array([0, 300]), 300, "cpu")
    with pytest.raises(ValueError, match="outside"):
        GatherRows.build(np.array([-1]), 300, "cpu")
    with pytest.raises(ValueError, match="rows"):
        plan(torch.zeros(299, 2))
    with pytest.raises(ValueError, match="must be"):
        plan.backward(torch.zeros(len(idx) - 1, 2))
    with pytest.raises(TypeError, match="floating"):
        plan.backward(torch.zeros(len(idx), 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        plan.backward(torch.zeros(2, len(idx)).t())
    with pytest.raises(ValueError, match="window"):
        GatherRows.build(idx, 300, "cpu", window=3)
    # Neither the CPU nor CUDA: no segment_sum kernel, no plain fallback.
    meta = GatherRows.build(idx, 300, "meta")
    with pytest.raises(ValueError, match="no segment_sum kernel"):
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
    assert paths_plan.launches_per_backward == 1
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
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 5, 16])
@pytest.mark.parametrize("window,threads", [(WINDOW, THREADS), (4, 32)])
def test_backward_bit_equal_on_card(cuda_device, d, window, threads, dtype):
    """One kernel launch a backward, bit-equal to ``segment_sum_plain``
    run on the card and bit-identical over 3 calls and 2 replays of a
    CUDA graph, in f32 and f64; the forward equal to ``x[idx]``; within
    rtol 1e-5 of ``index_add_``."""
    idx = skewed_index(d, 300, window, threads)
    plan = GatherRows.build(idx, 300, cuda_device, window, threads)
    rng = np.random.RandomState(d)
    x = torch.from_numpy(rng.rand(300, d).astype(dtype)).to(
        cuda_device).requires_grad_()
    g = torch.from_numpy(rng.rand(len(idx), d).astype(dtype)).to(
        cuda_device)
    out = plan(x)
    assert torch.equal(out.detach(), x.detach()[plan.idx])
    before = gather.LAUNCHES
    out.backward(g)
    assert gather.LAUNCHES - before == plan.launches_per_backward == 1
    assert torch.equal(x.grad, plan.backward_plain(g))
    again = [plan.backward(g) for _ in range(3)]
    assert all(torch.equal(x.grad, a) for a in again)
    # Every launch leaves its scratch zeroed, so a CUDA graph replays it.
    assert not plan.flags.any() and plan.counter.item() == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = plan.backward(g)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, x.grad)
    want = torch.zeros_like(x).index_add_(0, plan.idx, g)
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_cases_bit_equal_on_card(cuda_device, case):
    """The kernel on each edge case of the plain version's tests, f32 D=2
    and D=5, bit-equal to ``segment_sum_plain`` on the card."""
    idx, rows = _segment_case(case, 4, 32)
    plan = GatherRows.build(np.random.RandomState(0).permutation(idx), rows,
                            cuda_device, 4, 32)
    for d in (2, 5):
        g = torch.from_numpy(np.random.RandomState(d).randn(
            len(idx), d).astype(np.float32)).to(cuda_device)
        assert torch.equal(segment_sum(g, plan), plan.backward_plain(g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float64, 1), (torch.float64, 2),
                                     (torch.float64, 5),
                                     (torch.float32, 4_100),
                                     (torch.float64, 4_100)])
@pytest.mark.parametrize("case", ["one_row_many_tiles",
                                  "window_and_tile_edges", "empty_rows"])
def test_wide_types_bit_equal_on_card(cuda_device, case, dtype, d):
    """f64 and D = 4,100 (past the earlier cap) on the edge cases: one
    launch, bit-equal to ``segment_sum_plain`` on the card and
    bit-identical over 2 calls."""
    idx, rows = _segment_case(case, 4, 32)
    plan = GatherRows.build(np.random.RandomState(1).permutation(idx), rows,
                            cuda_device, 4, 32)
    gen = torch.Generator(cuda_device).manual_seed(d)
    g = torch.randn((len(idx), d), generator=gen, dtype=dtype,
                    device=cuda_device)
    before = gather.LAUNCHES
    got = segment_sum(g, plan)
    assert gather.LAUNCHES - before == 1
    assert got.dtype == dtype and got.shape == (rows, d)
    assert torch.equal(got, plan.backward_plain(g))
    assert torch.equal(got, segment_sum(g, plan))
    assert not plan.flags.any() and plan.counter.item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_empty_index_on_card(cuda_device, dtype):
    """An empty index: the backward through autograd ([R, D] and
    [R, L, D]) is one launch and all zeros; D = 0 returns [R, 0] with no
    launch."""
    plan = GatherRows.build(np.zeros(0, np.int64), 9, cuda_device)
    for shape in ((9, 2), (9, 3, 2)):
        x = torch.randn(shape, dtype=dtype, device=cuda_device,
                        requires_grad=True)
        before = gather.LAUNCHES
        plan(x).sum().backward()
        assert gather.LAUNCHES - before == 1
        assert x.grad.shape == shape and not x.grad.any()
    before = gather.LAUNCHES
    out = segment_sum(torch.zeros((0, 0), dtype=dtype, device=cuda_device),
                      plan)
    assert out.shape == (9, 0) and gather.LAUNCHES == before


@pytest.mark.cuda
def test_past_2_31_elements_on_card(cuda_device):
    """N·D past 2^31: 2^24 + 1,000 entries at f32 D = 128 (8.6 GB of
    cotangent) into 100,000 rows, one of them named 10^5 times; one
    launch, bit-equal to ``segment_sum_plain`` on the card column slice
    by column slice (columns are independent, so a slice keeps the
    order)."""
    n, rows, d = 2 ** 24 + 1_000, 100_000, 128
    assert n * d >= 2 ** 31
    rng = np.random.RandomState(2)
    idx = rng.randint(0, rows, n)
    idx[rng.choice(n, 100_000, replace=False)] = 17
    plan = GatherRows.build(idx, rows, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(3)
    g = torch.rand((n, d), generator=gen, device=cuda_device)
    before = gather.LAUNCHES
    got = segment_sum(g, plan)
    assert gather.LAUNCHES - before == 1
    for c in range(0, d, 32):
        want = segment_sum_plain(g[:, c:c + 32].contiguous(), plan.perm,
                                 plan.offsets, plan.window, plan.threads)
        assert torch.equal(got[:, c:c + 32], want)
