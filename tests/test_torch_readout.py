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
                                        slot_shape, tile_layout)
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
        return rng.randint(0, 40, max(3, threads - 5)), 40
    if case == "one_row":
        return np.zeros(3 * tile + 1, np.int64), 1
    if case == "no_entries":
        return np.zeros(0, np.int64), 7
    if case == "row_starts_in_last_slot":
        # After window - 1 entries the next row starts in the window's
        # last slot; rows of one entry there, and rows that start there
        # and run on over several windows.
        counts = np.tile([window - 1, 1, window - 1, window + 2,
                          2 * window + 3, 1], 30)
        return np.repeat(np.arange(len(counts)), counts), len(counts)
    if case == "row_ends_on_warp_edge":
        # Rows of a warp's entries at 1, 2, 4, 8 and 32 lanes an entry
        # (32 / lanes slots of a window), one less and one more, so that
        # rows end on and beside warp edges at every width.
        counts = np.concatenate([[e, e - 1, 1, e + 1, e] for e in
                                 (32 * window, 16 * window, 8 * window,
                                  4 * window, window)] * 3)
        return np.repeat(np.arange(len(counts)), counts), len(counts)
    if case == "empty_row_runs":
        # Non-empty rows with runs of 6 empty rows between them, 40 empty
        # rows first and 50 last.
        named = np.arange(40, 950, 7)
        counts = rng.randint(1, 3 * window, len(named))
        return np.repeat(named, counts), 1_000
    if case == "n_is_one":
        return np.array([3]), 5
    raise ValueError(case)


SEGMENT_CASES = ["one_row_many_tiles", "window_and_tile_edges",
                 "empty_rows", "n_below_threads", "one_row", "no_entries",
                 "row_starts_in_last_slot", "row_ends_on_warp_edge",
                 "empty_row_runs", "n_is_one"]


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


def _order_by_hand(g, idx, rows, window, threads, lanes):
    """The kernel's order written out thread by thread in plain Python
    (csrc/segment_sum.cu), one row of D columns at a time: each slot's
    runs (a slot of ``lanes`` lanes sums ``min(16, window · lanes)``
    entries); the Kogge-Stone scan over a warp's slots; the warps' carries in
    warp order; the first run of a slot closing its row; the pieces of a
    row from earlier tiles summed into S slots, S = threads / lanes, then
    a pairwise tree over all S slots, the tile's own piece last."""
    n, d = g.shape
    perm = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=rows).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    key = np.repeat(np.arange(rows), counts)
    tail = np.zeros(n, bool)
    tail[offsets[1:][counts > 0] - 1] = True
    window = min(16, window * lanes)
    slots, per_warp, warps = threads // lanes, 32 // lanes, threads // 32
    tile = slots * window
    zero = np.zeros(d, g.dtype)
    out = np.zeros((rows, d), g.dtype)
    carries, owns = {}, {}
    for t in range(max(1, -(-n // tile))):
        base = t * tile
        trail, flag, first, first_row = [], [], [], []
        for s in range(slots):
            acc, fst, row = zero, None, None
            for j in range(base + s * window,
                           min(base + (s + 1) * window, n)):
                acc = acc + g[perm[j]]
                if tail[j]:
                    if fst is None:
                        fst, row = acc, key[j]
                    else:
                        out[key[j]] = acc
                    acc = zero
            trail.append(acc)
            flag.append(fst is not None)
            first.append(fst)
            first_row.append(row)
        incl, iflag = list(trail), list(flag)
        for w in range(warps):
            lo = w * per_warp
            h = 1
            while h < per_warp:
                prev, pflag = list(incl), list(iflag)
                for p in range(h, per_warp):
                    if not pflag[lo + p]:
                        incl[lo + p] = prev[lo + p - h] + prev[lo + p]
                    iflag[lo + p] = pflag[lo + p] or pflag[lo + p - h]
                h *= 2
        cin, cflag = [zero], [False]
        for w in range(1, warps):
            a, af = incl[w * per_warp - 1], iflag[w * per_warp - 1]
            cin.append(a if af else cin[-1] + a)
            cflag.append(cflag[-1] or af)
        takes = (0 < base < n and offsets[key[base]] < base)
        for s in range(slots):
            w, p = divmod(s, per_warp)
            xv = incl[s - 1] if p else zero
            xf = iflag[s - 1] if p else False
            x = xv if xf else cin[w] + xv
            if flag[s]:
                if takes and not xf and not cflag[w]:
                    owns[t] = x + first[s]
                else:
                    out[first_row[s]] = x + first[s]
        last = slots - 1
        w = last // per_warp
        carries[t] = incl[last] if iflag[last] else cin[w] + incl[last]
        if takes and t in owns:
            t0 = offsets[key[base]] // tile
            p = [zero] * slots
            for k in range(t - t0):
                p[k % slots] = p[k % slots] + carries[t0 + k]
            while len(p) > 1:
                p = [p[i] + p[i + 1] for i in range(0, len(p), 2)]
            out[key[base]] = p[0] + owns[t]
    return out


ORDER_SHAPES = [(32, 2, np.float32), (64, 2, np.float32),
                (64, 12, np.float32), (64, 3, np.float64),
                (128, 40, np.float32), (64, 130, np.float32)]


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("threads,d,dtype", ORDER_SHAPES)
def test_segment_sum_plain_is_the_order_by_hand(case, threads, d, dtype):
    """``segment_sum_plain`` bit-equal to ``_order_by_hand`` on every
    edge case, at 1 (f32 D=2), 4 (f32 D=12, f64 D=3), 16 (D=40) and 32
    (D=130) lanes an entry and 1, 2 and 4 warps a tile, on cotangents of
    mixed magnitude (so that another order of adds shows)."""
    window = 4
    lanes = slot_shape(d, np.dtype(dtype).itemsize)[0]
    idx, rows = _segment_case(case, window, threads // lanes)
    idx = np.random.RandomState(d).permutation(idx)
    rng = np.random.RandomState(threads + d)
    g = (rng.randn(len(idx), d) * 10.0 ** rng.randint(
        -3, 4, (len(idx), 1))).astype(dtype)
    plan = GatherRows.build(idx, rows, "cpu", window, threads)
    got = segment_sum_plain(torch.from_numpy(g), plan.perm, plan.offsets,
                            window, threads)
    want = _order_by_hand(g, idx, rows, window, threads, lanes)
    assert np.array_equal(got.numpy(), want)
    # A column slice keeps the order when it is told the full width's
    # lanes.
    part = segment_sum_plain(torch.from_numpy(g[:, :1].copy()), plan.perm,
                             plan.offsets, window, threads, lanes)
    assert np.array_equal(part.numpy(), want[:, :1])


def test_segment_sum_plain_keeps_the_tile_order():
    """The order is the kernel's: one row of 5,000 terms of mixed
    magnitude (f32 D=2: one lane an entry, tiles of 32 windows of 4 at 32
    threads) summed per window, by a Kogge-Stone scan over each tile's
    windows, then the 39 full tiles' carries into 32 slots and a pairwise
    tree, the last tile's own piece last; equal to that order written out
    by hand and not to the strictly left-to-right CSR sum of the same
    terms."""
    rng = np.random.RandomState(3)
    g = torch.from_numpy((rng.randn(5_000, 2) * 10.0 ** rng.randint(
        -3, 4, (5_000, 1))).astype(np.float32))
    perm = torch.arange(5_000, dtype=torch.int32)
    offsets = torch.tensor([0, 5_000], dtype=torch.int32)
    one = segment_sum_plain(g, perm, offsets, 4, 32)
    assert torch.equal(one, segment_sum_plain(g, perm, offsets, 4, 32))
    # By hand: windows of 4 left to right from 0.0.
    pieces = []
    for s in range(0, 5_000, 4):
        acc = torch.zeros(2)
        for row in g[s:s + 4]:
            acc = acc + row
        pieces.append(acc)
    # Each full tile (128 entries) has no row end: its carry is the last
    # value of the scan v[i] = v[i - h] + v[i], h = 1, 2, 4, 8, 16.
    carries = []
    for t in range(39):
        v = pieces[32 * t:32 * t + 32]
        for h in (1, 2, 4, 8, 16):
            v = [v[i] if i < h else v[i - h] + v[i] for i in range(32)]
        carries.append(torch.zeros(2) + v[31])
    # The last tile (entries 4,992-4,999): the row ends in its second
    # window, whose carry in is the first window's.
    own = (torch.zeros(2) + pieces[1248]) + pieces[1249]
    # The 39 carries into 32 slots (slot i: tiles i and i + 32), a
    # pairwise tree, own last.
    slots = [torch.zeros(2) for _ in range(32)]
    for k, c in enumerate(carries):
        slots[k % 32] = slots[k % 32] + c
    while len(slots) > 1:
        slots = [slots[i] + slots[i + 1] for i in range(0, len(slots), 2)]
    assert torch.equal(one[0], slots[0] + own)
    assert not torch.equal(one, neighbor_sum_plain(offsets, perm, g))


def test_tile_layout_fields():
    """The row ends, the run of each window's first entry and the rows
    in run order (non-empty, then empty), against a direct count; the
    plan's ``entries`` are ``perm`` with bit 31 set on the row ends, and
    its tiles at 1, 4 and 32 lanes an entry hold ``threads / lanes``
    slots of ``min(16, window · lanes)`` entries."""
    idx = skewed_index(2, 300, 4, 32)
    counts = np.bincount(idx, minlength=300)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n = len(idx)
    key = np.repeat(np.arange(300), counts)
    lay = tile_layout(offsets, 4, 32)
    ends = np.flatnonzero(np.append(key[1:] != key[:-1], True))
    assert np.array_equal(lay["ends"], ends)
    assert lay["runs"] == (counts > 0).sum() == len(ends)
    assert np.array_equal(lay["window_runs"],
                          [(ends < a).sum() for a in range(0, n, 4)])
    rr = lay["run_rows"]
    assert sorted(rr.tolist()) == list(range(300))
    assert np.array_equal(rr[:lay["runs"]], np.flatnonzero(counts))
    assert (counts[rr[lay["runs"]:]] == 0).all()
    # The run of a window's first entry names its row.
    assert np.array_equal(rr[lay["window_runs"]], key[::4])
    assert all(lay[k].dtype == np.int32
               for k in ("ends", "window_runs", "run_rows"))
    empty = tile_layout(np.zeros(4, np.int64))
    assert empty["window_runs"].shape == empty["ends"].shape == (0,)
    assert empty["run_rows"].tolist() == [0, 1, 2] and empty["runs"] == 0
    plan = GatherRows.build(idx, 300, "cpu", 4, 32)
    for d, lanes in ((2, 1), (12, 4), (130, 32)):
        state = plan.launch_state(d)
        assert (state.lanes, state.slot_window) == (lanes,
                                                     min(16, 4 * lanes))
        assert state.tile == 32 // lanes * state.slot_window
        assert state.tiles == -(-n // state.tile)
    assert GatherRows.build(np.zeros(0, np.int64), 3, "cpu").launch_state(
        2).tiles == 1
    tagged = plan.entries.numpy()
    assert np.array_equal(tagged < 0, np.isin(np.arange(n), ends))
    assert np.array_equal(tagged & 0x7fffffff, plan.perm.numpy())
    for name in ("window_runs", "run_rows"):
        assert np.array_equal(getattr(plan, name).numpy(), lay[name])
    for bad in (dict(window=6), dict(threads=48), dict(threads=1024)):
        with pytest.raises(ValueError):
            tile_layout(offsets, **bad)


def test_kernel_args_struct():
    """The ctypes mirror of csrc/segment_sum.cu's SegmentPlan: 6
    pointers, the entry count and 7 ints (88 bytes, the last 4 padding),
    filled from the plan and its launch state for (D, type): the order's
    lanes and slot window
    and tiles, each tile's incoming row and its first tile, a carry and
    an own piece of D elements a tile, zeroed flags; made once per (D,
    type)."""
    import ctypes
    idx = skewed_index(4)
    plan = GatherRows.build(idx, 300, "cpu", 4, 64)
    state = plan.launch_state(2)
    args = state.args
    assert ctypes.sizeof(args) == 88
    assert (state.lanes, state.slot_window, state.vec) == (1, 4, 2)
    assert state.tile == 64 * 4 and state.tiles == -(-len(idx) // 256)
    assert (args.n, args.rows, args.runs, args.window, args.slot_window,
            args.threads, args.lanes, args.tiles) == (
        plan.perm.numel(), 300, plan.runs, 4, 4, 64, 1, state.tiles)
    assert args.entries == plan.entries.data_ptr()
    assert args.window_runs == plan.window_runs.data_ptr()
    assert args.run_rows == plan.run_rows.data_ptr()
    assert args.tile_in == state.tile_in.data_ptr()
    assert args.scratch == state.scratch.data_ptr()
    assert args.flags == state.flags.data_ptr()
    assert state.scratch.numel() == 2 * state.tiles * 2
    assert state.scratch.dtype == torch.float32
    assert not state.flags.any()
    # Each tile's incoming row: the row of its first entry where that
    # row started in an earlier tile, and that tile.
    offsets = plan.offsets.numpy().astype(np.int64)
    key = np.repeat(np.arange(300), np.diff(offsets))
    for t, (row, t0) in enumerate(state.tile_in.tolist()):
        start = t * state.tile
        takes = 0 < start and offsets[key[start]] < start
        assert (row, t0) == ((key[start], offsets[key[start]] // 256)
                             if takes else (-1, t))
    assert plan.launch_state(2) is state
    wide = plan.launch_state(12)
    assert (wide.lanes, wide.slot_window, wide.vec, wide.tile) == (
        4, 16, 4, 16 * 16)
    assert (wide.args.lanes, wide.args.slot_window) == (4, 16)
    assert wide.scratch.numel() == 2 * wide.tiles * 12
    f64 = plan.launch_state(12, torch.float64)
    assert (f64.lanes, f64.slot_window, f64.vec, f64.tile) == (8, 16, 2, 128)
    assert f64.scratch.dtype == torch.float64 and f64 is not wide
    assert plan.launch_state(2).args is args


def test_plan_layout_and_checks():
    """The plan holds the transposed index (int32 ``perm`` and
    ``offsets``), ``tile_layout``'s fields of its (``window``,
    ``threads``), no launch state before a backward asks for one, and one
    launch a backward; bad indices, row counts, cotangents and devices
    raise."""
    idx = skewed_index(0)
    plan = GatherRows.build(torch.from_numpy(idx), 300, "cpu")
    assert (plan.window, plan.threads) == (WINDOW, THREADS)
    assert plan.perm.dtype == plan.offsets.dtype == torch.int32
    assert torch.equal(plan.perm.long(), torch.from_numpy(
        np.argsort(idx, kind="stable")))
    assert plan.offsets.numel() == 301 and plan.offsets[-1] == len(idx)
    lay = tile_layout(plan.offsets.numpy(), WINDOW, THREADS)
    for name in ("window_runs", "run_rows"):
        assert np.array_equal(getattr(plan, name).numpy(), lay[name])
    assert plan.entries.dtype == torch.int32 and plan.runs == lay["runs"]
    assert not plan._launches
    state = plan.launch_state(2)
    assert state.tiles == -(-len(idx) // (WINDOW * THREADS))
    assert state.flags.dtype == torch.int32 and not state.flags.any()
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


def test_backward_range_only_under_the_profiler(monkeypatch):
    """Under ``torch.profiler`` a backward is the range
    ``<name>.backward``; without a profiler it opens no range (which
    costs more host time than the label lookup's kernel on the card)."""
    import contextlib
    plan = GatherRows.build(skewed_index(0), 300, "cpu", name="readout.t")
    g = torch.rand(plan.perm.numel(), 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        plan.backward(g)
    assert "readout.t.backward" in {e.key for e in prof.key_averages()}
    opened = []
    monkeypatch.setattr(gather, "annotate", lambda *a, **k: opened.append(
        a) or contextlib.nullcontext())
    assert torch.equal(plan.backward(g), plan.backward_plain(g))
    assert not opened


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
@pytest.mark.parametrize("d", [1, 2, 3, 5, 12, 16])
@pytest.mark.parametrize("window,threads", [(WINDOW, THREADS), (4, 32)])
def test_backward_bit_equal_on_card(cuda_device, d, window, threads, dtype):
    """One kernel launch a backward, bit-equal to ``segment_sum_plain``
    run on the card and bit-identical over 3 calls and 2 replays of a
    CUDA graph, in f32 and f64 (D = 3 and 12: 4 and 8 lanes an entry);
    the forward equal to ``x[idx]``; within rtol 1e-5 of
    ``index_add_``."""
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
    state = plan.launch_state(d, x.dtype)
    assert not state.flags.any()
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
@pytest.mark.parametrize("threads", [32, 64])
def test_segment_cases_bit_equal_on_card(cuda_device, case, threads):
    """The kernel on each edge case of the plain version's tests, at one
    and two warps a block: f32 D=2, 3, 5 and 12 and f64 D=3 and 12 (1, 4,
    8 and 4 lanes; 4 and 8), bit-equal to ``segment_sum_plain`` on the
    card."""
    idx, rows = _segment_case(case, 4, 32)
    plan = GatherRows.build(np.random.RandomState(0).permutation(idx), rows,
                            cuda_device, 4, threads)
    for dtype, d in ((np.float32, 2), (np.float32, 3), (np.float32, 5),
                     (np.float32, 12), (np.float64, 3), (np.float64, 12)):
        rng = np.random.RandomState(d)
        g = torch.from_numpy((rng.randn(len(idx), d) * 10.0 ** rng.randint(
            -3, 4, (len(idx), 1))).astype(dtype)).to(cuda_device)
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
    state = plan.launch_state(d, dtype)
    assert not state.flags.any()


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
    by column slice (columns are independent, so a slice told the full
    width's lanes keeps the order)."""
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
    lanes = plan.launch_state(d).lanes
    for c in range(0, d, 32):
        want = plan.backward_plain(g[:, c:c + 32], lanes)
        assert torch.equal(got[:, c:c + 32], want)
