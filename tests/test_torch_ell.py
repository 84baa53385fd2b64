"""The port's degree-binned ELL aggregation (gnnpe_tpu_torch/ops/ell.py)
against gnnpe_tpu's ``BinnedEll`` and the Pallas kernel it replaces
(experiments/pallas_blocked_spmm.py, interpret mode), on the CPU.

Tolerances: rtol 1e-5 (atol 1e-6) on non-negative f32 features, because
XLA's ``take(...).sum(1)`` and the Pallas kernel sum in another order
than the port's ascending slots.  The launch plan (levels, descriptors,
launches per apply) is plain Python and is checked here on the CPU.  The
CUDA tests, which skip without a card, require the kernel bit-equal to
its plain version:
    python -m pytest --noconftest -q -m cuda tests/test_torch_ell.py
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu.io.datasets import powerlaw_graph
from gnnpe_tpu_torch.ops import ell


def _hub_graph():
    """A degree-199 vertex among 300: past the "cpu" row's hub
    threshold (~0.27·V occurrences), so the layout takes the hub path."""
    rng = np.random.RandomState(0)
    edges = ([[0, i] for i in range(1, 200)] +
             rng.randint(1, 300, (800, 2)).tolist())
    edges = np.array([e for e in edges if e[0] != e[1]])
    return CSRGraph.from_edges(300, edges, np.zeros(300, dtype=np.int64))


def _chain_graph():
    """A degree-700 vertex among 3000: 11 chunks of width 64, more than
    one fold of 8, so the head chain has three levels; below the hub
    threshold (~0.27·V occurrences)."""
    rng = np.random.RandomState(1)
    edges = np.array([[0, i] for i in range(1, 701)] +
                     rng.randint(1, 3000, (6000, 2)).tolist())
    edges = np.unique(np.sort(edges[edges[:, 0] != edges[:, 1]], 1), axis=0)
    return CSRGraph.from_edges(3000, edges, np.zeros(3000, dtype=np.int64))


GRAPHS = {
    # 42 head vertices (degree > 64, folded) and no hubs.
    "head": lambda: powerlaw_graph(2000, 12000, 8, seed=0, max_degree=300),
    "hubs": _hub_graph,
}
PLAN_GRAPHS = dict(GRAPHS, chain=_chain_graph)


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in PLAN_GRAPHS.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _table_inputs(seed=0, n=128, w=4, v=64, d=8):
    """tests/test_ops.py::test_pallas_blocked_spmm_interpret's inputs;
    with pads, the last padcnt[i] slots of row i point at row 0."""
    rng = np.random.RandomState(seed)
    x = rng.rand(v, d).astype(np.float32)
    tbl = rng.randint(0, v, (n, w)).astype(np.int32)
    pads = rng.randint(0, w + 1, n)
    for i, p in enumerate(pads):
        tbl[i, w - p:] = 0
    return x, tbl, pads.astype(np.float32)


@pytest.mark.parametrize("with_padcnt", [False, True])
def test_gather_sum_plain_matches_pallas_interpret(with_padcnt):
    import jax.numpy as jnp
    from experiments.pallas_blocked_spmm import blocked_gather_sum
    x, tbl, padcnt = _table_inputs()
    pc = padcnt if with_padcnt else None
    want = np.asarray(blocked_gather_sum(jnp.asarray(x), tbl, pc, tile_r=64,
                                         interpret=True))
    before = ell.LAUNCHES
    got = ell.gather_sum(torch.from_numpy(x), torch.from_numpy(tbl),
                         None if pc is None else torch.from_numpy(pc))
    assert ell.LAUNCHES == before          # CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_gather_sum_writes_into_row_range():
    x, tbl, padcnt = _table_inputs()
    xt, tt, pt = map(torch.from_numpy, (x, tbl, padcnt))
    big = torch.full((200, x.shape[1]), -1.0)
    ell.gather_sum(xt, tt, pt, out=big[40:168])
    assert torch.equal(big[40:168], ell.gather_sum_plain(xt, tt, pt))
    assert (big[:40] == -1).all() and (big[168:] == -1).all()


CASES = [("head", "hi_lo"), ("hubs", "hi_lo"), ("hubs", "bf16"),
         ("hubs", "f32")]


@pytest.mark.parametrize("graph,precision", CASES)
def test_binned_apply_matches_jax(graphs, graph, precision):
    import jax.numpy as jnp
    from gnnpe_tpu.ops.ell import build_binned_ell as jax_build
    g = graphs[graph]
    ref = jax_build(g.offsets, g.neighbors, hub_precision=precision)
    lay = ell.build_binned_ell(g.offsets, g.neighbors,
                               hub_precision=precision)
    # The pinned hub prices give gnnpe_tpu's layout (tests pin it with
    # GNNPE_NO_PROBE) without importing JAX.
    assert np.array_equal(lay.perm, ref.perm)
    assert lay.num_hub_arcs == ref.num_hub_arcs
    assert (lay.num_hub_arcs > 0) == (graph == "hubs")
    assert (lay.num_head > 0)
    for a, b in zip(lay.class_tables + lay.head_tables,
                    ref.class_tables + ref.head_tables):
        assert np.array_equal(a, b)
    dev = ell.BinnedEllDevice.from_host(lay, "cpu")
    x = np.random.RandomState(1).rand(g.num_vertices, 8).astype(np.float32)
    np.testing.assert_allclose(dev.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.apply(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    xp = x[lay.perm]
    np.testing.assert_allclose(
        dev.apply_perm(torch.from_numpy(xp)).numpy(),
        np.asarray(ref.apply_perm(jnp.asarray(xp))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_symmetric_aggregate_value_and_grad_match_jax(graphs, graph):
    """Value and gradient of sum(w · agg(h)) through
    ``symmetric_aggregate`` (permuted space) and ``binned_aggregate``
    (with the boundary permutes, as fit uses it)."""
    import jax
    import jax.numpy as jnp
    from gnnpe_tpu.ops.ell import build_binned_ell as jax_build
    from gnnpe_tpu.ops.ell import symmetric_aggregate as jax_sym
    g = graphs[graph]
    ref = jax_build(g.offsets, g.neighbors)
    dev = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors), "cpu")
    rng = np.random.RandomState(2)
    h = rng.rand(g.num_vertices, 4).astype(np.float32)
    w = rng.rand(g.num_vertices, 4).astype(np.float32)
    inner = jax_sym(ref)
    perm, rank = jnp.asarray(ref.perm), jnp.asarray(ref.rank)
    jax_fns = {
        "symmetric": inner,
        "binned": lambda x: jnp.take(inner(jnp.take(x, perm, axis=0)), rank,
                                     axis=0),
    }
    port_fns = {"symmetric": ell.symmetric_aggregate(dev),
                "binned": ell.binned_aggregate(dev)}
    for name in ("symmetric", "binned"):
        jfn = jax_fns[name]
        want_v, want_g = jax.value_and_grad(
            lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(h))
        ht = torch.from_numpy(h).requires_grad_(True)
        value = (port_fns[name](ht) * torch.from_numpy(w)).sum()
        value.backward()
        np.testing.assert_allclose(value.item(), float(want_v), rtol=1e-5)
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-5, atol=1e-6)


def _per_table_apply_perm(dev, h_perm, gather=ell.gather_sum):
    """The layout table by table, one ``gather`` call each: the head
    chain through every fold level, then each width class into its row
    range (what ``apply_perm`` did before it had a launch plan)."""
    out = torch.empty_like(h_perm)
    if dev.num_head:
        cur = h_perm
        for tbl, pc in dev.head[:-1]:
            cur = gather(cur, tbl, pc)
        gather(cur, *dev.head[-1], out=out[:dev.num_head])
    lo = dev.num_head
    for tbl, pc in dev.classes:
        gather(h_perm, tbl, pc, out=out[lo:lo + tbl.shape[0]])
        lo += tbl.shape[0]
    if dev.hub_rows is not None:
        out = out + dev._hub_part(h_perm)
    return out


@pytest.mark.parametrize("graph", sorted(PLAN_GRAPHS))
def test_launch_plan_levels_and_descriptors(graphs, graph):
    g = graphs[graph]
    dev = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors), "cpu")
    plan, v = dev.plan, g.num_vertices
    assert dev.num_head > 0 and len(dev.head) >= (3 if graph == "chain"
                                                  else 2)
    assert (dev.hub_rows is not None) == (graph == "hubs")
    # One level per head table; the classes share the first.
    assert len(plan.levels) == len(dev.head)
    assert plan.launches_per_apply == dev.launches_per_apply == len(dev.head)
    first = plan.levels[0]
    assert first.src_row is None and first.src_rows == v
    assert [t.tbl for t in first.tables] == \
        [t for t, _ in dev.classes] + [dev.head[0][0]]
    lo = dev.num_head
    for t in first.tables[:-1]:
        assert t.out_row == lo
        lo += t.rows
    assert lo == v
    # The chain: each level reads the rows the one before wrote; the
    # intermediate levels sit past the output rows, the last at row 0.
    scratch = v
    for i, level in enumerate(plan.levels):
        t = level.tables[-1]
        assert (t.tbl, t.padcnt) == dev.head[i]
        if i:
            assert len(level.tables) == 1
            prev = plan.levels[i - 1].tables[-1]
            assert (level.src_row, level.src_rows) == (prev.out_row,
                                                       prev.rows)
            assert int(t.tbl.max()) < level.src_rows
        if i < len(plan.levels) - 1:
            assert t.out_row == scratch
            scratch += t.rows
        else:
            assert t.out_row == 0 and t.rows == dev.num_head
    assert plan.work_rows == scratch
    # Descriptors: what the kernel is handed, for 1 and 32 lanes per row.
    for lanes in (1, 32):
        per_unit = 32 // lanes
        for level, launches in zip(plan.levels, plan.descriptors(lanes)):
            (desc, blocks), = launches
            assert desc.n == len(level.tables)
            at = 0
            for i, t in enumerate(level.tables):
                c = desc.t[i]
                assert (c.tbl, c.rows, c.width, c.out_row, c.first_unit) \
                    == (t.tbl.data_ptr(), t.rows, t.width, t.out_row, at)
                assert c.padcnt == (None if t.padcnt is None
                                    else t.padcnt.data_ptr())
                at += -(-t.rows // per_unit)
            assert desc.units == at
            assert blocks == -(-at // (ell.THREADS // 32))
        assert plan.descriptors(lanes) is plan.descriptors(lanes)


@pytest.mark.parametrize("graph", sorted(PLAN_GRAPHS))
@pytest.mark.parametrize("d", [2, 5])
def test_plan_walk_equals_per_table_apply_and_jax(graphs, graph, d):
    """The plan walked over gather_sum_plain is the per-table apply bit
    for bit (the same adds in the same order) and gnnpe_tpu's BinnedEll
    apply within rtol 1e-5, atol 1e-6 (XLA sums in another order)."""
    import jax.numpy as jnp
    from gnnpe_tpu.ops.ell import build_binned_ell as jax_build
    g = graphs[graph]
    dev = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors), "cpu")
    xp = np.random.RandomState(4).rand(g.num_vertices, d).astype(np.float32)
    h = torch.from_numpy(xp)
    before = ell.LAUNCHES
    got = dev.apply_perm(h)
    assert ell.LAUNCHES == before          # CPU walks the plain version
    assert torch.equal(got, dev.apply_perm(h, gather=ell.gather_sum_plain))
    assert torch.equal(got, _per_table_apply_perm(dev, h))
    ref = jax_build(g.offsets, g.neighbors)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.apply_perm(jnp.asarray(xp))),
        rtol=1e-5, atol=1e-6)


def test_plan_splits_a_level_over_max_tables(graphs):
    """More width classes than one launch holds: the level becomes
    several launches and the walk still equals the per-table apply."""
    g = graphs["head"]
    widths = tuple(range(1, 41))
    dev = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors, widths=widths), "cpu")
    n_first = len(dev.plan.levels[0].tables)
    assert n_first > ell.MAX_TABLES
    launches = dev.plan.levels[0].descriptors(4)
    assert [d.n for d, _ in launches] == \
        [ell.MAX_TABLES] * (n_first // ell.MAX_TABLES) + \
        ([n_first % ell.MAX_TABLES] if n_first % ell.MAX_TABLES else [])
    assert all(d.t[0].first_unit == 0 for d, _ in launches)
    assert dev.launches_per_apply == len(launches) + len(dev.head) - 1
    h = torch.from_numpy(np.random.RandomState(5).rand(
        g.num_vertices, 3).astype(np.float32))
    assert torch.equal(dev.apply_perm(h), _per_table_apply_perm(dev, h))


def test_apply_perm_rejects_bad_input(graphs):
    g = graphs["head"]
    dev = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors), "cpu")
    good = torch.zeros(g.num_vertices, 2)
    for bad in (good[:-1], good.double(), good[:, 0], good.to("meta")):
        with pytest.raises(ValueError):
            dev.apply_perm(bad)


def test_from_host_rejects_out_of_range_table(graphs):
    g = graphs["head"]
    lay = ell.build_binned_ell(g.offsets, g.neighbors)
    lay.class_tables[0] = lay.class_tables[0].copy()
    lay.class_tables[0][0, 0] = g.num_vertices
    with pytest.raises(ValueError):
        ell.BinnedEllDevice.from_host(lay, "cpu")


def _bad_inputs():
    x, tbl, padcnt = map(torch.from_numpy, _table_inputs())
    return {
        "buf_float64": (x.double(), tbl, padcnt, None, TypeError),
        "tbl_int64": (x, tbl.long(), padcnt, None, TypeError),
        "padcnt_short": (x, tbl, padcnt[:-1], None, TypeError),
        "buf_not_contiguous": (x.t().contiguous().t(), tbl, padcnt, None,
                               ValueError),
        "out_wrong_shape": (x, tbl, padcnt, torch.empty(3, 8), ValueError),
        "meta_device": (x.to("meta"), tbl.to("meta"), padcnt.to("meta"),
                        None, ValueError),
    }


@pytest.mark.parametrize("case", ["buf_float64", "tbl_int64", "padcnt_short",
                                  "buf_not_contiguous", "out_wrong_shape",
                                  "meta_device"])
def test_gather_sum_rejects(case):
    x, tbl, padcnt, out, err = _bad_inputs()[case]
    with pytest.raises(err):
        ell.gather_sum(x, tbl, padcnt, out=out)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    """gather_sum, apply_perm and the symmetric backward, each bit-equal
    to the plain version on the card (f32, D=2 and D=128)."""
    g = powerlaw_graph(20000, 80000, 12, seed=0, max_degree=300)
    dev = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors), cuda_device)
    assert dev.num_head > 0
    x, tbl, padcnt = (t.to(cuda_device)
                      for t in map(torch.from_numpy, _table_inputs()))
    before = ell.LAUNCHES
    assert torch.equal(ell.gather_sum(x, tbl, padcnt),
                       ell.gather_sum_plain(x, tbl, padcnt))
    assert ell.LAUNCHES == before + 1
    rng = np.random.RandomState(3)
    for d in (2, 128):
        h = torch.from_numpy(rng.rand(g.num_vertices, d).astype(np.float32)
                             ).to(cuda_device)
        got = dev.apply_perm(h)
        torch.cuda.synchronize()
        assert torch.equal(got, dev.apply_perm(h, gather=ell.gather_sum_plain))
        hg = h.clone().requires_grad_(True)
        cot = torch.rand_like(h)
        ell.symmetric_aggregate(dev)(hg).backward(cot)
        assert torch.equal(hg.grad, dev.apply_perm(cot))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 5, 128, 130])
def test_kernel_odd_shapes_on_cuda(cuda_device, d):
    """Every lane shape of the kernel (columns per lane 1, 2, 4; 1 to 32
    lanes per row; a row wider than one column tile), bit-equal to the
    plain version: single tables of width 1 and 7 with and without pads,
    written into row ranges whose first byte is not 16-aligned, and the
    launch plan of a layout with a three-level head chain and of one
    with hubs, one launch per level."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(97, d).astype(np.float32)).to(cuda_device)
    for w in (1, 7):
        tbl = rng.randint(0, 97, (203, w)).astype(np.int32)
        pads = rng.randint(0, w + 1, 203)
        for i, p in enumerate(pads):
            tbl[i, w - p:] = 0
        tt = torch.from_numpy(tbl).to(cuda_device)
        for pc in (None, torch.from_numpy(pads.astype(np.float32)
                                          ).to(cuda_device)):
            want = ell.gather_sum_plain(x, tt, pc)
            assert torch.equal(ell.gather_sum(x, tt, pc), want)
            for first in (1, 3, 4):
                big = torch.full((210, d), -1.0, device=cuda_device)
                ell.gather_sum(x, tt, pc, out=big[first:first + 203])
                torch.cuda.synchronize()
                assert torch.equal(big[first:first + 203], want)
                assert (big[:first] == -1).all()
                assert (big[first + 203:] == -1).all()
    for make in (_chain_graph, _hub_graph):
        g = make()
        dev = ell.BinnedEllDevice.from_host(
            ell.build_binned_ell(g.offsets, g.neighbors), cuda_device)
        h = torch.from_numpy(rng.rand(g.num_vertices, d).astype(np.float32)
                             ).to(cuda_device)
        before = ell.LAUNCHES
        got = dev.apply_perm(h)
        torch.cuda.synchronize()
        assert ell.LAUNCHES == before + dev.launches_per_apply
        assert dev.launches_per_apply == len(dev.head)
        assert torch.equal(got, dev.apply_perm(h,
                                               gather=ell.gather_sum_plain))
        # An h_perm whose first byte is only 4-aligned.
        flat = torch.empty(h.numel() + 1, device=cuda_device)
        shifted = flat[1:].view(h.shape).copy_(h)
        assert torch.equal(dev.apply_perm(shifted), got)
