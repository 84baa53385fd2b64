"""The port's degree-binned ELL aggregation (gnnpe_tpu_torch/ops/ell.py)
against gnnpe_tpu's ``BinnedEll`` and the Pallas kernel it replaces
(experiments/pallas_blocked_spmm.py, interpret mode), on the CPU.

Tolerances: rtol 1e-5 (atol 1e-6) on non-negative f32 features, because
XLA's ``take(...).sum(1)`` and the Pallas kernel sum in another order
than the port's ascending slots.  The CUDA test, which skips without a
card, requires the kernel bit-equal to its plain version:
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


GRAPHS = {
    # 42 head vertices (degree > 64, folded) and no hubs.
    "head": lambda: powerlaw_graph(2000, 12000, 8, seed=0, max_degree=300),
    "hubs": _hub_graph,
}


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in GRAPHS.items()}


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
