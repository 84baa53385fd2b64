"""The uniform-width ELL (``HierarchicalEll``), ``semijoin_prune(ell=)``
and the ``spmm_csr`` / ``segment_spmm`` names, held to gnnpe_tpu on
numpy-seeded inputs.  On the CPU each level is the masked plain form; the
kernel route (one A2 launch a level) runs only on a card.

Tables and ``slot_arc`` are bit-equal; sums agree with gnnpe_tpu's at
f32 rtol 1e-6 (XLA may order a row's adds differently) and exactly on
integer-valued inputs.
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu.match import preverify as jax_preverify
from gnnpe_tpu.ops import ell as jax_ell
from gnnpe_tpu.ops import spmm as jax_spmm
from gnnpe_tpu_torch.graph.csr import CSRGraph
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.match.preverify import semijoin_prune
from gnnpe_tpu_torch.ops import ell, spmm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _csr(seed, v=300, e=1500, isolated=7, hub=120):
    """A CSR adjacency with a hub (several fold levels at small widths)
    and isolated vertices at the end."""
    rng = np.random.RandomState(seed)
    pairs = np.concatenate([
        np.stack([np.zeros(hub, np.int64), np.arange(1, hub + 1)], 1),
        rng.randint(1, v - isolated, (e, 2))])
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    pairs = np.unique(np.sort(pairs, axis=1), axis=0)
    g = CSRGraph.from_edges(v, pairs, rng.randint(0, 4, v))
    return g.offsets, g.neighbors


WIDTHS = [(8, 8), (4, 4), (4, 2), (2, 2), (16, 3)]


@pytest.mark.parametrize("width,level2", WIDTHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_build_ell_bit_equal(seed, width, level2):
    offs, nbr = _csr(seed)
    got = ell.build_ell(offs, nbr, width=width, level2_width=level2)
    want = jax_ell.build_ell(offs, nbr, width=width, level2_width=level2)
    assert len(got.levels) == len(want.levels) >= 2
    for a, b in zip(got.levels, want.levels):
        assert a.tbl.dtype == b.tbl.dtype and np.array_equal(a.tbl, b.tbl)
        assert a.num_rows == b.num_rows
    assert np.array_equal(got.slot_arc, want.slot_arc)
    assert (got.num_vertices, got.num_slots) == (want.num_vertices,
                                                 want.num_slots)


def test_build_ell_recursive_fold_and_isolated():
    """A width-2 fold of a 120-degree hub needs several levels; isolated
    vertices keep one all-pad chunk row and sum to zero."""
    offs, nbr = _csr(2)
    lay = ell.build_ell(offs, nbr, width=2, level2_width=2)
    assert len(lay.levels) > 3
    x = torch.ones((len(offs) - 1, 3))
    out = lay.apply(x)
    deg = torch.from_numpy(np.diff(offs).astype(np.float32))
    assert torch.equal(out, deg[:, None].expand(-1, 3))
    assert torch.equal(out[-7:], torch.zeros((7, 3)))


@pytest.mark.parametrize("width,level2", WIDTHS)
def test_apply_matches_gnnpe_tpu(width, level2):
    import jax.numpy as jnp
    offs, nbr = _csr(3)
    x = np.random.RandomState(4).rand(len(offs) - 1, 5).astype(np.float32)
    got = ell.build_ell(offs, nbr, width, level2).apply(torch.from_numpy(x))
    want = np.asarray(jax_ell.build_ell(offs, nbr, width, level2).apply(
        jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # Against the CSR sum (A1's plain version) as well.
    np.testing.assert_allclose(
        got.numpy(), spmm.neighbor_sum_np(offs, nbr, x), rtol=1e-6)


@pytest.mark.parametrize("width,level2", WIDTHS)
def test_apply_exact_on_integers(width, level2):
    import jax.numpy as jnp
    offs, nbr = _csr(5)
    x = np.random.RandomState(6).randint(-50, 50, (len(offs) - 1, 4)
                                         ).astype(np.float32)
    lay = ell.build_ell(offs, nbr, width, level2)
    got = ell.ell_neighbor_sum(lay, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ell.ell_neighbor_sum(
        jax_ell.build_ell(offs, nbr, width, level2), jnp.asarray(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, spmm.neighbor_sum_np(offs, nbr, x))


def test_on_uploads_once_and_checks_inputs():
    offs, nbr = _csr(7)
    lay = ell.build_ell(offs, nbr)
    dev = lay.on("cpu")
    assert lay.on("cpu") is dev
    assert dev.launches_per_apply == len(lay.levels)
    # The kernel's tables point every pad at the zero row past the
    # level's input, and are the only tables uploaded: the mask of the
    # plain form is ``tbl < src_rows``.
    assert not hasattr(dev, "masked")
    for lvl, tbl, rows in zip(lay.levels, dev.tables, dev.src_rows):
        pad = lvl.tbl < 0
        assert tbl.dtype == torch.int32
        assert np.array_equal(np.where(tbl.numpy() < rows, tbl.numpy(), -1),
                              lvl.tbl)
        assert np.array_equal(tbl.numpy()[pad], np.full(pad.sum(), rows))
        assert np.array_equal(tbl.numpy()[~pad], lvl.tbl[~pad])
    x = torch.rand(len(offs) - 1, 2)
    assert torch.equal(dev.apply(x), dev.apply_plain(x))
    with pytest.raises(ValueError):
        dev.apply(torch.rand(5, 2))
    with pytest.raises(ValueError):
        dev.apply(torch.rand(len(offs) - 1, 2, device="meta"))


def test_kernel_tables_walk_equals_masked_form():
    """What the kernel computes on the card — the level's input with a
    zero row appended, pads pointing at it, slots added in order from
    0.0 — walked here with A2's plain version: bit-equal to the masked
    plain form."""
    offs, nbr = _csr(8)
    dev = ell.build_ell(offs, nbr, 4, 2).on("cpu")
    x = torch.from_numpy(np.random.RandomState(9).rand(
        len(offs) - 1, 6).astype(np.float32) * 2 - 1)
    buf = torch.cat([x, torch.zeros(1, 6)])
    for tbl in dev.tables:
        out = ell.gather_sum_plain(buf, tbl, None)
        buf = torch.cat([out, torch.zeros(1, 6)])
    assert torch.equal(buf[:-1], dev.apply_plain(x))


def test_semijoin_prune_ell_equals_a1_and_gnnpe_tpu():
    from gnnpe_tpu.graph.csr import CSRGraph as JaxGraph
    g = powerlaw_graph(400, 2400, 3, seed=3, max_degree=70)
    jg = JaxGraph(g.offsets, g.neighbors, g.labels)
    lay = ell.build_ell(g.offsets, g.neighbors)
    jlay = jax_ell.build_ell(g.offsets, g.neighbors)
    rng = np.random.RandomState(1)
    for s in range(3):
        q = sample_query(g, 5, seed=s)
        jq = JaxGraph(q.offsets, q.neighbors, q.labels)
        cands = [np.unique(rng.randint(0, g.num_vertices, 160))
                 for _ in range(q.num_vertices)]
        for iters in (1, 3):
            got = semijoin_prune(g, q, cands, "cpu", iters=iters, ell=lay)
            a1 = semijoin_prune(g, q, cands, "cpu", iters=iters)
            ref = jax_preverify.semijoin_prune(jg, jq, cands, iters=iters,
                                               ell=jlay)
            for a, b, c in zip(got, a1, ref):
                assert np.array_equal(a, b) and np.array_equal(a, c)
            assert sum(map(len, got)) < sum(map(len, cands))


def test_spmm_names_match_gnnpe_tpu():
    import jax.numpy as jnp
    offs, nbr = _csr(10)
    v = len(offs) - 1
    rng = np.random.RandomState(11)
    x = rng.rand(v, 3).astype(np.float32)
    got = spmm.spmm_csr(offs, nbr, torch.from_numpy(x))
    want = np.asarray(jax_spmm.spmm_csr(jnp.asarray(offs), jnp.asarray(nbr),
                                        jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    rows = np.repeat(np.arange(v), np.diff(offs))
    w = rng.rand(len(nbr)).astype(np.float32)
    got = spmm.segment_spmm(nbr, rows, torch.from_numpy(w),
                            torch.from_numpy(x), v)
    want = np.asarray(jax_spmm.segment_spmm(
        jnp.asarray(nbr), jnp.asarray(rows), jnp.asarray(w), jnp.asarray(x),
        v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # gnnpe_tpu's COO neighbor_sum is segment_spmm with unit weights.
    got = spmm.segment_spmm(nbr, rows, 1, torch.from_numpy(x), v)
    want = np.asarray(jax_spmm.neighbor_sum(jnp.asarray(nbr),
                                            jnp.asarray(rows),
                                            jnp.asarray(x), v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 16, 128])
def test_a2_route_bit_equal_on_card(cuda_device, d):
    """One A2 launch a level, bit-equal to the masked plain form run on
    the card, and within rtol 1e-5 of A1's sum."""
    offs, nbr = _csr(12)
    lay = ell.build_ell(offs, nbr, 4, 2)
    dev = lay.on(cuda_device)
    x = torch.from_numpy(np.random.RandomState(d).rand(
        len(offs) - 1, d).astype(np.float32)).to(cuda_device)
    before = ell.LAUNCHES
    got = dev.apply(x)
    assert ell.LAUNCHES - before == len(lay.levels)
    assert torch.equal(got, dev.apply_plain(x))
    want = spmm.neighbor_sum(torch.from_numpy(offs).to(cuda_device),
                             torch.from_numpy(nbr).to(cuda_device), x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_semijoin_prune_ell_on_card(cuda_device):
    g = powerlaw_graph(400, 2400, 3, seed=3, max_degree=70)
    lay = ell.build_ell(g.offsets, g.neighbors)
    q = sample_query(g, 5, seed=0)
    rng = np.random.RandomState(2)
    cands = [np.unique(rng.randint(0, g.num_vertices, 160))
             for _ in range(q.num_vertices)]
    before = ell.LAUNCHES
    got = semijoin_prune(g, q, cands, cuda_device, iters=2, ell=lay)
    assert ell.LAUNCHES > before
    for a, b in zip(got, semijoin_prune(g, q, cands, "cpu", iters=2)):
        assert np.array_equal(a, b)
