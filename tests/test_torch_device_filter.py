"""The port's native-f64 dominance masks against gnnpe_tpu's three-limb
f32 masks (split3/ge3), including thresholds equal to a data value and
one ulp either side of it; and the flat ``pe_candidates_device`` against
gnnpe_tpu's and against both packages' f64 host filter, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnpe_tpu.embed.pde import gen_pde, gen_query_pde_table
from gnnpe_tpu.embed.vde import gen_vde
from gnnpe_tpu.graph.partition import degree_sorted_nodes
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.match import device_filter as jax_filter
from gnnpe_tpu.match.device_filter import (pe_mask_device_exact,
                                           pge_mask_device_exact, split3)
from gnnpe_tpu.match.filter import pe_candidates as jax_pe_candidates
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu_torch.match import device_filter
from gnnpe_tpu_torch.match.device_filter import (pe_candidates_device,
                                                 pe_mask_exact,
                                                 pge_mask_exact)
from gnnpe_tpu_torch.match.filter import pe_candidates


def _nudged(rng, t):
    """Copy of thresholds ``t`` (taken from data rows) with some entries
    nudged one ulp up or down."""
    t = t.copy()
    nudge = rng.choice([-1, 0, 1], size=t.shape, p=[0.1, 0.8, 0.1])
    t[nudge > 0] = np.nextafter(t[nudge > 0], np.inf)
    t[nudge < 0] = np.nextafter(t[nudge < 0], -np.inf)
    return t


def _jax3(a):
    return tuple(jnp.asarray(x) for x in split3(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_pe_mask_equals_limb_mask(seed):
    rng = np.random.RandomState(seed)
    p, q, l, d = 400, 24, 3, 2
    d_labels = rng.randint(0, 2, (p, l)).astype(np.int32)
    d_degrees = rng.randint(1, 4, (p, l)).astype(np.int32)
    d_pde = rng.rand(p, l * d) * 40
    rows = rng.randint(0, p, q)
    q_labels = d_labels[rows]
    q_degrees = rng.randint(1, 3, (q, l)).astype(np.int32)
    q_thresh = _nudged(rng, d_pde[rows])
    want = np.asarray(pe_mask_device_exact(
        jnp.asarray(d_labels), jnp.asarray(d_degrees), _jax3(d_pde),
        jnp.asarray(q_labels), jnp.asarray(q_degrees), _jax3(q_thresh)))
    t = torch.from_numpy
    got = pe_mask_exact(t(d_labels), t(d_degrees), t(d_pde), t(q_labels),
                        t(q_degrees), t(q_thresh)).numpy()
    assert want.any() and not want.all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_pge_mask_equals_limb_mask(seed):
    rng = np.random.RandomState(seed)
    v, q, w = 400, 24, 4
    d_labels = rng.randint(0, 2, v).astype(np.int32)
    d_degrees = rng.randint(1, 4, v).astype(np.int32)
    d_ghi = rng.rand(v, w) * 40
    d_llo = rng.rand(v, w)
    d_lhi = d_llo + rng.rand(v, w)
    rows = rng.randint(0, v, q)
    q_labels = d_labels[rows]
    q_degrees = rng.randint(1, 3, q).astype(np.int32)
    q_glo = _nudged(rng, d_ghi[rows])
    q_llo = _nudged(rng, d_lhi[rows])
    q_lhi = _nudged(rng, d_llo[rows])
    want = np.asarray(pge_mask_device_exact(
        jnp.asarray(d_labels), jnp.asarray(d_degrees), _jax3(d_ghi),
        _jax3(d_llo), _jax3(d_lhi), jnp.asarray(q_labels),
        jnp.asarray(q_degrees), _jax3(q_glo), _jax3(q_llo),
        _jax3(q_lhi)))
    t = torch.from_numpy
    got = pge_mask_exact(t(d_labels), t(d_degrees), t(d_ghi), t(d_llo),
                         t(d_lhi), t(q_labels), t(q_degrees), t(q_glo),
                         t(q_llo), t(q_lhi)).numpy()
    assert want.any() and not want.all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("chunk_elems", [None, 5000])
def test_pe_candidates_device_equals_jax_and_host(chunk_elems, monkeypatch):
    """Whole and in many chunks over the data paths (5,000 elements make
    chunks of a few dozen rows)."""
    g = powerlaw_graph(600, 2400, 6, seed=4, max_degree=40)
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), 3, dedup=True)
    data = gen_pde(gen_vde(g, 2), paths)
    if chunk_elems:
        monkeypatch.setattr(device_filter, "FLAT_CHUNK_ELEMS", chunk_elems)
    total = 0
    for s in range(3):
        qg = sample_query(g, 6, seed=s)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices), 3,
                                dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde(qg, 2), qp)
        plan = greedy_path_cover(qp, weight, qg.num_vertices)
        got = pe_candidates_device(data, q_pde, plan, qg.num_vertices, "cpu")
        for want in (
                jax_filter.pe_candidates_device(data, q_pde, plan,
                                                qg.num_vertices),
                jax_pe_candidates(data, q_pde, plan, qg.num_vertices),
                pe_candidates(data, q_pde, plan, qg.num_vertices)):
            assert len(got) == len(want) == qg.num_vertices
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        total += sum(map(len, got))
    assert total > 0
    none = pe_candidates_device(data, q_pde, plan[:0], qg.num_vertices, "cpu")
    assert [len(c) for c in none] == [0] * qg.num_vertices
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pe_candidates_device(data, q_pde, plan, qg.num_vertices, "cuda")
