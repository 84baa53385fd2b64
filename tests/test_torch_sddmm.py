"""SDDMM, segment softmax, weighted apply and one attention hop over the
uniform-width ELL, held to gnnpe_tpu and to the dense per-destination
reference of tests/test_ops.py::test_sddmm_attention_matches_dense, at
rtol 1e-5, on numpy-seeded inputs.  The sum folds walk the layout's
levels (the masked plain form on the CPU, kernel A2 on a card)."""

import numpy as np
import pytest
import torch

from gnnpe_tpu.ops import ell as jax_ell
from gnnpe_tpu.ops import sddmm as jax_sddmm
from gnnpe_tpu_torch.ops import ell, sddmm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed=0, v=120, e=900, d=8, width=4, isolated=0):
    """tests/test_ops.py's arcs (destination-sorted, random sources);
    ``isolated`` destinations get no arc."""
    rng = np.random.RandomState(seed)
    dst = np.sort(rng.randint(0, v - isolated, e))
    src = rng.randint(0, v, e).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=v))])
    xk, xq, xv = (rng.rand(v, d).astype(np.float32) for _ in range(3))
    return dict(v=v, dst=dst, src=src, offs=offs, xk=xk, xq=xq, xv=xv,
                width=width)


def _dense(c):
    """The dense reference: scores, per-destination softmax, aggregate."""
    v, src, offs = c["v"], c["src"], c["offs"]
    dst = sddmm.arc_endpoints(offs)
    s = (c["xk"][src].astype(np.float64) * c["xq"][dst]).sum(-1)
    w = np.zeros_like(s)
    for u in range(v):
        lo, hi = offs[u], offs[u + 1]
        if hi > lo:
            ex = np.exp(s[lo:hi] - s[lo:hi].max())
            w[lo:hi] = ex / ex.sum()
    out = np.zeros((v, c["xv"].shape[1]))
    np.add.at(out, dst, w[:, None] * c["xv"][src])
    return s, w, out


CASES = [dict(seed=0), dict(seed=1, width=2), dict(seed=2, isolated=9),
         dict(seed=3, width=8, d=16, e=2000)]


@pytest.mark.parametrize("case", CASES)
def test_attention_pieces_match_gnnpe_tpu_and_dense(case):
    import jax.numpy as jnp
    c = _inputs(**case)
    lay = ell.build_ell(c["offs"], c["src"], width=c["width"],
                        level2_width=c["width"])
    jlay = jax_ell.build_ell(c["offs"], c["src"], width=c["width"],
                             level2_width=c["width"])
    dst = sddmm.arc_endpoints(c["offs"])
    assert np.array_equal(dst, jax_sddmm.arc_endpoints(c["offs"]))
    t, j = torch.from_numpy, jnp.asarray
    want_s, want_w, want = _dense(c)

    s = sddmm.sddmm(t(c["src"]), t(dst), t(c["xk"]), t(c["xq"]))
    js = jax_sddmm.sddmm(j(c["src"]), j(dst), j(c["xk"]), j(c["xq"]))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-5)

    w = sddmm.segment_softmax(lay, s, t(dst))
    jw = jax_sddmm.segment_softmax(jlay, js, j(dst))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(w.numpy(), want_w, rtol=1e-5, atol=1e-7)

    out = sddmm.weighted_apply(lay, t(c["xv"]), w)
    jout = jax_sddmm.weighted_apply(jlay, j(c["xv"]), jw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-7)

    full = sddmm.attention_aggregate(lay, c["src"], dst, t(c["xk"]),
                                     t(c["xq"]), t(c["xv"]))
    assert torch.equal(full, out)


def test_sddmm_chunks_and_isolated_destinations():
    c = _inputs(seed=4, isolated=11)
    dst = sddmm.arc_endpoints(c["offs"])
    t = torch.from_numpy
    whole = sddmm.sddmm(c["src"], dst, t(c["xk"]), t(c["xq"]))
    chunked = sddmm.sddmm(c["src"], dst, t(c["xk"]), t(c["xq"]), chunk=64)
    assert torch.equal(whole, chunked)
    lay = ell.build_ell(c["offs"], c["src"], width=4, level2_width=4)
    out = sddmm.attention_aggregate(lay, c["src"], dst, t(c["xk"]),
                                    t(c["xq"]), t(c["xv"]))
    assert torch.isfinite(out).all()
    assert torch.equal(out[-11:], torch.zeros((11, out.shape[1])))


@pytest.mark.cuda
def test_attention_on_card(cuda_device):
    c = _inputs(seed=5, d=16, e=2000, width=4)
    lay = ell.build_ell(c["offs"], c["src"], width=4, level2_width=2)
    dst = sddmm.arc_endpoints(c["offs"])
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    before = ell.LAUNCHES
    out = sddmm.attention_aggregate(lay, t(c["src"]), t(dst), t(c["xk"]),
                                    t(c["xq"]), t(c["xv"]))
    assert ell.LAUNCHES - before == 2 * (len(lay.levels) - 1)
    np.testing.assert_allclose(out.cpu().numpy(), _dense(c)[2], rtol=1e-4,
                               atol=1e-6)
