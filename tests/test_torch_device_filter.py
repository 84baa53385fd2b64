"""The port's native-f64 dominance masks against gnnpe_tpu's three-limb
f32 masks (split3/ge3), including thresholds equal to a data value and
one ulp either side of it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnpe_tpu.match.device_filter import (pe_mask_device_exact,
                                           pge_mask_device_exact, split3)
from gnnpe_tpu_torch.match.device_filter import pe_mask_exact, pge_mask_exact


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
