"""Sorted-set intersection and bitset forms, held to gnnpe_tpu's on
hypothesis-generated sets: the numpy forms bit for bit, the torch forms
against gnnpe_tpu's jnp forms (masks, compacted values, ``uint32``
popcounts and memberships equal)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gnnpe_tpu.ops import intersect as jax_it
from gnnpe_tpu_torch.ops import intersect as it

UNIVERSE = 2000
INT32_MAX = 2 ** 31 - 1

id_sets = st.lists(st.integers(0, UNIVERSE - 1), max_size=300).map(
    lambda xs: np.unique(np.asarray(xs, dtype=np.int64)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _padded(a, n):
    p = np.full(n, INT32_MAX, np.int32)
    p[:len(a)] = a
    return p, np.arange(n) < len(a)


@settings(max_examples=60, deadline=None)
@given(a=id_sets, b=id_sets)
def test_host_forms_equal_gnnpe_tpu(a, b):
    for fn in ("intersect_sorted_np", "intersect_auto_np"):
        got, want = getattr(it, fn)(a, b), getattr(jax_it, fn)(a, b)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(got, np.intersect1d(a, b))
    assert it.intersect_count_np(a, b) == jax_it.intersect_count_np(a, b)
    bits = it.bitset_from_ids(a, UNIVERSE)
    assert np.array_equal(bits, jax_it.bitset_from_ids(a, UNIVERSE))
    assert np.array_equal(it.bitset_to_ids(bits), jax_it.bitset_to_ids(bits))
    assert np.array_equal(it.bitset_to_ids(bits), a)


@settings(max_examples=60, deadline=None)
@given(a=id_sets, b=id_sets)
def test_device_forms_equal_gnnpe_tpu(a, b):
    import jax.numpy as jnp
    ap, av = _padded(a, 320)
    bp, bv = _padded(b, 340)
    t, j = torch.from_numpy, jnp.asarray
    mask = it.intersect_mask(t(ap), t(av), t(bp), t(bv))
    jmask = jax_it.intersect_mask(j(ap), j(av), j(bp), j(bv))
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    vals, valid = it.intersect_sorted_device(t(ap), t(av), t(bp), t(bv))
    jvals, jvalid = jax_it.intersect_sorted_device(j(ap), j(av), j(bp),
                                                   j(bv))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert np.array_equal(vals[valid].numpy(), np.intersect1d(a, b))

    ba, bb = (it.bitset_from_ids(s, UNIVERSE) for s in (a, b))
    both = it.bitset_and(ba, bb)
    assert np.array_equal(both, np.asarray(jax_it.bitset_and(j(ba), j(bb))))
    # numpy uint32, a torch int32 view of the same words, and the AND of
    # two such views all count as gnnpe_tpu's uint32 popcount.
    want = int(jax_it.bitset_count(j(both)))
    assert want == len(np.intersect1d(a, b))
    assert int(it.bitset_count(both)) == want
    views = [t(x.view(np.int32)) for x in (ba, bb)]
    assert int(it.bitset_count(it.bitset_and(*views))) == want
    ids = np.arange(0, UNIVERSE, 3).astype(np.int32)
    ok = np.random.RandomState(len(a)).rand(len(ids)) < 0.9
    got = it.array_and_bitset(t(ids), t(ok), views[1])
    jgot = jax_it.array_and_bitset(j(ids), j(ok), j(bb))
    assert np.array_equal(got.numpy(), np.asarray(jgot))


def test_popcount_high_bits_and_empty_sets():
    import jax.numpy as jnp
    words = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 1],
                     dtype=np.uint32)
    want = int(jax_it.bitset_count(jnp.asarray(words)))
    assert want == 32 + 1 + 31 + 0 + 1
    assert int(it.bitset_count(words)) == want
    assert int(it.bitset_count(torch.from_numpy(words.view(np.int32)))) \
        == want
    empty = np.zeros(0, np.int32)
    none = it.intersect_mask(torch.from_numpy(np.array([3, 4], np.int32)),
                             torch.ones(2, dtype=torch.bool),
                             torch.from_numpy(empty),
                             torch.zeros(0, dtype=torch.bool))
    assert not none.any()


@pytest.mark.cuda
def test_device_forms_on_card(cuda_device):
    rng = np.random.RandomState(0)
    a = np.unique(rng.randint(0, UNIVERSE, 400))
    b = np.unique(rng.randint(0, UNIVERSE, 700))
    ap, av = _padded(a, 512)
    bp, bv = _padded(b, 800)
    t = lambda x: torch.from_numpy(x).to(cuda_device)
    vals, valid = it.intersect_sorted_device(t(ap), t(av), t(bp), t(bv))
    assert np.array_equal(vals[valid].cpu().numpy(), np.intersect1d(a, b))
    bits = [t(it.bitset_from_ids(s, UNIVERSE).view(np.int32)) for s in (a, b)]
    assert int(it.bitset_count(it.bitset_and(*bits))) == len(
        np.intersect1d(a, b))
