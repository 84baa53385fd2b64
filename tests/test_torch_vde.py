"""The port's VDE (gnnpe_tpu_torch/embed/vde.py) against gnnpe_tpu's
host f64 gen_vde (bit-equal) and its f32 JAX device VDE."""

import jax.numpy as jnp
import numpy as np
import pytest

from gnnpe_tpu.embed.vde import gen_vde as host_gen_vde
from gnnpe_tpu.embed.vde import gen_vde_device
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.ops.mt19937 import label_feature_table
from gnnpe_tpu_torch.embed.vde import gen_vde


@pytest.fixture(scope="module")
def graph():
    return powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)


@pytest.mark.parametrize("vde_dim", [2, 4])
def test_gen_vde_bit_equal_to_host(graph, vde_dim):
    got = gen_vde(graph, vde_dim, "cpu")
    want = host_gen_vde(graph, vde_dim)
    for name in ("labels", "degrees", "x", "nx", "vde"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_query_graph_vde_bit_equal_to_host(graph):
    q = sample_query(graph, 6, seed=0)
    assert np.array_equal(gen_vde(q, 2, "cpu").vde, host_gen_vde(q, 2).vde)


def test_gen_vde_close_to_jax_device_f32(graph):
    """rtol=1e-5: the JAX device VDE sums ≤60 neighbours in f32."""
    got = gen_vde(graph, 2, "cpu")
    table = label_feature_table(graph.labels_count, 2).astype(np.float32)
    want = gen_vde_device(jnp.asarray(graph.offsets),
                          jnp.asarray(graph.neighbors),
                          jnp.asarray(graph.labels), jnp.asarray(table))
    for a, b in zip((got.x, got.nx, got.vde), want):
        np.testing.assert_allclose(a, np.asarray(b, np.float64),
                                   rtol=1e-5, atol=0)
