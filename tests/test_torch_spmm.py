"""The port's neighbour-sum SpMM (gnnpe_tpu_torch/ops/spmm.py) against
the host f64 reference and the Pallas kernel it replaces.

This file imports no JAX at module level, so its CUDA test also runs on
a machine without JAX:
    python -m pytest --noconftest -q -m cuda tests/test_torch_spmm.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu.io.datasets import powerlaw_graph
from gnnpe_tpu.ops.spmm import neighbor_sum_np
from gnnpe_tpu_torch.ops import spmm


@pytest.fixture(scope="module")
def rand_graph():
    """tests/test_ops.py's graph (a degree-199 hub plus random edges)
    with ten isolated vertices appended (ids 300-309)."""
    rng = np.random.RandomState(0)
    edges = ([[0, i] for i in range(1, 200)] +
             rng.randint(1, 300, (800, 2)).tolist())
    edges = np.array([e for e in edges if e[0] != e[1]])
    return CSRGraph.from_edges(310, edges, np.zeros(310, dtype=np.int64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _csr(g, device="cpu"):
    return (torch.from_numpy(g.offsets).to(device),
            torch.from_numpy(g.neighbors).to(device))


def test_fixture_has_hub_and_isolated_vertices(rand_graph):
    assert rand_graph.degrees.max() == 199
    assert (rand_graph.degrees == 0).sum() == 10


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_plain_f64_bit_equal_to_host(rand_graph, scale):
    x = np.random.RandomState(1).rand(rand_graph.num_vertices, 3) * scale
    before = spmm.LAUNCHES
    nx, vde = spmm.neighbor_sum(*_csr(rand_graph), torch.from_numpy(x),
                                with_vde=True)
    want = neighbor_sum_np(rand_graph.offsets, rand_graph.neighbors, x)
    assert np.array_equal(nx.numpy(), want)
    assert np.array_equal(vde.numpy(), x + want)
    assert spmm.LAUNCHES == before        # CPU runs the plain version


def test_plain_f32_matches_pallas_interpret(rand_graph):
    """Same inputs as test_ops.py::test_pallas_spmm_interpret, through
    the retired Pallas kernel in interpret mode; rtol=atol=1e-4 because
    the Pallas kernel sums in another order."""
    import jax.numpy as jnp
    spec = importlib.util.spec_from_file_location(
        "pallas_spmm", pathlib.Path(__file__).resolve().parents[1]
        / "experiments" / "pallas_spmm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    x = np.random.RandomState(2).rand(rand_graph.num_vertices,
                                      128).astype(np.float32)
    want = np.asarray(mod.spmm_pallas(rand_graph.offsets,
                                      rand_graph.neighbors,
                                      jnp.asarray(x), interpret=True))
    got = spmm.neighbor_sum(*_csr(rand_graph), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _bad_inputs(g):
    off, nbr = _csr(g)
    x = torch.rand(g.num_vertices, 4, dtype=torch.float64)
    return {
        "x_int64": (off, nbr, x.long(), TypeError),
        "x_float16": (off, nbr, x.half(), TypeError),
        "offsets_int64": (off.long(), nbr, x, TypeError),
        "x_not_contiguous": (off, nbr, x.t().contiguous().t(), ValueError),
        "neighbors_not_contiguous": (off, torch.stack([nbr, nbr], 1)[:, 0],
                                     x, ValueError),
        "rows_mismatch": (off, nbr, x[:-1], ValueError),
        "meta_device": (off.to("meta"), nbr.to("meta"), x.to("meta"),
                        ValueError),
    }


@pytest.mark.parametrize("case", ["x_int64", "x_float16", "offsets_int64",
                                  "x_not_contiguous",
                                  "neighbors_not_contiguous",
                                  "rows_mismatch", "meta_device"])
def test_wrapper_rejects(rand_graph, case):
    off, nbr, x, err = _bad_inputs(rand_graph)[case]
    with pytest.raises(err):
        spmm.neighbor_sum(off, nbr, x)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    """f64 at the VDE width (D=2) bit-equal; f32 at D=128 equal too —
    both versions add in the same order."""
    g = powerlaw_graph(20000, 80000, 12, seed=0, max_degree=300)
    off, nbr = _csr(g, cuda_device)
    rng = np.random.RandomState(3)
    for dtype, d in ((np.float64, 2), (np.float32, 128)):
        x = torch.from_numpy(rng.rand(g.num_vertices, d).astype(dtype)
                             ).to(cuda_device)
        before = spmm.LAUNCHES
        nx, vde = spmm.neighbor_sum(off, nbr, x, with_vde=True)
        torch.cuda.synchronize()
        assert spmm.LAUNCHES == before + 1
        plain = spmm.neighbor_sum_plain(off, nbr, x)
        assert torch.equal(nx, plain)
        assert torch.equal(vde, x + plain)
    x64 = x.double().cpu().numpy()
    assert np.array_equal(
        spmm.neighbor_sum(off, nbr, x.double()).cpu().numpy(),
        neighbor_sum_np(g.offsets, g.neighbors, x64))
