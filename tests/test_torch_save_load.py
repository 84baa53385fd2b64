"""``save``/``load`` of the port's table-mode PE index in gnnpe_tpu's npz
format, both ways: gnnpe_tpu saves (its power-of-two padded layout, on a
1-device CPU mesh) and the port loads, the port saves and gnnpe_tpu
loads.  Candidates must be equal, with the raw ``.vids.bin`` sidecar and
without; a streamed index and one that does not fit raise."""

import numpy as np
import pytest
import torch

from gnnpe_tpu.embed.pde import gen_query_pde_table
from gnnpe_tpu.embed.vde import gen_vde
from gnnpe_tpu.graph.partition import degree_sorted_nodes
from gnnpe_tpu.index import device_packed as jax_dp
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.index.device_packed import (DevicePackedPESearch,
                                                 PEQuery, TablePESearch)


@pytest.fixture(scope="module")
def case():
    g = powerlaw_graph(1200, 4800, 10, seed=2, max_degree=50)
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), 3, dedup=True)
    vertices = gen_vde(g, 2)
    queries = []
    for s in range(3):
        qg = sample_query(g, 6, seed=s)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices), 3,
                                dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde(qg, 2), qp)
        queries.append((q_pde, greedy_path_cover(qp, weight,
                                                 qg.num_vertices),
                        qg.num_vertices))
    mesh = make_mesh(1, axes=("graph",), shape=(1,))
    ref = jax_dp.DevicePackedPESearch.build_from_paths(mesh, paths, vertices,
                                                       block_size=64)
    port = TablePESearch.build_from_paths(paths, vertices, "cpu",
                                          block_size=64)
    want = [ref.search(q, plan, n) for q, plan, n in queries]
    return vertices, queries, mesh, ref, port, want


def _assert_port_answers(idx, queries, want):
    for (q, plan, n), w in zip(queries, want):
        for union in ("host", "device"):
            got = idx.search(PEQuery(q, plan, n), union=union)
            assert len(got) == len(w)
            for a, b in zip(got, w):
                assert np.array_equal(a, b)


def _assert_jax_answers(idx, queries, want):
    for (q, plan, n), w in zip(queries, want):
        for a, b in zip(idx.search(q, plan, n), w):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("sidecar", [False, True])
def test_jax_saves_port_loads(case, tmp_path, sidecar):
    vertices, queries, _, ref, _, want = case
    table = ref._host_vids
    if sidecar:
        # gnnpe_tpu writes the sidecar for a memmap-backed table.
        mm = np.memmap(tmp_path / "table.bin", dtype=np.int32, mode="w+",
                       shape=ref._host_vids.shape)
        mm[:] = ref._host_vids
        ref._host_vids = mm
    fp = str(tmp_path / "jax.npz")
    try:
        ref.save(fp)
    finally:
        ref._host_vids = table
    assert (tmp_path / "jax.npz.vids.bin").exists() == sidecar
    port = TablePESearch.load(fp, vertices, "cpu")
    assert isinstance(port, TablePESearch)
    # The padded layout is kept whole; its pad blocks never survive.
    assert port.num_blocks == len(np.asarray(ref.b_deg))
    assert np.array_equal(port._host_vids, table)
    _assert_port_answers(port, queries, want)


@pytest.mark.parametrize("sidecar", [False, True])
def test_port_saves_jax_loads(case, tmp_path, sidecar, monkeypatch):
    vertices, queries, mesh, _, port, want = case
    if sidecar:
        monkeypatch.setattr(device_packed, "SIDECAR_BYTES", 0)
    fp = str(tmp_path / "port.npz")
    port.save(fp)
    assert (tmp_path / "port.npz.vids.bin").exists() == sidecar
    ref = jax_dp.DevicePackedPESearch.load(mesh, fp, vertices)
    assert np.array_equal(np.asarray(ref._host_vids), port._host_vids)
    _assert_jax_answers(ref, queries, want)
    back = TablePESearch.load(fp, vertices, "cpu")
    for name in ("d_vids", "b_ub", "b_llo", "b_lhi", "b_deg"):
        assert torch.equal(getattr(back, name), getattr(port, name))
    _assert_port_answers(back, queries, want)


def test_streamed_file_raises(case, tmp_path):
    vertices, _, mesh, _, port, _ = case
    streamed = jax_dp.DevicePackedPESearch.build_from_paths(
        mesh, port._host_vids[:port.num_entries], vertices, block_size=64,
        resident=False)
    fp = str(tmp_path / "streamed.npz")
    streamed.save(fp)
    with pytest.raises(NotImplementedError, match="Queue A 9"):
        TablePESearch.load(fp, vertices, "cpu")


def test_load_that_does_not_fit_raises(case, tmp_path, monkeypatch):
    vertices, _, _, _, port, _ = case
    fp = str(tmp_path / "port.npz")
    port.save(fp)
    monkeypatch.setattr(device_packed, "free_bytes", lambda device: 1000)
    with pytest.raises(MemoryError, match="Queue A 9"):
        TablePESearch.load(fp, vertices, "cpu")


def test_array_mode_does_not_save(tmp_path):
    from gnnpe_tpu.embed.pde import gen_pde
    from gnnpe_tpu.index.packed import PackedDominanceIndex
    g = powerlaw_graph(200, 600, 5, seed=1, max_degree=20)
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), 3, dedup=True)
    index = PackedDominanceIndex.build(gen_pde(gen_vde(g, 2), paths),
                                       block_size=16)
    # Only table mode has the npz format; the array class has no save.
    with pytest.raises(AttributeError):
        DevicePackedPESearch(index, "cpu").save(str(tmp_path / "a.npz"))
