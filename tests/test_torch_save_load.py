"""``save``/``load`` of the port's table-mode and streamed PE indexes in
gnnpe_tpu's npz format, both ways: gnnpe_tpu saves (its padded layouts,
on a 1-device CPU mesh) and the port loads, the port saves and gnnpe_tpu
loads.  Candidates must be equal, with the raw ``.vids.bin`` sidecar and
without; ``load`` returns the class the file names (``meta[4]``); a
resident index that does not fit raises."""

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
                                                 PEQuery, StreamedPESearch,
                                                 TablePESearch)


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
        got = idx.search(PEQuery(q, plan, n))
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


def _jax_streamed(case, tmp_path, sidecar):
    """gnnpe_tpu's streamed index of the fixture's paths, over an
    ``np.memmap`` table (which it saves to the sidecar) or in memory."""
    vertices, _, mesh, _, port, _ = case
    streamed = jax_dp.DevicePackedPESearch.build_from_paths(
        mesh, port._host_vids[:port.num_entries], vertices, block_size=64,
        resident=False)
    if sidecar:
        mm = np.memmap(tmp_path / "jtable.bin", dtype=np.int32, mode="w+",
                       shape=streamed._host_vids.shape)
        mm[:] = streamed._host_vids
        streamed._host_vids = mm
    return streamed


def test_streamed_file_raises(case, tmp_path):
    """A streamed file gnnpe_tpu saved loads as a ``StreamedPESearch``
    (through either class's ``load`` and the module's) and answers as
    gnnpe_tpu does; what still raises is a file whose sidecar is gone."""
    vertices, queries, _, _, _, want = case
    streamed = _jax_streamed(case, tmp_path, sidecar=False)
    fp = str(tmp_path / "streamed.npz")
    streamed.save(fp)
    for load in (TablePESearch.load, StreamedPESearch.load,
                 device_packed.load):
        got = load(fp, vertices, "cpu")
        assert type(got) is StreamedPESearch
        assert not hasattr(got, "d_vids")
        _assert_port_answers(got, queries, want)
        _assert_jax_answers(streamed, queries, want)
    big = _jax_streamed(case, tmp_path, sidecar=True)
    big.save(fp)
    (tmp_path / "streamed.npz.vids.bin").unlink()
    with pytest.raises(FileNotFoundError):
        TablePESearch.load(fp, vertices, "cpu")


@pytest.mark.parametrize("sidecar", [False, True])
def test_streamed_jax_saves_port_loads(case, tmp_path, sidecar):
    vertices, queries, _, _, port, want = case
    streamed = _jax_streamed(case, tmp_path, sidecar)
    fp = str(tmp_path / "jax_streamed.npz")
    streamed.save(fp)
    assert (tmp_path / "jax_streamed.npz.vids.bin").exists() == sidecar
    got = device_packed.load(fp, vertices, "cpu", cache_bytes=40 * 64 * 12)
    assert type(got) is StreamedPESearch
    assert isinstance(got._host_vids, np.memmap) == sidecar
    # gnnpe_tpu's 32-aligned layout is kept whole; its pad blocks never
    # survive and are never prefilled.
    assert got.num_blocks == len(np.asarray(streamed.b_deg))
    assert got.num_blocks % 32 == 0 and got.num_blocks > port.num_blocks
    assert np.array_equal(got._host_vids, streamed._host_vids)
    assert np.array_equal(got._host_vids[:len(port._host_vids)],
                          port._host_vids)
    _assert_port_answers(got, queries, want)
    assert got._cache.capacity == 40 and got._cache.evictions > 0
    uncached = device_packed.load(fp, vertices, "cpu", cache=False)
    _assert_port_answers(uncached, queries, want)
    whole = device_packed.load(fp, vertices, "cpu",
                               cache_bytes=2 * got._host_vids.nbytes)
    assert whole.prefill_cache() == port.num_blocks
    _assert_port_answers(whole, queries, want)
    assert whole._cache.misses == 0
    # Closing a loaded index leaves its files alone.
    got.close()
    assert (tmp_path / "jax_streamed.npz.vids.bin").exists() == sidecar


@pytest.mark.parametrize("sidecar", [False, True])
def test_streamed_port_saves_jax_loads(case, tmp_path, sidecar):
    """The port's streamed index, in memory or over the ``np.memmap`` a
    bucketed disk build leaves (always saved to the sidecar, in bounded
    pieces), loads in gnnpe_tpu as a streamed index and back here."""
    vertices, queries, mesh, _, port, want = case
    paths = port._host_vids[:port.num_entries]
    mine = StreamedPESearch.build_from_paths(paths, vertices, "cpu",
                                             block_size=64)
    if sidecar:
        table = str(tmp_path / "table.bin")
        mm = np.memmap(table, dtype=np.int32, mode="w+",
                       shape=mine._host_vids.shape)
        mm[:] = mine._host_vids
        mine._host_vids, mine._owned_table_path = mm, table
    fp = str(tmp_path / "port_streamed.npz")
    mine.save(fp)
    assert (tmp_path / "port_streamed.npz.vids.bin").exists() == sidecar
    with np.load(fp) as z:
        assert [int(x) for x in z["meta"]] == [
            port.num_entries, 64, port.num_blocks, port.num_blocks, 1,
            mine._sig_radix, int(sidecar), 3]
    ref = jax_dp.DevicePackedPESearch.load(mesh, fp, vertices)
    assert ref.streamed and ref.d_vids is None
    assert np.array_equal(np.asarray(ref._host_vids), port._host_vids)
    _assert_jax_answers(ref, queries, want)
    back = device_packed.load(fp, vertices, "cpu")
    assert type(back) is StreamedPESearch
    for name in ("b_ub", "b_llo", "b_lhi", "b_deg"):
        assert torch.equal(getattr(back, name), getattr(port, name))
    assert np.array_equal(back._host_vids, port._host_vids)
    _assert_port_answers(back, queries, want)
    if sidecar:
        # The saved sidecar is its own file: closing the index that owns
        # the working table unlinks that table and nothing else.
        mine.close()
        assert not (tmp_path / "table.bin").exists()
        _assert_port_answers(back, queries, want)
    # A table-mode file still loads as a table index through any entry.
    port.save(fp)
    assert type(StreamedPESearch.load(fp, vertices, "cpu")) is TablePESearch


def test_load_that_does_not_fit_raises(case, tmp_path, monkeypatch):
    vertices, queries, _, _, port, want = case
    fp = str(tmp_path / "port.npz")
    port.save(fp)
    monkeypatch.setattr(device_packed, "free_bytes", lambda device: 1000)
    with pytest.raises(MemoryError, match="StreamedPESearch"):
        TablePESearch.load(fp, vertices, "cpu")
    # The same rows saved streamed need no room for the table.
    mine = StreamedPESearch.build_from_paths(
        port._host_vids[:port.num_entries], vertices, "cpu", block_size=64,
        cache=False)
    mine.save(fp)
    _assert_port_answers(TablePESearch.load(fp, vertices, "cpu", cache=False),
                         queries, want)


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
