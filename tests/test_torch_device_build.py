"""The port's device offline build against gnnpe_tpu on the CPU: device
path enumeration (paths/device_enumerate.py), the composite sort key on
the device, the table-mode ``build_from_paths`` with its permute-fold
and search, the pipelined builds (paths/pipeline.py),
``path_groups_device``, the engines' ``offline(device=True)`` and
``build_index(table=True)``, and the PE payoff.  gnnpe_tpu runs on a
1-device CPU mesh.  Every comparison is exact except
``offline_pipelined``'s f32 PDE, held at rtol 1e-6 (f32 neighbour sums
may add in another order)."""

import numpy as np
import pytest
import torch

from gnnpe_tpu.config import PEConfig, PGEConfig
from gnnpe_tpu.embed import pde as jpde
from gnnpe_tpu.embed.vde import gen_vde
from gnnpe_tpu.engine import PEEngine as RefPEEngine
from gnnpe_tpu.graph.partition import degree_sorted_nodes
from gnnpe_tpu.index import device_packed as jax_dp
from gnnpe_tpu.index.packed import PackedDominanceIndex
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.match.filter import pe_candidates
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.ops.mt19937 import label_feature_table
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu.paths import device_enumerate as jax_enum
from gnnpe_tpu.paths import pipeline as jax_pipeline
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu_torch.embed.pde import path_groups_device
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.frontends import train_payoff
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.index.device_packed import (DevicePackedPESearch,
                                                 PEQuery, TablePESearch,
                                                 composite_sort_key_device)
from gnnpe_tpu_torch.paths import device_enumerate, pipeline
from gnnpe_tpu_torch.paths.enumerate import (dedup_orientations_streaming,
                                             enumerate_paths_from,
                                             start_ranks)

# A hop cap small enough to split the test graph's starts into many
# chunks and large enough for its hub (max degree 60: < 3,600 slots).
SMALL_CAP = 5000


@pytest.fixture(scope="module")
def graph():
    g = powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)
    return g, degree_sorted_nodes(g), [sample_query(g, 6, seed=s)
                                       for s in range(4)]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, axes=("graph",), shape=(1,))


@pytest.fixture(scope="module")
def pe_paths(graph):
    g, order, _ = graph
    paths, _ = enumerate_paths(g, order, 3, dedup=True)
    return paths


def _query_tables(queries, dim):
    out = []
    for qg in queries:
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices), 3,
                                dedup=True)
        q_pde, weight, _ = jpde.gen_query_pde_table(gen_vde(qg, dim), qp)
        out.append((q_pde, greedy_path_cover(qp, weight, qg.num_vertices),
                    qg.num_vertices))
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# -- device enumeration (B8) -------------------------------------------
@pytest.mark.parametrize("cap", [None, 500])
@pytest.mark.parametrize("num_vertices", [1, 2, 3])
def test_enumerate_paths_device_rows_and_order(graph, num_vertices, cap,
                                               monkeypatch):
    g, order, _ = graph
    starts = order[:800]
    runs = []
    run = device_enumerate.PathEnumerator._run
    monkeypatch.setattr(device_enumerate.PathEnumerator, "_run",
                        lambda self, *a: runs.append(1) or run(self, *a))
    got = device_enumerate.enumerate_paths_device(
        g, starts, num_vertices, "cpu", cap=cap)
    assert got.dtype == torch.int32
    got = got.numpy()
    assert np.array_equal(got, enumerate_paths_from(g, starts, num_vertices))
    assert np.array_equal(got, jax_enum.enumerate_paths_device(
        g, starts, num_vertices, cap=1 << 15))
    # The tiny cap splits the starts into many chunks.
    assert (len(runs) > 1) == (cap is not None)
    rank = start_ranks(order, g.num_vertices)
    keep = device_enumerate.dedup_mask(torch.from_numpy(got),
                                       torch.from_numpy(rank))
    assert np.array_equal(keep.numpy(),
                          dedup_orientations_streaming(got, rank))


@pytest.mark.parametrize("num_vertices", [2, 3])
def test_enumerate_dedup_device_chunked(graph, num_vertices, monkeypatch):
    """Chunks deduplicated as they come give the host's deduplicated
    rows, whatever the chunking."""
    g, order, _ = graph
    want, _ = enumerate_paths(g, order, num_vertices, dedup=True)
    chunks = []
    gen = device_enumerate.PathEnumerator.chunks

    def counted(self, *a):
        for rows in gen(self, *a):
            chunks.append(len(rows))
            yield rows

    monkeypatch.setattr(device_enumerate.PathEnumerator, "chunks", counted)
    monkeypatch.setattr(device_enumerate, "default_cap",
                        lambda *a: SMALL_CAP)
    got = device_enumerate.enumerate_dedup_device(g, order, num_vertices,
                                                  "cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert len(chunks) > 1 and max(chunks) <= SMALL_CAP


def test_enumerate_overflow_at_one_start_raises(graph):
    g, order, _ = graph
    hub = order[-1:]                       # the highest-degree start
    with pytest.raises(ValueError, match="too small for start"):
        device_enumerate.enumerate_paths_device(g, hub, 3, "cpu", cap=100)


# -- sort key ----------------------------------------------------------
@pytest.mark.parametrize("dim", [2, 4])
def test_device_key_equals_composite_sort_key(graph, pe_paths, dim):
    vertices = gen_vde(graph[0], dim)
    got = composite_sort_key_device(torch.from_numpy(pe_paths), vertices)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(),
                          jax_dp.composite_sort_key(pe_paths, vertices))


# -- table-mode build (B4) and search ----------------------------------
@pytest.fixture(scope="module")
def table_pair(graph, pe_paths, mesh):
    vertices = gen_vde(graph[0], 2)
    out = {}
    for b in (64, 512):
        out[b] = (jax_dp.DevicePackedPESearch.build_from_paths(
            mesh, pe_paths, vertices, block_size=b),
            TablePESearch.build_from_paths(pe_paths, vertices, "cpu",
                                           block_size=b))
    return vertices, out


@pytest.mark.parametrize("block", [64, 512])
def test_build_from_paths_bit_equal(table_pair, pe_paths, block):
    _, pairs = table_pair
    ref, port = pairs[block]
    p = len(pe_paths)
    nb = -(-p // block)
    assert isinstance(port, TablePESearch) and port.num_blocks == nb
    assert np.array_equal(port._host_vids[:p], ref._host_vids[:p])
    assert (port._host_vids[p:] == ref._host_vids[p:nb * block]).all()
    for mine, theirs in (("b_ub", ref.b_ub3[0]), ("b_llo", ref.b_llo3[0]),
                         ("b_lhi", ref.b_lhi3[0]), ("b_deg", ref.b_deg)):
        got, want = getattr(port, mine).numpy(), np.asarray(theirs)[:nb]
        assert got.dtype == want.dtype and np.array_equal(got, want), mine
    assert np.array_equal(port._blk_sig_first, ref._blk_sig_first[:nb])
    assert np.array_equal(port._blk_sig_last, ref._blk_sig_last[:nb])
    assert set(port.build_phase_ms) >= {"key", "sort", "permute_fold",
                                        "d2h"}


@pytest.mark.parametrize("ref_union", ["host", "device"])
def test_table_search_parity(graph, table_pair, pe_paths, ref_union):
    g, _, queries = graph
    vertices, pairs = table_pair
    ref, port = pairs[64]
    data_pde = jpde.gen_pde(vertices, pe_paths)
    array = DevicePackedPESearch(
        PackedDominanceIndex.build(data_pde, block_size=64), "cpu")
    pruned = []
    for q_pde, plan, nq in _query_tables(queries, 2):
        got = port.search(PEQuery(q_pde, plan, nq))
        _assert_same(got, ref.search(q_pde, plan, nq, union=ref_union))
        assert {k: port.last_stats[k] for k in ("phase1", "survived")} == \
            {k: ref.last_stats[k] for k in ("phase1", "survived")}
        pruned.append(port.last_stats["phase1"] - port.last_stats["survived"])
        _assert_same(got, array.search(PEQuery(q_pde, plan, nq)))
        _assert_same(got, pe_candidates(data_pde, q_pde, plan, nq))
        assert sum(map(len, got)) > 0
    # The signature-range prune removes blocks that phase 1 kept.
    assert min(pruned) >= 0 and max(pruned) > 0


def test_build_raises_when_it_does_not_fit(pe_paths, table_pair,
                                           monkeypatch):
    vertices, _ = table_pair
    monkeypatch.setattr(device_packed, "free_bytes", lambda device: 1000)
    with pytest.raises(MemoryError, match="resident=False"):
        TablePESearch.build_from_paths(pe_paths, vertices, "cpu")


# -- pipelined builds --------------------------------------------------
@pytest.mark.parametrize("l", [1, 2])
def test_offline_build_pipelined(graph, mesh, l, monkeypatch):
    g, order, _ = graph
    cfg = PEConfig.from_cli(l=l, e=2)
    vertices = gen_vde(g, 2)
    seq, _ = enumerate_paths(g, order, cfg.path_length, dedup=True)
    seq_idx = TablePESearch.build_from_paths(seq, vertices, "cpu",
                                             block_size=64)
    monkeypatch.setattr(device_enumerate, "default_cap",
                        lambda *a: SMALL_CAP)
    paths, idx, timings = pipeline.offline_build_pipelined(
        g, order, cfg.path_length, vertices, "cpu", block_size=64)
    ref_paths, ref, _ = jax_pipeline.offline_build_pipelined(
        g, order, cfg.path_length, vertices, mesh, block_size=64,
        chunk_starts=777)
    p, nb = len(seq), idx.num_blocks
    assert np.array_equal(paths.numpy(), seq)
    assert np.array_equal(ref_paths, seq)
    assert np.array_equal(idx._host_vids, seq_idx._host_vids)
    assert np.array_equal(idx._host_vids[:p], ref._host_vids[:p])
    for name in ("b_ub", "b_llo", "b_lhi", "b_deg"):
        assert torch.equal(getattr(idx, name), getattr(seq_idx, name))
    assert np.array_equal(idx.b_deg.numpy(), np.asarray(ref.b_deg)[:nb])
    assert timings["total_s"] > 0 and timings["enumerate_s"] >= 0


def test_offline_pipelined_pde(graph):
    g, order, _ = graph
    table = label_feature_table(g.labels_count, 2).astype(np.float32)
    paths, pde = pipeline.offline_pipelined(g, order[:700], 3, table, "cpu")
    want_paths, want_pde = jax_pipeline.offline_pipelined(
        g, order[:700], 3, table, chunk_starts=128)
    assert np.array_equal(paths.numpy(), want_paths)
    assert pde.dtype == torch.float32
    np.testing.assert_allclose(pde.numpy(), want_pde, rtol=1e-6, atol=0)


# -- PGE path groups (B7's fold) ---------------------------------------
@pytest.mark.parametrize("num_vertices,dim", [(2, 2), (3, 2), (3, 4)])
def test_path_groups_device_bit_equal(graph, num_vertices, dim,
                                      monkeypatch):
    g, order, _ = graph
    monkeypatch.setattr(device_enumerate, "default_cap",
                        lambda *a: SMALL_CAP)
    vertices = gen_vde(g, dim)
    width = num_vertices * dim
    paths, _ = enumerate_paths(g, order, num_vertices, dedup=False)
    host = jpde.path_groups(vertices, paths[:, 0], paths, width)
    ref = jpde.path_groups_device(vertices, g, order, num_vertices, width,
                                  chunk_starts=300)
    got = path_groups_device(vertices, g, order, num_vertices, width, "cpu")
    for a, b, c in zip(got, host, ref):
        assert a.dtype == np.float64
        assert np.array_equal(a, b) and np.array_equal(a, c)


# -- engines -----------------------------------------------------------
def test_pe_engine_device_offline_and_table_build(graph, mesh):
    g, _, queries = graph
    cfg = PEConfig.from_cli(l=2, e=2)
    host = PEEngine(cfg, g, "cpu").offline()
    port = PEEngine(cfg, g, "cpu").offline(device=True)
    assert port.paths.dtype == torch.int32
    assert np.array_equal(port.paths.numpy(), host.paths)
    port.build_index(block_size=64, table=True).attach_device("cpu")
    assert isinstance(port.searcher, TablePESearch) and port.index is None
    ref = RefPEEngine(cfg, g)
    ref.offline(device=True)
    ref.build_index(block_size=64)
    ref.attach_mesh(mesh, packed=True)
    for qg in queries:
        got, want = port.online(qg), ref.online(qg)
        assert got.answer_count == want.answer_count
        _assert_same(got.candidates, want.candidates)
    many = port.online_many(queries)
    for ref_union in ("host", "device"):
        assert [r.answer_count for r in many] == [
            r.answer_count for r in ref.online_many(queries, union=ref_union)]
    # The array-mode build takes the device-enumerated paths too, and
    # serves nothing until it is uploaded.
    port.build_index(block_size=64)
    assert port.searcher is None
    port.attach_device("cpu")
    assert type(port.searcher) is DevicePackedPESearch
    _assert_same(port.online(queries[0]).candidates,
                 ref.online(queries[0]).candidates)


def test_pge_engine_device_offline(graph, monkeypatch):
    g, _, queries = graph
    cfg = PGEConfig.from_cli(l=2, e=2)
    host = PGEEngine(cfg, g, "cpu").offline()
    monkeypatch.setattr(device_enumerate, "default_cap",
                        lambda *a: SMALL_CAP)
    port = PGEEngine(cfg, g, "cpu").offline(device=True)
    assert np.array_equal(port.group, host.group)
    assert np.array_equal(port.label_group, host.label_group)
    host.build_index(block_size=16).attach_device("cpu")
    port.build_index(block_size=16).attach_device("cpu")
    for qg in queries:
        got, want = port.online(qg), host.online(qg)
        assert got.answer_count == want.answer_count
        _assert_same(got.candidates, want.candidates)


def test_pe_payoff_answers_equal():
    """The PE payoff on the device-built table-mode index: ``run``
    asserts that trained and fixed answers are equal per query."""
    pay = train_payoff.run("yeast", queries=2, query_size=5, steps=3,
                           variant="pe", device="cpu")
    fixed, trained = pay.rows
    assert fixed["variant"] == trained["variant"] == "pe"
    assert [r.answer_count for r in pay.fixed] == \
        [r.answer_count for r in pay.trained]
    assert isinstance(pay.engine.searcher, TablePESearch)
    with pytest.raises(ValueError):
        train_payoff.run("yeast", variant="flat", device="cpu")
