"""The port's device packed search (gnnpe_tpu_torch/index/device_packed.py)
fed the same host index as gnnpe_tpu's DevicePackedPESearch /
DevicePackedPGESearch on a 1-device CPU mesh: the port's one candidate
union (the bit-packed bitmap) must give lists equal to both of the
reference's unions and to the flat f64 filters."""

import numpy as np
import pytest

from gnnpe_tpu.config import PEConfig, PGEConfig
from gnnpe_tpu.embed.pde import gen_pde, gen_query_pde_table, path_groups
from gnnpe_tpu.embed.vde import gen_vde
from gnnpe_tpu.graph.partition import degree_sorted_nodes
from gnnpe_tpu.index import device_packed as jax_dp
from gnnpe_tpu.index.packed import PackedDominanceIndex, PGEPackedIndex
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.match.filter import pe_candidates, pge_candidates
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.index.device_packed import (DevicePackedPESearch,
                                                 DevicePackedPGESearch,
                                                 PEQuery, PGEQuery)

# The small bound forces several phase-1 and phase-2 chunks.
CHUNKINGS = {"one_chunk": device_packed.CHUNK_ELEMS, "many_chunks": 1 << 12}


@pytest.fixture(scope="module")
def setup():
    g = powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)
    queries = [sample_query(g, 6, seed=s) for s in range(4)]
    return g, queries, gen_vde(g, 2), degree_sorted_nodes(g)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, axes=("graph",), shape=(1,))


@pytest.fixture(scope="module")
def pe_case(setup, mesh):
    g, queries, vertices, order = setup
    cfg = PEConfig.from_cli(l=2, e=2)
    paths, _ = enumerate_paths(g, order, cfg.path_length, dedup=True)
    data_pde = gen_pde(vertices, paths)
    index = PackedDominanceIndex.build(data_pde, block_size=64)
    qtabs = []
    for qg in queries:
        q_paths, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                     cfg.path_length, dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde(qg, 2), q_paths)
        plan = greedy_path_cover(q_paths, weight, qg.num_vertices)
        qtabs.append((q_pde, plan, qg.num_vertices))
    ref = jax_dp.DevicePackedPESearch(mesh, index,
                                      base_epsilon=cfg.epsilon)
    return cfg, data_pde, index, qtabs, ref


@pytest.fixture(scope="module")
def pge_case(setup, mesh):
    g, queries, vertices, order = setup
    cfg = PGEConfig.from_cli(l=2, e=2)
    paths, _ = enumerate_paths(g, order, cfg.path_length, dedup=False)
    group, lgroup = path_groups(vertices, paths[:, 0], paths, cfg.pde_dim)
    index = PGEPackedIndex.build(vertices.labels, vertices.degrees, group,
                                 lgroup, block_size=16)
    qtabs = []
    for qg in queries:
        qv = gen_vde(qg, 2)
        q_paths, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                     cfg.path_length, dedup=False)
        qg_group, qg_lgroup = path_groups(qv, q_paths[:, 0], q_paths,
                                          cfg.pde_dim)
        qtabs.append(PGEQuery(qv.labels, qv.degrees, qg_group, qg_lgroup))
    ref = jax_dp.DevicePackedPGESearch(mesh, index,
                                       base_epsilon=cfg.epsilon)
    return cfg, (vertices, group, lgroup), index, qtabs, ref


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == np.int64 and np.array_equal(x, y)


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("ref_union", ["host", "device"])
def test_pe_search_parity(pe_case, ref_union, chunking, monkeypatch):
    cfg, data_pde, index, qtabs, ref = pe_case
    monkeypatch.setattr(device_packed, "CHUNK_ELEMS", CHUNKINGS[chunking])
    port = DevicePackedPESearch(index, "cpu", base_epsilon=cfg.epsilon)
    assert ref.nb_local > ref.k_chunk      # the reference chunks too
    for q_pde, plan, nq in qtabs:
        got = port.search(PEQuery(q_pde, plan, nq))
        _assert_same(got, ref.search(q_pde, plan, nq, union=ref_union))
        _assert_same(got, pe_candidates(data_pde, q_pde, plan, nq,
                                        epsilon=cfg.epsilon))
        assert sum(map(len, got)) > 0
        assert (port.last_stats["chunks"] > 1) == (chunking ==
                                                   "many_chunks")


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("ref_union", ["host", "device"])
def test_pge_search_parity(pge_case, ref_union, chunking, monkeypatch):
    cfg, (vertices, group, lgroup), index, qtabs, ref = pge_case
    monkeypatch.setattr(device_packed, "CHUNK_ELEMS", CHUNKINGS[chunking])
    port = DevicePackedPGESearch(index, "cpu", base_epsilon=cfg.epsilon)
    assert ref.nb_local > ref.k_chunk
    for q in qtabs:
        ids = list(range(len(q.labels)))
        got = port.search(q)
        _assert_same(got, ref.search(q.labels, q.degrees, q.group,
                                     q.label_group, ids, union=ref_union))
        _assert_same(got, pge_candidates(
            vertices.labels, vertices.degrees, group, lgroup, q.labels,
            q.degrees, q.group, q.label_group, q_vertex_ids=ids,
            epsilon=cfg.epsilon))
        assert sum(map(len, got)) > 0


def test_resident_tensors_and_pads(pe_case):
    _, _, index, _, _ = pe_case
    port = DevicePackedPESearch(index, "cpu")
    tensors = port.resident_tensors()
    assert {"d_labels", "d_degrees", "d_vids", "d_pde", "b_ub"} <= set(
        tensors)
    p = len(index.order)
    assert port.d_labels.shape[0] == port.num_blocks * index.block_size
    assert (port.d_labels[p:] == -2).all()
    assert np.array_equal(port.d_pde[:p].numpy(), index.pde)
