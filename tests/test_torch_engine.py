"""The port's engines (gnnpe_tpu_torch/engine.py) against gnnpe_tpu's
engines with attach_mesh(packed=True) on a 1-device CPU mesh: equal
candidates and answer counts for online and online_many, PE and PGE.
Also: the port's slice imports neither JAX nor anything of gnnpe_tpu,
and asking for CUDA where there is none raises."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnnpe_tpu.config import PEConfig, PGEConfig
from gnnpe_tpu.engine import PEEngine as RefPEEngine
from gnnpe_tpu.engine import PGEEngine as RefPGEEngine
from gnnpe_tpu.index.packed import PGEPackedIndex
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu.index import device_packed as jax_dp
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.graph.csr import CSRGraph
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.index.device_packed import (StreamedPESearch,
                                                 TablePESearch)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def graphs():
    g = powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)
    return g, [sample_query(g, 6, seed=s) for s in range(4)]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, axes=("graph",), shape=(1,))


@pytest.fixture(scope="module")
def pe_pair(graphs, mesh):
    g, _ = graphs
    cfg = PEConfig.from_cli(l=2, e=2)
    ref = RefPEEngine(cfg, g)
    ref.offline()
    ref.build_index(block_size=64)
    ref.attach_mesh(mesh, packed=True)
    port = PEEngine(cfg, g, "cpu").offline().build_index(block_size=64)
    port.attach_device("cpu")
    assert np.array_equal(port.paths, ref.paths)
    return ref, port


@pytest.fixture(scope="module")
def pge_pair(graphs, mesh):
    g, _ = graphs
    cfg = PGEConfig.from_cli(l=2, e=2)
    ref = RefPGEEngine(cfg, g)
    ref.offline()
    ref.index = PGEPackedIndex.build(ref.vertices.labels,
                                     ref.vertices.degrees, ref.group,
                                     ref.label_group, block_size=16)
    ref.attach_mesh(mesh, packed=True)
    port = PGEEngine(cfg, g, "cpu").offline().build_index(block_size=16)
    port.attach_device("cpu")
    return ref, port


def _assert_same_result(got, want):
    assert got.answer_count == want.answer_count
    assert len(got.candidates) == len(want.candidates)
    for a, b in zip(got.candidates, want.candidates):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("variant", ["pe", "pge"])
@pytest.mark.parametrize("ref_union", ["host", "device"])
def test_online_parity(graphs, pe_pair, pge_pair, variant, ref_union):
    ref, port = pe_pair if variant == "pe" else pge_pair
    for qg in graphs[1]:
        got = port.online(qg)
        _assert_same_result(got, ref.online(qg, engine="native",
                                            union=ref_union))
        assert set(got.timings_ms) == {"query_plan", "search", "refine",
                                       "refine.order", "refine.prepare",
                                       "refine.explore"}
    assert port.searcher.last_stats["survived"] > 0


@pytest.mark.parametrize("variant", ["pe", "pge"])
@pytest.mark.parametrize("ref_union", ["host", "device"])
def test_online_many_parity(graphs, pe_pair, pge_pair, variant, ref_union):
    ref, port = pe_pair if variant == "pe" else pge_pair
    queries = graphs[1]
    got = port.online_many(queries)
    want = ref.online_many(queries, engine="native", union=ref_union)
    assert len(got) == len(want) == len(queries)
    for a, b in zip(got, want):
        _assert_same_result(a, b)
    assert sum(r.answer_count for r in got) > 0


@pytest.mark.parametrize("variant", ["pe", "pge"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_return_embeddings_parity(graphs, pe_pair, pge_pair, variant, engine):
    """``online(return_embeddings=True)`` fills ``MatchResult.embeddings``
    with gnnpe_tpu's matches, row for row; without it the field is None."""
    _, queries = graphs
    ref, port = pe_pair if variant == "pe" else pge_pair
    for q in queries[:2]:
        want = ref.online(q, engine=engine, return_embeddings=True)
        got = port.online(q, engine=engine, return_embeddings=True)
        _assert_same_result(got, want)
        assert got.embeddings.shape == (got.answer_count, q.num_vertices)
        assert np.array_equal(np.asarray(got.embeddings, np.int64),
                              np.asarray(want.embeddings, np.int64))
        assert port.online(q, engine=engine).embeddings is None


def test_membership_and_flat_table_are_kept(graphs):
    """``membership=`` reaches PE's ``partition_rows`` as in gnnpe_tpu,
    ``build_index(packed=False)`` keeps ``data_pde`` and no packed index,
    and ``DevicePackedPGESearch.close`` frees the index."""
    from gnnpe_tpu.graph.partition import partition_graph
    g, queries = graphs
    membership = partition_graph(g, 3)
    cfg = PEConfig.from_cli(l=2, e=2)
    ref = RefPEEngine(cfg, g, membership=membership).offline().build_index(
        packed=False)
    port = PEEngine(cfg, g, "cpu", membership=membership).offline()
    port.build_index(packed=False)
    assert port.index is None and ref.index is None
    for a, b in zip(ref.partition_rows, port.partition_rows):
        assert np.array_equal(a, b)
    for name in ("vids", "labels", "degrees", "pde", "pde_label"):
        assert np.array_equal(getattr(ref.data_pde, name),
                              getattr(port.data_pde, name))
    with pytest.raises(RuntimeError, match="attach_device"):
        port.online(queries[0])
    pge = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, "cpu").offline()
    pge.build_index(block_size=16).attach_device("cpu")
    assert pge.online(queries[0]).answer_count > 0
    pge.searcher.close()
    assert pge.searcher.d_labels is None
    with pytest.raises(RuntimeError, match="closed"):
        pge.online(queries[0])


def test_pge_pathless_query_raises(pge_pair):
    _, port = pge_pair
    lonely = CSRGraph.from_edges(1, np.zeros((0, 2), np.int64),
                                 np.zeros(1, np.int64))
    with pytest.raises(ValueError):
        port.online(lonely)


def test_online_needs_attached_device(graphs):
    g, queries = graphs
    eng = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, "cpu").offline()
    with pytest.raises(RuntimeError):
        eng.attach_device("cpu")          # no index yet
    with pytest.raises(RuntimeError):
        eng.online(queries[0])


def test_attach_device_must_be_the_engines_device(pe_pair):
    _, port = pe_pair
    searcher = port.searcher
    with pytest.raises(ValueError):
        port.attach_device("meta")
    assert port.searcher is searcher and port.device == torch.device("cpu")


def test_attach_device_cuda_raises_without_cuda(pe_pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port = pe_pair
    with pytest.raises(RuntimeError):
        port.attach_device("cuda")
    with pytest.raises(RuntimeError):
        PEEngine(PEConfig.from_cli(l=2, e=2), port.graph, "cuda")


@pytest.mark.parametrize("spill", [False, True], ids=["ram", "disk"])
def test_build_index_streamed(graphs, mesh, tmp_path, spill):
    """``build_index(table=True, resident=False)``: the bucketed build
    through the engine, against gnnpe_tpu's streamed index and the
    port's resident one."""
    g, queries = graphs
    cfg = PEConfig.from_cli(l=2, e=2)
    port = PEEngine(cfg, g, "cpu").offline()
    paths = port.paths
    port.build_index(block_size=64, table=True, resident=False,
                     spill_dir=str(tmp_path / "spill") if spill else None,
                     cache_bytes=300 * 64 * 12)
    idx = port.searcher
    assert type(idx) is StreamedPESearch and port.index is None
    assert isinstance(idx._host_vids, np.memmap) == spill
    assert port.build_timings["mode"] == "streamed"
    assert port.build_timings["label_runs_s"] >= 0
    assert port.paths is paths                  # enumeration order, kept
    table = PEEngine(cfg, g, "cpu").offline(device=True).build_index(
        block_size=64, table=True, resident=True)
    assert type(table.searcher) is TablePESearch
    assert set(table.build_timings) == {"label_runs_s"}
    assert np.array_equal(idx._host_vids, table.searcher._host_vids)
    ref = RefPEEngine(cfg, g)
    ref.offline()
    ref.build_index(packed=False)
    ref.sharded = jax_dp.DevicePackedPESearch.build_from_paths(
        mesh, ref.paths, ref.vertices, block_size=64, resident=False)
    for ref_union in ("host", "device"):
        for qg in queries:
            got = port.online(qg)
            _assert_same_result(got, ref.online(qg, engine="native",
                                                union=ref_union))
            _assert_same_result(got, table.online(qg))
        many = port.online_many(queries)
        for a, b in zip(many, ref.online_many(queries, engine="native",
                                              union=ref_union)):
            _assert_same_result(a, b)
    assert idx._cache.misses > 0 and idx._cache.hits > 0
    port.attach_device("cpu")                   # already attached: no-op
    assert port.searcher is idx
    idx.close()
    if spill:
        assert list((tmp_path / "spill").iterdir()) == []


def test_build_index_resident_switch(graphs, monkeypatch):
    """``resident=None`` asks ``auto_resident``; ``True`` keeps the
    ``MemoryError`` where the table does not fit."""
    g, queries = graphs
    cfg = PEConfig.from_cli(l=2, e=2)
    eng = PEEngine(cfg, g, "cpu").offline()
    p = len(eng.paths)
    table_bytes = -(-p // 64) * 64 * 3 * 4
    build = device_packed.table_build_bytes(p, 3, 64, False,
                                            g.num_vertices, 2)
    assert build > table_bytes / device_packed.RESIDENT_SHARE
    monkeypatch.setattr(device_packed, "free_bytes", lambda d: build)
    eng.build_index(block_size=64, table=True)
    assert type(eng.searcher) is TablePESearch
    want = eng.online(queries[0])
    # Room for the table at its share, none for the build: streamed.
    assert device_packed.auto_resident(p, 3, 64, "cpu", build - 1)
    for free in (build - 1, table_bytes):
        monkeypatch.setattr(device_packed, "free_bytes", lambda d: free)
        eng.build_index(block_size=64, table=True)
        assert type(eng.searcher) is StreamedPESearch
        _assert_same_result(eng.online(queries[0]), want)
    monkeypatch.setattr(device_packed, "free_bytes", lambda d: 1000)
    with pytest.raises(MemoryError, match="resident=False"):
        eng.build_index(block_size=64, table=True, resident=True)
    # No path at all: the streamed index builds in one piece.
    lonely = CSRGraph.from_edges(3, np.zeros((0, 2), np.int64),
                                 np.zeros(3, np.int64))
    empty = PEEngine(cfg, lonely, "cpu").offline().build_index(
        table=True, resident=False)
    assert type(empty.searcher) is StreamedPESearch
    assert empty.searcher.num_blocks == 0


_SLICE = """
import sys
import numpy as np
import torch
from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.frontends import cli
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.match.filter import pe_candidates_chunked
from gnnpe_tpu_torch.frontends import train_payoff
from gnnpe_tpu_torch.models import embedder, gnn, train
from gnnpe_tpu_torch.ops import ell
g = powerlaw_graph(300, 900, 6, seed=1, max_degree=30)
q = sample_query(g, 4, seed=0)
for cls, cfg in ((PEEngine, PEConfig.from_cli(l=2, e=2)),
                 (PGEEngine, PGEConfig.from_cli(l=2, e=2))):
    eng = cls(cfg, g, "cpu").offline().build_index(block_size=16)
    eng.attach_device("cpu")
    assert eng.online(q).answer_count > 0
    eng.online_many([q, q])
# The device offline build, a table-mode search, save and load.
from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
from gnnpe_tpu_torch.index.device_packed import TablePESearch
from gnnpe_tpu_torch.paths import pipeline
pe = PEEngine(PEConfig.from_cli(l=2, e=2), g, "cpu").offline(device=True)
pe.build_index(block_size=16, table=True)
want = pe.online(q)
assert want.answer_count > 0 and isinstance(pe.searcher, TablePESearch)
pe.searcher.save(sys.argv[1])
pe.searcher = TablePESearch.load(sys.argv[1], pe.vertices, "cpu")
assert pe.online(q).answer_count == want.answer_count
order = degree_sorted_nodes(g)
paths, idx, _ = pipeline.offline_build_pipelined(g, order, 3, pe.vertices,
                                                 "cpu", block_size=16)
assert torch.equal(paths, pe.paths) and torch.equal(idx.d_vids,
                                                     pe.searcher.d_vids)
pipeline.offline_pipelined(g, order, 3, np.ones((g.labels_count, 2)), "cpu")
pge = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, "cpu").offline(device=True)
assert pge.build_index(block_size=16).attach_device("cpu").online(q).answer_count
# A streamed (bucketed) build with a disk spill, a search through the
# block cache, save and load, the flat filter and the pre-verify.
import os
from gnnpe_tpu_torch.index import bucket_build, device_packed
from gnnpe_tpu_torch.index.device_packed import StreamedPESearch
from gnnpe_tpu_torch.match.device_filter import pe_candidates_device
from gnnpe_tpu_torch.match.preverify import semijoin_prune
spill = sys.argv[1] + ".spill"
pe.build_index(block_size=16, table=True, resident=False, spill_dir=spill,
               cache_bytes=50 * 16 * 12)
assert isinstance(pe.searcher, StreamedPESearch)
got = pe.online(q)
assert got.answer_count == want.answer_count
assert pe.searcher.last_stats["cache_misses"] > 0
pe.searcher.prefill_cache()
pe.searcher.save(sys.argv[1])
again = device_packed.load(sys.argv[1], pe.vertices, "cpu", cache=False)
assert isinstance(again, StreamedPESearch)
pe.searcher.close()
assert os.listdir(spill) == []
pe.searcher = again
assert pe.online(q).answer_count == want.answer_count
_, streamed, _ = pipeline.offline_build_pipelined(
    g, order, 3, pe.vertices, "cpu", block_size=16, resident=False)
assert np.array_equal(streamed._host_vids, again._host_vids)
pruned = semijoin_prune(g, q, got.candidates, "cpu", iters=2)
assert sum(map(len, pruned)) <= sum(map(len, got.candidates))
assert pe.online(q, preverify=2).timings_ms["preverify"] >= 0
assert pge.online(q, preverify=2).answer_count == pge.online(q).answer_count
from gnnpe_tpu_torch.embed.pde import gen_pde, gen_query_pde_table
from gnnpe_tpu_torch.match.plan import greedy_path_cover
from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
qp, _ = enumerate_paths(q, np.arange(q.num_vertices), 3, dedup=True)
q_pde, weight, _ = gen_query_pde_table(pe._vde(q), qp)
flat = pe_candidates_device(gen_pde(pe.vertices, pe.paths.cpu().numpy()),
                            q_pde, greedy_path_cover(qp, weight,
                                                     q.num_vertices),
                            q.num_vertices, "cpu")
assert all(np.array_equal(a, b) for a, b in zip(flat, got.candidates))
model = gnn.PathGNN(dim=2, labels_count=g.labels_count, device="cpu")
paths = np.random.RandomState(0).randint(0, g.num_vertices, (64, 3))
st = train.fit(model, g, paths, num_steps=3, batch_size=32,
               aggregation="binned", negatives=True, device="cpu")
assert st.step == 3 and embedder.model_embedder(model, "cpu")(q).vde.shape
# The readout's plan: a gather whose backward walks the transposed index.
from gnnpe_tpu_torch.ops.gather import GatherRows
plan = GatherRows.build(paths, g.num_vertices, "cpu")
x = torch.rand(g.num_vertices, 2, requires_grad=True)
plan(x).sum().backward()
assert torch.equal(x.grad[:, 0], torch.bincount(torch.from_numpy(
    paths.reshape(-1)), minlength=g.num_vertices).float())
# The multi-device layer on two gloo ranks (each rank checks itself too).
from gnnpe_tpu_torch.parallel.dryrun import dryrun_multichip
dryrun_multichip(2, "cpu", "cpu")
# The ladder, the uniform ELL and attention, intersect, the probe and a
# trace.
from gnnpe_tpu_torch.frontends.ladder import run_rung
from gnnpe_tpu_torch.ops import intersect, sddmm
from gnnpe_tpu_torch.utils import device_probe, profiling
rows = run_rung("yeast", queries=2, device="cpu")
assert [r["spot_verified"] for r in rows] == [True, True]
lay = ell.build_ell(g.offsets, g.neighbors)
x = torch.rand(g.num_vertices, 4)
out = sddmm.attention_aggregate(lay, g.neighbors, sddmm.arc_endpoints(
    g.offsets), x, x, x)
assert torch.isfinite(out).all() and lay.apply(x).shape == x.shape
bits = intersect.bitset_from_ids(np.arange(0, 90, 3), 100)
assert int(intersect.bitset_count(bits)) == 30
assert device_probe.device_constants("cpu") == ell.HUB_PRICES
with profiling.trace(sys.argv[1] + ".trace", "cpu") as prof:
    pge.online(q)
assert os.path.exists(prof.trace_path)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "gnnpe_tpu"))
assert not foreign, foreign
print("no-jax-ok")
"""


def test_port_slice_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _SLICE,
                          str(tmp_path / "index.npz")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "no-jax-ok" in res.stdout
