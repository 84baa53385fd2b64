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
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.graph.csr import CSRGraph

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
@pytest.mark.parametrize("union", ["host", "device"])
def test_online_parity(graphs, pe_pair, pge_pair, variant, union):
    ref, port = pe_pair if variant == "pe" else pge_pair
    for qg in graphs[1]:
        got = port.online(qg, union=union)
        _assert_same_result(got, ref.online(qg, engine="native"))
        assert set(got.timings_ms) == {"query_plan", "search", "refine"}
    assert port.searcher.last_stats["survived"] > 0


@pytest.mark.parametrize("variant", ["pe", "pge"])
@pytest.mark.parametrize("union", ["host", "device"])
def test_online_many_parity(graphs, pe_pair, pge_pair, variant, union):
    ref, port = pe_pair if variant == "pe" else pge_pair
    queries = graphs[1]
    got = port.online_many(queries, union=union)
    want = ref.online_many(queries, engine="native", union=union)
    assert len(got) == len(want) == len(queries)
    for a, b in zip(got, want):
        _assert_same_result(a, b)
    assert sum(r.answer_count for r in got) > 0


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
    eng.online_many([q, q], union="device")
# The device offline build, a table-mode search, save and load.
from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
from gnnpe_tpu_torch.index.device_packed import TablePESearch
from gnnpe_tpu_torch.paths import pipeline
pe = PEEngine(PEConfig.from_cli(l=2, e=2), g, "cpu").offline(device=True)
pe.build_index(block_size=16, table=True)
want = pe.online(q, union="device")
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
model = gnn.PathGNN(dim=2, labels_count=g.labels_count, device="cpu")
paths = np.random.RandomState(0).randint(0, g.num_vertices, (64, 3))
st = train.fit(model, g, paths, num_steps=3, batch_size=32,
               aggregation="binned", negatives=True, device="cpu")
assert st.step == 3 and embedder.model_embedder(model, "cpu")(q).vde.shape
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
