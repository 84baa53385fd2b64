"""The port's trained-embedding serving (models/embedder.py, the engines'
``embedder=``) and its payoff front end against gnnpe_tpu, on the CPU.

The embedder runs in f64 on both sides; rtol 1e-12 covers the D×D
matmuls' summation order (the neighbour sums are bit-equal).
"""

import json

import jax
import numpy as np
import pytest

from gnnpe_tpu.config import PGEConfig
from gnnpe_tpu.engine import PGEEngine as RefPGEEngine
from gnnpe_tpu.index.packed import PGEPackedIndex
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.models import embedder as jembedder
from gnnpe_tpu.models import gnn as jgnn
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu_torch.engine import PGEEngine
from gnnpe_tpu_torch.frontends import train_payoff
from gnnpe_tpu_torch.models import embedder, gnn


@pytest.fixture(scope="module")
def setup():
    """A generated graph, queries, and a 2-layer softplus PathGNN with
    random weights on both sides."""
    g = powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)
    cfg = dict(dim=2, num_layers=2, labels_count=g.labels_count,
               activation="softplus")
    jm = jgnn.PathGNN(**cfg)
    params = jm.init(jax.random.key(3), labels_count=g.labels_count)
    port = gnn.params_from_jax(
        gnn.PathGNN(**cfg, device="cpu"),
        [np.asarray(l) for l in jax.tree.flatten(params)[0]])
    queries = [sample_query(g, 6, seed=s) for s in range(4)]
    return g, queries, jembedder.model_embedder(jm, params), \
        embedder.model_embedder(port, "cpu")


def test_model_embedder_matches_jax(setup):
    g, queries, jemb, temb = setup
    for graph in [g] + queries:
        want, got = jemb(graph), temb(graph)
        assert np.array_equal(got.labels, want.labels)
        assert np.array_equal(got.degrees, want.degrees)
        for name in ("x", "nx", "vde"):
            a = getattr(got, name)
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, getattr(want, name), rtol=1e-12)


def test_trained_pge_engine_matches_jax(setup):
    g, queries, jemb, temb = setup
    cfg = PGEConfig.from_cli(l=2, e=2)
    ref = RefPGEEngine(cfg, g, embedder=jemb)
    ref.offline()
    ref.index = PGEPackedIndex.build(ref.vertices.labels,
                                     ref.vertices.degrees, ref.group,
                                     ref.label_group, block_size=16)
    ref.attach_mesh(make_mesh(1, axes=("graph",), shape=(1,)), packed=True)
    port = PGEEngine(cfg, g, "cpu", embedder=temb).offline().build_index(
        block_size=16).attach_device("cpu")
    total = 0
    for q in queries:
        got, want = port.online(q), ref.online(q, engine="native")
        assert got.answer_count == want.answer_count
        assert len(got.candidates) == len(want.candidates)
        for a, b in zip(got.candidates, want.candidates):
            assert np.array_equal(a, b)
        total += got.answer_count
    assert total > 0


def test_payoff_cli_on_cpu_writes_no_file(tmp_path, monkeypatch, capsys):
    """yeast-sized run (segment aggregation): answers equal per query
    (run asserts it), two JSON rows on stdout, nothing written."""
    monkeypatch.chdir(tmp_path)
    train_payoff.main(["--dataset", "yeast", "--device", "cpu",
                       "--steps", "3", "--queries", "2",
                       "--query-size", "5"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["embedder"] for r in rows] == ["fixed-vde", "trained-pathgnn"]
    assert all(r["answers_ok"] for r in rows)
    assert rows[1]["train_steps"] == 3
    assert rows[1]["aggregation"] == "segment"
    assert list(tmp_path.iterdir()) == []
    train_payoff.write_md(rows, "t.md")
    table = (tmp_path / "t.md").read_text().splitlines()
    assert len(table) == 8 and "trained-pathgnn" in table[-1]


def test_payoff_cli_needs_device():
    with pytest.raises(SystemExit):
        train_payoff.main(["--dataset", "yeast"])


def test_streamed_pe_payoff_matches_jax():
    """``run(variant="pe", force_streamed=True)`` on yeast: both rows
    served by the streamed index (``mode`` "streamed", ``chunks_mean``
    recorded), trained answers equal to the fixed ones (run asserts it);
    the fixed embedder's answers and candidates on the held-out queries,
    and the row's ``cand_sum_mean``, equal to gnnpe_tpu's PE engine on
    the same graph and queries (candidates do not depend on the index
    layout, so its host packed index is the oracle)."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine as RefPEEngine
    from gnnpe_tpu.io.datasets import load_dataset
    from gnnpe_tpu_torch.index.device_packed import StreamedPESearch
    pay = train_payoff.run("yeast", queries=3, query_size=5, steps=3,
                           variant="pe", device="cpu", force_streamed=True)
    assert isinstance(pay.engine.searcher, StreamedPESearch)
    fixed_row, trained_row = pay.rows
    for row in pay.rows:
        assert row["mode"] == "streamed" and row["answers_ok"]
        assert row["chunks_mean"] >= 1.0
    assert [r.answer_count for r in pay.trained] == [
        r.answer_count for r in pay.fixed]
    assert all("uploaded_bytes" in st and "cache_misses" in st
               for st in pay.fixed_stats + pay.trained_stats)
    g = load_dataset("yeast", seed=0)
    ref = RefPEEngine(PEConfig.from_cli(l=2, e=2, p=5, n=100_000),
                      g).offline().build_index()
    qs = [sample_query(g, 5, tree=True, seed=10_000 + i) for i in range(3)]
    want = [ref.online(q, engine="native") for q in qs]
    for q, mine in zip(qs, pay.queries):
        assert np.array_equal(q.neighbors, mine.neighbors)
    assert [r.answer_count for r in pay.fixed] == [
        w.answer_count for w in want]
    for got, w in zip(pay.fixed, want):
        assert len(got.candidates) == len(w.candidates)
        for a, b in zip(got.candidates, w.candidates):
            assert np.array_equal(a, b)
    assert fixed_row["cand_sum_mean"] == np.mean(
        [sum(map(len, w.candidates)) for w in want])


def test_payoff_cli_force_streamed(capsys):
    """``--variant pe --force-streamed``: both printed rows carry
    ``mode`` "streamed" and ``chunks_mean``; PGE rows carry no mode."""
    train_payoff.main(["--dataset", "yeast", "--device", "cpu",
                       "--steps", "2", "--queries", "1", "--query-size",
                       "5", "--variant", "pe", "--force-streamed"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["mode"] for r in rows] == ["streamed", "streamed"]
    assert all("chunks_mean" in r for r in rows)
    train_payoff.main(["--dataset", "yeast", "--device", "cpu",
                       "--steps", "2", "--queries", "1", "--query-size",
                       "5", "--force-streamed"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert all("mode" not in r and "chunks_mean" in r for r in rows)
