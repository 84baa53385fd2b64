"""The port's GNN-PGE engine against the benchmark's plain PGE reference
(``benchmark/reference/pge.py``, NumPy, which shares no code with the
port): on seeded generated graphs, through the path the benchmark
serves (``offline(device=True)``, ``build_index``, ``attach_device``),
``online`` and ``online_many`` with either refinement engine give the
reference's candidate sets and counts, the query rows the search is
handed carry the reference's boxes, and every search's
``label_run_blocks`` bounds its ``survived``."""

import numpy as np
import pytest

from benchmark import gen
from benchmark.reference import graph as ref_graph
from benchmark.reference import pge as ref_pge
from gnnpe_tpu_torch.config import PGEConfig
from gnnpe_tpu_torch.engine import PGEEngine
from gnnpe_tpu_torch.graph.csr import CSRGraph

EPS, CAP = 1e-6, 10 ** 5


@pytest.fixture(scope="module", params=[3, 8])
def deployment(request):
    seed = request.param
    n = 600
    edges, labels = gen.powerlaw_graph(n, 2400, 5, 0.8, seed, 40)
    offsets, neighbors = gen.csr(n, edges)
    eng = PGEEngine(PGEConfig.from_cli(l=2, e=2, n=CAP),
                    CSRGraph.from_edges(n, edges, labels), "cpu")
    eng.offline(device=True).build_index(block_size=16).attach_device("cpu")
    data = ref_pge.Data(offsets, neighbors, labels, 2)
    queries = [gen.sample_query(offsets, neighbors, labels, 6, bool(s % 2),
                                seed * 100 + s) for s in range(6)]
    return eng, data, queries


def _reference(data, q_edges, q_labels):
    table = ref_pge.query_table(q_edges, q_labels, 2, 2)
    cands = ref_pge.candidates(data, table, EPS)
    count = ref_graph.count_answers(data.offsets, data.neighbors,
                                    data.labels, q_edges, q_labels, cands,
                                    CAP)
    return cands, count


def _graph(q):
    return CSRGraph.from_edges(len(q[1]), q[0], q[1])


@pytest.mark.parametrize("serve", ["online", "online_many"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_candidates_and_counts_equal_the_reference(deployment, serve,
                                                   engine):
    eng, data, queries = deployment
    graphs = [_graph(q) for q in queries]
    if serve == "online":
        results = [eng.online(g, engine=engine) for g in graphs]
    else:
        results = eng.online_many(graphs, engine=engine)
    assert len(results) == len(queries)
    for (q_edges, q_labels), res in zip(queries, results):
        cands, count = _reference(data, q_edges, q_labels)
        assert len(res.candidates) == len(cands)
        for got, want in zip(res.candidates, cands):
            assert np.array_equal(np.asarray(got, np.int64), want)
        assert res.answer_count == count > 0


def test_query_rows_carry_the_reference_boxes(deployment):
    eng, _, queries = deployment
    for q_edges, q_labels in queries:
        rows = eng._query_table(_graph((q_edges, q_labels)))
        table = ref_pge.query_table(q_edges, q_labels, 2, 2)
        assert np.array_equal(rows.labels, table["labels"])
        assert np.array_equal(rows.degrees, table["degrees"])
        np.testing.assert_allclose(rows.group, table["group"], rtol=1e-12,
                                   atol=0)
        np.testing.assert_array_equal(rows.label_group, table["label_group"])


def test_label_runs_bound_the_surviving_blocks(deployment):
    eng, _, queries = deployment
    graphs = [_graph(q) for q in queries]
    stats = []
    for g in graphs:
        eng.online(g)
        stats.append(dict(eng.searcher.last_stats))
    eng.online_many(graphs)
    stats.append(dict(eng.searcher.last_stats))
    for st in stats:
        assert st["blocks"] >= st["phase1"] >= st["survived"] > 0
        assert st["label_run_blocks"] >= st["survived"]
    # The stacked search's runs are its queries' runs, row for row.
    assert stats[-1]["label_run_blocks"] == sum(
        st["label_run_blocks"] for st in stats[:-1])


def test_build_times_each_part_of_the_build(deployment):
    eng = deployment[0]
    assert set(eng.build_timings) == {"vde_s", "groups_s", "label_runs_s",
                                      "index_s", "upload_s"}
    assert all(v >= 0 for v in eng.build_timings.values())
