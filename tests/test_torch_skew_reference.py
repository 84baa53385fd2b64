"""The port's GNN-PE engine at l=1 (2-vertex paths, the table index) on a
graph with one hub, against the benchmark's plain PE reference
(``benchmark/reference/pe.py``, NumPy, which shares no code with the
port): the shape of ``youtube_skew_pe``, whose generated hub has 28,753
neighbours, cut to the CPU.  8-vertex trees, half of them walked from
the hub, get the reference's candidate sets and counts, capped and
uncapped; refinement reports its three spans inside ``refine`` and its
counters in ``MatchResult.stats``, the same from either explorer and
from run to run."""

import numpy as np
import pytest

from benchmark import gen
from benchmark.reference import graph as ref_graph
from benchmark.reference import pe as ref_pe
from gnnpe_tpu_torch.config import UNLIMITED, PEConfig
from gnnpe_tpu_torch.engine import PEEngine
from gnnpe_tpu_torch.graph.csr import CSRGraph
from gnnpe_tpu_torch.match.refine import refinement

N, LABELS, HUB_DEGREE, BLOCK = 3000, 5, 1200, 512
EPS, CAP = 1e-6, 10 ** 5
SPANS = ("refine.order", "refine.prepare", "refine.explore")
COUNTERS = {"cand_ids", "explore_nodes", "explore_scans"}


def _hub_graph(seed: int = 7):
    """A sparse seeded power-law graph (max degree 12) and one vertex of
    the rarest label joined to HUB_DEGREE others drawn from the seed."""
    edges, labels = gen.powerlaw_graph(N, 3600, LABELS, 0.3, seed, 12)
    hub = int(np.nonzero(labels == LABELS - 1)[0][0])
    spokes = np.random.RandomState(seed).choice(
        np.setdiff1d(np.arange(N), [hub]), HUB_DEGREE, replace=False)
    keys = np.concatenate([edges[:, 0] * N + edges[:, 1],
                           np.minimum(hub, spokes) * N
                           + np.maximum(hub, spokes)])
    keys = np.unique(keys)
    return np.stack([keys // N, keys % N], 1), labels, hub


def _tree_from(offsets, neighbors, labels, start: int, size: int,
               seed: int):
    """An ``size``-vertex tree walked from ``start``: each step joins an
    unchosen neighbour of a chosen vertex drawn from the seed."""
    rng = np.random.RandomState(seed)
    chosen, edges = [start], []
    while len(chosen) < size:
        v = chosen[rng.randint(len(chosen))]
        free = [int(u) for u in neighbors[offsets[v]:offsets[v + 1]]
                if int(u) not in chosen]
        if free:
            edges.append((chosen.index(v), len(chosen)))
            chosen.append(free[rng.randint(len(free))])
    return (np.array(edges, np.int64).reshape(-1, 2),
            labels[np.array(chosen)].astype(np.int32))


def _engine(graph, cap):
    eng = PEEngine(PEConfig.from_cli(l=1, e=2, p=5, n=cap), graph, "cpu")
    return eng.offline(device=True).build_index(block_size=BLOCK,
                                                table=True)


@pytest.fixture(scope="module")
def deployment():
    edges, labels, hub = _hub_graph()
    offsets, neighbors = gen.csr(N, edges)
    graph = CSRGraph.from_edges(N, edges, labels)
    queries = ([_tree_from(offsets, neighbors, labels, hub, 8, s)
                for s in range(6)]
               + [gen.sample_query(offsets, neighbors, labels, 8, True, s)
                  for s in range(6)])
    data = ref_pe.Data(offsets, neighbors, labels, 2)
    want = []
    for q_edges, q_labels in queries:
        table = ref_pe.query_table(q_edges, q_labels, 2, 2)
        cands = ref_pe.candidates(data, table, EPS)
        want.append((cands, ref_graph.count_answers(
            offsets, neighbors, labels, q_edges, q_labels, cands, CAP)))
    return dict(graph=graph, hub=hub, queries=queries, want=want,
                capped=_engine(graph, CAP),
                uncapped=_engine(graph, UNLIMITED))


def _graph(q):
    return CSRGraph.from_edges(len(q[1]), q[0], q[1])


def _serve(eng, graphs, serve, engine="native"):
    if serve == "online":
        return [eng.online(g, engine=engine) for g in graphs]
    return eng.online_many(graphs, engine=engine)


def test_the_hub_spans_several_blocks(deployment):
    eng, hub = deployment["capped"], deployment["hub"]
    assert deployment["graph"].degrees[hub] >= HUB_DEGREE
    assert eng.paths.shape[1] == 2
    vids = eng.searcher.d_vids.cpu().numpy()
    blocks = np.unique(np.nonzero((vids == hub).any(1))[0] // BLOCK)
    assert len(blocks) > 1


@pytest.mark.parametrize("serve", ["online", "online_many"])
def test_capped_candidates_and_counts_equal_the_reference(deployment,
                                                          serve):
    results = _serve(deployment["capped"],
                     [_graph(q) for q in deployment["queries"]], serve)
    for res, (cands, count) in zip(results, deployment["want"]):
        assert len(res.candidates) == len(cands)
        for got, ref in zip(res.candidates, cands):
            assert np.array_equal(np.asarray(got, np.int64), ref)
        assert res.answer_count == count
    # Some queries reach the cap, the hub's walks among them.
    assert any(c == CAP for _, c in deployment["want"][:6])


@pytest.mark.parametrize("serve", ["online", "online_many"])
def test_uncapped_counts_equal_the_reference(deployment, serve):
    """Uncapped, on the queries whose whole count the reference finds
    under CAP: the count is then every map, not a prefix of them."""
    whole = [k for k, (_, c) in enumerate(deployment["want"]) if c < CAP]
    assert any(k < 6 for k in whole) and any(k >= 6 for k in whole)
    results = _serve(deployment["uncapped"],
                     [_graph(deployment["queries"][k]) for k in whole], serve)
    for k, res in zip(whole, results):
        assert res.answer_count == deployment["want"][k][1]
        assert res.stats["explore_nodes"] >= res.answer_count


@pytest.mark.parametrize("serve", ["online", "online_many"])
def test_refinement_spans_lie_inside_refine(deployment, serve):
    results = _serve(deployment["capped"],
                     [_graph(q) for q in deployment["queries"][:4]], serve)
    for res in results:
        parts = [res.timings_ms[s] for s in SPANS]
        assert all(0 <= p <= res.timings_ms["refine"] for p in parts)
        assert sum(parts) <= res.timings_ms["refine"]
        assert set(res.stats) == COUNTERS
        assert res.stats["cand_ids"] == sum(map(len, res.candidates))


@pytest.mark.parametrize("cap", [2000, UNLIMITED])
def test_both_explorers_count_the_same_search_tree(deployment, cap):
    eng = deployment["capped"]
    picked = [k for k, (_, c) in enumerate(deployment["want"])
              if cap != UNLIMITED or c < 2000]
    assert picked
    for k in picked:
        q = _graph(deployment["queries"][k])
        cands = deployment["want"][k][0]
        got = {}
        for engine in ("native", "python"):
            stats = {}
            count = refinement(eng.graph, q, cands, cap, engine=engine,
                               stats=stats)
            got[engine] = count, stats
        (n_count, n_stats), (p_count, p_stats) = (got["native"],
                                                  got["python"])
        assert n_count == p_count
        assert n_stats["explore_nodes"] == p_stats["explore_nodes"]
        assert n_stats["explore_nodes"] >= n_count
        assert n_stats["cand_ids"] == p_stats["cand_ids"]
        # The native explorer reads whole rows, the Python one a label's
        # slice of them; both read the first vertex's candidates.
        assert n_stats["explore_scans"] >= p_stats["explore_scans"] > 0


def test_stats_are_the_same_from_run_to_run(deployment):
    eng = deployment["capped"]
    for q in (deployment["queries"][0], deployment["queries"][6]):
        runs = [eng.online(_graph(q)) for _ in range(2)]
        runs.append(eng.online_many([_graph(q)])[0])
        assert runs[0].stats == runs[1].stats == runs[2].stats
        assert runs[0].stats["explore_scans"] >= runs[0].stats[
            "explore_nodes"] > 0
