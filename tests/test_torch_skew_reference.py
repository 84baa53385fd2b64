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
from gnnpe_tpu_torch.match.plan import generate_bn, gql_order
from gnnpe_tpu_torch.match.refine import refinement

N, LABELS, HUB_DEGREE, BLOCK = 3000, 5, 1200, 512
EPS, CAP = 1e-6, 10 ** 5
SPANS = ("refine.order", "refine.prepare", "refine.explore")
COUNTERS = {"cand_ids", "explore_nodes", "explore_scans",
            "explore_row_arcs"}


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
        # Both explorers read the first vertex's candidates and each
        # pivot's label run, a slice of its whole row.
        assert n_stats["explore_scans"] == p_stats["explore_scans"] > 0
        assert n_stats["explore_row_arcs"] == p_stats["explore_row_arcs"]
        assert n_stats["explore_row_arcs"] >= n_stats["explore_scans"]


def test_stats_are_the_same_from_run_to_run(deployment):
    eng = deployment["capped"]
    for q in (deployment["queries"][0], deployment["queries"][6]):
        runs = [eng.online(_graph(q)) for _ in range(2)]
        runs.append(eng.online_many([_graph(q)])[0])
        assert runs[0].stats == runs[1].stats == runs[2].stats
        assert runs[0].stats["explore_scans"] >= runs[0].stats[
            "explore_nodes"] > 0


# ---- label runs: the explorers against a walk of whole rows -----------------

def _whole_row_walk(graph, query, cands, cap):
    """The search tree that reading every pivot's whole row and testing
    each neighbour's label gives, in plain Python: (count, nodes, entries
    read, embeddings in query-vertex-id order, and for each embedding
    whether it was the last of its last depth's candidates)."""
    counts = np.array([len(c) for c in cands], dtype=np.int64)
    order, pivot = gql_order(query, counts)
    bn = generate_bn(query, order, pivot)
    nq = query.num_vertices
    emb, used, out, last = [-1] * nq, set(), [], []
    tally = {"nodes": 0, "read": len(cands[order[0]])}

    def extend(depth, stack):
        for i, v in enumerate(stack):
            emb[order[depth]] = int(v)
            tally["nodes"] += 1
            if depth == nq - 1:
                out.append(list(emb))
                last.append(i == len(stack) - 1)
                if len(out) >= cap:
                    return True
                continue
            used.add(int(v))
            u = order[depth + 1]
            row = graph.vertex_neighbors(emb[pivot[depth + 1]])
            tally["read"] += len(row)
            nxt = [int(w) for w in row
                   if int(w) not in used
                   and graph.labels[w] == query.labels[u]
                   and graph.degrees[w] >= query.degrees[u]
                   and all(int(w) in set(graph.vertex_neighbors(emb[b]))
                           for b in bn[depth + 1])]
            stop = extend(depth + 1, nxt)
            used.discard(int(v))
            if stop:
                return True
        return False

    extend(0, [int(v) for v in cands[order[0]]])
    return (len(out), tally["nodes"], tally["read"],
            np.array(out, np.int64).reshape(-1, nq), last)


def _case_graph(case):
    """(data graph, query graph, candidates, cap) of one case."""
    rng = np.random.RandomState(5)
    v, labels = 240, (1 if case == "one-label" else 6)
    pairs = np.concatenate([
        np.stack([np.zeros(100, np.int64), np.arange(1, 101)], 1),
        rng.randint(1, v, (600, 2))])
    pairs = np.unique(np.sort(pairs[pairs[:, 0] != pairs[:, 1]], 1), axis=0)
    lab = np.minimum(rng.zipf(1.6, v) - 1, labels - 1)
    if case == "absent-label":
        lab[lab == 2] = 3                   # label 2 < labels_count, unused
    graph = CSRGraph.from_edges(v, pairs, lab)
    offsets, neighbors = graph.offsets, graph.neighbors
    # One label matches every vertex: a shorter tree keeps the walk small.
    size = 4 if case == "one-label" else 5
    q_edges, q_labels = _tree_from(offsets, neighbors, graph.labels, 0, size,
                                   seed=1)
    q_labels = q_labels.copy()
    odd = {"absent-label": {2: 2},
           "label-at-count": {2: graph.labels_count,
                              4: graph.labels_count + 7}}.get(case, {})
    for u, label in odd.items():
        q_labels[u] = label
    query = CSRGraph.from_edges(len(q_labels), q_edges, q_labels)
    # A vertex of an odd label takes every data vertex as a candidate,
    # so the order puts it past depth 0 and a pivot's run is read for it.
    cands = [np.arange(v) if u in odd else np.nonzero(
        (graph.labels == query.labels[u])
        & (graph.degrees >= query.degrees[u]))[0]
        for u in range(query.num_vertices)]
    return graph, query, cands


@pytest.mark.parametrize("case", ["hub", "one-label", "absent-label",
                                  "label-at-count", "cap-in-last-run"])
def test_label_runs_keep_the_whole_row_search_tree(case):
    """Both explorers walk label runs and give the count, the search
    tree's nodes and the embeddings, in order, of a walk over whole
    rows; ``explore_row_arcs`` is that walk's reads, ``explore_scans``
    the runs' share of them."""
    graph, query, cands = _case_graph(case)
    cap = UNLIMITED
    whole = _whole_row_walk(graph, query, cands, cap)
    if case == "cap-in-last-run":
        # The first embedding that does not end its last depth's run.
        inside = [k for k, end in enumerate(whole[4]) if not end]
        assert inside, "no last-depth run holds two embeddings"
        cap = inside[0] + 1
        whole = _whole_row_walk(graph, query, cands, cap)
        assert whole[0] == cap and not whole[4][-1]
    count, nodes, read, emb, _ = whole
    if case in ("hub", "one-label", "cap-in-last-run"):
        assert count > 0
    else:
        assert count == 0 and nodes > 0 and read > 0
    got = {}
    for engine in ("native", "python"):
        stats = {}
        n = refinement(graph, query, cands, cap, engine=engine, stats=stats)
        m, rows = refinement(graph, query, cands, cap, engine=engine,
                             return_embeddings=True)
        assert n == m == count
        assert np.array_equal(np.asarray(rows, np.int64), emb)
        assert stats["explore_nodes"] == nodes
        assert stats["explore_row_arcs"] == read
        assert stats["explore_scans"] <= read
        got[engine] = stats
    assert got["native"] == got["python"]
    if case == "one-label":
        assert got["native"]["explore_scans"] == read
    elif case == "hub":
        assert got["native"]["explore_scans"] < read


def test_online_many_equals_online_calls(deployment):
    """16 queries through ``online_many`` (refinement on 8 pool threads
    over the one shared table) give what 16 ``online`` calls give."""
    graph, eng = deployment["graph"], deployment["capped"]
    queries = [_graph(q) for q in deployment["queries"]] + [
        _graph(gen.sample_query(graph.offsets, graph.neighbors,
                                graph.labels, 8, True, 100 + s))
        for s in range(16 - len(deployment["queries"]))]
    many = eng.online_many(queries)
    one = [eng.online(q) for q in queries]
    assert len(many) == len(one) == 16
    for a, b in zip(many, one):
        assert a.answer_count == b.answer_count
        assert a.stats == b.stats
        for x, y in zip(a.candidates, b.candidates):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_the_engine_builds_the_label_runs_once_in_offline(monkeypatch):
    """``offline`` builds the table; ``build_timings`` keeps its time;
    two ``online`` calls and an ``online_many`` read the same arrays
    and build nothing."""
    edges, labels, hub = _hub_graph(seed=3)
    graph = CSRGraph.from_edges(N, edges, labels)
    eng = PEEngine(PEConfig.from_cli(l=1, e=2, p=5, n=CAP), graph, "cpu")
    assert getattr(graph, "_label_adj", None) is None
    eng.offline(device=True)
    built = graph.label_adjacency()
    eng.build_index(block_size=BLOCK, table=True)
    assert eng.build_timings["label_runs_s"] >= 0
    seen = []
    real = CSRGraph.label_adjacency

    def spy(self):
        fresh = getattr(self, "_label_adj", None) is None
        runs = real(self)
        if self is graph:
            seen.append((fresh, runs))
        return runs

    monkeypatch.setattr(CSRGraph, "label_adjacency", spy)
    offsets, neighbors = graph.offsets, graph.neighbors
    queries = [CSRGraph.from_edges(8, *_tree_from(offsets, neighbors,
                                                  labels, hub, 8, s))
               for s in range(3)]
    eng.online(queries[0])
    eng.online(queries[1])
    eng.online_many(queries)
    assert len(seen) == 5
    for fresh, runs in seen:
        assert not fresh
        assert runs[0] is built[0] and runs[1] is built[1]
