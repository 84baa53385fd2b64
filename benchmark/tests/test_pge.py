"""Tests of the GNN-PGE variant of the benchmark (``dblp_pge``): its
plain reference against brute force, a tiny PGE cell through the
harness's CPU form, the faults that must come out not correct, the PGE
search's byte count, and the float32 control at dblp scale.

    python -m pytest -q benchmark/tests/test_pge.py
"""

from __future__ import annotations

import ast
import itertools
import pathlib

import numpy as np
import pytest

from benchmark import check, gen, harness, roofline_pge, spec
from benchmark.reference import graph as ref_graph
from benchmark.reference import pge as ref_pge
from benchmark.run import FORBIDDEN
from benchmark.tests.test_bench_harness import (BENCH, LIMITS, MIXES, SEED,
                                                TINY, _alter_count,
                                                _drop_candidate)

ROOT = pathlib.Path(__file__).resolve().parents[2]
TINY_PGE = dict(TINY, name="tiny_pge", variant="pge", l=1)
CELL = "dblp_pge.online"


def tiny_cell() -> spec.Cell:
    e2e = [m for m in BENCH["end_to_end"] if "workloads" not in m
           or CELL in m["workloads"]]
    layer = [m for m in BENCH["per_layer"] if CELL in m.get("workloads", [])]
    return spec.Cell("tiny_pge.online", 1, TINY_PGE, MIXES["online"], e2e,
                     layer)


def run_cpu(traced: bool = False) -> dict:
    return harness.run(tiny_cell(), SEED, 0.5, traced, device="cpu")


# ---- the plain reference against brute force ------------------------

def _tiny(seed: int):
    edges, labels = gen.powerlaw_graph(40, 90, 2, 0.8, seed, 10)
    offsets, neighbors = gen.csr(40, edges)
    return offsets, neighbors, labels


def _embeddings(offsets, neighbors, labels, q_edges, q_labels):
    """Every label- and edge-preserving injective map of the query, by
    trying each data vertex for each query vertex in id order."""
    n = len(q_labels)
    adj = {(int(a), int(b)) for a, b in q_edges}
    adj |= {(b, a) for a, b in adj}
    edge = {(u, int(w)) for u in range(len(labels))
            for w in neighbors[offsets[u]:offsets[u + 1]]}
    found = []

    def extend(m):
        if len(m) == n:
            found.append(tuple(m))
            return
        u = len(m)
        for v in range(len(labels)):
            if (v not in m and labels[v] == q_labels[u]
                    and all((m[w], v) in edge for w in range(u)
                            if (w, u) in adj)):
                extend(m + [v])

    extend([])
    return found


def _boxes_by_paths(offsets, neighbors, table):
    """Each vertex's [min, max] over its paths (v, w), one path at a
    time; the degenerate box where it has none."""
    n, dim = table.shape
    out = np.zeros((n, 2, 2 * dim))
    for v in range(n):
        paths = [np.concatenate([table[v], table[w]])
                 for w in neighbors[offsets[v]:offsets[v + 1]]]
        if not paths:
            out[v, :, :dim] = table[v]
            continue
        out[v, 0] = np.min(paths, axis=0)
        out[v, 1] = np.max(paths, axis=0)
    return out


@pytest.mark.parametrize("graph_seed", [3, 4, 7])
def test_reference_boxes_equal_the_paths_folded_one_by_one(graph_seed):
    offsets, neighbors, labels = _tiny(graph_seed)
    data = ref_pge.Data(offsets, neighbors, labels, 2)
    x = ref_graph.label_table(int(labels.max()) + 1, 2)[labels]
    assert not np.diff(offsets).all()        # a vertex with no path
    assert np.array_equal(data.group,
                          _boxes_by_paths(offsets, neighbors, data.vde))
    assert np.array_equal(data.label_group,
                          _boxes_by_paths(offsets, neighbors, x))


@pytest.mark.parametrize("tree", [True, False])
@pytest.mark.parametrize("graph_seed", [3, 7])
def test_reference_dismisses_no_embedding_and_counts_them_all(graph_seed,
                                                              tree):
    offsets, neighbors, labels = _tiny(graph_seed)
    data = ref_pge.Data(offsets, neighbors, labels, 2)
    seen = 0
    for s in range(4):
        q_edges, q_labels = gen.sample_query(offsets, neighbors, labels, 4,
                                             tree, s)
        table = ref_pge.query_table(q_edges, q_labels, 2, 2)
        cands = ref_pge.candidates(data, table, 1e-6)
        found = _embeddings(offsets, neighbors, labels, q_edges, q_labels)
        for m in found:
            assert all(v in cands[u] for u, v in enumerate(m))
        seen += len(found)
        for cap in (3, 10 ** 6):
            assert ref_graph.count_answers(
                offsets, neighbors, labels, q_edges, q_labels, cands,
                cap, rows_per_step=5) == min(cap, len(found))
    assert seen > 0


def test_reference_candidates_are_the_filter_vertex_by_vertex():
    offsets, neighbors, labels = _tiny(4)
    data = ref_pge.Data(offsets, neighbors, labels, 2)
    q_edges, q_labels = gen.sample_query(offsets, neighbors, labels, 5,
                                         False, 1)
    table = ref_pge.query_table(q_edges, q_labels, 2, 2)
    assert table["vids"].tolist() == [[u] for u in range(5)]
    assert table["pde"].shape == (5, 16)
    got = ref_pge.candidates(data, table, 1e-6)
    for u in range(5):
        thr = ref_pge.threshold(table["group"][u, 0], 1e-6)
        lo, hi = table["label_group"][u]
        want = [v for v in range(len(labels))
                if labels[v] == table["labels"][u]
                and data.degrees[v] >= table["degrees"][u]
                and all(data.label_group[v, 1] >= lo)
                and all(data.label_group[v, 0] <= hi)
                and all(data.group[v, 1] >= thr)]
        assert got[u].tolist() == want


def test_reference_refuses_what_it_does_not_cover():
    q_edges, q_labels = np.array([[0, 1]]), np.array([0, 1, 0])
    with pytest.raises(ValueError):
        ref_pge.query_table(q_edges, q_labels, 2, 2)   # vertex 2: no path
    with pytest.raises(ValueError):
        ref_pge.query_table(q_edges, q_labels[:2], 2, 3)


# ---- the harness's CPU form ------------------------------------------

@pytest.mark.parametrize("traced", [False, True])
def test_tiny_pge_cell_runs_correct(traced):
    res = run_cpu(traced)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % TINY_PGE["query_set"] == 0
    assert all(v["value"] == 0 for v in res["checks"].values())
    cell = tiny_cell()
    got = res["metrics"]
    if traced:
        want = {m["name"] for m in cell.per_layer}
        # No device time on the CPU, so no roofline share.
        assert set(got) == want - {"pge_search_roofline"}
        assert (got["search_label_run_blocks.pge"]["value"]
                >= got["blocks_survived.pge"]["value"] > 0)
        assert got["search_cand_ids.pge"]["value"] > 0
    else:
        assert set(got) == {m["name"] for m in cell.end_to_end}
        assert set(got) == {"setup_s", "qps"}


def _query_boxes_in_f32(monkeypatch):
    import gnnpe_tpu_torch.engine as engine
    inner = engine.PGEEngine._query_table

    def query_table(self, qg):
        t = inner(self, qg)
        t.group = t.group.astype(np.float32).astype(np.float64)
        t.label_group = t.label_group.astype(np.float32).astype(np.float64)
        return t
    monkeypatch.setattr(engine.PGEEngine, "_query_table", query_table)


def _data_vde_off_by_1e9(monkeypatch):
    import gnnpe_tpu_torch.engine as engine
    inner = engine._Engine._vde

    def vde(self, graph):
        v = inner(self, graph)
        if graph is self.graph:
            v.vde = v.vde * (1 + 1e-9)
        return v
    monkeypatch.setattr(engine._Engine, "_vde", vde)


@pytest.mark.parametrize("fault", [_drop_candidate, _alter_count,
                                   _query_boxes_in_f32,
                                   _data_vde_off_by_1e9])
def test_a_broken_pge_path_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run_cpu()
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


# ---- the byte count --------------------------------------------------

def test_search_bytes_by_hand_and_by_the_index_on_the_device():
    from gnnpe_tpu_torch.index.device_packed import DevicePackedPGESearch
    from gnnpe_tpu_torch.index.packed import PGEPackedIndex
    cfg = dict(l=1, e=2, block_size=8)
    # A summary: 3 boxes of 4 f64 and an int32 degree; a row: label,
    # degree, the group's upper end, the label group (3 boxes of 4 f64)
    # and the vertex id.
    assert roofline_pge.search_bytes(cfg, dict(blocks=5, survived=2)) == (
        5 * (3 * 4 * 8 + 4) + 2 * 8 * (4 + 4 + 3 * 4 * 8 + 4))
    rng = np.random.RandomState(0)
    v, d = 37, 4
    group = np.sort(rng.rand(v, 2, d), axis=1)
    index = PGEPackedIndex.build(rng.randint(0, 3, v).astype(np.int32),
                                 rng.randint(1, 9, v).astype(np.int32),
                                 group, np.sort(rng.rand(v, 2, d), axis=1),
                                 block_size=8)
    search = DevicePackedPGESearch(index, "cpu")
    nbytes = lambda names: sum(getattr(search, k).nbytes for k in names)
    summaries = nbytes(("b_gub", "b_llo", "b_lhi", "b_deg"))
    rows = nbytes(("d_labels", "d_degrees", "d_ghi", "d_llo", "d_lhi",
                   "d_order"))
    nb = search.num_blocks
    assert roofline_pge.search_bytes(
        cfg, dict(blocks=nb, survived=nb)) == summaries + rows


# ---- what the yardstick imports, and the control at full size -------

def test_roofline_and_engine_file_import_nothing_at_module_level():
    for path in (ROOT / "benchmark" / "roofline_pge.py",
                 ROOT / "benchmark" / "engines" / "pge.py",
                 ROOT / "benchmark" / "reference" / "pge.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in tree.body:                  # module level only
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"gnnpe_tpu_torch", *FORBIDDEN}, path


def test_control_in_float32_comes_out_not_correct_at_dblp_scale():
    from benchmark import control
    cell = spec.cell(ROOT, CELL)
    assert cell.config["variant"] == "pge" and cell.config["l"] == 1
    numbers = control.control(cell, SEED)
    assert not check.verdict(numbers, cell.config["limits"])
    assert numbers["data_vde_gap"] > 1e-9 and numbers["query_pde_gap"] > 1e-9
    assert set(numbers) == set(LIMITS)


def test_the_pge_cell_shares_dblp_pe_graph_queries_and_limits():
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "dblp_pge", "online", 1)
    pe, pge = spec.config("dblp_pe"), spec.config("dblp_pge")
    same = ("vertices", "edges", "labels", "alpha", "max_degree",
            "graph_seed", "query_set", "query_seed", "e", "p", "max_answers",
            "block_size", "epsilon", "limits", "published")
    assert all(pe[k] == pge[k] for k in same)
    assert (pge["variant"], pge["l"], pge["reduced"]) == ("pge", 1, [])
    assert {m["name"] for m in spec.cell(ROOT, CELL).end_to_end} == {
        "setup_s", "qps"}
    for a, b in itertools.combinations(BENCH["per_layer"], 2):
        assert a["name"] != b["name"]
