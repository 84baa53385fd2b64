"""Tests of the benchmark's harness, on the CPU at a tiny size (the
harness's CPU form, asked for by name), and one test on the card.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import check, gen, harness, readers, spec
from benchmark import trace as tracing
from benchmark.reference import graph as ref_graph
from benchmark.reference import pe as ref_pe
from benchmark.run import FORBIDDEN

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LIMITS = dict(data_vde_gap=1e-12, query_pde_gap=1e-12, plan_mismatch=0,
              cand_mismatch=0, count_mismatch=0, failed=0, unchecked=0)
TINY = dict(name="tiny_pe", variant="pe", vertices=2500, edges=10000,
            labels=6, alpha=0.8, max_degree=80, l=2, e=2, p=5,
            max_answers=100000, block_size=64, epsilon=1e-06, graph_seed=5,
            query_set=8, query_seed=6, limits=LIMITS)
MIXES = {"online": dict(loop="online", query_vertices=8, tree=True, batch=1,
                        warmup=2, check=4),
         "batch": dict(loop="batch", query_vertices=8, tree=True, batch=4,
                       warmup=4, check=4)}
SEED = 2 ** 31 + 977          # past 32 signed bits, as large seeds are


def tiny_cell(loop: str, config: dict = None) -> spec.Cell:
    e2e = [m for m in BENCH["end_to_end"] if "workloads" not in m
           or f"dblp_pe.{loop}" in m["workloads"]]
    layer = [m for m in BENCH["per_layer"]
             if f"dblp_pe.{loop}" in m.get("workloads", [])]
    return spec.Cell(f"tiny_pe.{loop}", 1, config or TINY, MIXES[loop], e2e,
                     layer)


def run_cpu(loop: str, traced: bool = False, seconds: float = 0.5,
            config: dict = None) -> dict:
    return harness.run(tiny_cell(loop, config), SEED, seconds, traced,
                       device="cpu")


# ---- BENCHMARK.json and the files it names --------------------------

def test_every_named_file_is_found_and_parses():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.exists() and path.parent.name == "configs"
        assert spec.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = spec.cell(ROOT, w["name"])
        assert cell.mix["loop"] in ("online", "batch")
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
        for m in cell.end_to_end:
            assert m["name"] in harness.END_TO_END
    for m in BENCH["per_layer"]:
        assert spec.reader_path(m["name"]).exists(), m["name"]
    for c in BENCH["configs"]:
        variant = spec.config(c["name"])["variant"]
        engine, ref = spec.engine(variant), spec.reference(variant)
        for name in ("build", "data_vde", "planned"):
            assert callable(getattr(engine, name))
        for name in ("Data", "query_table", "candidates"):
            assert callable(getattr(ref, name))


def test_a_quantity_in_two_mixes_reads_one_file():
    assert spec.reader_path("refine_ms.batch") == spec.reader_path(
        "refine_ms.online") == spec.HERE / "metrics" / "refine_ms.py"
    assert spec.reader_path("build_s").name == "build_s.py"


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert spec.NAME.fullmatch(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs_state_the_reduced_keys_and_the_guarantee():
    for c in BENCH["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"]
        assert cfg["guarantee"] and cfg["source"] == c["source"]
        assert set(cfg["limits"]) == set(check.ORDER)


# ---- the plain reference against brute force ------------------------

def _brute_candidates(offsets, neighbors, labels, vde, table, eps):
    deg = np.diff(offsets)
    n = len(labels)
    rank = deg * n + np.arange(n)
    length = table["vids"].shape[1]
    paths = [[v] for v in range(n)]
    for _ in range(length - 1):
        paths = [p + [int(w)] for p in paths
                 for w in neighbors[offsets[p[-1]]:offsets[p[-1] + 1]]
                 if int(w) not in p]
    paths = [p for p in paths if rank[p[0]] < rank[p[-1]]]
    out = [set() for _ in range(table["n"])]
    dim = vde.shape[1]
    for vids, labs, degs, pde in zip(table["vids"], table["labels"],
                                     table["degrees"], table["pde"]):
        thr = ref_pe.threshold(pde, eps).reshape(length, dim)
        for p in paths:
            if all(labels[p[k]] == labs[k] and deg[p[k]] >= degs[k]
                   and (vde[p[k]] >= thr[k]).all() for k in range(length)):
                for k in range(length):
                    out[vids[k]].add(p[k])
    return [np.array(sorted(s), np.int64) for s in out]


def _brute_count(offsets, neighbors, labels, q_edges, q_labels, root_cands,
                 root, cap):
    n = len(q_labels)
    adj = {u: set() for u in range(n)}
    for a, b in q_edges:
        adj[int(a)].add(int(b))
        adj[int(b)].add(int(a))
    deg = np.diff(offsets)
    edge = {(int(u), int(w)) for u in range(len(labels))
            for w in neighbors[offsets[u]:offsets[u + 1]]}
    order = [root] + [u for u in range(n) if u != root]
    count = 0

    def extend(m):
        nonlocal count
        if count >= cap:
            return
        if len(m) == n:
            count += 1
            return
        u = order[len(m)]
        pool = range(len(labels))
        for v in pool:
            if (v in m.values() or labels[v] != q_labels[u]
                    or deg[v] < len(adj[u])):
                continue
            if all((m[w], v) in edge for w in adj[u] if w in m):
                m[u] = v
                extend(m)
                del m[u]

    for v in root_cands:
        extend({root: int(v)})
    return min(count, cap)


@pytest.mark.parametrize("length", [2, 3])
@pytest.mark.parametrize("graph_seed", [3, 4])
def test_reference_candidates_equal_brute_force(length, graph_seed):
    edges, labels = gen.powerlaw_graph(60, 150, 3, 0.8, graph_seed, 12)
    offsets, neighbors = gen.csr(60, edges)
    data = ref_pe.Data(offsets, neighbors, labels, 2)
    for s in range(4):
        q_edges, q_labels = gen.sample_query(offsets, neighbors, labels, 5,
                                             bool(s % 2), s)
        table = ref_pe.query_table(q_edges, q_labels, 2, length)
        got = ref_pe.candidates(data, table, 1e-6)
        want = _brute_candidates(offsets, neighbors, labels, data.vde, table,
                                 1e-6)
        assert [list(c) for c in got] == [list(c) for c in want]


@pytest.mark.parametrize("tree", [True, False])
def test_reference_count_equals_brute_force(tree):
    edges, labels = gen.powerlaw_graph(40, 90, 2, 0.8, 7, 10)
    offsets, neighbors = gen.csr(40, edges)
    data = ref_pe.Data(offsets, neighbors, labels, 2)
    for s in range(3):
        q_edges, q_labels = gen.sample_query(offsets, neighbors, labels, 4,
                                             tree, s)
        table = ref_pe.query_table(q_edges, q_labels, 2, 3)
        cands = ref_pe.candidates(data, table, 1e-6)
        q_deg = np.bincount(q_edges.ravel(), minlength=len(q_labels))
        root = ref_graph.first_vertex(cands, q_deg)
        for cap in (5, 10 ** 6):
            got = ref_graph.count_answers(offsets, neighbors, labels, q_edges,
                                          q_labels, cands, cap,
                                          rows_per_step=7)
            assert got == _brute_count(offsets, neighbors, labels, q_edges,
                                       q_labels, cands[root], root, cap)


def test_reference_query_plan_is_the_greedy_cover():
    # A path 0-1-2-3 with a leaf 4 on 1: degrees 1, 3, 2, 1, 1.
    q_edges = np.array([[0, 1], [1, 2], [2, 3], [1, 4]])
    paths = ref_pe.query_paths(q_edges, 5, 3)
    assert paths.tolist() == [[0, 1, 2], [0, 1, 4], [1, 2, 3], [2, 1, 4]]
    deg = np.array([1, 3, 2, 1, 1])
    # weights 6, 5, 6, 6: [0,1,2] first, then [1,2,3] adds 3, [2,1,4] adds 4.
    assert ref_pe.plan(paths, deg, 5).tolist() == [0, 2, 3]


# ---- the harness's CPU form ------------------------------------------

@pytest.mark.parametrize("loop", ["online", "batch"])
@pytest.mark.parametrize("traced", [False, True])
def test_cpu_form_runs_a_cell_and_is_correct(loop, traced):
    res = run_cpu(loop, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert res["attempted"] % TINY["query_set"] == 0      # whole passes
    cell = tiny_cell(loop)
    want = cell.per_layer if traced else cell.end_to_end
    got = res["metrics"]
    if traced:
        assert set(got) <= {m["name"] for m in want}
        assert {"build_s", f"device_idle_pct.{loop}",
                f"refine_ms.{loop}", f"blocks_survived.{loop}"} <= set(got)
        assert "search_roofline" not in got      # no device time on the CPU
        assert res["device"]["window_s"] > 0
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(got) == {m["name"] for m in want}
        assert all(v["value"] > 0 for v in got.values())
    assert res["device"]["platform"] == "cpu"
    assert list(res["checks"]) == list(check.ORDER)


def test_every_seed_sends_the_same_calls_in_its_own_order():
    a, b = harness.cycle(32, 4, 11), harness.cycle(32, 4, 12)
    assert sorted(a) == sorted(b) == [list(range(k, k + 4))
                                      for k in range(0, 32, 4)]
    assert a != b and a == harness.cycle(32, 4, 11)
    with pytest.raises(ValueError):
        harness.cycle(30, 4, 1)


def test_closed_loop_counts_every_query_and_window():
    run = harness.Run(tiny_cell("online"))
    run.records = [dict(latency_ms=float(ms), timings={"search": 2.0 * ms})
                   for ms in range(1, 11)]
    run.calls = [dict(survived=4, blocks=10)] * 10
    run.window_s = 2.0
    assert harness.END_TO_END["qps"](run) == 5.0
    assert harness.END_TO_END["query_ms_p50"](run) == 5.5
    assert harness.END_TO_END["query_ms_p90"](run) == pytest.approx(9.1)
    assert spec.reader("search_ms.online")(run) == 11.0
    assert spec.reader("query_plan_ms.online")(run) is None
    assert spec.reader("blocks_survived.online")(run) == 4
    assert spec.reader("device_idle_pct.online")(run) is None
    run.trace = dict(busy_s=0.5, window_s=2.0,
                     range_kernel_s={"search": 1e-6})
    assert spec.reader("device_idle_pct.online")(run) == 75.0
    need = 10 * (3 * 6 * 4 + 3 * 4) + 4 * TINY["block_size"] * 3 * 4
    assert readers.search_roofline_pct(run) == pytest.approx(
        100 * 10 * need / 3.35e12 / 1e-6)


def test_trace_summary_splits_idle_time_by_host_range():
    ev = lambda cat, name, ts, dur, **kw: dict(ph="X", cat=cat, name=name,
                                               ts=ts, dur=dur, tid=1, **kw)
    events = [ev("user_annotation", "bench.window", 0, 100),
              ev("user_annotation", "search", 10, 30),
              ev("user_annotation", "refine", 50, 20),
              ev("cuda_runtime", "cudaLaunchKernel", 12, 1,
                 args={"correlation": 7}),
              ev("cuda_runtime", "cudaLaunchKernel", 60, 1,
                 args={"correlation": 8}),
              ev("kernel", "k1", 15, 10, args={"correlation": 7}),
              ev("kernel", "k2", 20, 10, args={"correlation": 8})]
    s = tracing.summarize(events)
    assert s["busy_s"] == pytest.approx(15e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["range_kernel_s"]["search"] == pytest.approx(10e-6)
    idle = dict(s["idle_gaps"])
    assert idle["search"] == pytest.approx(15e-6)
    assert idle["refine"] == pytest.approx(20e-6)
    assert idle["bench.loop"] == pytest.approx(50e-6)
    assert dict(s["device_ops"]) == {"k1": pytest.approx(10e-6),
                                     "k2": pytest.approx(10e-6)}


def test_the_plan_is_read_from_host_arrays_and_tensors_alike():
    import torch
    from types import SimpleNamespace
    from benchmark.engines import Unreadable, pe as pe_engine
    vids = np.array([[0, 1, 2], [8, 9, 10], [1, 2, 3], [9, 10, 11]])
    pde = np.arange(24, dtype=np.float64).reshape(4, 6)
    rows = np.array([0, 1, 3])
    on_host = SimpleNamespace(pde=SimpleNamespace(vids=vids, pde=pde),
                              plan_rows=rows)
    as_tensors = SimpleNamespace(
        pde=SimpleNamespace(vids=torch.from_numpy(vids),
                            pde=torch.from_numpy(pde)),
        plan_rows=torch.from_numpy(rows))
    for query in (on_host, as_tensors):
        got_vids, got_pde = pe_engine.planned(query, 8, 16)
        assert got_vids.tolist() == [[0, 1, 2], [1, 2, 3]]
        assert np.array_equal(got_pde, pde[[1, 3]])
    with pytest.raises(Unreadable):
        pe_engine.planned(SimpleNamespace(pde=on_host.pde), 0, 8)
    with pytest.raises(Unreadable):
        pe_engine.data_vde(SimpleNamespace())


def test_a_plan_it_cannot_read_ends_the_run_with_no_result(monkeypatch,
                                                           capsys):
    from benchmark import run as bench_run
    from benchmark.engines import Unreadable, pe as pe_engine

    def planned(query, lo, hi):
        raise Unreadable("the search's query table: renamed")
    monkeypatch.setattr(pe_engine, "planned", planned)
    with pytest.raises(Unreadable):
        run_cpu("online")

    def run(*args, **kwargs):
        raise Unreadable("the search's query table: renamed")
    monkeypatch.setattr(harness, "run", run)
    rc = bench_run.main(["--workload", BENCH["workloads"][0]["name"],
                         "--seed", "5", "--seconds", "1", "--trace", "0"])
    assert rc == 4
    assert capsys.readouterr().out == ""


def test_host_probe_times_its_fixed_work():
    assert harness.host_probe_ms() > 0


# ---- what has to come out not correct --------------------------------

def _alter_count(monkeypatch):
    import gnnpe_tpu_torch.engine as engine
    inner = engine.refinement
    monkeypatch.setattr(engine, "refinement",
                        lambda *a, **k: inner(*a, **k) + 1)


def _drop_candidate(monkeypatch):
    from gnnpe_tpu_torch.index import device_packed
    inner = device_packed._PackedSearch.search

    def search(self, query, union="host"):
        out = inner(self, query, union)
        big = max(range(len(out)), key=lambda u: len(out[u]))
        out[big] = out[big][1:]
        return out
    monkeypatch.setattr(device_packed._PackedSearch, "search", search)


def _query_vde_in_f32(monkeypatch):
    import gnnpe_tpu_torch.engine as engine
    inner = engine._Engine._vde

    def vde(self, graph):
        v = inner(self, graph)
        if graph is not self.graph:
            v.vde = v.vde.astype(np.float32).astype(np.float64)
        return v
    monkeypatch.setattr(engine._Engine, "_vde", vde)


def _half_batch_left_out(monkeypatch):
    import gnnpe_tpu_torch.engine as engine
    inner = engine._Engine.online_many
    monkeypatch.setattr(engine._Engine, "online_many",
                        lambda self, qs, **k: inner(self, qs[:len(qs) // 2],
                                                    **k))


def _half_batch_answered_for_the_rest(monkeypatch):
    import gnnpe_tpu_torch.engine as engine
    inner = engine._Engine.online_many

    def online_many(self, qs, **k):
        half = inner(self, qs[:len(qs) // 2], **k)
        return half + half
    monkeypatch.setattr(engine._Engine, "online_many", online_many)


@pytest.mark.parametrize("loop,fault", [
    ("online", _alter_count), ("online", _drop_candidate),
    ("online", _query_vde_in_f32), ("batch", _alter_count),
    ("batch", _half_batch_left_out),
    ("batch", _half_batch_answered_for_the_rest)])
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, loop, fault):
    fault(monkeypatch)
    res = run_cpu(loop)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_control_in_float32_comes_out_not_correct():
    from benchmark import control
    numbers = control.control(tiny_cell("online"), SEED)
    assert not check.verdict(numbers, LIMITS)
    assert numbers["data_vde_gap"] > 1e-9 and numbers["query_pde_gap"] > 1e-9


def test_a_data_vde_off_by_a_part_in_1e9_comes_out_not_correct(monkeypatch):
    import gnnpe_tpu_torch.engine as engine
    inner = engine._Engine._vde

    def vde(self, graph):
        v = inner(self, graph)
        if graph is self.graph:
            v.vde = v.vde * (1 + 1e-9)
        return v
    monkeypatch.setattr(engine._Engine, "_vde", vde)
    assert run_cpu("online")["correct"] is False


# ---- JAX stays out, and the run needs its card and its program -------

def test_harness_process_loads_no_jax_module():
    code = ("import json, sys\n"
            "from benchmark.tests.test_bench_harness import run_cpu\n"
            "res = run_cpu('online', traced=True)\n"
            "assert res['correct']\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gnnpe_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_and_yardstick_import_nothing_of_the_program():
    files = list((ROOT / "benchmark" / "reference").glob("*.py"))
    files += [ROOT / "benchmark" / f for f in
              ("gen.py", "check.py", "roofline.py", "control.py")]
    for path in files:
        assert not _imports(path) & {"gnnpe_tpu_torch", *FORBIDDEN}, path


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, benchmark.harness as h\n"
         "from benchmark import spec\n"
         "cell = spec.cell(__import__('pathlib').Path.cwd(), "
         f"{BENCH['workloads'][0]['name']!r})\n"
         "h.run(cell, 1, 0.1, False, device='cpu')\n"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "gnnpe_tpu_torch" in out.stderr


# ---- on the card -----------------------------------------------------

@pytest.mark.cuda
def test_first_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    name = BENCH["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
