"""Profiling on torch.profiler: ``trace`` writes a Chrome trace holding
the ``annotate`` ranges and the engine's stage ranges, ``StageTimer``
sums its stages, and ``MetricsLog`` writes gnnpe_tpu's records (apart
from their time stamps)."""

import json

import numpy as np
import pytest
import torch

from gnnpe_tpu.utils import profiling as jax_profiling
from gnnpe_tpu.utils import timers as jax_timers
from gnnpe_tpu_torch.config import PGEConfig
from gnnpe_tpu_torch.engine import PGEEngine
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.utils import profiling
from gnnpe_tpu_torch.utils.timers import StageTimer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _names(path):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return {ev.get("name") for ev in events}


def test_trace_holds_annotations(tmp_path):
    x = torch.rand(64, 64)
    with profiling.trace(str(tmp_path / "t"), "cpu") as prof:
        with profiling.annotate("outer_range"):
            with profiling.annotate("inner_range", "cpu"):
                (x @ x).sum()
    assert prof.trace_path.startswith(str(tmp_path / "t"))
    names = _names(prof.trace_path)
    assert {"outer_range", "inner_range"} <= names
    assert any(e.key == "outer_range" for e in prof.key_averages())
    # A second trace into the same directory is a file of its own.
    with profiling.trace(str(tmp_path / "t"), "cpu") as again:
        x.sum()
    assert again.trace_path != prof.trace_path


def test_annotate_opens_a_range_only_under_a_profiler(tmp_path,
                                                     monkeypatch):
    opened, inner = [], torch.profiler.record_function

    def record_function(name, *args):
        opened.append(name)
        return inner(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    with profiling.annotate("untraced"):
        pass
    assert opened == []
    with profiling.trace(str(tmp_path), "cpu") as prof:
        with profiling.annotate("traced"):
            pass
    assert opened == ["traced"]
    assert "traced" in _names(prof.trace_path)


def test_engine_stages_are_ranges(tmp_path):
    g = powerlaw_graph(300, 1200, 4, seed=2, max_degree=40)
    q = sample_query(g, 4, seed=1)
    eng = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, "cpu").offline()
    eng.build_index(block_size=16).attach_device("cpu")
    with profiling.trace(str(tmp_path), "cpu") as prof:
        r = eng.online(q, preverify=1)
    stages = {"query_plan", "search", "preverify", "refine",
              "refine.order", "refine.prepare", "refine.explore"}
    assert stages <= set(r.timings_ms)
    assert stages <= _names(prof.trace_path)


def test_online_many_stages_are_ranges_on_the_calling_thread(tmp_path):
    """``online_many``'s stages are ranges on the thread that called it,
    refinement's too though its queries run in pool threads, and the
    search's three spans lie inside its ``search`` ranges."""
    import threading
    g = powerlaw_graph(300, 1200, 4, seed=2, max_degree=40)
    qs = [sample_query(g, 4, seed=s) for s in range(3)]
    eng = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, "cpu").offline()
    eng.build_index(block_size=16).attach_device("cpu")
    with profiling.trace(str(tmp_path), "cpu") as prof:
        rs = eng.online_many(qs)
    assert all(list(r.timings_ms) == ["query_plan", "search", "refine",
                                      "refine.order", "refine.prepare",
                                      "refine.explore"] for r in rs)
    with open(prof.trace_path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ranges = [ev for ev in events if ev.get("cat") == "user_annotation"]
    me = threading.get_native_id()
    here = {ev["name"] for ev in ranges if ev["tid"] == me}
    assert {"query_plan", "search", "refine"} <= here
    search = [ev for ev in ranges if ev["name"] == "search"]
    spans = [ev for ev in ranges if ev["name"].startswith("search.")]
    assert {ev["name"] for ev in spans} == {
        "search.filter", "search.phase2", "search.extract"}
    for ev in spans:
        assert any(s["tid"] == ev["tid"] and s["ts"] <= ev["ts"]
                   and ev["ts"] + ev["dur"] <= s["ts"] + s["dur"]
                   for s in search), ev["name"]


def test_stage_timer_total_and_repr():
    ours, theirs = StageTimer(), jax_timers.StageTimer()
    for t in (ours, theirs):
        for name in ("a", "b", "a"):
            with t.stage(name):
                pass
        t.times_ms = {"a": 1.5, "b": 2.25}
    assert ours.total_ms == theirs.total_ms == 3.75
    assert repr(ours) == repr(theirs) == "StageTimer(a=1.50ms, b=2.25ms)"


def test_metrics_log_matches_gnnpe_tpu(tmp_path):
    events = [("step", dict(loss=0.5, n=3)), ("done", {}),
              ("row", dict(name="x", vals=[1, 2], nested={"k": 1.0}))]
    logs = {}
    for side, mod in (("ours", profiling), ("theirs", jax_profiling)):
        path = str(tmp_path / f"{side}.jsonl")
        log = mod.MetricsLog(path)
        recs = [log.log(ev, **kw) for ev, kw in events]
        log.close()
        log.close()
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        assert lines == recs
        logs[side] = [{k: v for k, v in r.items() if k != "t"}
                      for r in lines]
        assert all(isinstance(r["t"], float) for r in lines)
    assert logs["ours"] == logs["theirs"]
    assert profiling.MetricsLog().log("x", a=1)["event"] == "x"


@pytest.mark.cuda
def test_trace_on_card(cuda_device, tmp_path):
    x = torch.rand(256, 256, device=cuda_device)
    with profiling.trace(str(tmp_path), cuda_device) as prof:
        with profiling.annotate("card_range", cuda_device):
            (x @ x).sum()
    with open(prof.trace_path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    assert any(ev.get("cat") == "kernel" for ev in events)
    assert "card_range" in {ev.get("name") for ev in events}
    assert np.isfinite(sum(ev.get("dur", 0) for ev in events))
