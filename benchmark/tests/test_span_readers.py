"""The readers of the index search's spans and copy counters, and of the
batch's shared stages: each the mean of its key over a run's search
calls (or queries), None where none has it; and the harness's CPU form
reports every one of them in a traced run of each mix.

    python -m pytest -q benchmark/tests/test_span_readers.py
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, spec
from benchmark.tests.test_bench_harness import SEED, tiny_cell

COUNTERS = {"search_filter_ms": "filter_ms",
            "search_phase2_ms": "phase2_ms",
            "search_copy_ms": "copy_ms",
            "search_extract_ms": "extract_ms",
            "search_copy_bytes": "copied_bytes",
            "search_hit_rows": "hit_rows"}
STAGES = {"search_ms.batch": "search", "query_plan_ms.batch": "query_plan"}
NEW = [f"{q}.{mix}" for q in COUNTERS for mix in ("online", "batch")]
NEW += list(STAGES)


@pytest.mark.parametrize("quantity,key", sorted(COUNTERS.items()))
def test_counter_reader_is_the_mean_over_search_calls(quantity, key):
    calls = [{key: 2.0, "survived": 3}, {"survived": 1}, {key: 7.0}]
    for mix in ("online", "batch"):
        read = spec.reader(f"{quantity}.{mix}")
        assert read(SimpleNamespace(calls=calls, records=[])) == 4.5
        assert read(SimpleNamespace(calls=[{"survived": 1}],
                                    records=[])) is None
        assert read(SimpleNamespace(calls=[], records=[])) is None


@pytest.mark.parametrize("metric,stage", sorted(STAGES.items()))
def test_batch_stage_reader_is_the_batch_value(metric, stage):
    # Every query of a batch carries the batch's value.
    records = ([{"timings": {stage: 30.0, "refine": 1.0}}] * 16
               + [{"timings": {stage: 10.0, "refine": 2.0}}] * 16)
    read = spec.reader(metric)
    assert read(SimpleNamespace(calls=[], records=records)) == 20.0
    assert read(SimpleNamespace(
        calls=[], records=[{"timings": {"refine": 1.0}}])) is None


@pytest.mark.parametrize("loop", ["online", "batch"])
def test_traced_cpu_run_reports_the_new_metrics(loop):
    cell = tiny_cell(loop)
    res = harness.run(cell, SEED, 0.5, True, device="cpu")
    assert res["correct"] is True
    want = {m["name"] for m in cell.per_layer} & set(NEW)
    assert len(want) == (6 if loop == "online" else 8)
    got = res["metrics"]
    assert want <= set(got)
    assert all(got[m]["value"] >= 0 for m in want)
    assert got[f"search_copy_bytes.{loop}"]["unit"] == "B"
    assert got[f"search_hit_rows.{loop}"]["unit"] == "rows"
