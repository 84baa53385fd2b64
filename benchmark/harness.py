"""One run of one cell: set-up, the measured window, the check, and the
result line.

  set-up   the configuration's data graph and query set (the frozen
           generators of ``benchmark/gen.py``), the engine built through
           its public offline path, a few warm-up calls; ``setup_s`` runs
           from the process's start to the first timed query;
  window   a closed loop through the engine's public serving call with
           the program's own defaults: ``online(q)`` one query at a
           time, or ``online_many(batch)`` one batch at a time, over the
           whole set in an order drawn from the seed, pass after pass
           until a pass ends ``seconds`` or more after the start.  With
           ``traced`` it runs under the profiler;
  check    ``benchmark/check.py`` on a sample of the completed queries,
           after the peak memory is read and the engine is freed.

The program is imported here and in ``benchmark/engines/<variant>.py``,
which builds the engine and reads back what its timed path derived, and
nowhere else in the benchmark.  Before the window and after it, outside
both metrics, ``host_probe_ms`` times a fixed piece of host work like
the search's union, so that a run's standard error says how fast its
host was."""

from __future__ import annotations

import gc
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from benchmark import check as checking
from benchmark import gen, spec
from benchmark import trace as tracing

QUERIES, ORDER, SAMPLE = 1, 2, 3       # streams of a seed


class NoDevice(RuntimeError):
    """The run asked for CUDA devices that are not there."""


@dataclass
class Run:
    """What the metric readers read: the cell, every completed call's
    records, the search's counters, set-up times and the trace's
    summary (None in an untraced run)."""
    cell: spec.Cell
    records: List[dict] = field(default_factory=list)
    calls: List[dict] = field(default_factory=list)
    setup: dict = field(default_factory=dict)
    window_s: float = 0.0
    trace: Optional[dict] = None


class _Probe:
    """Wraps the engine's searcher so that each ``search`` call leaves
    the query it was handed and its ``last_stats`` counters (both the
    program's public serving state: ``search(query)`` and
    ``last_stats``)."""

    def __init__(self, searcher):
        self.calls = []
        inner = searcher.search

        def search(query, *args, **kwargs):
            out = inner(query, *args, **kwargs)
            self.calls.append(dict(query=query,
                                   stats=dict(searcher.last_stats or {})))
            return out

        searcher.search = search


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_probe_ms() -> float:
    """Ms of a fixed piece of single-threaded host work like the search's
    host union: a random gather of 2**20 values from a 64 MiB table and
    their sorted unique values."""
    rng = np.random.RandomState(0)
    table = rng.randint(0, 2 ** 30, 2 ** 24).astype(np.int32)
    rows = rng.randint(0, len(table), 2 ** 20)
    t = time.perf_counter()
    np.unique(table[rows])
    return (time.perf_counter() - t) * 1e3


def inputs(cfg: dict, mix: dict):
    """The configuration's data graph (edges, labels, and its
    ``gen.csr`` offsets and neighbours) and its query set [(edges,
    labels)] in the mix's shape.  Both come from the configuration's
    seeds, not the run's: a deployment serves one graph, and the run's
    seed changes the order in which the set is sent and the sample that
    is checked, so that every run does the same work."""
    edges, labels = gen.powerlaw_graph(
        cfg["vertices"], cfg["edges"], cfg["labels"], cfg["alpha"],
        cfg["graph_seed"], cfg["max_degree"])
    offsets, neighbors = gen.csr(cfg["vertices"], edges)
    rng = np.random.RandomState(gen.derive_seed(cfg["query_seed"], QUERIES))
    queries = [gen.sample_query(offsets, neighbors, labels,
                                mix["query_vertices"], mix["tree"], int(s))
               for s in rng.randint(0, 2 ** 31 - 1, cfg["query_set"])]
    return edges, labels, offsets, neighbors, queries


def cycle(n: int, batch: int, seed: int) -> List[List[int]]:
    """One pass over a set of ``n`` queries: calls of ``batch``
    consecutive queries, the calls in an order drawn from ``seed``."""
    if n % batch:
        raise ValueError(f"a set of {n} queries in calls of {batch}")
    calls = [list(range(k, k + batch)) for k in range(0, n, batch)]
    order = np.random.RandomState(gen.derive_seed(seed, ORDER)).permutation(
        len(calls))
    return [calls[k] for k in order]


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """The result of one run, as the last line prints it.  ``device`` is
    "cuda" for every run of the benchmark; the tests ask for "cpu" by
    name.  Raises ``NoDevice`` where CUDA is asked for and the cell's
    cards are not there."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise NoDevice(f"cell {cell.name} needs {cell.chips} CUDA "
                       f"device(s); torch.cuda.is_available() is "
                       f"{torch.cuda.is_available()}")
    from gnnpe_tpu_torch.graph.csr import CSRGraph
    from gnnpe_tpu_torch.utils.device import as_device
    dev = as_device(device)
    cfg, mix = cell.config, cell.mix
    out = Run(cell)

    t = time.perf_counter()
    edges, labels, offsets, neighbors, queries = inputs(cfg, mix)
    graph = CSRGraph.from_edges(cfg["vertices"], edges, labels)
    pool = [CSRGraph.from_edges(len(ql), qe, ql) for qe, ql in queries]
    out.setup["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    variant = spec.engine(cfg["variant"])
    eng = variant.build(cfg, graph, dev)
    _sync(dev)
    out.setup["build_s"] = time.perf_counter() - t

    probe = _Probe(eng.searcher)
    serve = {"online": lambda qs: [eng.online(qs[0])],
             "batch": eng.online_many}[mix["loop"]]
    calls = cycle(len(pool), mix["batch"], seed)
    # Warm-up: the first ``warmup`` queries of the order, in calls of at
    # most ``batch`` (they load the kernels' libraries and refinement's).
    first = [j for idx in calls for j in idx][:mix["warmup"]]
    for k in range(0, len(first), mix["batch"]):
        serve([pool[j] for j in first[k:k + mix["batch"]]])
    _sync(dev)
    probe.calls.clear()
    out.setup["setup_s"] = time.perf_counter() - t_start
    host_ms = [host_probe_ms()]

    attempted = failed = 0
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    label = "bench.query" if mix["loop"] == "online" else "bench.batch"
    with torch.profiler.record_function(tracing.WINDOW):
        # Whole passes over the set, until one ends past ``seconds``: each
        # run does the same work, whatever its seed.
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for idx in calls:
                attempted += len(idx)
                a, before = time.perf_counter(), len(probe.calls)
                try:
                    with torch.profiler.record_function(label):
                        results = serve([pool[j] for j in idx])
                except Exception:          # counted; the loop goes on
                    failed += len(idx)
                    traceback.print_exc(file=sys.stderr)
                    continue
                ms = (time.perf_counter() - a) * 1e3
                call = probe.calls[-1] if len(probe.calls) > before else None
                failed += len(idx) - len(results)
                base = 0
                for j, r in zip(idx, results):
                    n = pool[j].num_vertices
                    out.records.append(dict(
                        pool=j, latency_ms=ms, timings=dict(r.timings_ms),
                        answer=r.answer_count, candidates=r.candidates,
                        call=call, lo=base, hi=base + n))
                    base += n
        _sync(dev)
        out.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    host_ms.append(host_probe_ms())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out.calls = [c["stats"] for c in probe.calls]
    if prof is not None:
        t = time.perf_counter()
        events = tracing.export_events(prof)
        out.trace = tracing.summarize(events)
        print(f"trace: {len(events)} events read in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
        del prof, events

    program_vde = variant.data_vde(eng)
    checked = checking.sample(out.records, mix["check"],
                              gen.derive_seed(seed, SAMPLE))
    for rec in checked:
        rec["plan_vids"], rec["plan_pde"] = (
            variant.planned(rec["call"]["query"], rec["lo"], rec["hi"])
            if rec["call"] else (None, None))
    for rec in out.records:
        rec.pop("call")
    del eng, probe, serve, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = spec.reference(cfg["variant"])
    data = ref.Data(offsets, neighbors, labels, cfg["e"])
    numbers = checking.compare(cfg, ref, data, queries, checked,
                               program_vde, failed)
    correct = checking.verdict(numbers, cfg["limits"])

    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics={}, device=_device(dev, cell.chips, peak))
    if traced:
        result["device"].update(busy_s=out.trace["busy_s"],
                                window_s=out.trace["window_s"])
        for m in cell.per_layer:
            value = spec.reader(m["name"])(out)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value,
                                                    unit=m["unit"])
        result["breakdown"] = dict(device_ops=out.trace["device_ops"],
                                   idle_gaps=out.trace["idle_gaps"])
    elif out.records:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = dict(
                value=END_TO_END[m["name"]](out), unit=m["unit"])
    print(f"latencies_ms: {[round(r['latency_ms'], 1) for r in out.records]}",
          file=sys.stderr)
    print(f"setup: {out.setup}", file=sys.stderr)
    print(f"host_probe_ms: before {host_ms[0]!r} after {host_ms[1]!r}",
          file=sys.stderr)
    result["checks"] = checking.report(numbers, cfg["limits"])
    return result


def _device(dev, chips: int, peak: int) -> dict:
    import torch
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                    count=chips, memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def _latencies(run: Run) -> List[float]:
    return [r["latency_ms"] for r in run.records]


END_TO_END = {
    "setup_s": lambda run: run.setup["setup_s"],
    "query_ms_p50": lambda run: statistics.median(_latencies(run)),
    "query_ms_p90": lambda run: float(np.percentile(_latencies(run), 90)),
    "qps": lambda run: len(run.records) / run.window_s,
}
