"""What a traced run reads from the profiler's trace.

The window runs under ``torch.profiler`` (host and CUDA activity) inside
a ``bench.window`` range; the trace is exported as Chrome JSON into a
directory under TMPDIR, read once and deleted.  From it:

  * busy: the union of the device's kernel, copy and set intervals
    inside the window;
  * the device operations that took most time, by name;
  * the device's idle time, split by what the host was doing: the
    innermost of the engine's stage ranges open at that moment (its
    ``StageTimer`` opens ``query_plan``, ``search``, ``preverify``,
    ``refine``), else the harness's range around the serving call, else
    the loop between calls;
  * the device time of the kernels launched inside each named range (a
    launch and its kernel share the trace's correlation id).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List, Sequence, Tuple

import numpy as np

WINDOW = "bench.window"
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Innermost first: idle time goes to the first of these open at the time.
HOST_RANGES = ("query_plan", "search", "preverify", "refine",
               "bench.query", "bench.batch")
BETWEEN = "bench.loop"


def export_events(prof) -> list:
    """The profiler's events, by way of a Chrome trace in a directory of
    its own under TMPDIR that is removed before this returns."""
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return data["traceEvents"] if isinstance(data, dict) else data


def _merge(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted union of intervals [start, end), float[N, 2]."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    ends = np.maximum.reduceat(iv[:, 1], np.nonzero(new)[0])
    return np.stack([starts, ends], 1)


def _covered(union: np.ndarray, t: np.ndarray) -> np.ndarray:
    """bool per time: inside one of the disjoint sorted intervals."""
    i = np.searchsorted(union[:, 0], t, side="right") - 1
    ok = i >= 0
    return ok & (t < union[np.maximum(i, 0), 1])


def _spans(events, cat: Sequence[str], name=None) -> list:
    return [ev for ev in events if ev.get("ph") == "X"
            and ev.get("cat") in cat and (name is None or ev["name"] == name)]


def summarize(events: list, ranges: Sequence[str] = ("search",)) -> dict:
    """busy_s, window_s, device_ops and idle_gaps ([name, seconds], most
    first, at most 10 each), and ``range_kernel_s``: for each name in
    ``ranges``, the device time of the kernels launched inside it."""
    win = _spans(events, ("user_annotation",), WINDOW)
    if len(win) != 1:
        raise ValueError(f"{len(win)} {WINDOW} ranges in the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    gpu = _spans(events, GPU_CATS)
    iv = np.array([[ev["ts"], ev["ts"] + ev["dur"]] for ev in gpu],
                  float).reshape(-1, 2)
    iv = np.clip(iv, w0, w1)
    busy = _merge(iv[iv[:, 1] > iv[:, 0]])
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())

    ops: Dict[str, float] = {}
    for ev, (a, b) in zip(gpu, iv):
        if b > a:
            ops[ev["name"]] = ops.get(ev["name"], 0.0) + (b - a) / 1e6

    idle = _idle_by_host(events, busy, w0, w1)
    kernels = _spans(events, ("kernel",))
    return dict(
        busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6,
        device_ops=_top(ops), idle_gaps=_top(idle),
        range_kernel_s={r: _kernel_s_inside(events, kernels, r)
                        for r in ranges})


def _top(d: Dict[str, float]) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _idle_by_host(events, busy, w0, w1) -> Dict[str, float]:
    # Elementary pieces between every edge of the busy union and of the
    # host ranges; each idle piece goes to the innermost range over it.
    unions = {}
    for name in HOST_RANGES:
        sp = _spans(events, ("user_annotation",), name)
        unions[name] = _merge(np.array(
            [[ev["ts"], ev["ts"] + ev["dur"]] for ev in sp],
            float).reshape(-1, 2))
    edges = [np.array([w0, w1]), busy.ravel()]
    edges += [u.ravel() for u in unions.values()]
    t = np.unique(np.clip(np.concatenate(edges), w0, w1))
    mid, length = (t[1:] + t[:-1]) / 2, np.diff(t)
    free = ~_covered(busy, mid) if len(busy) else np.ones(len(mid), bool)
    out: Dict[str, float] = {}
    for name, union in unions.items():
        hit = free & _covered(union, mid) if len(union) else free & False
        if hit.any():
            out[name] = float(length[hit].sum()) / 1e6
        free &= ~hit
    if free.any():
        out[BETWEEN] = float(length[free].sum()) / 1e6
    return out


def _kernel_s_inside(events, kernels, name: str) -> float:
    ranges = _spans(events, ("user_annotation",), name)
    if not ranges or not kernels:
        return 0.0
    launches = _spans(events, LAUNCH_CATS)
    ids = set()
    by_tid: Dict[object, List[Tuple[float, int]]] = {}
    for ev in launches:
        cid = ev.get("args", {}).get("correlation")
        if cid is not None:
            by_tid.setdefault(ev["tid"], []).append((ev["ts"], cid))
    for tid, rows in by_tid.items():
        rows.sort()
        ts = np.array([r[0] for r in rows])
        cids = np.array([r[1] for r in rows])
        mine = [r for r in ranges if r["tid"] == tid]
        if not mine:
            continue
        lo = np.searchsorted(ts, [r["ts"] for r in mine], side="left")
        hi = np.searchsorted(ts, [r["ts"] + r["dur"] for r in mine],
                             side="right")
        mark = np.zeros(len(ts) + 1, np.int64)
        np.add.at(mark, lo, 1)
        np.add.at(mark, hi, -1)
        ids.update(cids[np.cumsum(mark)[:-1] > 0].tolist())
    return sum(ev["dur"] for ev in kernels
               if ev.get("args", {}).get("correlation") in ids) / 1e6
