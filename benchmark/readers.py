"""Helpers the per-layer readers under ``benchmark/metrics/`` share.  A
reader returns None where its run has nothing to read, and the metric
is then left out of the result line."""

from __future__ import annotations

from typing import Optional

from benchmark.roofline import PEAK_HBM_BYTES_PER_S, search_bytes


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def mean_stage(run, stage: str) -> Optional[float]:
    """Mean ms of an engine stage (``MatchResult.timings_ms``) over the
    window's queries that report it."""
    return mean(r["timings"][stage] for r in run.records
                if stage in r["timings"])


def mean_counter(run, key: str) -> Optional[float]:
    """Mean of a ``last_stats`` counter over the window's search calls."""
    return mean(c[key] for c in run.calls if key in c)


def device_idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def search_roofline_pct(run) -> Optional[float]:
    """The least time the search's bytes need at the card's peak rate,
    as a share of the device time of the kernels launched inside the
    engine's ``search`` ranges, over the traced window."""
    if run.trace is None:
        return None
    kernel_s = run.trace["range_kernel_s"].get("search", 0.0)
    calls = [c for c in run.calls if "survived" in c]
    if kernel_s <= 0 or not calls:
        return None
    need = sum(search_bytes(run.cell.config, c) for c in calls)
    return 100.0 * need / PEAK_HBM_BYTES_PER_S / kernel_s
