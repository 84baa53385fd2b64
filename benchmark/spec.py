"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/mixes/<traffic>.json``), the readers of its per-layer
metrics (``benchmark/metrics/<metric>.py``), and the configuration's
variant: how the engine is built and read (``benchmark/engines/<variant>.py``)
and its plain reference (``benchmark/reference/<variant>.py``).
Everything is found by the name ``BENCHMARK.json`` or the configuration
gives it, so a new cell, configuration, variant, mix or metric is new
files and entries, never an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, List

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]      # the entries this cell reports
    per_layer: List[dict]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files
    loaded; raises KeyError for a name it does not list."""
    bench = load_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(workload, entry["chips"], config(entry["config"]),
                mix(entry["traffic"]), e2e, layer)


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(HERE / "mixes" / f"{name}.json")


def engine(variant: str) -> ModuleType:
    """``benchmark/engines/<variant>.py``: ``build(cfg, graph, device)``,
    ``data_vde(engine)`` and ``planned(query, lo, hi)``."""
    return importlib.import_module(f"benchmark.engines.{variant}")


def reference(variant: str) -> ModuleType:
    """``benchmark/reference/<variant>.py``: ``Data``, ``query_table``
    and ``candidates``."""
    return importlib.import_module(f"benchmark.reference.{variant}")


def reader_path(metric: str) -> pathlib.Path:
    """``benchmark/metrics/<metric>.py``, or where there is none the file
    of the quantity, the name before its first dot: ``refine_ms.online``
    and ``refine_ms.batch`` both read ``refine_ms.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    return path if path.exists() else (
        HERE / "metrics" / f"{metric.split('.')[0]}.py")


def reader(metric: str) -> Callable:
    """``read(run)`` of the metric's file (``reader_path``): the metric's
    value from a run's records, or None where it finds nothing."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
