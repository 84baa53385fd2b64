"""The control of the comparison that decides ``correct``: the plain
reference computed in float32, the precision below the float64 that the
configuration states, put in the program's place and compared as a run
compares the program.  It has to come out not correct.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3

makes the graph and the query set as a run does, draws as many queries
as a run checks from the seed's stream, and prints one JSON line per
seed: the numbers compared and whether they pass the configuration's
limits.  It needs no card and imports nothing of the program.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np

from benchmark import check as checking
from benchmark import gen, spec
from benchmark.harness import SAMPLE, inputs
from benchmark.reference import graph as ref_graph


def control(cell: spec.Cell, seed: int) -> dict:
    """The compared numbers of the float32 reference against the float64
    one, on the sample of the query set that a run with ``seed`` checks."""
    cfg, mix = cell.config, cell.mix
    length = cfg["l"] + 1
    ref = spec.reference(cfg["variant"])
    _, labels, offsets, neighbors, queries = inputs(cfg, mix)
    data = ref.Data(offsets, neighbors, labels, cfg["e"])
    low = ref.Data(offsets, neighbors, labels, cfg["e"], np.float32)
    # The draw a run makes among its completed queries, over the set.
    checked = checking.sample(
        [dict(pool=i, latency_ms=0.0, answer=0) for i in range(len(queries))],
        mix["check"], gen.derive_seed(seed, SAMPLE))
    for rec in checked:
        q_edges, q_labels = queries[rec["pool"]]
        table = ref.query_table(q_edges, q_labels, cfg["e"], length,
                                   np.float32)
        rec["candidates"] = ref.candidates(low, table, cfg["epsilon"])
        rec["answer"] = ref_graph.count_answers(
            offsets, neighbors, labels, q_edges, q_labels,
            rec["candidates"], cfg["max_answers"])
        rec["plan_vids"], rec["plan_pde"] = table["vids"], table["pde"]
    return checking.compare(cfg, ref, data, queries, checked, low.vde, 0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(pathlib.Path.cwd(), args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = control(cell, seed)
        print(json.dumps(dict(
            workload=cell.name, seed=seed, numbers=numbers,
            correct=checking.verdict(numbers, cell.config["limits"]),
            seconds=time.perf_counter() - t)), flush=True)


if __name__ == "__main__":
    main()
