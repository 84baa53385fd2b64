"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference (``benchmark/reference/``), which works
everything out again from the same generated graph and queries.

Compared, for a sample of the queries that the window completed (drawn
from the seed, with the slowest of them in it), and each number held to
its limit from the configuration's ``limits``:

  * ``data_vde_gap``: the widest relative gap between the data graph's
    VDE the program built its index from and the reference's;
  * ``query_pde_gap``: the same over the query paths' PDE that the
    program's search was handed (its query plan, on kernel A1);
  * ``plan_mismatch``: queries whose planned paths differ;
  * ``cand_mismatch``: query vertices whose candidate set differs;
  * ``count_mismatch``: queries whose answer count differs;
  * ``failed``: queries whose call raised;
  * ``unchecked``: 1 where no query was compared at all.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np

from benchmark.reference import graph as ref_graph

ORDER = ("data_vde_gap", "query_pde_gap", "plan_mismatch", "cand_mismatch",
         "count_mismatch", "failed", "unchecked")


def rel_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """max |prog - ref| / |ref| (VDE entries are positive); inf where
    the shapes differ."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        return float("inf")
    if not ref.size:
        return 0.0
    return float((np.abs(prog - ref) / np.abs(ref)).max())


def sample(records: List[dict], count: int, seed: int) -> List[dict]:
    """Up to ``count`` completed queries, one per query of the set (its
    index is ``pool``): the slowest and a draw from ``seed`` among the
    rest."""
    first = {}
    for r in records:
        if r.get("answer") is not None:
            first.setdefault(r["pool"], r)
    if not first:
        return []
    slowest = max(first.values(), key=lambda r: r["latency_ms"])
    rest = sorted(k for k in first if k != slowest["pool"])
    pick = np.random.RandomState(seed).permutation(len(rest))[:count - 1]
    return [slowest] + [first[rest[i]] for i in sorted(pick)]


def compare(config: dict, ref, data, queries, checked: List[dict],
            program_vde: np.ndarray, failed: int) -> dict:
    """Every number of ORDER for the ``checked`` records (each with the
    query's pool index, its candidates, answer and planned rows as the
    search got them: ``plan_vids`` and ``plan_pde``, None where they
    could not be read).  ``ref`` is the configuration's variant's
    reference module (``spec.reference``) and ``data`` its ``Data``;
    ``queries[pool]`` the (edges, labels) of each query of the set.  The
    control hands a second reference's records in the program's place."""
    length = config["l"] + 1
    t0, spent = time.perf_counter(), 0.0
    out = dict(data_vde_gap=rel_gap(program_vde, data.vde),
               query_pde_gap=0.0, plan_mismatch=0, cand_mismatch=0,
               count_mismatch=0, failed=int(failed),
               unchecked=int(not checked))
    for rec in checked:
        q_edges, q_labels = queries[rec["pool"]]
        table = ref.query_table(q_edges, q_labels, config["e"], length)
        vids, pde = rec.get("plan_vids"), rec.get("plan_pde")
        if (vids is None or np.shape(vids) != table["vids"].shape
                or not np.array_equal(vids, table["vids"])):
            out["plan_mismatch"] += 1
        else:
            out["query_pde_gap"] = max(out["query_pde_gap"],
                                       rel_gap(pde, table["pde"]))
        cands = ref.candidates(data, table, config["epsilon"])
        prog = rec["candidates"]
        out["cand_mismatch"] += abs(len(prog) - len(cands)) + sum(
            1 for u in range(min(len(prog), len(cands)))
            if not np.array_equal(np.asarray(prog[u], np.int64), cands[u]))
        t = time.perf_counter()
        answer = ref_graph.count_answers(
            data.offsets, data.neighbors, data.labels, q_edges, q_labels,
            cands, config["max_answers"])
        spent += time.perf_counter() - t
        out["count_mismatch"] += int(answer != rec["answer"])
    print(f"reference: {len(checked)} queries in "
          f"{time.perf_counter() - t0:.1f} s, {spent:.1f} s of it counting",
          file=sys.stderr)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in ORDER)


def report(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit, as the last lines on standard error
    and as the result line's last key."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in ORDER}
    for k, row in rows.items():
        print(f"check {k}: {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    return rows
