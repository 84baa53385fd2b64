#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gnnpe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the CUDA kernels from gnnpe_tpu_torch/csrc (and the host C++
   refinement engine).
3. Kernel phase: the neighbour-sum SpMM against its plain PyTorch
   version on the card, on the dblp-rung graph — f64 at the VDE width
   (D=2) and f32 at D=128 — required bit-equal (both add in the same
   order), with both times.
4. PE phase: the exact online query at the dblp rung (317,080 vertices,
   1,049,866 edges; PE -l 2, 3-vertex paths, 512-entry blocks, answers
   capped at 100,000): 8 tree queries of 8 vertices through ``online``
   (host union, then device union), then all 8 at once through
   ``online_many`` with the device union.
5. PGE phase: the same graph and queries with PGE -l 2.

The card's f64 data-graph VDE must equal gnnpe_tpu's numpy ``gen_vde``
(re-exported as ``gen_vde_host``).  Every query's candidates must equal
the flat f64 host filter, run on that numpy VDE for the data graph and
every query (so it shares no code with the port's VDE, the packed index
or the kernel), and every answer count must equal native refinement on
those candidates.  The kernel's launch count over each phase's engine
run must be > 0, and the index tensors must live on the card.  Any
failure exits non-zero.  The full record is printed as one
``record: {...}`` line; the second-to-last line is the kernels record,
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np

MAX_ANSWERS = 100_000
QUERY_SEEDS = range(8)
QUERY_SIZE = 8
BLOCK_SIZE = 512


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_phase(record) -> None:
    from gnnpe_tpu_torch.graph.csr import CSRGraph
    from gnnpe_tpu_torch.kernels import _build
    from gnnpe_tpu_torch.match.refine import refinement
    t0 = time.perf_counter()
    so = _build.build("spmm_csr")
    _build.load("spmm_csr")
    record["build_s"] = {"spmm_csr": time.perf_counter() - t0}
    print(f"built spmm_csr in {record['build_s']['spmm_csr']:.2f} s: {so}")
    log = so.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())
    t0 = time.perf_counter()
    tri = CSRGraph.from_edges(3, np.array([[0, 1], [1, 2], [0, 2]]),
                              np.zeros(3, np.int64))
    check(refinement(tri, tri, [np.arange(3)] * 3,
                     engine="native") == 6, "native refinement on a triangle")
    record["build_s"]["native_refine"] = time.perf_counter() - t0
    print(f"native refinement ready in "
          f"{record['build_s']['native_refine']:.2f} s")


def kernel_phase(g, device, record) -> dict:
    """spmm_csr against neighbor_sum_plain on the card; returns the f64
    D=2 (main-path shape) row of the kernels record."""
    import torch
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.ops import spmm
    from gnnpe_tpu_torch.ops.mt19937 import label_feature_table
    off, nbr, labels, _ = to_device(g, device)
    table = torch.from_numpy(label_feature_table(g.labels_count, 2))
    inputs = {
        "f64_d2": table.to(device)[labels.long()],
        "f32_d128": torch.from_numpy(np.random.RandomState(0).rand(
            g.num_vertices, 128).astype(np.float32)).to(device),
    }
    rows = {}
    for name, x in inputs.items():
        nx, vde = spmm.neighbor_sum(off, nbr, x, with_vde=True)
        plain = spmm.neighbor_sum_plain(off, nbr, x)
        torch.cuda.synchronize()
        err = float((nx - plain).abs().max())
        check(torch.equal(nx, plain) and torch.equal(vde, x + plain),
              f"spmm_csr {name} differs from its plain version "
              f"(max abs err {err})")

        def kern():
            spmm.neighbor_sum(off, nbr, x)

        def plain_fn():
            spmm.neighbor_sum_plain(off, nbr, x)

        # Turns within one call: plain, kernel, kernel, plain.
        p1, k1, k2, p2 = (cuda_ms(plain_fn, 5), cuda_ms(kern, 50),
                          cuda_ms(kern, 50), cuda_ms(plain_fn, 5))
        rows[name] = dict(max_abs_err=err, ms=(k1 + k2) / 2,
                          plain_ms=(p1 + p2) / 2, turns_ms=[p1, k1, k2, p2],
                          bytes_gathered=int(nbr.numel() * x.shape[1]
                                             * x.element_size()))
        print(f"spmm_csr {name}: bit-equal to plain; kernel "
              f"{rows[name]['ms']:.4f} ms, plain {rows[name]['plain_ms']:.4f}"
              f" ms (plain, kernel, kernel, plain = {p1:.4f}, {k1:.4f}, "
              f"{k2:.4f}, {p2:.4f})")
    record["kernel"] = rows
    return rows


def _percentiles(vals):
    return {"p50": float(np.percentile(vals, 50)),
            "p90": float(np.percentile(vals, 90))}


def _drive(eng, queries, device, wall, prefix, block_size):
    """The main path: offline, index, upload, online x N, online_many."""
    with wall.stage(f"{prefix}.offline"):
        eng.offline()
    with wall.stage(f"{prefix}.build_index"):
        eng.build_index(block_size=block_size)
    with wall.stage(f"{prefix}.attach_device"):
        eng.attach_device(device)
    runs = {"online": [], "online_device_union": []}
    survived = []
    for q in queries:
        runs["online"].append(eng.online(q))
        survived.append(eng.searcher.last_stats["survived"])
        runs["online_device_union"].append(eng.online(q, union="device"))
    with wall.stage(f"{prefix}.online_many"):
        runs["online_many"] = eng.online_many(queries, union="device")
    return runs, survived


def _summarise(prefix, eng, runs, survived, wall, launches,
               record) -> None:
    tensors = eng.searcher.resident_tensors()
    devices = sorted({str(t.device) for t in tensors.values()})
    single = runs["online"]
    n = len(single)
    rec = dict(wall_ms=wall.times_ms)
    for how in ("online", "online_device_union"):
        rec[f"{how}_ms"] = _percentiles(
            [sum(r.timings_ms.values()) for r in runs[how]])
        rec[f"{how}_stage_ms"] = {
            k: _percentiles([r.timings_ms[k] for r in runs[how]])
            for k in ("query_plan", "search", "refine")}
    rec.update(
        online_many_qps=n / (wall.times_ms[f"{prefix}.online_many"] / 1e3),
        blocks=eng.searcher.num_blocks,
        blocks_survived=_percentiles(survived),
        index_bytes=int(sum(t.numel() * t.element_size()
                            for t in tensors.values())),
        index_devices=devices, spmm_launches=launches,
        answers=[r.answer_count for r in single],
        candidates=[int(sum(map(len, r.candidates))) for r in single])
    if prefix == "pe":
        rec["paths"] = int(eng.paths.shape[0])
    record[prefix] = rec
    print(f"{prefix}: " + json.dumps(rec))


def _engine_phase(prefix, eng, queries, device, record, block_size):
    """Runs ``_drive`` with the kernel's launch count set to 0 just
    before and read just after; returns (runs, launches)."""
    from gnnpe_tpu_torch.ops import spmm
    from gnnpe_tpu_torch.utils.timers import StageTimer
    wall = StageTimer(device)
    spmm.LAUNCHES = 0
    runs, survived = _drive(eng, queries, device, wall, prefix, block_size)
    launches = spmm.LAUNCHES
    _summarise(prefix, eng, runs, survived, wall, launches, record)
    check(launches > 0, f"{prefix} phase launched no spmm_csr kernel")
    check(record[prefix]["index_devices"] == [str(eng.searcher.device)],
          f"{prefix} index tensors on {record[prefix]['index_devices']}")
    return runs, launches


def _check_query(prefix, i, runs, want, count) -> None:
    """Query ``i`` of every run equals the oracle's candidates and
    answer count."""
    for how, rs in runs.items():
        r = rs[i]
        check(len(r.candidates) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(r.candidates, want)),
            f"{prefix} query {i} {how}: candidates differ from the oracle")
        check(r.answer_count == count,
              f"{prefix} query {i} {how}: {r.answer_count} answers, oracle "
              f"{count}")


def _checked_host_vde(g, cfg, eng, device):
    """gnnpe_tpu's numpy VDE of ``g``, after checking that the engine's
    VDE (computed on ``device``) equals it bit for bit."""
    from gnnpe_tpu_torch.embed.vde import gen_vde_host
    host = gen_vde_host(g, cfg.vde_dim)
    for name in ("x", "nx", "vde"):
        check(np.array_equal(getattr(host, name), getattr(eng.vertices, name)),
              f"data-graph VDE {name} on {device} differs from numpy's")
    return host


def pe_phase(g, queries, device, record, block_size=BLOCK_SIZE) -> int:
    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.embed.pde import gen_query_pde_table
    from gnnpe_tpu_torch.embed.vde import gen_vde_host
    from gnnpe_tpu_torch.engine import PEEngine
    from gnnpe_tpu_torch.match.filter import pe_candidates_chunked
    from gnnpe_tpu_torch.match.plan import greedy_path_cover
    from gnnpe_tpu_torch.match.refine import refinement
    from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
    cfg = PEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS)
    eng = PEEngine(cfg, g, device)
    runs, launches = _engine_phase("pe", eng, queries, device, record,
                                   block_size)

    host = _checked_host_vde(g, cfg, eng, device)
    for i, q in enumerate(queries):
        q_paths, _ = enumerate_paths(q, np.arange(q.num_vertices),
                                     cfg.path_length, dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde_host(q, cfg.vde_dim),
                                               q_paths)
        plan = greedy_path_cover(q_paths, weight, q.num_vertices)
        want = pe_candidates_chunked(host, eng.paths, q_pde, plan,
                                     q.num_vertices, epsilon=cfg.epsilon)
        count = refinement(g, q, want, cfg.max_answers, engine="native")
        _check_query("pe", i, runs, want, count)
    print(f"pe: {len(queries)} queries x {sorted(runs)} equal the "
          "flat f64 oracle and native refinement")
    return launches


def pge_phase(g, queries, device, record, block_size=BLOCK_SIZE) -> int:
    from gnnpe_tpu_torch.config import PGEConfig
    from gnnpe_tpu_torch.embed.pde import path_groups
    from gnnpe_tpu_torch.embed.vde import gen_vde_host
    from gnnpe_tpu_torch.engine import PGEEngine
    from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
    from gnnpe_tpu_torch.match.filter import pge_candidates_chunked
    from gnnpe_tpu_torch.match.refine import refinement
    from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
    cfg = PGEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS)
    eng = PGEEngine(cfg, g, device)
    runs, launches = _engine_phase("pge", eng, queries, device, record,
                                   block_size)

    host = _checked_host_vde(g, cfg, eng, device)
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), cfg.path_length,
                               dedup=False)
    group, lgroup = path_groups(host, paths[:, 0], paths, cfg.pde_dim)
    for i, q in enumerate(queries):
        qv = gen_vde_host(q, cfg.vde_dim)
        q_paths, _ = enumerate_paths(q, np.arange(q.num_vertices),
                                     cfg.path_length, dedup=False)
        q_group, q_lgroup = path_groups(qv, q_paths[:, 0], q_paths,
                                        cfg.pde_dim)
        want = pge_candidates_chunked(
            host.labels, host.degrees, group, lgroup, qv.labels, qv.degrees,
            q_group, q_lgroup, list(range(q.num_vertices)),
            epsilon=cfg.epsilon)
        count = refinement(g, q, want, cfg.max_answers, engine="native")
        _check_query("pge", i, runs, want, count)
    print(f"pge: {len(queries)} queries x {sorted(runs)} equal the "
          "flat f64 oracle and native refinement")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from gnnpe_tpu_torch.io.datasets import load_dataset, sample_query

    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    build_phase(record)
    t0 = time.perf_counter()
    g = load_dataset("dblp", seed=0)
    queries = [sample_query(g, QUERY_SIZE, seed=s) for s in QUERY_SEEDS]
    record["data_s"] = time.perf_counter() - t0
    print(f"dblp: |V| {g.num_vertices}, |E| {g.num_edges}, labels "
          f"{g.labels_count}, max degree {g.max_degree} "
          f"({record['data_s']:.1f} s)")

    rows = kernel_phase(g, device, record)
    torch.cuda.reset_peak_memory_stats()
    launches = pe_phase(g, queries, device, record)
    record["pe"]["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches += pge_phase(g, queries, device, record)
    record["pge"]["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    check("jax" not in sys.modules, "the port imported jax")

    print("record: " + json.dumps(record))
    main_row = rows["f64_d2"]
    print(json.dumps({"kernels": [{
        "name": "spmm_csr", "route": "cuda",
        "source": "gnnpe_tpu_torch/csrc/spmm_csr.cu",
        "replaces": "experiments/pallas_spmm.py:181",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
