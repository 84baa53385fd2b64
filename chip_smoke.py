#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gnnpe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the CUDA kernels from gnnpe_tpu_torch/csrc (and the host C++
   refinement engine).
3. Kernel phase: the neighbour-sum SpMM (A1) against its plain PyTorch
   version on the card, on the dblp-rung graph — f64 at the VDE width
   (D=2) and f32 at D=128 — required bit-equal (both add in the same
   order); timed in turns plain, kernel, kernel, plain, beside one
   library call of the same function (``torch.sparse.mm`` of the CSR
   adjacency, which the port never calls), the kernel alone on the card
   (replayed from a CUDA graph) and with L2 flushed, its bound from the
   bytes, and the rate of the bytes it gathers.
4. PE phase: the exact online query at the dblp rung (317,080 vertices,
   1,049,866 edges; PE -l 2, 3-vertex paths, 512-entry blocks, answers
   capped at 100,000) over the host-built array-mode index: 8 tree
   queries of 8 vertices through ``online`` (host union, then device
   union), then all 8 at once through ``online_many`` with the device
   union.
5. PE table phase: the same queries over the table-mode index built on
   the card — ``offline(device=True)`` (device path enumeration and
   dedup) and ``build_index(table=True)`` (sort key, stable sort,
   permute-fold, one copy back).  Its paths must equal the host
   enumeration's rows; its resident bytes and build stage times are
   printed beside array mode's.  Then, outside the counted run: ``save``
   and ``load`` at full size must give the same index and answers; each
   device program of the build (enumeration, dedup, key, sort,
   permute-fold) is timed alone with CUDA events, and the copy of the
   vid table to the host into fresh pinned and fresh pageable memory
   by wall clock; and the two PE layouts' ``search`` times are compared
   on 64 more queries (seeds 100-163), in turns array, table, table,
   array, each union, with equal candidates required.
6. PGE phase: the same graph and queries with PGE -l 2 (host path
   groups).
7. PGE device phase: ``offline(device=True)`` — path groups folded on
   the card — whose groups must equal phase 6's bit for bit; the fold is
   timed alone with CUDA events.
8. A2 phase: the ELL gather-sum kernel on the dblp graph's binned
   layout — ``BinnedEllDevice.apply_perm`` (one launch per level of
   its launch plan) against the plan walked over ``gather_sum_plain``
   in f32 at the trainer's width (D=2) and D=128, required bit-equal;
   timed as in phase 3, the library call being
   ``torch.nn.functional.embedding_bag`` over the same tables (it
   leaves out the pad correction); the autograd backward of
   ``symmetric_aggregate`` and of A1's ``NeighborSum`` bit-equal to the
   forward of the cotangent.
9. Train phase: ``train_payoff.run`` at the dblp rung (PGE, D=2, 300
   steps, binned aggregation, 8 held-out queries).  A2 must launch
   ``launches_per_apply`` times in every step's forward and in its
   backward; every loss finite, the last below the first, and the first
   and last equal to the values earlier revisions of the port recorded
   for this seed; every trained answer equal to the fixed-VDE answer;
   every trained candidate set equal to the flat f64 host filter on the
   embedder's own VDE; the card's f64 trained VDE within rtol 1e-12 of
   a numpy forward of the same weights.  Then a 50-step
   ``aggregation="segment"`` fit from the same initial weights and
   batches (the binned run's first chunk) must track the binned loss
   history within rtol 1e-3.

The card's f64 data-graph VDE must equal the port's numpy
``gen_vde_host``.  Every query's candidates must equal the flat f64 host
filter, run on that numpy VDE for the data graph and every query (so it
shares no code with the torch VDE, the packed index or the kernels), and
every answer count must equal native refinement on
those candidates; the table and device phases share the oracle of the
phase before them.  Each kernel's launch count over the main path of
the phases that run it (A1: PE, PE table, PGE, PGE device and train;
A2: train) must be > 0, and the index tensors must live on the card.
At the end neither ``jax`` nor any module of ``gnnpe_tpu`` may have been
imported.  Any failure exits non-zero.  The full record is printed as one
``record: {...}`` line; the second-to-last line is the kernels record,
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time

import numpy as np

MAX_ANSWERS = 100_000
QUERY_SEEDS = range(8)
QUERY_SIZE = 8
MODE_QUERIES = range(100, 164)   # the PE layouts' search comparison
BLOCK_SIZE = 512
KERNELS = ("spmm_csr", "ell_gather_sum")
TRAIN_STEPS = 300
TRAIN_QUERIES = 8
SEGMENT_STEPS = 50        # the binned run's first chunk of batches
# First and last loss of the 300-step binned fit from seed 0, as the
# port's earlier revisions recorded them (4 digits): the kernels' sums
# did not move, so neither may these.
TRAIN_LOSS_FIRST_LAST = (0.7733, 0.7234)
# The card's published peaks: HBM bytes/s, and f32 FLOP/s outside the
# tensor cores (taken for f64 too, which is no faster).
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12


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


def graph_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time of one ``fn()`` with the host left out: ``calls`` of
    them captured in a CUDA graph, replayed ``replays`` times (L2 warm)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, replays) / calls


def cold_ms(fn, iters: int = 20) -> float:
    """CUDA events round single calls of ``fn``, each after a 256 MB
    write, so that it finds L2 flushed."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _measure(plain_fn, kern, library_fn, bytes_moved, operations,
             bytes_gathered) -> dict:
    """One shape's times, in turns within one call (plain, kernel,
    kernel, plain by CUDA events, host path included), the library call
    beside them, the kernel alone on the card and with L2 flushed, and
    its bound: the larger of ``bytes_moved`` (each input read once, each
    output written once) over the card's memory rate and ``operations``
    over its f32 rate."""
    p1, k1, k2, p2 = (cuda_ms(plain_fn, 5), cuda_ms(kern, 50),
                      cuda_ms(kern, 50), cuda_ms(plain_fn, 5))
    by_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    by_ops = operations / PEAK_FLOP_S * 1e3
    row = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               turns_ms=[p1, k1, k2, p2], library_ms=cuda_ms(library_fn, 20),
               device_ms=graph_ms(kern), cold_ms=cold_ms(kern),
               bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations",
               bytes_moved=int(bytes_moved), bytes_gathered=int(bytes_gathered))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
    row["gathered_bytes_per_s"] = bytes_gathered / (row["device_ms"] * 1e-3)
    return row


def _print_turns(what, row) -> None:
    t = row["turns_ms"]
    print(f"{what}: bit-equal to plain; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms (plain, kernel, kernel, plain = "
          f"{t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, {t[3]:.4f}); library "
          f"{row['library_ms']:.4f} ms; on the card alone "
          f"{row['device_ms']:.4f} ms, L2 flushed {row['cold_ms']:.4f} ms; "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({row['bytes_moved']} B): {100 * row['share_of_bound']:.1f} % "
          f"of it by events, {100 * row['device_share_of_bound']:.1f} % on "
          f"the card; gathers {row['gathered_bytes_per_s'] / 1e12:.3f} TB/s")


def build_phase(record) -> None:
    """Every kernel's nvcc started at once, then each library loaded."""
    from concurrent.futures import ThreadPoolExecutor
    from gnnpe_tpu_torch.graph.csr import CSRGraph
    from gnnpe_tpu_torch.kernels import _build
    from gnnpe_tpu_torch.match.refine import refinement

    def timed_build(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
    record["build_s"] = {}
    for name, (so, secs) in built.items():
        _build.load(name)
        record["build_s"][name] = secs
        print(f"built {name} in {secs:.2f} s: {so}")
        log = so.with_suffix(".log")
        if log.exists():
            # nvcc's resource report, one line per library (the file
            # keeps every kernel's).
            text = log.read_text()
            regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                                 text)]
            print(f"  {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                  f"at most {max(spills)} bytes of spill stores ({log})")
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
    v, arcs = g.num_vertices, int(nbr.numel())
    for name, x in inputs.items():
        nx, vde = spmm.neighbor_sum(off, nbr, x, with_vde=True)
        plain = spmm.neighbor_sum_plain(off, nbr, x)
        torch.cuda.synchronize()
        err = float((nx - plain).abs().max())
        check(torch.equal(nx, plain) and torch.equal(vde, x + plain),
              f"spmm_csr {name} differs from its plain version "
              f"(max abs err {err})")
        # The library's version of the same function, built outside the
        # timed window; the port never calls it.
        adj = torch.sparse_csr_tensor(
            off, nbr, torch.ones(arcs, dtype=x.dtype, device=device),
            size=(v, v))
        lib = torch.sparse.mm(adj, x)
        check(torch.allclose(lib, plain, rtol=1e-5 if x.dtype ==
                             torch.float32 else 1e-12),
              f"torch.sparse.mm {name} differs from the plain version")
        d, es = x.shape[1], x.element_size()
        # Bound: offsets and neighbours read once, x read once, nx
        # written once; one add per arc and column.
        rows[name] = dict(max_abs_err=err, **_measure(
            lambda: spmm.neighbor_sum_plain(off, nbr, x),
            lambda: spmm.neighbor_sum(off, nbr, x),
            lambda: torch.sparse.mm(adj, x),
            bytes_moved=4 * (v + 1) + 4 * arcs + 2 * v * d * es,
            operations=arcs * d, bytes_gathered=arcs * d * es))
        _print_turns(f"spmm_csr {name}", rows[name])
        del adj, lib
    record["kernel"] = rows
    return rows


def _percentiles(vals):
    return {"p50": float(np.percentile(vals, 50)),
            "p90": float(np.percentile(vals, 90))}


def _drive(eng, queries, device, wall, prefix, block_size, offline_kw,
           build_kw):
    """The main path: offline, index, upload, online x N, online_many."""
    with wall.stage(f"{prefix}.offline"):
        eng.offline(**offline_kw)
    with wall.stage(f"{prefix}.build_index"):
        eng.build_index(block_size=block_size, **build_kw)
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
    if hasattr(eng, "paths"):
        rec["paths"] = int(eng.paths.shape[0])
    if getattr(eng.searcher, "build_phase_ms", None):
        rec["build_phase_ms"] = eng.searcher.build_phase_ms
    record[prefix] = rec
    print(f"{prefix}: " + json.dumps(rec))


def _engine_phase(prefix, eng, queries, device, record, block_size,
                  offline_kw=None, build_kw=None):
    """Runs ``_drive`` with the kernel's launch count set to 0 just
    before and read just after; returns (runs, launches)."""
    from gnnpe_tpu_torch.ops import spmm
    from gnnpe_tpu_torch.utils.timers import StageTimer
    wall = StageTimer(device)
    spmm.LAUNCHES = 0
    runs, survived = _drive(eng, queries, device, wall, prefix, block_size,
                            offline_kw or {}, build_kw or {})
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
    """The port's numpy VDE of ``g``, after checking that the engine's
    VDE (computed on ``device``) equals it bit for bit."""
    from gnnpe_tpu_torch.embed.vde import gen_vde_host
    host = gen_vde_host(g, cfg.vde_dim)
    for name in ("x", "nx", "vde"):
        check(np.array_equal(getattr(host, name), getattr(eng.vertices, name)),
              f"data-graph VDE {name} on {device} differs from numpy's")
    return host


def pe_phase(g, queries, device, record, block_size=BLOCK_SIZE) -> tuple:
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
    wants, counts = [], []
    for i, q in enumerate(queries):
        q_paths, _ = enumerate_paths(q, np.arange(q.num_vertices),
                                     cfg.path_length, dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde_host(q, cfg.vde_dim),
                                               q_paths)
        plan = greedy_path_cover(q_paths, weight, q.num_vertices)
        wants.append(pe_candidates_chunked(host, eng.paths, q_pde, plan,
                                           q.num_vertices,
                                           epsilon=cfg.epsilon))
        counts.append(refinement(g, q, wants[-1], cfg.max_answers,
                                 engine="native"))
        _check_query("pe", i, runs, wants[-1], counts[-1])
    print(f"pe: {len(queries)} queries x {sorted(runs)} equal the "
          "flat f64 oracle and native refinement")
    return launches, dict(paths=eng.paths, vertices=host, wants=wants,
                          counts=counts, engine=eng)


def pe_table_phase(g, queries, device, record, oracle,
                   block_size=BLOCK_SIZE) -> int:
    """The table-mode PE index built on the card through the engine (the
    main path), held to the PE phase's oracle; then, outside the counted
    run, save/load at full size, each device program of the build timed
    alone, the host copy of the vid table both ways, and the search of
    both PE layouts on more queries (the PE phase's array-mode engine
    stays resident for it; peaks are counted above it).  Returns the
    main path's A1 launches."""
    import os
    from pathlib import Path

    import torch
    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.engine import PEEngine
    from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
    from gnnpe_tpu_torch.index import device_packed as dp
    from gnnpe_tpu_torch.paths import device_enumerate
    from gnnpe_tpu_torch.paths.enumerate import start_ranks
    cfg = PEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS)
    eng = PEEngine(cfg, g, device)
    base = torch.cuda.memory_allocated()
    runs, launches = _engine_phase("pe_table", eng, queries, device, record,
                                   block_size, dict(device=True),
                                   dict(table=True))
    rec = record["pe_table"]
    rec["main_path_peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                          - base)
    idx = eng.searcher
    check(isinstance(idx, dp.TablePESearch) and eng.index is None,
          "pe_table: build_index(table=True) did not build a table index")
    check(eng.paths.is_cuda and np.array_equal(eng.paths.cpu().numpy(),
                                               oracle["paths"]),
          "pe_table: device-enumerated paths differ from the host rows")
    for name in ("x", "nx", "vde"):
        check(np.array_equal(getattr(oracle["vertices"], name),
                             getattr(eng.vertices, name)),
              f"pe_table: data-graph VDE {name} differs from numpy's")
    for i in range(len(queries)):
        _check_query("pe_table", i, runs, oracle["wants"][i],
                     oracle["counts"][i])
    print(f"pe_table: paths equal the host enumeration's rows; "
          f"{len(queries)} queries x {sorted(runs)} equal the PE oracle; "
          f"resident {rec['index_bytes']} B (array mode "
          f"{record['pe']['index_bytes']} B)")

    # save and load at full size re-serve the same index and answers.
    out = Path(__file__).resolve().parent / "build" / "smoke_index"
    out.mkdir(parents=True, exist_ok=True)
    fp = str(out / "dblp_pe.npz")
    t0 = time.perf_counter()
    idx.save(fp)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = dp.TablePESearch.load(fp, eng.vertices, device)
    load_s = time.perf_counter() - t0
    file_bytes = sum(os.path.getsize(f) for f in out.iterdir())
    for f in out.iterdir():
        f.unlink()
    out.rmdir()
    check(np.array_equal(loaded._host_vids, idx._host_vids)
          and all(torch.equal(getattr(loaded, k), getattr(idx, k))
                  for k in ("d_vids", "b_ub", "b_llo", "b_lhi", "b_deg")),
          "the loaded index differs from the saved one")
    eng.searcher = loaded
    for union in ("host", "device"):
        for i, q in enumerate(queries):
            r = eng.online(q, union=union)
            check(r.answer_count == oracle["counts"][i] and all(
                np.array_equal(a, b)
                for a, b in zip(r.candidates, oracle["wants"][i])),
                f"pe_table: loaded index, query {i} {union}: differs")
    eng.searcher = idx
    del loaded
    rec["save_load"] = dict(save_s=save_s, load_s=load_s,
                            file_bytes=file_bytes)
    print(f"pe_table: save {save_s:.2f} s, load {load_s:.2f} s, "
          f"{file_bytes} B on disk; the loaded index answers every query "
          "equal to the oracle under both unions")

    # Each device program of the build alone, by CUDA events.
    order = degree_sorted_nodes(g)
    enum = device_enumerate.PathEnumerator(g, device)
    rank = torch.from_numpy(start_ranks(order, g.num_vertices)).to(device)
    rows = enum(order, cfg.path_length)
    tables = dp._vertex_tables(eng.vertices, device)
    keyt = dp.key_tables_device(eng.vertices, device)
    key = dp.composite_sort_key_device(eng.paths, eng.vertices, keyt)
    _, perm = torch.sort(key, stable=True)
    vids, _ = dp.permute_fold(eng.paths, perm, tables, block_size)
    progs = {
        "enumerate": cuda_ms(lambda: enum(order, cfg.path_length), 3),
        "dedup": cuda_ms(lambda: rows[device_enumerate.dedup_mask(rows,
                                                                  rank)], 3),
        "key": cuda_ms(lambda: dp.composite_sort_key_device(
            eng.paths, eng.vertices, keyt), 3),
        "sort": cuda_ms(lambda: torch.sort(key, stable=True), 3),
        "permute_fold": cuda_ms(lambda: dp.permute_fold(
            eng.paths, perm, tables, block_size), 3)}
    rec["device_programs_ms"] = progs
    rec["directed_paths"] = int(rows.shape[0])
    print(f"pe_table: device programs alone (ms, CUDA events; "
          f"{rec['directed_paths']} directed paths): " + json.dumps(progs))
    del rows, key, perm, tables
    rec["d2h_ms"] = _d2h_ms(vids)
    print(f"pe_table: vid table ({vids.numel() * 4} B) to the host, wall "
          "ms, each into fresh memory: " + json.dumps(rec["d2h_ms"]))
    del vids
    rec["modes"] = _compare_modes(g, oracle["engine"], eng)
    print("pe_table: search ms, array vs table mode: "
          + json.dumps(rec["modes"]))
    return launches


def _d2h_ms(vids) -> dict:
    """Wall ms of copying ``vids`` to the host three times each way:
    into a fresh pinned buffer (allocation included) and into fresh
    pageable memory (``.cpu()``).  Every copy is kept until the end, so
    no allocation is served from a cache."""
    import torch
    kept, out = [], {}
    for name, copy in (
            ("pinned", lambda: torch.empty(vids.shape, dtype=vids.dtype,
                                           pin_memory=True).copy_(vids)),
            ("pageable", vids.cpu)):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept.append(copy())
            ms.append((time.perf_counter() - t0) * 1e3)
            check(torch.equal(kept[-1][:1000], vids[:1000].cpu()),
                  f"{name} copy of the vid table differs")
        out[name] = ms
    del kept
    return out


def _compare_modes(g, array_eng, table_eng) -> dict:
    """``search`` wall ms of the array-mode and table-mode PE indexes on
    MODE_QUERIES queries, in turns array, table, table, array per query
    and union; each layout's time per query is the mean of its two
    turns.  Candidates must be equal."""
    from gnnpe_tpu_torch.io.datasets import sample_query
    out = {}
    tables = [array_eng._stack([array_eng._query_table(
        sample_query(g, QUERY_SIZE, seed=s))]) for s in MODE_QUERIES]
    for union in ("host", "device"):
        times = {"array": [], "table": []}
        for i, q in enumerate(tables):
            got = {}
            for mode in ("array", "table", "table", "array"):
                eng = array_eng if mode == "array" else table_eng
                t0 = time.perf_counter()
                got[mode] = eng.searcher.search(q, union=union)
                times[mode].append((time.perf_counter() - t0) * 1e3)
            check(len(got["array"]) == len(got["table"]) and all(
                np.array_equal(a, b)
                for a, b in zip(got["array"], got["table"])),
                f"modes: query {i} {union}: table candidates differ")
        per = {m: np.asarray(t).reshape(-1, 2).mean(1)
               for m, t in times.items()}
        ratio = per["table"] / per["array"]
        out[union] = dict(
            array=_percentiles(per["array"]), table=_percentiles(per["table"]),
            ratio_p25_p50_p75=[float(x) for x in
                               np.percentile(ratio, [25, 50, 75])],
            table_faster=int((ratio < 1).sum()), queries=len(ratio))
    return out


def pge_phase(g, queries, device, record, block_size=BLOCK_SIZE) -> tuple:
    from gnnpe_tpu_torch.config import PGEConfig
    from gnnpe_tpu_torch.embed.vde import gen_vde_host
    from gnnpe_tpu_torch.engine import PGEEngine
    from gnnpe_tpu_torch.match.refine import refinement
    cfg = PGEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS)
    eng = PGEEngine(cfg, g, device)
    runs, launches = _engine_phase("pge", eng, queries, device, record,
                                   block_size)

    host = _checked_host_vde(g, cfg, eng, device)
    wants = _pge_oracle(g, cfg, host, lambda q: gen_vde_host(q, cfg.vde_dim),
                        queries)
    counts = []
    for i, (q, want) in enumerate(zip(queries, wants)):
        counts.append(refinement(g, q, want, cfg.max_answers,
                                 engine="native"))
        _check_query("pge", i, runs, want, counts[-1])
    print(f"pge: {len(queries)} queries x {sorted(runs)} equal the "
          "flat f64 oracle and native refinement")
    return launches, dict(group=eng.group, label_group=eng.label_group,
                          wants=wants, counts=counts)


def pge_device_phase(g, queries, device, record, oracle,
                     block_size=BLOCK_SIZE) -> int:
    """PGE with its path groups folded on the card (``offline(device=
    True)``, the main path), held to the PGE phase's groups and oracle;
    then the fold timed alone.  Returns the main path's A1 launches."""
    from gnnpe_tpu_torch.config import PGEConfig
    from gnnpe_tpu_torch.embed.pde import path_groups_device
    from gnnpe_tpu_torch.engine import PGEEngine
    from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
    cfg = PGEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS)
    eng = PGEEngine(cfg, g, device)
    runs, launches = _engine_phase("pge_device", eng, queries, device,
                                   record, block_size, dict(device=True))
    check(np.array_equal(eng.group, oracle["group"])
          and np.array_equal(eng.label_group, oracle["label_group"]),
          "pge_device: device path groups differ from host path_groups")
    for i in range(len(queries)):
        _check_query("pge_device", i, runs, oracle["wants"][i],
                     oracle["counts"][i])
    order = degree_sorted_nodes(g)
    fold_ms = cuda_ms(lambda: path_groups_device(
        eng.vertices, g, order, cfg.path_length, cfg.pde_dim, device), 3)
    record["pge_device"]["device_programs_ms"] = {"path_groups": fold_ms}
    print(f"pge_device: groups bit-equal to host path_groups; "
          f"{len(queries)} queries x {sorted(runs)} equal the PGE oracle; "
          f"path_groups_device alone {fold_ms:.2f} ms (CUDA events)")
    return launches


def _pge_oracle(g, cfg, host, embed, queries) -> list:
    """Per query, the flat f64 host filter's candidates, with ``host``
    the data graph's VDE and ``embed(q)`` each query's."""
    from gnnpe_tpu_torch.embed.pde import path_groups
    from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
    from gnnpe_tpu_torch.match.filter import pge_candidates_chunked
    from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), cfg.path_length,
                               dedup=False)
    group, lgroup = path_groups(host, paths[:, 0], paths, cfg.pde_dim)
    wants = []
    for q in queries:
        qv = embed(q)
        q_paths, _ = enumerate_paths(q, np.arange(q.num_vertices),
                                     cfg.path_length, dedup=False)
        q_group, q_lgroup = path_groups(qv, q_paths[:, 0], q_paths,
                                        cfg.pde_dim)
        wants.append(pge_candidates_chunked(
            host.labels, host.degrees, group, lgroup, qv.labels, qv.degrees,
            q_group, q_lgroup, list(range(q.num_vertices)),
            epsilon=cfg.epsilon))
    return wants


def ell_phase(g, device, record) -> dict:
    """A2 on the dblp layout: apply_perm through the kernel against
    gather_sum_plain, and the two autograd backwards; returns the f32
    rows of the kernels record (D=2 is the trainer's shape)."""
    import torch
    import torch.nn.functional as F
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.ops import ell, spmm
    t0 = time.perf_counter()
    host = ell.build_binned_ell(g.offsets, g.neighbors)
    lay = ell.BinnedEllDevice.from_host(host, device)
    tables = [tuple(t.shape) for t, _ in lay.head + lay.classes]
    record["ell_layout"] = dict(
        build_s=time.perf_counter() - t0, num_slots=lay.num_slots,
        num_head=lay.num_head, num_hub_arcs=lay.num_hub_arcs, tables=tables,
        padded_tables=sum(pc is not None for _, pc in lay.head + lay.classes),
        launches_per_apply=lay.launches_per_apply,
        levels=[len(lv.tables) for lv in lay.plan.levels])
    check(lay.launches_per_apply == len(lay.plan.levels) < len(tables),
          "the dblp layout's plan does not launch once per level")

    def bag(buf, tbl, padcnt, out):
        # embedding_bag sums each table row's bag; no pad correction.
        out.copy_(F.embedding_bag(tbl, buf, mode="sum"))
    print("ell layout: " + json.dumps(record["ell_layout"]))
    rng = np.random.RandomState(1)
    rows = {}
    for d in (2, 128):
        h = torch.from_numpy(rng.rand(g.num_vertices, d).astype(np.float32)
                             ).to(device)
        got = lay.apply_perm(h)
        plain = lay.apply_perm(h, gather=ell.gather_sum_plain)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"ell_gather_sum D={d} differs from "
              f"its plain version (max abs err {err})")
        name = f"f32_d{d}"
        # Bound, summed over the plan: every table and padcnt read once
        # and its rows written once; every level's input read once.
        moved = sum(4 * t.rows * t.width + 4 * t.rows * d
                    + (4 * t.rows if t.padcnt is not None else 0)
                    for lv in lay.plan.levels for t in lv.tables)
        moved += sum(4 * lv.src_rows * d for lv in lay.plan.levels)
        rows[name] = dict(max_abs_err=err, **_measure(
            lambda: lay.apply_perm(h, gather=ell.gather_sum_plain),
            lambda: lay.apply_perm(h),
            lambda: lay.apply_perm(h, gather=bag),
            bytes_moved=moved, operations=lay.num_slots * d,
            bytes_gathered=lay.num_slots * d * 4))
        _print_turns(f"ell_gather_sum apply_perm {name} "
                     f"({lay.launches_per_apply} launches)", rows[name])

    cot = torch.from_numpy(rng.rand(g.num_vertices, 2).astype(np.float32)
                           ).to(device)
    hg = torch.from_numpy(rng.rand(g.num_vertices, 2).astype(np.float32)
                          ).to(device).requires_grad_(True)
    ell.symmetric_aggregate(lay)(hg).backward(cot)
    check(torch.equal(hg.grad, lay.apply_perm(cot)),
          "symmetric_aggregate's backward differs from apply_perm(cotangent)")
    off, nbr, _, _ = to_device(g, device)
    xg = hg.detach().clone().requires_grad_(True)
    spmm.NeighborSum.apply(off, nbr, xg).backward(cot)
    check(torch.equal(xg.grad, spmm.neighbor_sum(off, nbr, cot)),
          "NeighborSum's backward differs from neighbor_sum(cotangent)")
    torch.cuda.synchronize()
    print("backward of symmetric_aggregate (A2) and NeighborSum (A1): "
          "bit-equal to the forward of the cotangent")
    record["ell"] = rows
    return rows


def _numpy_forward(model, g) -> np.ndarray:
    """model_embedder's forward in numpy f64 (the card's is held to it)."""
    from gnnpe_tpu_torch.ops.spmm import neighbor_sum_np

    def pos(p):
        raw = p.detach().cpu().double().numpy()
        return np.logaddexp(0.0, raw) if model.nonneg else raw

    check(model.activation == "softplus", "numpy forward: softplus only")
    h = pos(model.embed)[g.labels]
    for i in range(model.num_layers):
        nbr = neighbor_sum_np(g.offsets, g.neighbors, h)
        h = np.logaddexp(0.0, h @ pos(model.w_self[i])
                         + nbr @ pos(model.w_nbr[i]) + pos(model.bias[i]))
    return h


def train_phase(g, device, record, launches_per_apply) -> tuple:
    """train_payoff.run at the dblp rung (the main path: counts set to 0
    just before, read just after), then its checks and the segment fit;
    returns the (A1, A2) launches of the run."""
    import torch
    from gnnpe_tpu_torch.frontends import train_payoff
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.models.train import fit
    from gnnpe_tpu_torch.ops import ell, spmm
    spmm.LAUNCHES = 0
    ell.LAUNCHES = 0
    t0 = time.perf_counter()
    pay = train_payoff.run("dblp", queries=TRAIN_QUERIES, steps=TRAIN_STEPS,
                           device=device)
    wall_s = time.perf_counter() - t0
    launches = (spmm.LAUNCHES, ell.LAUNCHES)
    fixed_row, trained_row = pay.rows
    hist = pay.state.history
    aggregation = trained_row["aggregation"]
    rec = dict(wall_s=wall_s, spmm_launches=launches[0],
               ell_launches=launches[1], aggregation=aggregation,
               train_paths=int(len(pay.train_paths)),
               train_s=trained_row["train_s"], step_ms=trained_row["step_ms"],
               loss_first=hist[0], loss_last=hist[-1],
               candidate_reduction_pct=trained_row["candidate_reduction_pct"],
               fixed=fixed_row, trained=trained_row)
    record["train"] = rec
    print(f"train: {TRAIN_STEPS} steps ({aggregation}) in "
          f"{rec['train_s']:.2f} s, {rec['step_ms']:.3f} ms/step, loss "
          f"{hist[0]:.6f} -> {hist[-1]:.6f}; candidates "
          f"-{rec['candidate_reduction_pct']:.2f} %; online p50 fixed "
          f"{fixed_row['online_p50_ms']:.2f} ms, trained "
          f"{trained_row['online_p50_ms']:.2f} ms")
    check(aggregation == "binned", "dblp did not train binned")
    # One forward and one backward apply_perm per step, one launch per
    # level each: the backward went through the kernel too.
    check(launches[1] == 2 * launches_per_apply * TRAIN_STEPS,
          f"{launches[1]} ell_gather_sum launches in fit, want "
          f"{2 * launches_per_apply * TRAIN_STEPS}")
    check(launches[0] > 0, "train phase launched no spmm_csr kernel")
    check(np.isfinite(hist).all() and len(hist) == TRAIN_STEPS,
          "loss history not finite")
    check(hist[-1] < hist[0], f"loss did not fall: {hist[0]} -> {hist[-1]}")
    check(all(abs(got - want) < 5e-5 for got, want in
              zip((hist[0], hist[-1]), TRAIN_LOSS_FIRST_LAST)),
          f"loss {hist[0]:.6f} -> {hist[-1]:.6f} left the recorded "
          f"{TRAIN_LOSS_FIRST_LAST}")

    eng = pay.engine
    check(np.allclose(eng.vertices.vde, _numpy_forward(pay.state.params, g),
                      rtol=1e-12, atol=0.0),
          "the card's trained f64 VDE differs from numpy's beyond 1e-12")
    wants = _pge_oracle(g, eng.config, eng.vertices, eng.embedder,
                        pay.queries)
    for i, (want, fx, tr) in enumerate(zip(wants, pay.fixed, pay.trained)):
        check(tr.answer_count == fx.answer_count,
              f"trained query {i}: {tr.answer_count} answers, fixed "
              f"{fx.answer_count}")
        check(len(tr.candidates) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(tr.candidates, want)),
            f"trained query {i}: candidates differ from the oracle")
    print(f"train: {len(wants)} trained queries equal the fixed answers and "
          "the flat f64 oracle on the embedder's VDE; trained VDE within "
          "1e-12 of numpy")

    seg = PathGNN(dim=2, num_layers=1, labels_count=g.labels_count,
                  activation="softplus", device=device)
    st = fit(seg, g, pay.train_paths, num_steps=SEGMENT_STEPS,
             batch_size=1024, seed=0, negatives=True, learning_rate=1e-2,
             aggregation="segment", device=device)
    diff = np.abs(np.asarray(st.history) - np.asarray(hist[:SEGMENT_STEPS]))
    rec["segment"] = dict(steps=SEGMENT_STEPS, step_ms=st.steps_s
                          / SEGMENT_STEPS * 1e3, max_abs_diff=float(diff.max()))
    check(np.allclose(st.history, hist[:SEGMENT_STEPS], rtol=1e-3,
                      atol=1e-5),
          f"segment fit's losses leave the binned ones (max diff "
          f"{diff.max()})")
    print(f"train: {SEGMENT_STEPS}-step segment fit tracks binned within "
          f"rtol 1e-3 (max abs diff {diff.max():.3e}, "
          f"{rec['segment']['step_ms']:.3f} ms/step)")
    torch.cuda.synchronize()
    return launches


def _kernel_row(name, replaces, launches, rows, main_shape) -> dict:
    """One entry of the kernels record; the times and the bound at the
    main path's shape."""
    return {"name": name, "route": "cuda",
            "source": f"gnnpe_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            **{k: rows[main_shape][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


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
    ell_rows = ell_phase(g, device, record)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak(prefix, base=0):
        record[prefix]["peak_device_bytes"] = (
            torch.cuda.max_memory_allocated() - base)

    fresh()
    launches, pe_oracle = pe_phase(g, queries, device, record)
    peak("pe")
    fresh()
    base = torch.cuda.memory_allocated()      # the array-mode PE index
    launches += pe_table_phase(g, queries, device, record, pe_oracle)
    peak("pe_table", base)
    del pe_oracle
    fresh()
    a1, pge_oracle = pge_phase(g, queries, device, record)
    launches += a1
    peak("pge")
    fresh()
    launches += pge_device_phase(g, queries, device, record, pge_oracle)
    peak("pge_device")
    del pge_oracle
    fresh()
    a1, a2 = train_phase(g, device, record,
                         record["ell_layout"]["launches_per_apply"])
    launches += a1
    peak("train")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "gnnpe_tpu"))
    check(not foreign, f"the port imported {foreign}")

    print("record: " + json.dumps(record))
    print(smi)
    print(json.dumps({"kernels": [
        _kernel_row("spmm_csr", "experiments/pallas_spmm.py:181", launches,
                    rows, "f64_d2"),
        _kernel_row("ell_gather_sum", "experiments/pallas_blocked_spmm.py:106",
                    a2, ell_rows, "f32_d2")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
