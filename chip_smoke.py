#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gnnpe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the CUDA kernels from gnnpe_tpu_torch/csrc (A1 spmm_csr, A2
   ell_gather_sum, the readout's segment_sum and the search's
   union_bitmap; and the host C++ refinement engine).
3. Kernel phase: the neighbour-sum SpMM (A1) against its plain PyTorch
   version on the card, on the dblp-rung graph — f64 at the VDE width
   (D=2), f32 at D=128 and f32 at D=8 on a 0/1 matrix (the pre-verify's
   shape) — required bit-equal (both add in the same order); timed in turns plain, kernel, kernel, plain, beside one
   library call of the same function (``torch.sparse.mm`` of the CSR
   adjacency, which the port never calls), the kernel alone on the card
   (replayed from a CUDA graph) and with L2 flushed, its bound from the
   bytes, and the rate of the bytes it gathers.
4. PE phase: the exact online query at the dblp rung (317,080 vertices,
   1,049,866 edges; PE -l 2, 3-vertex paths, 512-entry blocks, answers
   capped at 100,000) over the host-built array-mode index: 8 tree
   queries of 8 vertices through ``online`` (host union, then device
   union), then all 8 at once through ``online_many`` with the device
   union.  Then the pre-verify check: ``online(preverify=2,
   union="device")`` on the same queries, whose pruned candidates must
   equal a numpy arc-consistency oracle (``neighbor_sum_np`` on the 0/1
   matrix); PE's answer counts are printed beside the unpruned ones
   (they may move), PGE's (phase 6) must not move.
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
   Union phase, on the table index: the union_bitmap scatters of one
   online search and of the 8 queries' stacked search, recorded as the
   search launches them (at most 64 chunks a search), replayed through
   the kernel and ``scatter_plain`` on the card — words and hit rows
   bit-equal — and compacted by ``compact`` against ``compact_plain``;
   timed in turns plain, kernel, kernel, plain by CUDA events beside the
   bytes bound.  Every engine phase sets the union's launch count to 0
   before its searches and holds it to the launches that its
   device-union searches' ``last_stats`` account for.
   PE streamed phase: the same index served past device memory.  The
   card would hold the table many times over, so the phase forces
   ``build_index(table=True, resident=False)``: the bucketed build on
   the host with a disk spill into a temporary directory, fed chunk by
   chunk from phase 4's host paths, whose vid table, summaries and
   signature ranges must equal phase 5's device build; a block pool of
   about a quarter of the table.  The 8 queries under both unions must
   equal the oracle; the 64 comparison queries must equal table mode's
   candidates cold (misses), warm (the same queries again: hits), hot
   (each query twice in a row, the second timed), after
   ``prefill_cache``, after ``degrade_cache(0.5)`` and with the cache
   off (per-chunk uploads), each timed in turns with table mode; evictions must have happened,
   and the phase's resident tensors and peak device memory must stay
   under the table's.  ``auto_resident`` must say resident with the
   card's free memory and streamed with a budget under the table.
   ``save``, ``load`` over the memmap sidecar, one query, ``close``, and
   the spill directory must be empty.
6. PGE phase: the same graph and queries with PGE -l 2 (host path
   groups), and the pre-verify check with equal answer counts.
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
9. Multi-device phase (after phase 6, at the dblp rung and full width):
   the multi-device layer on ``torch.distributed``.
   *World size 1 on NCCL*, in this process: ``make_mesh(1)``, both
   engines through ``attach_mesh(packed=True)`` and ``packed=False``,
   both unions, held to the oracles of phases 4 and 6; ``HaloPlan`` and
   ``BinnedHaloPlan`` aggregation (f32 D=128) against A1's square sum
   (the halo backend bit-equal, the binned one at rtol 1e-4 / atol
   1e-4); 5 train steps of each backend ("binned_halo", "halo", "psum")
   whose losses must track the single device's (``fit``'s inner loop
   over the binned aggregation and the readout plans, from ``fit``'s
   initial weights, on the same batches of random path pairs: ``fit``'s
   own positives are dominated by construction, so their hinge is ~0)
   within rtol 1e-3 / atol 1e-5.
   *Four ranks on the one card over gloo*, started by this script
   (parallel/launch.py): NCCL takes one rank per device, so the ranks
   share ``cuda:0``, compute there with the kernels, and their
   collectives cross the host (parallel/collectives.py stages by the
   group's backend).  Each rank loads its block range of the index that
   phase 5 saved and answers the 8 queries under both unions, equal to
   phase 4's oracle on every rank; the halo and binned-halo aggregation
   over 4 shards (``partition_graph``) must equal the single-device sum
   row for row (halo bit-equal, binned rtol 1e-4 / atol 1e-4); 3 steps
   of each backend are timed.  A rank that fails fails the script.
   Both kernels' new rectangular shapes (rank 0's shard of the 4-way
   plans, f32 D=2 and D=128: A1 with ``own_pad + 4·halo_pad`` source rows
   and ``own_pad`` output rows, A2 through ``RectBinned``'s launch plan)
   are held bit-equal to their plain versions and timed as in phases 3
   and 8.  The phase's A1, A2 and segment_sum launches are counted path
   by path — the counts set to 0 after every oracle and single-device
   comparison, so that only the multi-device layer's own launches are
   read — and each must be exactly what the path says it launches
   (``agg.launches`` of a plan's aggregation, ``step.launches`` of a
   train step: the aggregation's A1 and A2 and the readout plans'
   segment sums; one A1 a query for its VDE), at world size 1 and in
   every rank.
10. Train phase: ``train_payoff.run`` at the dblp rung (PGE, D=2, 300
   steps, binned aggregation, 8 held-out queries).  A2 must launch
   ``launches_per_apply`` times in every step's forward and in its
   backward, and the segment-sum kernel once for each readout plan
   (``readout_plans``: the label lookup and the path readout) in the
   backward; every loss
   finite, the last below the first, and the first
   and last equal to the values earlier revisions of the port recorded
   for this seed; every trained answer equal to the fixed-VDE answer;
   every trained candidate set equal to the flat f64 host filter on the
   embedder's own VDE; the card's f64 trained VDE within rtol 1e-12 of
   a numpy forward of the same weights.  Then the streamed payoff:
   ``train_payoff.run`` on PE with ``force_streamed=True`` (100 steps, 4
   held-out queries: cut from the PGE run's 300 and 8 to fit the
   smoke's time; the same graph at D=2), its main path counted alone:
   both engines' ``mode`` "streamed", the trained answers equal to the
   fixed ones (the run's own assertion), the fixed candidates equal to
   the flat f64 host filter, A2 and segment_sum launched as ``fit``
   says; ``chunks_mean``, ``blocks_survived_mean``, the search's cache
   misses and uploaded bytes per query and ``train_s`` printed.  Then a
   50-step
   ``aggregation="segment"`` fit from the same initial weights and
   batches (the binned run's first chunk) must track the binned loss
   history within rtol 1e-3, launching no A2 and the segment-sum kernel
   for the readout plans.  ``fit`` prices the binned layout's hubs
   with the card's measured constants (phase 14); that host layout must
   equal the one of gnnpe_tpu's "cpu" row, which the recorded losses
   came from (no hubs, the same permutation and tables).
11. Ladder phase (after the multi-device phase): the slice's entry point,
   ``frontends/ladder.py:run_rung("dblp")`` on the 8 queries of phases 4
   and 6 with serving: the PE and PGE rows spot-verified (query 0 and the
   heaviest, against the flat host filter), serving without error, each
   query's Σ|candidates| equal to that phase's oracle (every query
   reaches the answer cap, so the answers alone could not tell) and the
   mean answers to the mean of its 8 counts.  Then the ladder's streamed
   tier: ``run_rung("dblp", pe_only=True)`` on the same queries with a
   resident budget of half the table (the rule, not a flag, sends it
   streamed), a pool of ``STREAM_POOL_BLOCKS`` and a disk tier in a fresh
   temporary directory: partitions spilled and the table mapped there,
   the candidates equal to the PE oracle's, both spot checks, serving,
   misses in the pool, and the directory empty once the index is freed;
   its A1 launches (the VDEs) count on the main path.
12. Uniform-ELL phase: ``build_ell(width=8, level2_width=8)`` on dblp,
   ``HierarchicalEll`` through kernel A2 (one launch a level: the level's
   input gets a zero row, every -1 pad points at it) bit-equal to its
   masked plain form at f32 D=2 and D=128 and within rtol 1e-5 of A1's
   sum, timed as in phase 3 beside ``embedding_bag`` over the same
   tables; its padding against the binned layout's; ``semijoin_prune(
   ell=)`` on the PE oracle's candidates equal to the A1 form; one
   attention hop (D=16) within rtol 1e-4 of a float64 numpy hop; the
   intersect and bitset forms on the card equal to numpy.
13. Readout rows and profile phase: the trainer's two fixed gathers at
   dblp (the label lookup, 317,080 entries into 15 rows, and the readout
   of 500,000 paths, 1,500,000 entries into 317,080 rows), f32 D=2: each
   ``GatherRows`` plan's backward through the segment-sum kernel (one
   launch) bit-equal to ``segment_sum_plain`` and bit-identical over 3
   calls, timed as in phase 3 beside ``index_add_`` and torch's own
   backward of ``x[idx]`` (``index_put_`` with ``accumulate=True``), and
   in turns with the earlier route of the same call, kernel A2's walk of
   the transposed index as a uniform-width ELL (one launch a level); the
   same two plans at f64 D=2, bit-equal and timed the same way.  The
   kernel past its earlier limits: (a) the full dblp path readout (all
   60,779,769 paths, 182,339,307 entries into 317,080 rows) at f32 D=12,
   N·D past 2^31, one launch bit-equal to ``segment_sum_plain`` on the
   card column slice by column slice, bit-identical over 2 calls, within
   rtol 1e-4 of ``index_add_``, timed by events and on the card alone
   beside ``index_add_``, its peak device memory printed; (c) a small
   index at D = 4,100 (f32 and f64), bit-equal; (d) an empty index
   through autograd, one launch, all rows zero.
   Then ``utils/profiling.trace`` around 5 warm binned ``fit`` steps (the
   train phase's model and pairs), its top device kernels and ops by
   share of device time, each readout backward's range
   (``readout.labels.backward``, ``readout.paths.backward``) and what is
   left of ``IndexBackward0`` (the pair gathers) beside its share before
   the plans; a trace of one PGE ``online`` call must hold the stage
   ranges ``query_plan``, ``search``, ``refine``.
14. Probe phase (last): ``utils/device_probe.device_constants`` measured
   on the card (its matmul the hub product's: f32, TF32 off), and the
   youtube and youtube_skew rungs' binned layouts built with them (a
   count charged the 4 bytes it takes on the card, any hub the product's
   passes over the output).  Each is timed in turns against the other
   choice on the same graph — no hubs, or as many as the memory budget
   holds — and the prices' choice must not be the slower one on the card
   by more than 10 %; the layout with hubs is held to A1's sum.  On the
   first rung's layout with hubs, ``BinnedEllDevice.apply`` — A2's launch
   plan plus the hub product — bit-equal to its plain version and within
   the hi/lo tolerance (2e-3 of max(|sum|, 1)) of A1's sum at f32 D=2
   and D=128, timed as in phase 8.
15. Bench phase (after the probe): the port's aggregation benchmark
   (``gnnpe_tpu_torch/bench.py``) at the root bench's size (100,000
   vertices, 800,000 arcs, f32 D=128).  One aggregation of each of its
   four implementations (binned, uniform ELL, 1-shard binned halo, flat
   CSR) within rtol 1e-5 / atol 1e-6 of ``neighbor_sum_np`` in f64; both
   kernels at those shapes bit-equal to their plain versions and timed
   as in phase 3; ``bench_aggregation`` of each (the main path: every
   step's A1 and A2 launches as its plan says, the share of the bound
   finite); ``python -m gnnpe_tpu_torch.bench --device cuda --skip-halo``
   in a subprocess, whose last line must carry the root bench's keys.
16. Scale phase (last): the ladder past dblp at full size,
   ``run_rung("youtube")`` (1,134,890 vertices; PE -l 2 over
   1,170,203,040 paths, a 14 GB vid table) and ``run_rung(
   "youtube_skew")`` (the same scale, one 28,753-degree hub; PE at l=1,
   2,987,624 paths), PE and PGE, 8 queries each: the PE rows' ``l``,
   paths and blocks equal to gnnpe_tpu's, the index built in the mode
   the resident rule chose before enumeration, both variants' spot
   checks (query 0 and the heaviest against the flat f64 host filter)
   true, serving without error, the peak device memory under the card's
   and A1 launched for every VDE.  Then youtube's index is built once
   more from its enumerated paths, and the PE table phase's dblp index
   too: each build's peak (``max_memory_allocated`` above its paths)
   must stay under the bytes the rule counts (``table_build_bytes``).

The card's f64 data-graph VDE must equal the port's numpy
``gen_vde_host``.  Every query's candidates must equal the flat f64 host
filter, run on that numpy VDE for the data graph and every query (so it
shares no code with the torch VDE, the packed index or the kernels), and
every answer count must equal native refinement on
those candidates; the table and device phases share the oracle of the
phase before them.  Each kernel's launch count over the main path of
the phases that run it (A1: PE, PE table, PE streamed, PGE, PGE device,
both pre-verify runs, multi-device, ladder, train, the streamed payoff,
bench and scale; A2: multi-device, train (aggregation), the streamed payoff,
the uniform-ELL pre-verify and attention, and bench; segment_sum: train,
the segment fit, the streamed payoff and multi-device) must be > 0, and
the index tensors must live on the card.
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
import tempfile
import time

import numpy as np

MAX_ANSWERS = 100_000
QUERY_SEEDS = range(8)
QUERY_SIZE = 8
MODE_QUERIES = range(100, 164)   # the PE layouts' search comparison
BLOCK_SIZE = 512
KERNELS = ("spmm_csr", "ell_gather_sum", "segment_sum", "union_bitmap")
PREVERIFY_ROUNDS = 2
# The streamed phase's block pool: about a quarter of the dblp index's
# 118,711 blocks, so that misses, hits and evictions all happen.
STREAM_POOL_BLOCKS = 30_000
TRAIN_STEPS = 300
TRAIN_QUERIES = 8
# The streamed PE payoff, cut to fit the smoke's time: fewer steps and
# queries than the PGE payoff above, the same graph at D=2.
STREAMED_STEPS = 100
STREAMED_QUERIES = 4
SEGMENT_STEPS = 50        # the binned run's first chunk of batches
MULTI_RANKS = 4           # ranks that share the card over gloo
MULTI_STEPS = 5           # train steps per backend at world size 1
MULTI_TRAIN_PATHS = 200_000
MULTI_RANK_TIMEOUT_S = 420
# The scale phase: the youtube rung at full size, then youtube_skew (PE
# at l=1: its 3-vertex paths pass ``pe_max_paths``), PE and PGE over
# SCALE_QUERIES queries each; the PE rows' path counts are gnnpe_tpu's.
SCALE_RUNGS = (("youtube", 2, 1_170_203_040), ("youtube_skew", 1, 2_987_624))
SCALE_QUERIES = 8
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


def _bag(buf, tbl, padcnt, out):
    """The library's gather-sum of one table for ``LaunchPlan.walk``:
    ``embedding_bag`` sums each table row's bag, with no pad
    correction."""
    import torch.nn.functional as F
    out.copy_(F.embedding_bag(tbl, buf, mode="sum"))


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
    """spmm_csr against neighbor_sum_plain on the card; returns its
    rows of the kernels record (f64 D=2 and f32 D=8 are main-path
    shapes)."""
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
        # The pre-verify's shape: 8 candidate sets as a 0/1 matrix.
        "f32_d8": torch.from_numpy((np.random.RandomState(2).rand(
            g.num_vertices, QUERY_SIZE) < 0.1).astype(np.float32)
        ).to(device),
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


def _union_launches(prefix, stats) -> int:
    """The union_bitmap launches that one device-union search made, from
    its ``last_stats``: a scatter a phase-2 chunk, the count and scan,
    and the write where any id came out; none where no block survived
    (or the query had no rows, and no stats)."""
    if stats is None:
        return 0
    check(stats["union"] == "device",
          f"{prefix}: a device-union search ran the {stats['union']} union")
    if stats["survived"] == 0:
        return 0
    return stats["chunks"] + 2 + (stats["cand_ids"] > 0)


def _drive(eng, queries, device, wall, prefix, block_size, offline_kw,
           build_kw):
    """The main path: offline (unless the engine was handed its paths),
    index, upload, online x N under both unions, online_many.  Returns
    the runs, each query's surviving blocks, and the union_bitmap
    launches that the device-union searches' ``last_stats`` account
    for."""
    with wall.stage(f"{prefix}.offline"):
        if getattr(eng, "paths", None) is None:
            eng.offline(**offline_kw)
    with wall.stage(f"{prefix}.build_index"):
        eng.build_index(block_size=block_size, **build_kw)
    with wall.stage(f"{prefix}.attach_device"):
        eng.attach_device(device)
    runs = {"online": [], "online_device_union": []}
    survived, union = [], 0
    for q in queries:
        runs["online"].append(eng.online(q, union="host"))
        survived.append(eng.searcher.last_stats["survived"])
        runs["online_device_union"].append(eng.online(q, union="device"))
        union += _union_launches(prefix, eng.searcher.last_stats)
    with wall.stage(f"{prefix}.online_many"):
        runs["online_many"] = eng.online_many(queries, union="device")
    union += _union_launches(prefix, eng.searcher.last_stats)
    return runs, survived, union


def _summarise(prefix, eng, runs, survived, wall, launches, union_launches,
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
        union_launches=union_launches,
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
    """Runs ``_drive`` with the launch counts of spmm_csr and of the
    union's kernels set to 0 just before and read just after; records
    the union's as ``union_launches``, held to what the device-union
    searches account for.  Returns (runs, spmm_csr launches)."""
    from gnnpe_tpu_torch.ops import spmm, union_bitmap
    from gnnpe_tpu_torch.utils.timers import StageTimer
    wall = StageTimer(device)
    spmm.LAUNCHES = union_bitmap.LAUNCHES = 0
    runs, survived, union_want = _drive(
        eng, queries, device, wall, prefix, block_size, offline_kw or {},
        build_kw or {})
    launches, union = spmm.LAUNCHES, union_bitmap.LAUNCHES
    _summarise(prefix, eng, runs, survived, wall, launches, union, record)
    check(launches > 0, f"{prefix} phase launched no spmm_csr kernel")
    check(union == union_want > 0,
          f"{prefix} phase: {union} union_bitmap launches, its "
          f"device-union searches account for {union_want}")
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


def _arc_consistency_np(g, q, cands, rounds) -> list:
    """Arc consistency in numpy, f64, over the 0/1 candidate matrix: a
    candidate of query vertex i stays iff, for every query neighbour j
    of i, one of j's candidates is adjacent to it in ``g``."""
    from gnnpe_tpu_torch.ops.spmm import neighbor_sum_np
    c = np.zeros((g.num_vertices, q.num_vertices))
    for i, cand in enumerate(cands):
        c[cand, i] = 1.0
    for _ in range(rounds):
        reach = neighbor_sum_np(g.offsets, g.neighbors, c) > 0
        for i in range(q.num_vertices):
            for j in q.vertex_neighbors(i):
                c[:, i] *= reach[:, j]
    return [np.nonzero(c[:, i])[0].astype(np.int64)
            for i in range(q.num_vertices)]


def _preverify_check(prefix, eng, g, queries, runs, record,
                     counts_must_hold) -> int:
    """``online(preverify=PREVERIFY_ROUNDS, union="device")`` on every
    query, with the kernel's count set to 0 just before and read just
    after: pruned candidates equal to the numpy oracle on the unpruned
    run's candidates; answer counts equal to the unpruned ones where
    the variant is exact.  Returns A1's launches."""
    from gnnpe_tpu_torch.ops import spmm
    base = runs["online_device_union"]
    spmm.LAUNCHES = 0
    pruned = [eng.online(q, union="device", preverify=PREVERIFY_ROUNDS)
              for q in queries]
    launches = spmm.LAUNCHES
    # One launch a query is its VDE; the rest are pruning rounds.
    rounds = launches - len(queries)
    check(len(queries) <= rounds <= PREVERIFY_ROUNDS * len(queries),
          f"{prefix} pre-verify: {rounds} spmm_csr launches for "
          f"{len(queries)} queries of {PREVERIFY_ROUNDS} rounds")
    for i, (q, r, b) in enumerate(zip(queries, pruned, base)):
        want = _arc_consistency_np(g, q, b.candidates, PREVERIFY_ROUNDS)
        check(len(r.candidates) == len(want) and all(
            np.array_equal(x, y) for x, y in zip(r.candidates, want)),
            f"{prefix} pre-verify query {i}: pruned candidates differ from "
            "the numpy oracle")
        check(not counts_must_hold or r.answer_count == b.answer_count,
              f"{prefix} pre-verify query {i}: {r.answer_count} answers, "
              f"unpruned {b.answer_count}")
    rec = dict(
        rounds=PREVERIFY_ROUNDS, spmm_launches=launches,
        prune_launches=rounds,
        candidates_before=[int(sum(map(len, b.candidates))) for b in base],
        candidates_after=[int(sum(map(len, r.candidates))) for r in pruned],
        answers_unpruned=[b.answer_count for b in base],
        answers_pruned=[r.answer_count for r in pruned],
        preverify_ms=_percentiles([r.timings_ms["preverify"]
                                   for r in pruned]),
        refine_ms=_percentiles([r.timings_ms["refine"] for r in pruned]),
        refine_ms_unpruned=_percentiles([b.timings_ms["refine"]
                                         for b in base]))
    record[prefix]["preverify"] = rec
    print(f"{prefix} pre-verify ({PREVERIFY_ROUNDS} rounds, {rounds} A1 "
          f"launches at f32 D={QUERY_SIZE}): pruned candidates equal the "
          f"numpy oracle; candidates {sum(rec['candidates_before'])} -> "
          f"{sum(rec['candidates_after'])}; answers unpruned "
          f"{rec['answers_unpruned']}, pruned {rec['answers_pruned']}"
          + (" (equal)" if counts_must_hold else " (PE's may move)")
          + f"; preverify p50 {rec['preverify_ms']['p50']:.2f} ms, refine "
          f"p50 {rec['refine_ms']['p50']:.2f} ms (unpruned "
          f"{rec['refine_ms_unpruned']['p50']:.2f} ms)")
    return launches


def _checked_host_vde(g, cfg, eng, device):
    """The port's numpy VDE of ``g``, after checking that the engine's
    VDE (computed on ``device``) equals it bit for bit."""
    from gnnpe_tpu_torch.embed.vde import gen_vde_host
    host = gen_vde_host(g, cfg.vde_dim)
    for name in ("x", "nx", "vde"):
        check(np.array_equal(getattr(host, name), getattr(eng.vertices, name)),
              f"data-graph VDE {name} on {device} differs from numpy's")
    return host


def _pe_oracle(host, paths, queries, cfg) -> list:
    """The flat f64 host filter (``pe_candidates_chunked``) of each query
    over ``paths`` and the numpy data VDE ``host``, the query's VDE from
    numpy too; the queries run in threads (numpy leaves the GIL in its
    array loops)."""
    from concurrent.futures import ThreadPoolExecutor
    from gnnpe_tpu_torch.embed.pde import gen_query_pde_table
    from gnnpe_tpu_torch.embed.vde import gen_vde_host
    from gnnpe_tpu_torch.match.filter import pe_candidates_chunked
    from gnnpe_tpu_torch.match.plan import greedy_path_cover
    from gnnpe_tpu_torch.paths.enumerate import enumerate_paths

    def one(q):
        q_paths, _ = enumerate_paths(q, np.arange(q.num_vertices),
                                     cfg.path_length, dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde_host(q, cfg.vde_dim),
                                               q_paths)
        plan = greedy_path_cover(q_paths, weight, q.num_vertices)
        return pe_candidates_chunked(host, paths, q_pde, plan,
                                     q.num_vertices, epsilon=cfg.epsilon)

    with ThreadPoolExecutor(max_workers=len(queries)) as pool:
        return list(pool.map(one, queries))


def pe_phase(g, queries, device, record, block_size=BLOCK_SIZE) -> tuple:
    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.engine import PEEngine
    from gnnpe_tpu_torch.match.refine import refinement
    cfg = PEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS)
    eng = PEEngine(cfg, g, device)
    runs, launches = _engine_phase("pe", eng, queries, device, record,
                                   block_size)

    host = _checked_host_vde(g, cfg, eng, device)
    wants = _pe_oracle(host, eng.paths, queries, cfg)
    counts = []
    for i, q in enumerate(queries):
        counts.append(refinement(g, q, wants[i], cfg.max_answers,
                                 engine="native"))
        _check_query("pe", i, runs, wants[i], counts[-1])
    print(f"pe: {len(queries)} queries x {sorted(runs)} equal the "
          "flat f64 oracle and native refinement")
    launches += _preverify_check("pe", eng, g, queries, runs, record,
                                 counts_must_hold=False)
    return launches, dict(paths=eng.paths, vertices=host, wants=wants,
                          counts=counts, engine=eng)


def pe_table_phase(g, queries, device, record, oracle,
                   block_size=BLOCK_SIZE) -> tuple:
    """The table-mode PE index built on the card through the engine (the
    main path), held to the PE phase's oracle; then, outside the counted
    run, save/load at full size, each device program of the build timed
    alone, the host copy of the vid table both ways, and the search of
    both PE layouts on more queries (the PE phase's array-mode engine
    stays resident for it; peaks are counted above it).  Returns the
    main path's A1 launches and the engine."""
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
    rec["index_file"] = fp       # the multi-device phase's ranks load it
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
    key = dp.sort_key_steps(eng.paths, keyt)
    perm = dp.stable_order(key)
    check(torch.equal(perm.long(), torch.sort(key, stable=True)[1]),
          "pe_table: the build's bounded stable sort differs from "
          "torch.sort's stable order")
    vids, _ = dp.permute_fold(eng.paths, perm, tables, block_size)
    progs = {
        "enumerate": cuda_ms(lambda: enum(order, cfg.path_length), 3),
        "dedup": cuda_ms(lambda: rows[device_enumerate.dedup_mask(rows,
                                                                  rank)], 3),
        "key": cuda_ms(lambda: dp.sort_key_steps(eng.paths, keyt), 3),
        "sort": cuda_ms(lambda: dp.stable_order(key), 3),
        # One sort of the whole key, the build's program before it was
        # bounded (twice the key's bytes beside it, and the sort's own).
        "torch_sort": cuda_ms(lambda: torch.sort(key, stable=True), 3),
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
    rec["build_accounting"], again = _build_accounting(
        "pe_table", eng.paths, eng.vertices, device, block_size)
    check(np.array_equal(again._host_vids, idx._host_vids),
          "pe_table: a second build gave another vid table")
    return launches, eng


def _build_accounting(what, paths, vertices, device, block_size) -> tuple:
    """The table-mode build from ``paths`` on the card, its peak
    (``max_memory_allocated`` above what was allocated before it) held
    under ``table_build_bytes`` — the bytes the resident rule counts.
    Returns (the record, the index)."""
    import torch
    from gnnpe_tpu_torch.index import device_packed as dp
    gc.collect()
    torch.cuda.empty_cache()
    p, l = paths.shape
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    idx = dp.TablePESearch.build_from_paths(paths, vertices, device,
                                            block_size=block_size)
    peak = torch.cuda.max_memory_allocated() - base
    model = dp.table_build_bytes(p, l, block_size, True,
                                 vertices.num_vertices, vertices.dim)
    table = idx.num_blocks * block_size * l * 4
    check(peak <= model, f"{what}: the build's peak {peak} B passes the "
          f"resident rule's count {model} B")
    acc = dict(paths=int(p), peak_bytes=int(peak), model_bytes=int(model),
               table_bytes=int(table),
               peak_beyond_table_per_path=(peak - table) / p,
               model_beyond_table_per_path=(model - table) / p,
               build_phase_ms=idx.build_phase_ms)
    print(f"{what}: build accounting: peak {peak} B above the paths, "
          f"{acc['peak_beyond_table_per_path']:.2f} B a path beyond the "
          f"padded table; the rule counts {model} B "
          f"({acc['model_beyond_table_per_path']:.2f} B a path)")
    return acc, idx


def _stream_pass(name, g_tables, table, idx, union="device",
                 repeat=False) -> dict:
    """One pass of the comparison queries: per query table mode then the
    streamed index (wall ms each, ``search`` ends in a copy to the
    host), candidates required equal; the streamed side's hits, misses
    and uploaded bytes summed from ``last_stats``.  With ``repeat`` the
    streamed index answers each query twice and the second answer is
    the one timed and counted: its blocks were used a moment ago."""
    ms = {"table": [], "streamed": []}
    hits = misses = uploaded = 0
    for i, q in enumerate(g_tables):
        t0 = time.perf_counter()
        want = table.search(q, union=union)
        ms["table"].append((time.perf_counter() - t0) * 1e3)
        if repeat:
            idx.search(q, union=union)
        t0 = time.perf_counter()
        got = idx.search(q, union=union)
        ms["streamed"].append((time.perf_counter() - t0) * 1e3)
        check(len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want)),
            f"pe_streamed {name}: query {i} {union}: candidates differ from "
            "table mode's")
        st = idx.last_stats
        hits += st.get("cache_hits", 0)
        misses += st.get("cache_misses", 0)
        uploaded += st["uploaded_bytes"]
    n = len(g_tables)
    cache = idx._cache
    return dict(
        union=union, streamed_ms=_percentiles(ms["streamed"]),
        table_ms=_percentiles(ms["table"]),
        streamed_mean_ms=float(np.mean(ms["streamed"])),
        table_mean_ms=float(np.mean(ms["table"])),
        hits=hits, misses=misses,
        hit_rate=hits / max(hits + misses, 1),
        uploaded_bytes_per_query=uploaded / n,
        evictions=cache.evictions if cache else 0,
        pool_blocks=cache.capacity if cache else 0,
        pool_bytes=int(cache.buf.numel() * 4) if cache else 0)


UNION_REPLAY_CHUNKS = 64      # the chunks of a search that are replayed


def union_phase(eng, queries, device, record) -> dict:
    """The union's kernels at the table index's main-path shapes: the
    scatters of one online search (query 0) and of the stacked search of
    every query, recorded as the search launches them (its first
    ``UNION_REPLAY_CHUNKS`` chunks), replayed through
    ``union_bitmap.scatter`` and ``scatter_plain`` on the same inputs on
    the card, bit for bit, then ``compact`` against ``compact_plain``;
    where every chunk was replayed, the replay equals the search's lists
    and hit rows.  Each is timed in turns by CUDA events, host path
    included (a scatter replay zeroes the words first, as a search's
    ``new_words`` does), beside its bytes bound: a scatter reads mask,
    gate, vid rows and output ids once and writes the words once; the
    compaction reads the words once and writes offsets and ids once.
    Returns the kernels record's rows."""
    import torch
    from gnnpe_tpu_torch.ops import union_bitmap as ub
    searcher, v = eng.searcher, eng.searcher.num_vertices
    tables = {"online": eng._stack([eng._query_table(queries[0])]),
              "batch": eng._stack([eng._query_table(q) for q in queries])}
    rows, rec, inner = {}, {}, ub.scatter
    for name, table in tables.items():
        chunks = []

        def keep(words, nv, mask, gate, vids, out_ids, hits):
            if len(chunks) < UNION_REPLAY_CHUNKS:
                chunks.append((mask.clone(), gate.clone(), vids.clone(),
                               out_ids.clone()))
            return inner(words, nv, mask, gate, vids, out_ids, hits)
        ub.scatter = keep
        try:
            got = searcher.search(table, union="device")
        finally:
            ub.scatter = inner
        stats, nq = dict(searcher.last_stats), len(got)
        check(chunks, f"union {name}: the search scattered no chunk")
        words = {k: ub.new_words(nq, v, device) for k in ("kernel", "plain")}
        hits = {k: torch.zeros(1, dtype=torch.int64, device=device)
                for k in words}

        def scatter_all(how):
            fn = ub.scatter if how == "kernel" else ub.scatter_plain
            words[how].zero_()
            hits[how].zero_()
            for c in chunks:
                fn(words[how], v, *c, hits[how])
        for how in words:
            scatter_all(how)
        check(torch.equal(words["kernel"], words["plain"])
              and int(hits["kernel"]) == int(hits["plain"]),
              f"union {name}: the scatter kernel's words or hit rows differ "
              "from scatter_plain's")
        offsets, ids = ub.compact(words["kernel"], v)
        want = ub.compact_plain(words["plain"].cpu(), v)
        check(np.array_equal(offsets, want[0])
              and np.array_equal(ids, want[1]),
              f"union {name}: compact differs from compact_plain")
        whole = len(chunks) == stats["chunks"]
        check(not whole or (int(hits["kernel"]) == stats["hit_rows"] and all(
            np.array_equal(a, b) for a, b in zip(ub.split(offsets, ids),
                                                 got))),
              f"union {name}: the replay differs from the search's union")
        w = words["kernel"].shape[1]
        in_bytes = sum(m.numel() + g.numel() + 4 * (i.numel() + o.numel())
                       for m, g, i, o in chunks)
        for part, fns, nbytes in (
                ("scatter", (lambda: scatter_all("plain"),
                             lambda: scatter_all("kernel")),
                 in_bytes + 4 * nq * w),
                ("compact", (lambda: ub.compact_plain(
                    words["kernel"].cpu(), v),
                    lambda: ub.compact(words["kernel"], v)),
                 4 * nq * w + 8 * (nq + 1) + 4 * len(ids))):
            plain, kern = fns
            p1, k1, k2, p2 = (cuda_ms(plain, 3), cuda_ms(kern, 20),
                              cuda_ms(kern, 20), cuda_ms(plain, 3))
            row = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                       turns_ms=[p1, k1, k2, p2],
                       bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes",
                       bytes_moved=int(nbytes), library_ms=None,
                       max_abs_err=0.0)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            rows[f"{name}_{part}"] = row
            print(f"union {name} {part}: bit-equal to plain; kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
                  f"(plain, kernel, kernel, plain = "
                  + ", ".join(f"{t:.4f}" for t in row["turns_ms"])
                  + f"); bound {row['bound_ms']:.5f} ms ({int(nbytes)} B): "
                  f"{100 * row['share_of_bound']:.1f} % of it by events")
        rec[name] = dict(query_vertices=nq, row_words=w,
                         chunks=stats["chunks"], replayed=len(chunks),
                         hit_rows=int(hits["kernel"]), ids=len(ids),
                         search_hit_rows=stats["hit_rows"])
        print(f"union {name}: {nq} query vertices x {w} words, "
              f"{len(chunks)} of {stats['chunks']} chunks replayed, "
              f"{int(hits['kernel'])} hit rows, {len(ids)} ids")
        del chunks, words, hits
    record["union"] = dict(rec, rows=rows)
    return rows


def pe_streamed_phase(g, queries, device, record, oracle, table_eng,
                      block_size=BLOCK_SIZE) -> int:
    """The PE index served past device memory (``resident=False``
    forced): the bucketed host build with a disk spill through the
    engine (the main path), held to the table phase's device build and
    the PE oracle; then the comparison queries against table mode cold,
    warm, prefilled, degraded and uncached; what stays resident;
    ``auto_resident``; save, load, close.  Returns the main path's A1
    launches."""
    import os

    import torch
    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.engine import PEEngine
    from gnnpe_tpu_torch.index import device_packed as dp
    from gnnpe_tpu_torch.io.datasets import sample_query
    cfg = PEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS)
    table = table_eng.searcher
    table_bytes = table._host_vids.nbytes
    l = table._host_vids.shape[1]
    block_bytes = block_size * l * 4
    eng = PEEngine(cfg, g, device)
    eng.paths = oracle["paths"]     # the array phase's host rows
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="gnnpe_smoke_") as tmp:
        spill_dir = os.path.join(tmp, "spill")
        runs, launches = _engine_phase(
            "pe_streamed", eng, queries, device, record, block_size,
            build_kw=dict(table=True, resident=False, spill_dir=spill_dir,
                          cache_bytes=STREAM_POOL_BLOCKS * block_bytes))
        rec = record["pe_streamed"]
        rec["main_path_peak_device_bytes"] = (
            torch.cuda.max_memory_allocated() - base)
        idx = eng.searcher
        check(type(idx) is dp.StreamedPESearch and eng.index is None,
              "pe_streamed: build_index(resident=False) did not build a "
              "streamed index")
        check(isinstance(idx._host_vids, np.memmap)
              and os.listdir(spill_dir) == [os.path.basename(
                  idx._owned_dir)]
              and os.listdir(idx._owned_dir) == [os.path.basename(
                  idx._owned_table_path)],
              "pe_streamed: the sorted table is not the one file left in "
              "the build's own directory under the spill directory")
        rec["build_timings"] = eng.build_timings
        check(np.array_equal(idx._host_vids, table._host_vids),
              "pe_streamed: the bucketed build's vid table differs from the "
              "device build's")
        check(all(torch.equal(getattr(idx, k), getattr(table, k))
                  for k in ("b_ub", "b_llo", "b_lhi", "b_deg")),
              "pe_streamed: summaries differ from the device build's")
        check(np.array_equal(idx._blk_sig_first, table._blk_sig_first)
              and np.array_equal(idx._blk_sig_last, table._blk_sig_last),
              "pe_streamed: signature ranges differ from the device build's")
        for i in range(len(queries)):
            _check_query("pe_streamed", i, runs, oracle["wants"][i],
                         oracle["counts"][i])
        print(f"pe_streamed: bucketed build ({eng.build_timings['n_buckets']} "
              f"buckets, {eng.build_timings['spilled_bytes']} B spilled) "
              "equals the device build's vid table, summaries and signature "
              f"ranges; {len(queries)} queries x {sorted(runs)} equal the PE "
              "oracle; build: " + json.dumps(eng.build_timings) + " stages ms: "
              + json.dumps(idx.build_phase_ms))

        # The comparison queries, each pass in turns with table mode.
        tables = [eng._stack([eng._query_table(
            sample_query(g, QUERY_SIZE, seed=s))]) for s in MODE_QUERIES]
        idx.degrade_cache(1.0)               # an empty pool, same budget
        passes = {"cold": _stream_pass("cold", tables, table, idx)}
        check(passes["cold"]["misses"] > 0, "pe_streamed: a cold pool hit")
        passes["warm"] = _stream_pass("warm", tables, table, idx)
        check(passes["warm"]["hits"] > 0, "pe_streamed: no hit when warm")
        check(passes["warm"]["evictions"] > 0,
              "pe_streamed: a pool of a quarter of the index never evicted")
        passes["warm_host_union"] = _stream_pass("warm host", tables, table,
                                                 idx, union="host")
        passes["hot"] = _stream_pass("hot", tables, table, idx, repeat=True)
        # What is resident: nothing of the table's size.
        tensors = idx.resident_tensors()
        sizes = {k: int(t.numel() * t.element_size())
                 for k, t in tensors.items()}
        rec["resident_bytes"] = sizes
        check("cache_pool" in sizes and sum(sizes.values()) < table_bytes
              and all(t.is_cuda for t in tensors.values()),
              f"pe_streamed: resident tensors {sizes} against a table of "
              f"{table_bytes} B")
        t0 = time.perf_counter()
        loaded = idx.prefill_cache(order="popular")
        torch.cuda.synchronize()
        rec["prefill"] = dict(blocks=loaded, s=time.perf_counter() - t0)
        check(loaded > 0, "pe_streamed: prefill_cache loaded nothing")
        passes["prefilled"] = _stream_pass("prefilled", tables, table, idx)
        budget = idx.degrade_cache(0.5)
        check(idx._cache is None and budget == STREAM_POOL_BLOCKS
              * block_bytes / 2, "pe_streamed: degrade_cache(0.5)")
        passes["degraded"] = _stream_pass("degraded", tables, table, idx)
        check(passes["degraded"]["pool_blocks"] == STREAM_POOL_BLOCKS // 2,
              "pe_streamed: the degraded pool's capacity")
        idx.degrade_cache(1.0)
        idx.use_cache = False
        passes["uncached"] = _stream_pass("uncached", tables, table, idx)
        check(idx._cache is None and passes["uncached"]["misses"] == 0
              and passes["uncached"]["uploaded_bytes_per_query"] > 0,
              "pe_streamed: the uncached pass used a pool")
        idx.use_cache = True
        rec["passes"] = passes
        for name, ps in passes.items():
            print(f"pe_streamed {name}: " + json.dumps(ps))
        rec["peak_phase_device_bytes"] = (torch.cuda.max_memory_allocated()
                                          - base)
        table_peak = record["pe_table"]["main_path_peak_device_bytes"]
        check(rec["peak_phase_device_bytes"] < table_peak,
              f"pe_streamed: peak {rec['peak_phase_device_bytes']} B on the "
              f"card, table mode's main path {table_peak} B")
        print(f"pe_streamed: resident {sum(sizes.values())} B (pool "
              f"{sizes['cache_pool']} B) against a vid table of {table_bytes}"
              f" B; peak over the phase {rec['peak_phase_device_bytes']} B "
              f"(table mode's main path {table_peak} B)")

        # auto_resident with the card's own free memory, and a budget
        # just under the table.
        p = int(eng.paths.shape[0])
        free = torch.cuda.mem_get_info(device)[0]
        rec["auto_resident"] = dict(
            free_bytes=int(free),
            card=dp.auto_resident(p, l, block_size, device),
            under_table=dp.auto_resident(p, l, block_size, device,
                                         budget_bytes=table_bytes - 1))
        check(rec["auto_resident"]["card"]
              and not rec["auto_resident"]["under_table"],
              f"pe_streamed: auto_resident {rec['auto_resident']}")

        # save, load over the memmap sidecar, one query, close.
        fp = os.path.join(tmp, "dblp_pe_streamed.npz")
        t0 = time.perf_counter()
        idx.save(fp)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded_idx = dp.load(fp, eng.vertices, device,
                             cache_bytes=STREAM_POOL_BLOCKS * block_bytes)
        load_s = time.perf_counter() - t0
        check(type(loaded_idx) is dp.StreamedPESearch
              and isinstance(loaded_idx._host_vids, np.memmap)
              and os.path.exists(fp + ".vids.bin"),
              "pe_streamed: the saved index did not load over its sidecar")
        eng.searcher = loaded_idx
        for union in ("host", "device"):
            r = eng.online(queries[0], union=union)
            check(r.answer_count == oracle["counts"][0] and all(
                np.array_equal(a, b)
                for a, b in zip(r.candidates, oracle["wants"][0])),
                f"pe_streamed: loaded index, query 0 {union}: differs")
        rec["save_load"] = dict(
            save_s=save_s, load_s=load_s,
            file_bytes=os.path.getsize(fp) + os.path.getsize(fp + ".vids.bin"))
        loaded_idx.close()
        idx.close()
        check(os.listdir(spill_dir) == [] and idx.resident_tensors() == {},
              "pe_streamed: close() left the spill file or device tensors")
        try:
            idx.search(tables[0])
            check(False, "pe_streamed: a closed index answered")
        except RuntimeError:
            pass
        print(f"pe_streamed: auto_resident says resident with {free} B free "
              f"and streamed with a budget under the table; save "
              f"{save_s:.2f} s, load {load_s:.2f} s over the memmap sidecar, "
              "query 0 equal under both unions; close() removed the spill "
              "file")
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
    launches += _preverify_check("pge", eng, g, queries, runs, record,
                                 counts_must_hold=True)
    return launches, dict(group=eng.group, label_group=eng.label_group,
                          wants=wants, counts=counts, engine=eng)


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
            lambda: lay.apply_perm(h, gather=_bag),
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


# ---- the multi-device phase ------------------------------------------------

def _plan_bytes(dev, d: int) -> int:
    """Bytes one ``RectBinnedDevice.apply`` must move: every table and
    padcnt read once and its rows written once, every level's input read
    once (level 0 reads the layout's source rows)."""
    moved = sum(4 * t.rows * t.width + 4 * t.rows * d
                + (4 * t.rows if t.padcnt is not None else 0)
                for lv in dev.plan.levels for t in lv.tables)
    return moved + sum(
        4 * (dev.num_src_rows if lv.src_row is None else lv.src_rows) * d
        for lv in dev.plan.levels)


def rect_kernel_rows(hplan, bplan, device, record) -> tuple:
    """Both kernels at this slice's shapes — rank 0's shard of the 4-way
    plans, f32 D=2 (the trainer's) and D=128: A1 summing ``own_pad +
    n·halo_pad`` source rows into ``own_pad`` rows, A2 over the local and
    the halo group's launch plans.  Each is held bit-equal to its plain
    version and timed beside its library call; returns (A1 rows, A2
    rows) for the kernels record."""
    import torch
    from gnnpe_tpu_torch.ops import ell, spmm
    pair = hplan.local_pair(0, device)
    n_ext = hplan.own_pad + hplan.num_shards * hplan.halo_pad
    arcs = int(pair.neighbors.numel())
    local = bplan.local_layouts[0].on(device)
    halo = bplan.halo_layouts[0].on(device)
    slots = bplan.local_layouts[0].num_slots + bplan.halo_layouts[0].num_slots
    record["multi"]["rect_shapes"] = dict(
        a1=dict(source_rows=n_ext, output_rows=hplan.own_pad, arcs=arcs),
        a2=dict(local=dict(source_rows=local.num_src_rows,
                           output_rows=local.num_out,
                           launches=local.launches_per_apply),
                halo=dict(source_rows=halo.num_src_rows,
                          output_rows=halo.num_out,
                          launches=halo.launches_per_apply), slots=slots))

    rng = np.random.RandomState(4)
    a1_rows, a2_rows = {}, {}
    for d in (2, 128):
        name = f"rect_f32_d{d}"
        x = torch.from_numpy(rng.rand(n_ext, d).astype(np.float32)).to(device)
        got = spmm.neighbor_sum(pair.offsets, pair.neighbors, x,
                                rectangular=True)
        plain = spmm.neighbor_sum_plain(pair.offsets, pair.neighbors, x)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(got.shape == (hplan.own_pad, d) and torch.equal(got, plain),
              f"spmm_csr {name} differs from its plain version (max abs "
              f"err {err})")
        adj = torch.sparse_csr_tensor(
            pair.offsets, pair.neighbors,
            torch.ones(arcs, dtype=x.dtype, device=device),
            size=(hplan.own_pad, n_ext))
        check(torch.allclose(torch.sparse.mm(adj, x), plain, rtol=1e-5),
              f"torch.sparse.mm {name} differs from the plain version")
        a1_rows[name] = dict(max_abs_err=err, **_measure(
            lambda: spmm.neighbor_sum_plain(pair.offsets, pair.neighbors, x),
            lambda: spmm.neighbor_sum(pair.offsets, pair.neighbors, x,
                                      rectangular=True),
            lambda: torch.sparse.mm(adj, x),
            bytes_moved=4 * (hplan.own_pad + 1) + 4 * arcs
            + 4 * d * (n_ext + hplan.own_pad),
            operations=arcs * d, bytes_gathered=arcs * d * 4))
        _print_turns(f"spmm_csr {name} ({n_ext} -> {hplan.own_pad} rows)",
                     a1_rows[name])
        del adj

        xo = x[:local.num_src_rows].contiguous()
        xh = torch.from_numpy(rng.rand(halo.num_src_rows, d).astype(
            np.float32)).to(device)

        def both(gather=None):
            return local.apply(xo, gather=gather), halo.apply(xh,
                                                              gather=gather)
        got, plain = both(), both(ell.gather_sum_plain)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
        check(all(torch.equal(a, b) for a, b in zip(got, plain)),
              f"ell_gather_sum {name} differs from its plain version (max "
              f"abs err {err})")
        a2_rows[name] = dict(max_abs_err=err, **_measure(
            lambda: both(ell.gather_sum_plain), both, lambda: both(_bag),
            bytes_moved=_plan_bytes(local, d) + _plan_bytes(halo, d),
            operations=slots * d, bytes_gathered=slots * d * 4))
        _print_turns(f"ell_gather_sum {name} (local + halo group, "
                     f"{local.launches_per_apply + halo.launches_per_apply} "
                     "launches)", a2_rows[name])
    return a1_rows, a2_rows


def _step_inputs(g, num_paths: int, seed=0, batch_size=1024):
    """A model factory with ``fit``'s initial weights for ``seed``
    (``models/train.py``), and MULTI_STEPS batches of random path pairs.
    ``fit``'s own positives are dominated by construction under the
    monotone model, so their hinge is ~0; random pairs give every step a
    loss that moves."""
    import torch
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.ops.mt19937 import label_feature_table

    def model(device):
        m = PathGNN(dim=2, num_layers=1, labels_count=g.labels_count,
                    activation="softplus", device=device)
        return m.init(torch.Generator().manual_seed(seed),
                      label_table=label_feature_table(g.labels_count, 2))

    batches = np.random.RandomState(seed + 1).randint(
        0, num_paths, size=(MULTI_STEPS, batch_size, 2))
    return model, batches.astype(np.int64)


def _single_device_step(g, model, device, paths):
    """``fit``'s inner loop as a step function: ``dominance_loss`` over
    the binned aggregation (kernel A2, forward and backward) with the
    readout plans of ``paths`` (the step's ``paths`` must be them), and
    Adam at ``fit``'s settings."""
    from gnnpe_tpu_torch.models.gnn import dominance_loss
    from gnnpe_tpu_torch.models.train import readout_plans
    from gnnpe_tpu_torch.ops.ell import (BinnedEllDevice, binned_aggregate,
                                         build_binned_ell)
    aggregate = binned_aggregate(BinnedEllDevice.from_host(
        build_binned_ell(g.offsets, g.neighbors), device))
    labels_plan, paths_plan = readout_plans(model, g, paths)
    opt = _adam(model)

    def step(labels, paths, pairs):
        opt.zero_grad(set_to_none=True)
        loss = dominance_loss(model, labels, paths, pairs, aggregate,
                              labels_plan=labels_plan, paths_plan=paths_plan)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def _adam(model):
    import torch
    return torch.optim.Adam(model.parameters(), lr=1e-2, betas=(0.9, 0.999),
                            eps=1e-8)


def _timed_steps(step, labels, paths_t, batches, device) -> tuple:
    """(losses, ms per step) of ``step`` over ``batches``: the first
    batch's step is the warm-up and is not timed, the rest are, the card
    synchronised at both ends."""
    import torch
    losses = [float(step(labels, paths_t,
                         torch.from_numpy(batches[0]).to(device)))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [float(step(labels, paths_t, torch.from_numpy(b).to(device)))
               for b in batches[1:]]
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)


def _zero_counts(*modules) -> None:
    for m in modules:
        m.LAUNCHES = 0


def _launch_reader(spmm, ell, gather, what: str, counts: dict):
    """``read(path, a1, a2, seg=0)``: the (A1, A2, segment_sum) launches
    since the last reading must be exactly (a1, a2, seg); they are kept
    in ``counts[path]`` and the counts go back to 0, so that the next
    path is read alone."""
    def read(path, a1, a2, seg=0):
        got = (spmm.LAUNCHES, ell.LAUNCHES, gather.LAUNCHES)
        check(got == (a1, a2, seg), f"{what}, {path}: launched {got} (A1, "
              f"A2, segment_sum), the path says {(a1, a2, seg)}")
        counts[path] = list(got)
        _zero_counts(spmm, ell, gather)
    return read


def multi_device_phase(g, queries, device, record, pe_oracle, pge_oracle,
                       index_file) -> tuple:
    """World size 1 on NCCL in this process, then MULTI_RANKS ranks on the
    one card over gloo; returns the phase's (A1, A2) launches in this
    process and the kernels' rows at the rectangular shapes."""
    import os
    import pickle

    import torch
    import torch.distributed as dist
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.graph.partition import partition_graph
    from gnnpe_tpu_torch.ops import ell, gather, spmm
    from gnnpe_tpu_torch.parallel.binned_halo import BinnedHaloPlan
    from gnnpe_tpu_torch.parallel.dist import (make_distributed_train_step,
                                               shard_edges)
    from gnnpe_tpu_torch.parallel.halo import HaloPlan
    from gnnpe_tpu_torch.parallel.launch import run_ranks
    from gnnpe_tpu_torch.parallel.mesh import (make_mesh,
                                               maybe_distributed_init)
    rec = record["multi"] = {"world1_launches": {}}
    t_phase = time.perf_counter()
    read = _launch_reader(spmm, ell, gather, "multi world 1",
                          rec["world1_launches"])
    with tempfile.TemporaryDirectory(prefix="gnnpe_smoke_pg_") as tmp:
        maybe_distributed_init("cuda", init_method="file://"
                               + os.path.join(tmp, "store"), rank=0,
                               world_size=1)
        mesh = make_mesh(1, axes=("graph",), shape=(1,), device="cuda")
        group = mesh.get_group("graph")
        one = torch.ones(4, device=device)
        dist.all_reduce(one, group=group)
        torch.cuda.synchronize()
        check(dist.get_backend(group) == "nccl" and bool((one == 1).all()),
              "multi: the world-size-1 group is not a working NCCL group")

        # Both engines over the mesh, packed and flat, both unions.
        t0 = time.perf_counter()
        _zero_counts(spmm, ell, gather)
        search_ms = {}
        for variant, oracle in (("pe", pe_oracle), ("pge", pge_oracle)):
            eng = oracle["engine"]
            for packed in (True, False):
                eng.attach_mesh(mesh, packed=packed)
                for union in ("host", "device"):
                    ms = []
                    for i, q in enumerate(queries):
                        r = eng.online(q, union=union)
                        ms.append(r.timings_ms["search"])
                        _check_query(
                            f"multi world 1 {variant} packed={packed}", i,
                            {union: [None] * i + [r]}, oracle["wants"][i],
                            oracle["counts"][i])
                    search_ms[f"{variant}_{'packed' if packed else 'flat'}_"
                              f"{union}"] = _percentiles(ms)
            eng.searcher = None
        read("search (a query's VDE)", 2 * 2 * 2 * len(queries), 0)
        rec["world1_search_ms"] = search_ms
        rec["world1_search_s"] = time.perf_counter() - t0
        print(f"multi world 1 (NCCL): PE and PGE through attach_mesh, packed "
              f"and flat, both unions, {len(queries)} queries each equal the "
              "oracles; search ms: " + json.dumps(search_ms))

        # Aggregation over one shard against A1's square sum.
        off, nbr, labels, _ = to_device(g, device)
        x = np.random.RandomState(5).rand(g.num_vertices, 128).astype(
            np.float32)
        want = spmm.neighbor_sum(off, nbr, torch.from_numpy(x).to(device))
        one_shard = np.zeros(g.num_vertices, np.int64)
        for cls, exact in ((HaloPlan, True), (BinnedHaloPlan, False)):
            plan = cls.build(g.offsets, g.neighbors, one_shard, 1)
            agg = plan.make_aggregate(mesh, device)
            _zero_counts(spmm, ell, gather)         # the oracle's launch
            out = agg(torch.from_numpy(plan.shard_features(x)[0]).to(device))
            read(f"{cls.__name__} aggregation", *agg.launches[0])
            got = torch.from_numpy(plan.unshard_features(
                out.cpu().numpy()[None])).to(device)
            check(torch.equal(got, want) if exact else torch.allclose(
                got, want, rtol=1e-4, atol=1e-4),
                f"multi world 1: {cls.__name__} aggregation differs from "
                f"neighbor_sum (max abs {float((got - want).abs().max())})")
        print("multi world 1: HaloPlan aggregation bit-equal to A1's sum, "
              "BinnedHaloPlan within rtol 1e-4 / atol 1e-4 (f32 D=128)")

        # A few steps of each backend against the single device's.
        paths = pe_oracle["paths"]
        paths = np.ascontiguousarray(
            paths[::max(1, len(paths) // MULTI_TRAIN_PATHS)]
            [:MULTI_TRAIN_PATHS])
        make_model, batches = _step_inputs(g, len(paths))
        paths_t = torch.from_numpy(paths.astype(np.int64)).to(device)
        labels = labels.long()
        want_losses, single_ms = _timed_steps(
            _single_device_step(g, make_model(device), device, paths),
            labels, paths_t, batches, device)
        check(np.isfinite(want_losses).all() and min(want_losses) > 1e-3,
              f"multi world 1: the single-device losses {want_losses} say "
              "nothing")
        steps = {}
        for backend in ("binned_halo", "halo", "psum"):
            model = make_model(device)
            opt = _adam(model)
            kw = (dict(arcs=shard_edges(*g.coo(), 1)) if backend == "psum"
                  else dict(plan=(BinnedHaloPlan if backend == "binned_halo"
                                  else HaloPlan).build(
                      g.offsets, g.neighbors, one_shard, 1)))
            step = make_distributed_train_step(
                model, mesh, opt, g.num_vertices, backend=backend, **kw)
            _zero_counts(spmm, ell, gather)     # the single device's steps
            losses, ms = _timed_steps(step, labels, paths_t, batches, device)
            read(f"{backend} steps", *(MULTI_STEPS * k for k in step.launches))
            check(np.allclose(losses, want_losses, rtol=1e-3, atol=1e-5),
                  f"multi world 1: {backend} losses {losses} leave the "
                  f"single device's {want_losses}")
            steps[backend] = dict(step_ms=ms, losses=losses)
        rec["world1_steps"] = dict(single_device_losses=want_losses,
                                   single_device_step_ms=single_ms, **steps)
        print(f"multi world 1: {MULTI_STEPS} steps of binned_halo, halo and "
              "psum track the single-device step's losses (fit's inner loop, "
              "binned) within rtol 1e-3: " + json.dumps(rec["world1_steps"]))
        dist.destroy_process_group()
    launches = tuple(sum(c[k] for c in rec["world1_launches"].values())
                     for k in (0, 1, 2))
    check(min(launches) > 0, f"multi world 1 launched {launches} kernels")
    print("multi world 1: (A1, A2, segment_sum) launches, each path read "
          "alone and equal "
          "to what it says it launches: " + json.dumps(rec["world1_launches"]))

    # The 4-way plans: their sizes, and both kernels at rank 0's shapes.
    t0 = time.perf_counter()
    n = MULTI_RANKS
    membership = partition_graph(g, n)
    rec["partition_s"] = time.perf_counter() - t0
    hplan = HaloPlan.build(g.offsets, g.neighbors, membership, n)
    bplan = BinnedHaloPlan.build(g.offsets, g.neighbors, membership, n)
    rec["plans"] = dict(
        shard_vertices=[int(c) for c in bplan.counts], own_pad=bplan.own_pad,
        halo_pad=bplan.halo_pad, halo_rows_sent=n * n * bplan.halo_pad,
        psum_rows=n * g.num_vertices, local_arcs=bplan.num_local_arcs,
        halo_arcs=bplan.num_halo_arcs, slots=bplan.num_slots)
    print("multi: 4-way plans: " + json.dumps(rec["plans"]))
    a1_rows, a2_rows = rect_kernel_rows(hplan, bplan, device, record)

    # Four ranks on this card over gloo.
    exchange = os.path.join(os.path.dirname(index_file), "exchange.pkl")
    with open(exchange, "wb") as f:
        pickle.dump(dict(index=index_file, membership=membership,
                         wants=pe_oracle["wants"],
                         counts=pe_oracle["counts"]), f)
    t0 = time.perf_counter()
    outs = run_ranks(n, "chip_smoke:multi_rank", dict(exchange=exchange),
                     group_device="cpu", timeout_s=MULTI_RANK_TIMEOUT_S)
    rec["ranks_s"] = time.perf_counter() - t0
    ranks = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("rank_record: ")]
        check(len(lines) == 1, f"multi: rank {r} printed no record:\n{out}")
        ranks.append(json.loads(lines[0][len("rank_record: "):]))
        for path in ("HaloPlan aggregation", "halo steps", "psum steps"):
            check(ranks[-1]["launches"][path][0] > 0,
                  f"multi: rank {r}, {path}: no A1 launch: {ranks[-1]}")
        for path in ("BinnedHaloPlan aggregation", "binned_halo steps"):
            check(min(ranks[-1]["launches"][path][:2]) > 0,
                  f"multi: rank {r}, {path}: a kernel did not launch: "
                  f"{ranks[-1]}")
        for path in ("binned_halo steps", "halo steps", "psum steps"):
            check(ranks[-1]["launches"][path][2] > 0,
                  f"multi: rank {r}, {path}: no segment_sum launch: "
                  f"{ranks[-1]}")
    rec["ranks"] = ranks
    for f in os.listdir(os.path.dirname(index_file)):
        os.unlink(os.path.join(os.path.dirname(index_file), f))
    os.rmdir(os.path.dirname(index_file))
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"multi: {n} ranks on one card over gloo in {rec['ranks_s']:.1f} s: "
          "every rank's answers equal the PE oracle under both unions, halo "
          "aggregation bit-equal and binned-halo within rtol 1e-4 / atol 1e-4 "
          "of the single-device sum; rank 0: " + json.dumps(ranks[0]))
    return launches, a1_rows, a2_rows


def multi_rank(rank: int, world: int, exchange: str) -> None:
    """One of the ranks that share the card (started by
    ``multi_device_phase`` through parallel/launch.py over gloo)."""
    import pickle

    import torch
    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.engine import PEEngine
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.index import device_packed as dp
    from gnnpe_tpu_torch.io.datasets import load_dataset, sample_query
    from gnnpe_tpu_torch.ops import ell, gather, spmm
    from gnnpe_tpu_torch.parallel.binned_halo import BinnedHaloPlan
    from gnnpe_tpu_torch.parallel.dist import (make_distributed_train_step,
                                               shard_edges)
    from gnnpe_tpu_torch.parallel.halo import HaloPlan
    from gnnpe_tpu_torch.parallel.mesh import make_mesh
    check(torch.cuda.is_available(), "a rank found no CUDA device")
    device = torch.device("cuda", 0)
    with open(exchange, "rb") as f:
        ex = pickle.load(f)
    g = load_dataset("dblp", seed=0)
    queries = [sample_query(g, QUERY_SIZE, seed=s) for s in QUERY_SEEDS]
    mesh = make_mesh(world, axes=("graph",), shape=(world,), device="cpu")
    out = dict(rank=rank, launches={})
    read = _launch_reader(spmm, ell, gather, f"multi rank {rank}",
                          out["launches"])

    # This rank's block range of the saved index, and the 8 queries.
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, n=MAX_ANSWERS), g, device)
    eng.vertices = eng._vde(g)
    t0 = time.perf_counter()
    eng.searcher = dp.load(ex["index"], eng.vertices, device, mesh=mesh)
    out["load_s"] = time.perf_counter() - t0
    out["block_range"] = list(eng.searcher.block_range)
    out["index_bytes"] = int(sum(
        t.numel() * t.element_size()
        for t in eng.searcher.resident_tensors().values()))
    _zero_counts(spmm, ell, gather)             # the data graph's VDE
    for union in ("host", "device"):
        ms = []
        for i, q in enumerate(queries):
            r = eng.online(q, union=union)
            ms.append(r.timings_ms["search"])
            _check_query(f"multi rank {rank}", i, {union: [None] * i + [r]},
                         ex["wants"][i], ex["counts"][i])
        out[f"search_{union}_ms"] = _percentiles(ms)
    eng.searcher = None
    read("search (a query's VDE)", 2 * len(queries), 0)

    # Halo and binned-halo aggregation over the shards, row for row
    # against the single device's sum of the same x.
    off, nbr, labels, _ = to_device(g, device)
    x = np.random.RandomState(5).rand(g.num_vertices, 128).astype(np.float32)
    want = spmm.neighbor_sum(off, nbr, torch.from_numpy(x).to(device))
    plans = {}
    for name, cls, exact in (("halo", HaloPlan, True),
                             ("binned_halo", BinnedHaloPlan, False)):
        plan = plans[name] = cls.build(g.offsets, g.neighbors,
                                       ex["membership"], world)
        agg = plan.make_aggregate(mesh, device)
        own = torch.from_numpy(plan.shard_features(x)[rank]).to(device)
        _zero_counts(spmm, ell, gather)             # the oracle's launch
        got = agg(own)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            agg(own)
        torch.cuda.synchronize()
        out[f"{name}_aggregate_ms"] = (time.perf_counter() - t0) * 1e3 / 3
        read(f"{cls.__name__} aggregation", *(4 * k for k in agg.launches[0]))
        vids = torch.from_numpy(plan.own_vertex_ids()[rank].astype(
            np.int64)).to(device)
        real = int(np.bincount(ex["membership"], minlength=world)[rank])
        got, ref = got[:real], want[vids[:real]]
        check(torch.equal(got, ref) if exact else torch.allclose(
            got, ref, rtol=1e-4, atol=1e-4),
            f"multi rank {rank}: {name} aggregation differs from the single "
            f"device's (max abs {float((got - ref).abs().max())})")
    out["own_rows"] = real

    # Three steps of each backend, timed; losses equal on every rank.
    paths = np.random.RandomState(6).randint(
        0, g.num_vertices, (MULTI_TRAIN_PATHS, 3))
    make_model, batches = _step_inputs(g, len(paths))
    paths_t = torch.from_numpy(paths).to(device)
    labels = labels.long()
    out["step_ms"], losses = {}, {}
    for backend in ("binned_halo", "halo", "psum"):
        model = make_model(device)
        opt = _adam(model)
        kw = (dict(arcs=shard_edges(*g.coo(), world)) if backend == "psum"
              else dict(plan=plans[backend]))
        step = make_distributed_train_step(model, mesh, opt, g.num_vertices,
                                           backend=backend, **kw)
        losses[backend], out["step_ms"][backend] = _timed_steps(
            step, labels, paths_t, batches[:4], device)
        read(f"{backend} steps", *(4 * k for k in step.launches))
    check(losses["binned_halo"][0] > 1e-3, f"multi rank {rank}: losses "
          f"{losses['binned_halo']} are zero")
    for backend in ("halo", "psum"):
        check(np.allclose(losses[backend], losses["binned_halo"], rtol=1e-3,
                          atol=1e-5),
              f"multi rank {rank}: {backend} losses {losses[backend]} leave "
              f"binned_halo's {losses['binned_halo']}")
    out["losses"] = losses["binned_halo"]
    print("rank_record: " + json.dumps(out))


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


def train_phase(g, device, record) -> tuple:
    """train_payoff.run at the dblp rung (the main path: counts set to 0
    just before, read just after), then its checks and the segment fit;
    returns the (A1, A2) launches of the run.  ``fit`` prices the binned
    layout's hubs with the card's measured constants; the recorded losses
    came from the layout of gnnpe_tpu's "cpu" row, so the two host
    layouts must be one (no hubs, the same permutation and tables).
    Returns the (A1, A2, segment_sum) launches of the run and the
    segment_sum launches of the segment fit."""
    import torch
    from gnnpe_tpu_torch.frontends import train_payoff
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.models.train import fit, readout_plans
    from gnnpe_tpu_torch.ops import ell, gather, spmm
    measured = ell.build_binned_ell(g.offsets, g.neighbors, device=device)
    pinned = ell.build_binned_ell(g.offsets, g.neighbors,
                                  hub_prices=ell.HUB_PRICES)
    hubs = 0 if measured.hub_rows is None else len(measured.hub_rows)
    check(hubs == 0 and pinned.hub_rows is None
          and measured.num_slots == pinned.num_slots
          and np.array_equal(measured.perm, pinned.perm)
          and all(np.array_equal(a, b) for a, b in zip(
              measured.class_tables + measured.head_tables,
              pinned.class_tables + pinned.head_tables)),
          f"train: the dblp layout priced by the card ({hubs} hubs, "
          f"{measured.num_slots} slots) is not the pinned row's "
          f"({pinned.num_slots} slots) that the recorded losses came from")
    # The plan depends on the tables' shapes only: laid out on the host.
    launches_per_apply = ell.BinnedEllDevice.from_host(
        measured, "cpu").launches_per_apply
    del measured, pinned
    _zero_counts(spmm, ell, gather)
    t0 = time.perf_counter()
    pay = train_payoff.run("dblp", queries=TRAIN_QUERIES, steps=TRAIN_STEPS,
                           device=device)
    wall_s = time.perf_counter() - t0
    launches = (spmm.LAUNCHES, ell.LAUNCHES, gather.LAUNCHES)
    fixed_row, trained_row = pay.rows
    hist = pay.state.history
    aggregation = trained_row["aggregation"]
    rec = dict(wall_s=wall_s, spmm_launches=launches[0],
               ell_launches=launches[1], segment_sum_launches=launches[2],
               aggregation=aggregation,
               hubs_with_measured_prices=hubs,
               train_paths=int(len(pay.train_paths)),
               launches_per_apply=launches_per_apply,
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
    check(launches[0] > 0, "train phase launched no spmm_csr kernel")
    check(np.isfinite(hist).all() and len(hist) == TRAIN_STEPS,
          "loss history not finite")
    check(hist[-1] < hist[0], f"loss did not fall: {hist[0]} -> {hist[-1]}")
    check(all(abs(got - want) < 5e-5 for got, want in
              zip((hist[0], hist[-1]), TRAIN_LOSS_FIRST_LAST)),
          f"loss {hist[0]:.6f} -> {hist[-1]:.6f} left the recorded "
          f"{TRAIN_LOSS_FIRST_LAST}")

    # The readout plans fit builds for these paths, laid out on the host.
    cpu_model = PathGNN(dim=2, num_layers=1, labels_count=g.labels_count,
                        device="cpu")
    readout = sum(p.launches_per_backward for p in readout_plans(
        cpu_model, g, pay.train_paths))
    rec["readout_launches_per_step"] = readout
    # One forward and one backward apply_perm per step, one A2 launch per
    # level each (the backward went through the kernel too), and each
    # readout plan's segment sums in the backward.
    want = 2 * launches_per_apply * TRAIN_STEPS
    check(launches[1] == want,
          f"{launches[1]} ell_gather_sum launches in fit, want {want} "
          f"(2 x {launches_per_apply} x {TRAIN_STEPS})")
    check(launches[2] == readout * TRAIN_STEPS,
          f"{launches[2]} segment_sum launches in fit, want "
          f"{readout * TRAIN_STEPS} ({readout} x {TRAIN_STEPS})")

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
    _zero_counts(ell, gather)
    st = fit(seg, g, pay.train_paths, num_steps=SEGMENT_STEPS,
             batch_size=1024, seed=0, negatives=True, learning_rate=1e-2,
             aggregation="segment", device=device)
    seg_launches = (ell.LAUNCHES, gather.LAUNCHES)
    check(seg_launches == (0, readout * SEGMENT_STEPS),
          f"segment fit: {seg_launches} (A2, segment_sum) launches, the "
          f"readout plans say (0, {readout * SEGMENT_STEPS})")
    diff = np.abs(np.asarray(st.history) - np.asarray(hist[:SEGMENT_STEPS]))
    rec["segment"] = dict(steps=SEGMENT_STEPS, step_ms=st.steps_s
                          / SEGMENT_STEPS * 1e3, max_abs_diff=float(diff.max()),
                          a2_launches=seg_launches[0],
                          segment_sum_launches=seg_launches[1])
    check(np.allclose(st.history, hist[:SEGMENT_STEPS], rtol=1e-3,
                      atol=1e-5),
          f"segment fit's losses leave the binned ones (max diff "
          f"{diff.max()})")
    print(f"train: {SEGMENT_STEPS}-step segment fit tracks binned within "
          f"rtol 1e-3 (max abs diff {diff.max():.3e}, "
          f"{rec['segment']['step_ms']:.3f} ms/step)")
    torch.cuda.synchronize()
    return launches, seg_launches[1]


def train_streamed_phase(g, device, record, pe_host) -> tuple:
    """``train_payoff.run`` on PE with ``force_streamed=True`` at the
    dblp rung, cut to STREAMED_STEPS steps and STREAMED_QUERIES queries
    (the main path: counts set to 0 just before, read just after): both
    engines served by the streamed index (``mode`` "streamed"), the
    trained answers equal to the fixed ones (the run's own assertion),
    the fixed embedder's candidates equal to the flat f64 host filter over
    the PE phase's host paths and numpy VDE, A2 and segment_sum launched
    as ``fit`` says.  Returns the (A1, A2, segment_sum) launches."""
    import torch
    from gnnpe_tpu_torch.frontends import train_payoff
    from gnnpe_tpu_torch.ops import ell, gather, spmm
    _zero_counts(spmm, ell, gather)
    t0 = time.perf_counter()
    pay = train_payoff.run("dblp", queries=STREAMED_QUERIES,
                           steps=STREAMED_STEPS, variant="pe",
                           device=device, force_streamed=True)
    wall_s = time.perf_counter() - t0
    launches = (spmm.LAUNCHES, ell.LAUNCHES, gather.LAUNCHES)
    fixed_row, trained_row = pay.rows
    hist = pay.state.history
    per_apply = record["train"]["launches_per_apply"]
    stats = {who: [dict(cache_misses=st["cache_misses"],
                        uploaded_bytes=st["uploaded_bytes"],
                        chunks=st["chunks"], survived=st["survived"])
                   for st in sts]
             for who, sts in (("fixed", pay.fixed_stats),
                              ("trained", pay.trained_stats))}
    rec = record["train_streamed"] = dict(
        wall_s=wall_s, spmm_launches=launches[0], ell_launches=launches[1],
        segment_sum_launches=launches[2], steps=STREAMED_STEPS,
        queries=STREAMED_QUERIES, train_s=trained_row["train_s"],
        step_ms=trained_row["step_ms"], loss_first=hist[0],
        loss_last=hist[-1], per_query=stats, fixed=fixed_row,
        trained=trained_row)
    for who, sts in stats.items():
        print(f"train streamed: {who} search per query: cache misses "
              f"{[s['cache_misses'] for s in sts]}, uploaded bytes "
              f"{[s['uploaded_bytes'] for s in sts]}")
    print(f"train streamed: PE, {STREAMED_STEPS} steps in "
          f"{rec['train_s']:.2f} s, loss {hist[0]:.6f} -> {hist[-1]:.6f}; "
          f"mode {fixed_row['mode']} / {trained_row['mode']}; chunks_mean "
          f"fixed {fixed_row['chunks_mean']}, trained "
          f"{trained_row['chunks_mean']}; blocks_survived_mean fixed "
          f"{fixed_row['blocks_survived_mean']}, trained "
          f"{trained_row['blocks_survived_mean']}; candidates "
          f"-{trained_row['candidate_reduction_pct']:.2f} %; "
          f"{wall_s:.1f} s in all")
    check(fixed_row["mode"] == trained_row["mode"] == "streamed",
          f"train streamed: mode {fixed_row['mode']} / "
          f"{trained_row['mode']}, not streamed")
    check(np.isfinite(hist).all() and len(hist) == STREAMED_STEPS,
          "train streamed: loss history not finite")
    check(launches[0] > 0, "train streamed launched no spmm_csr kernel")
    want = (2 * per_apply * STREAMED_STEPS, 2 * STREAMED_STEPS)
    check(launches[1:] == want, f"train streamed: {launches[1:]} (A2, "
          f"segment_sum) launches in fit, want {want}")
    # The fixed embedder's candidates against the flat f64 host filter.
    wants = _pe_oracle(pe_host["vertices"], pe_host["paths"], pay.queries,
                       pay.engine.config)
    for i, (want, fx) in enumerate(zip(wants, pay.fixed)):
        check(len(fx.candidates) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(fx.candidates, want)),
            f"train streamed query {i}: fixed candidates differ from the "
            "flat f64 oracle")
    print(f"train streamed: {len(pay.queries)} trained answers equal the "
          "fixed ones; the fixed candidates equal the flat f64 oracle")
    pay.engine.searcher.close()
    torch.cuda.synchronize()
    return launches


# ---- the probe, ladder, uniform-ELL and profile phases ---------------------

def _hub_layout_bytes(lay, d: int, count_bytes: int) -> int:
    """Bytes one ``BinnedEllDevice.apply_perm`` must move: the plan's
    (every table and padcnt read once, its rows written once, every
    level's input read once), the hub counts at ``count_bytes`` a count
    (on the card ``ops/ell.py:CUDA_HUB_ENTRY_BYTES``: B is f32 there),
    the hub rows read once and the output written once more by the
    product's add."""
    plan = lay.plan
    moved = sum(4 * t.rows * t.width + 4 * t.rows * d
                + (4 * t.rows if t.padcnt is not None else 0)
                for lv in plan.levels for t in lv.tables)
    moved += sum(4 * lv.src_rows * d for lv in plan.levels)
    if lay.hub_counts is not None:
        h = lay.hub_counts.shape[1]
        moved += (count_bytes * lay.num_vertices * h + 4 * h * d
                  + 4 * lay.num_vertices * d)
    return moved


def _layout_turns(with_hubs, without, xs) -> dict:
    """``apply_perm`` of two layouts of one graph in turns (with,
    without, without, with) by CUDA events, and each on the card alone,
    at every width of ``xs`` (D -> x)."""
    out = {}
    for d, x in xs.items():
        hw, hn = with_hubs.permute(x), without.permute(x)
        turns = [cuda_ms(lambda: lay.apply_perm(h), 10) for lay, h in
                 ((with_hubs, hw), (without, hn), (without, hn),
                  (with_hubs, hw))]
        out[f"d{d}"] = dict(
            turns_ms=turns, with_hubs_ms=(turns[0] + turns[3]) / 2,
            without_ms=(turns[1] + turns[2]) / 2,
            with_hubs_device_ms=graph_ms(lambda: with_hubs.apply_perm(hw)),
            without_device_ms=graph_ms(lambda: without.apply_perm(hn)))
        del hw, hn
    return out


def probe_phase(device, smi, record) -> dict:
    """The measured hub prices of this card; the youtube and youtube_skew
    rungs' binned layouts built with them, each timed in turns against
    the same graph's other choice (with hubs against none, none against
    as many hubs as the memory budget holds): the prices' choice must not
    be the slower; then, on the first rung's layout with hubs,
    ``BinnedEllDevice.apply`` — A2's launch plan plus the hub product —
    bit-equal to its plain version and against A1's neighbour sum within
    the hi/lo tolerance at f32 D=2 and D=128, timed as the A2 phase times
    it.  Returns A2's rows."""
    import torch
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.io.datasets import load_dataset
    from gnnpe_tpu_torch.ops import ell, spmm
    from gnnpe_tpu_torch.utils import device_probe
    from gnnpe_tpu_torch.utils.device_probe import CPU_ROW, device_constants
    # The constants every layout of this process was priced with (the
    # first call measured them), and a second probe for their spread.
    consts = device_constants(device)
    t0 = time.perf_counter()
    again = device_probe._probe(device)
    rec = record["probe"] = dict(
        probe_s=time.perf_counter() - t0, card=smi,
        bytes_per_s=consts[0], f32_matmul_flop_per_s=consts[1],
        gather_s_per_row=consts[2], second_probe=list(again),
        cpu_row=list(CPU_ROW))
    check(all(np.isfinite(consts)) and min(consts) > 0,
          f"probe: constants {consts}")
    for what, c in (("in use", consts), ("second probe", again)):
        print(f"probe ({smi}), {what}: memory {c[0] / 1e12:.3f} TB/s, f32 "
              f"matmul (TF32 off) {c[1] / 1e12:.2f} TFLOP/s, gather "
              f"{c[2] * 1e9:.4f} ns a 512-byte row")
    print(f"probe: one probe takes {rec['probe_s']:.3f} s")
    entry, passes = ell.hub_costs(device, "hi_lo")
    rng = np.random.RandomState(7)
    found = None
    for rung in ("youtube", "youtube_skew"):
        t0 = time.perf_counter()
        g = load_dataset(rung, seed=0)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = ell.build_binned_ell(g.offsets, g.neighbors, device=device)
        build_s = time.perf_counter() - t0
        nh = 0 if host.hub_rows is None else len(host.hub_rows)
        occ = np.bincount(g.neighbors, minlength=g.num_vertices)
        v = g.num_vertices
        col_s = entry * v / consts[0] + 4.0 * v * 128 / consts[1]
        thresh = col_s / consts[2]
        over = np.sort(occ[occ > thresh])
        # The other choice: no hubs where the prices took some, else as
        # many as the 256 MB budget holds (every price but the gather's
        # free, so only the budget and max_hubs cap them).
        other = (ell.build_binned_ell(g.offsets, g.neighbors, device=device,
                                      hub_matmul=False) if nh else
                 ell.build_binned_ell(g.offsets, g.neighbors, device=device,
                                      hub_prices=(np.inf, np.inf, consts[2])))
        r = rec[rung] = dict(
            vertices=v, arcs=int(len(g.neighbors)), max_degree=g.max_degree,
            gen_s=gen_s, build_s=build_s, hub_threshold=thresh,
            entry_bytes=entry, output_passes=passes, hubs=nh,
            hub_arcs=host.num_hub_arcs, sources_over_threshold=len(over),
            # What those sources' gathers would save beyond their columns,
            # against what any hub costs in passes over the output.
            over_threshold_saves_s=float(consts[2] * over.sum()
                                         - len(over) * col_s),
            fixed_cost_s=passes * 4.0 * v * 128 / consts[0],
            hub_precision=host.hub_precision, num_slots=host.num_slots,
            other_hubs=0 if other.hub_rows is None else len(other.hub_rows),
            other_num_slots=other.num_slots)
        print(f"probe: {rung} layout with the card's prices: "
              + json.dumps(r))
        lay, alt = (ell.BinnedEllDevice.from_host(x, device)
                    for x in (host, other))
        with_hubs, without = (lay, alt) if nh else (alt, lay)
        xs = {d: torch.from_numpy(rng.rand(v, d).astype(np.float32)).to(
            device) for d in (2, 128)}
        off, nbr, _, _ = to_device(g, device)
        for d, x in xs.items():
            want = spmm.neighbor_sum(off, nbr, x)
            got = with_hubs.apply(x)
            rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
            check(rel < 2e-3, f"probe: {rung} with hubs D={d} leaves A1's "
                  f"sum by {rel} (hi/lo tolerance 2e-3)")
            del want, got
        r["turns"] = _layout_turns(with_hubs, without, xs)
        for d, t in r["turns"].items():
            print(f"probe: {rung} {d} with {r['hubs'] or r['other_hubs']} "
                  f"hubs against none, by events {t['with_hubs_ms']:.4f} / "
                  f"{t['without_ms']:.4f} ms (turns {t['turns_ms']}), on the "
                  f"card alone {t['with_hubs_device_ms']:.4f} / "
                  f"{t['without_device_ms']:.4f} ms")
            chosen, rejected = ((t["with_hubs_device_ms"],
                                 t["without_device_ms"]) if nh else
                                (t["without_device_ms"],
                                 t["with_hubs_device_ms"]))
            check(chosen <= 1.1 * rejected,
                  f"probe: {rung} {d}: the prices' layout takes {chosen:.4f} "
                  f"ms on the card, the other {rejected:.4f} ms")
        if found is None:
            found = (rung, g, host if nh else other, with_hubs, xs, off, nbr)
        del lay, alt, with_hubs, without, xs, off, nbr, other
        torch.cuda.empty_cache()
    # The hub product's own check and times: on the first rung's layout
    # with hubs, the prices' own or the budget's.
    rung, g, host, lay, xs, off, nbr = found
    rec["rung"] = rung
    rec["launches_per_apply"] = lay.launches_per_apply
    nh, v = len(host.hub_rows), g.num_vertices

    rows = {}
    for d, x in xs.items():
        h = lay.permute(x)
        ell.LAUNCHES = 0
        got = lay.apply_perm(h)
        check(ell.LAUNCHES == lay.launches_per_apply,
              f"probe: {ell.LAUNCHES} A2 launches for one apply of "
              f"{lay.launches_per_apply}")
        plain = lay.apply_perm(h, gather=ell.gather_sum_plain)
        want = lay.permute(spmm.neighbor_sum(off, nbr, x))
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"probe: A2 + hub product D={d} "
              f"differs from its plain version (max abs err {err})")
        rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        check(rel < 2e-3, f"probe: A2 + hub product D={d} leaves A1's sum "
              f"by {rel} (hi/lo tolerance 2e-3)")
        name = f"hub_{rung}_f32_d{d}"
        ops = lay.num_slots * d + 2 * v * nh * d * (
            2 if lay.hub_precision == "hi_lo" else 1)
        rows[name] = dict(max_abs_err=err, rel_err_vs_a1=rel, **_measure(
            lambda: lay.apply_perm(h, gather=ell.gather_sum_plain),
            lambda: lay.apply_perm(h), lambda: lay.apply_perm(h, gather=_bag),
            bytes_moved=_hub_layout_bytes(lay, d, ell.CUDA_HUB_ENTRY_BYTES),
            operations=ops, bytes_gathered=lay.num_slots * d * 4))
        _print_turns(f"ell_gather_sum + hub product {name} "
                     f"({lay.launches_per_apply} launches, {nh} hubs; within "
                     f"{rel:.2e} of A1)", rows[name])
    rec["rows"] = rows
    return rows


def ladder_phase(device, record, pe_oracle, pge_oracle) -> int:
    """``run_rung("dblp")`` on the 8 queries of the PE and PGE phases
    (the slice's entry point): both rows spot-verified, serving without
    error, each query's Σ|candidates| equal to the phase oracle's and the
    mean answers to the phase's counts.  Every query reaches the answer
    cap, so the candidates are what can tell a wrong search.  Returns
    A1's launches over the run."""
    from gnnpe_tpu_torch.frontends.ladder import run_rung
    from gnnpe_tpu_torch.ops import ell, spmm
    spmm.LAUNCHES = ell.LAUNCHES = 0
    t0 = time.perf_counter()
    rows = run_rung("dblp", queries=len(QUERY_SEEDS), query_size=QUERY_SIZE,
                    seed=QUERY_SEEDS[0], max_answers=MAX_ANSWERS, serve=True,
                    device=device)
    wall_s = time.perf_counter() - t0
    launches = (spmm.LAUNCHES, ell.LAUNCHES)
    record["ladder"] = dict(rows=rows, wall_s=wall_s, launches=launches)
    for row in rows:
        print("ladder row: " + json.dumps(row))
    check([r["variant"] for r in rows] == ["pe", "pge"],
          f"ladder: rows {[r['variant'] for r in rows]}")
    for row, oracle in zip(rows, (pe_oracle, pge_oracle)):
        v, counts = row["variant"], oracle["counts"]
        want = [int(sum(len(c) for c in w)) for w in oracle["wants"]]
        check(row["spot_verified"] and row["spot_verified_p90"],
              f"ladder {v}: spot check failed: {row['spot_error']}")
        check(row["serving"] is not None and "error" not in row["serving"],
              f"ladder {v}: serving failed: {row['serving']}")
        check(row["candidates"] == want,
              f"ladder {v}: candidates per query {row['candidates']}, the "
              f"{v} oracle's {want}")
        check(row["queries"] == len(counts)
              and row["mean_answers"] == round(float(np.mean(counts)), 1),
              f"ladder {v}: mean answers {row['mean_answers']} over "
              f"{row['queries']} queries, the {v} phase's {counts}")
    # One A1 launch for the data graph's VDE per variant, one a query
    # for its VDE in every search of a query (the loop, two spot
    # checks, two serving passes).
    check(launches[0] > 0 and launches[1] == 0,
          f"ladder: launched {launches} (A1, A2)")
    print(f"ladder: dblp PE and PGE rows spot-verified (query 0 and the "
          f"heaviest), serving without error, each query's candidates and "
          f"the mean answers equal to the phases' oracles; {wall_s:.1f} s, "
          f"(A1, A2) launches {launches}")
    return launches[0] + _ladder_streamed(device, record, rows[0], pe_oracle)


def _ladder_streamed(device, record, resident, pe_oracle) -> int:
    """The ladder's streamed tier at dblp: ``run_rung("dblp",
    pe_only=True)`` with a resident budget of half the table (so the
    rule, not a flag, sends the rung streamed), a pool of
    STREAM_POOL_BLOCKS (a quarter of the table) and a disk tier in a
    fresh temporary directory: the build spilled its partitions and
    mapped its table there, the candidates equal the PE oracle's, both
    spot checks hold, serving ran, the pool missed, and freeing the
    index left the directory empty.  Returns A1's launches over the
    run."""
    import os
    from gnnpe_tpu_torch.frontends.ladder import run_rung
    from gnnpe_tpu_torch.ops import ell, spmm
    block_bytes = BLOCK_SIZE * 3 * 4
    budget = resident["num_blocks"] * block_bytes / 2
    spill_dir = tempfile.mkdtemp(prefix="gnnpe_smoke_spill_")
    spmm.LAUNCHES = ell.LAUNCHES = 0
    t0 = time.perf_counter()
    (row,) = run_rung("dblp", queries=len(QUERY_SEEDS),
                      query_size=QUERY_SIZE, seed=QUERY_SEEDS[0],
                      max_answers=MAX_ANSWERS, serve=True, pe_only=True,
                      spill_dir=spill_dir,
                      cache_bytes=STREAM_POOL_BLOCKS * block_bytes,
                      resident_budget_bytes=budget, device=device)
    wall_s = time.perf_counter() - t0
    launches = (spmm.LAUNCHES, ell.LAUNCHES)
    left = os.listdir(spill_dir)
    os.rmdir(spill_dir)
    record["ladder_streamed"] = dict(row=row, wall_s=wall_s,
                                     launches=launches)
    print("ladder streamed row: " + json.dumps(row))
    pipe = row["pipeline"] or {}
    want = [int(sum(len(c) for c in w)) for w in pe_oracle["wants"]]
    check(row["mode"] == pipe.get("mode") == "streamed"
          and pipe.get("rule_need_bytes") is not None
          and row["resident_budget_bytes"] == budget,
          f"ladder streamed: mode {row['mode']}, pipeline {pipe}: the rule "
          f"did not choose streamed under a budget of {budget} B")
    check(pipe["spilled_bytes"] > 0 and pipe["table_memmap"] is True,
          f"ladder streamed: spilled {pipe['spilled_bytes']} B, table "
          f"memmap {pipe['table_memmap']}: the disk tier was not used")
    check(row["candidates"] == want,
          f"ladder streamed: candidates per query {row['candidates']}, the "
          f"PE oracle's {want}")
    check(row["mean_answers"] == round(float(np.mean(pe_oracle["counts"])),
                                       1),
          f"ladder streamed: mean answers {row['mean_answers']}")
    check(row["spot_verified"] and row["spot_verified_p90"],
          f"ladder streamed: spot check failed: {row['spot_error']}")
    check(row["serving"] is not None and "error" not in row["serving"],
          f"ladder streamed: serving failed: {row['serving']}")
    check(row["pool_blocks"] == STREAM_POOL_BLOCKS
          and row["cache_misses_sum"] > 0,
          f"ladder streamed: pool of {row['pool_blocks']} blocks, "
          f"{row['cache_misses_sum']} misses over the queries")
    check(row["spill_dir_bytes_left"] == 0 and left == [],
          f"ladder streamed: {row['spill_dir_bytes_left']} B ({left}) left "
          f"in the spill directory")
    check(launches[0] > 0 and launches[1] == 0,
          f"ladder streamed: launched {launches} (A1, A2)")
    print(f"ladder streamed: dblp PE streamed by the rule (budget {budget:.0f}"
          f" B), spilled {pipe['spilled_bytes']} B, pool "
          f"{row['pool_blocks']} blocks, {row['cache_misses_sum']} misses, "
          f"candidates equal to the oracle's, spill directory empty; "
          f"{wall_s:.1f} s, (A1, A2) launches {launches}")
    return launches[0]


def _checked_vde(g, queries, device, what):
    """The engines' VDE (``gen_vde`` on the card, through A1) of the data
    graph ``g`` and of each of ``queries`` equal bit for bit to numpy's
    ``gen_vde_host``, and A1 on ``g``'s CSR equal to its plain version.
    Returns the data graph's VDE."""
    import torch
    from gnnpe_tpu_torch.embed.vde import gen_vde, gen_vde_host
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.ops import spmm

    def equal(q, whose):
        dev, host = gen_vde(q, 2, device), gen_vde_host(q, 2)
        for name in ("x", "nx", "vde"):
            check(np.array_equal(getattr(host, name), getattr(dev, name)),
                  f"{what}: VDE {name} of {whose} on the card differs "
                  "from numpy's")
        return dev

    vertices = equal(g, "the data graph")
    for i, q in enumerate(queries):
        equal(q, f"query {i}")
    off, nbr, _, _ = to_device(g, device)
    x = torch.from_numpy(vertices.x).to(device)
    nx, plain = spmm.neighbor_sum(off, nbr, x), spmm.neighbor_sum_plain(
        off, nbr, x)
    check(torch.equal(nx, plain), f"{what}: spmm_csr f64 [{g.num_vertices}, "
          f"2] differs from its plain version (max abs err "
          f"{float((nx - plain).abs().max())})")
    return vertices


def _check_stable_order(key, order, what, step=1 << 26) -> None:
    """``order`` a permutation of ``key``'s indices (each met once, in a
    bool table) under which ``key`` does not decrease and equal keys keep
    their index order: numpy's stable argsort, checked in slices."""
    import torch
    n = len(key)
    seen = torch.zeros(n, dtype=torch.bool, device=key.device)
    ordered = True
    for lo in range(0, n, step):
        o = order[lo:lo + step + 1].long()
        seen[o] = True
        k = key[o]
        ordered &= bool(((k[1:] > k[:-1])
                         | ((k[1:] == k[:-1]) & (o[1:] > o[:-1]))).all())
    met = sum(int(seen[lo:lo + step].sum()) for lo in range(0, n, step))
    check(met == n and ordered, f"{what}: stable_order of {n} keys meets "
          f"{met} indices, in stable key order: {ordered}")


def _rows_digest(rows, device, step=1 << 26) -> tuple:
    """An order-free digest of the multiset of int32 rows (a tensor or a
    numpy table, taken to ``device`` in slices): the row count and two
    wrapping int64 sums of a mix of each row's vids."""
    import torch
    a = b = 0
    for lo in range(0, len(rows), step):
        r = torch.as_tensor(rows[lo:lo + step]).to(device).long()
        h = torch.zeros(len(r), dtype=torch.int64, device=device)
        for j in range(r.shape[1]):
            h = (h ^ r[:, j]) * 0x100000001B3
        a += int(h.sum())
        b += int(((h ^ (h >> 29)) * 0x5851F42D4C957F2D).sum())
    return len(rows), a % 2 ** 64, b % 2 ** 64


def scale_phase(device, record) -> int:
    """The ladder past dblp (``run_rung`` of each of SCALE_RUNGS on the
    card, PE then PGE): first the rung's data-graph and query VDEs on the
    card equal to numpy's bit for bit (the spot checks' oracle reads the
    engine's VDE); then the PE row's ``l``, paths and blocks (one per 512
    paths) those of gnnpe_tpu's row, built in the mode the resident rule
    chose before enumeration, the peak device memory under the card's;
    both variants' spot checks (query 0 and the heaviest against the flat
    f64 host filter) true and serving without error; then the first
    rung's build alone: its stable order of the sort key checked at full
    size, its peak under the rule's count, and its vid table, on the card
    and on the host, the enumerated rows (an order-free digest).  Returns
    A1's launches over the ladder runs (the data graphs' and the queries'
    VDEs)."""
    import torch
    from gnnpe_tpu_torch.frontends.ladder import run_rung
    from gnnpe_tpu_torch.io.datasets import load_dataset, sample_query
    from gnnpe_tpu_torch.ops import ell, spmm
    card = torch.cuda.get_device_properties(device).total_memory
    total, record["scale"], checked = 0, {}, {}
    for name, l, paths in SCALE_RUNGS:
        gc.collect()
        torch.cuda.empty_cache()
        g = load_dataset(name, seed=QUERY_SEEDS[0])
        queries = [sample_query(g, QUERY_SIZE, tree=True,
                                seed=QUERY_SEEDS[0] + i)
                   for i in range(SCALE_QUERIES)]
        checked[name] = g, _checked_vde(g, queries, device, f"scale {name}")
        spmm.LAUNCHES = ell.LAUNCHES = 0
        t0 = time.perf_counter()
        rows = run_rung(name, queries=SCALE_QUERIES, query_size=QUERY_SIZE,
                        seed=QUERY_SEEDS[0], max_answers=MAX_ANSWERS,
                        serve=True, device=device)
        wall_s = time.perf_counter() - t0
        launches = (spmm.LAUNCHES, ell.LAUNCHES)
        record["scale"][name] = dict(rows=rows, wall_s=wall_s,
                                     launches=launches)
        for row in rows:
            print(f"scale row: {json.dumps(row)}")
        check([r["variant"] for r in rows] == ["pe", "pge"],
              f"scale {name}: rows {[r['variant'] for r in rows]}")
        pe = rows[0]
        check(pe["l"] == l and pe["paths"] == paths
              and pe["num_blocks"] == -(-paths // BLOCK_SIZE),
              f"scale {name}: PE l={pe['l']}, {pe['paths']} paths, "
              f"{pe['num_blocks']} blocks; gnnpe_tpu's row: l={l}, {paths}")
        check(pe["pipeline"]["mode"] == pe["mode"],
              f"scale {name}: the rule chose {pe['pipeline']['mode']}, "
              f"the index is {pe['mode']}")
        for row in rows:
            v = row["variant"]
            check(row["spot_verified"] and row["spot_verified_p90"],
                  f"scale {name} {v}: spot check failed: {row['spot_error']}")
            check(row["serving"] is not None
                  and "error" not in row["serving"],
                  f"scale {name} {v}: serving failed: {row['serving']}")
            check(0 < row["peak_device_bytes"] < card,
                  f"scale {name} {v}: peak {row['peak_device_bytes']} B")
        check(launches[0] > 0 and launches[1] == 0,
              f"scale {name}: launched {launches} (A1, A2)")
        rule = {k: pe["pipeline"].get(k) for k in ("rule_need_bytes",
                                                   "rule_free_bytes")}
        print(f"scale {name}: data-graph and {SCALE_QUERIES} query VDEs on "
              f"the card equal to numpy's; PE l={l} {paths} paths "
              f"{pe['mode']} (rule {rule}), index {pe['index_bytes']} B "
              f"({100 * pe['index_bytes'] / card:.1f} % of the card), peak "
              f"{pe['peak_device_bytes']} B; PE and PGE spot-verified, "
              f"serving without error; {wall_s:.1f} s, (A1, A2) launches "
              f"{launches}")
        total += launches[0]
    # The largest rung's build alone, its paths enumerated first: its
    # stable order at full size, its peak under the rule's count, and
    # its vid tables the enumerated rows.
    from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
    from gnnpe_tpu_torch.index import device_packed as dp
    from gnnpe_tpu_torch.paths.device_enumerate import enumerate_dedup_device
    name, _, paths = SCALE_RUNGS[0]
    g, vertices = checked[name]
    rows = enumerate_dedup_device(g, degree_sorted_nodes(g), 3, device)
    check(len(rows) == paths, f"scale {name}: {len(rows)} paths enumerated")
    t0 = time.perf_counter()
    key = dp.sort_key_steps(rows, dp.key_tables_device(vertices, device))
    _check_stable_order(key, dp.stable_order(key), f"scale {name}")
    del key
    digest = _rows_digest(rows, device)
    check_s = time.perf_counter() - t0
    record["scale"]["build_accounting"], idx = _build_accounting(
        f"scale {name}", rows, vertices, device, BLOCK_SIZE)
    del rows
    t0 = time.perf_counter()
    check(idx.num_entries == paths
          and _rows_digest(idx.d_vids[:paths], device) == digest
          and _rows_digest(idx._host_vids[:paths], device) == digest,
          f"scale {name}: the index's vid tables (device, host) hold other "
          f"rows than the {paths} enumerated")
    check_s += time.perf_counter() - t0
    record["scale"]["build_checks_s"] = check_s
    print(f"scale {name}: stable_order of {paths} keys a stable "
          f"permutation; the index's vid tables on the card and on the host "
          f"the enumerated rows (digest {digest[1]:#x}); checks {check_s:.1f} s")
    del idx
    return total


def _hier_library(dev, x):
    """The library's version of ``HierarchicalEllDevice.apply``:
    ``embedding_bag`` over each level's kernel table, the level's input
    with its zero row appended."""
    import torch
    import torch.nn.functional as F
    buf = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    for tbl in dev.tables:
        out = F.embedding_bag(tbl, buf, mode="sum")
        buf = torch.cat([out, out.new_zeros((1, out.shape[1]))])
    return buf[:-1]


def _hier_bytes(dev, d: int) -> int:
    """Bytes one ``HierarchicalEllDevice.apply`` must move: every level's
    table read once, its rows written once, its input read once."""
    return sum(4 * t.numel() + 4 * t.shape[0] * d + 4 * r * d
               for t, r in zip(dev.tables, dev.src_rows))


def uniform_ell_phase(g, queries, device, record, cands) -> tuple:
    """``build_ell(width=8, level2_width=8)`` on dblp through kernel A2
    (one launch a level) against the masked plain form and A1's sum,
    timed; then its main paths — ``semijoin_prune(ell=)`` on the PE
    oracle's candidates of the 8 queries, one attention hop — held to the
    A1 form and a float64 numpy hop, and the intersect and bitset forms
    on the card against numpy.  Returns (A2 rows, A2 launches of the main
    paths)."""
    import torch
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.match.preverify import semijoin_prune
    from gnnpe_tpu_torch.ops import ell, intersect, spmm
    from gnnpe_tpu_torch.ops.sddmm import arc_endpoints, attention_aggregate
    t0 = time.perf_counter()
    hel = ell.build_ell(g.offsets, g.neighbors, width=8, level2_width=8)
    dev = hel.on(device)
    arcs = int(len(g.neighbors))
    rec = record["uniform_ell"] = dict(
        build_s=time.perf_counter() - t0,
        levels=[list(t.shape) for t in dev.tables], num_slots=hel.num_slots,
        padding_ratio=hel.num_slots / arcs,
        binned_padding_ratio=record["ell_layout"]["num_slots"] / arcs,
        launches_per_apply=dev.launches_per_apply)
    print("uniform ell: " + json.dumps(rec))
    off, nbr, _, _ = to_device(g, device)
    rng = np.random.RandomState(8)
    rows = {}
    for d in (2, 128):
        x = torch.from_numpy(rng.rand(g.num_vertices, d).astype(np.float32)
                             ).to(device)
        ell.LAUNCHES = 0
        got = dev.apply(x)
        check(ell.LAUNCHES == dev.launches_per_apply == len(dev.tables),
              f"uniform ell: {ell.LAUNCHES} A2 launches for an apply of "
              f"{len(dev.tables)} levels")
        plain = dev.apply_plain(x)
        want = spmm.neighbor_sum(off, nbr, x)
        lib = _hier_library(dev, x)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"uniform ell D={d}: A2 differs from "
              f"the masked plain form (max abs err {err})")
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"uniform ell D={d}: leaves A1's sum by "
              f"{float((got - want).abs().max())}")
        check(torch.allclose(lib, want, rtol=1e-5, atol=1e-6),
              f"uniform ell D={d}: the embedding_bag walk leaves A1's sum")
        name = f"hier_f32_d{d}"
        rows[name] = dict(max_abs_err=err, **_measure(
            lambda: dev.apply_plain(x), lambda: dev.apply(x),
            lambda: _hier_library(dev, x), bytes_moved=_hier_bytes(dev, d),
            operations=hel.num_slots * d, bytes_gathered=hel.num_slots * d * 4))
        _print_turns(f"ell_gather_sum HierarchicalEll {name} "
                     f"({dev.launches_per_apply} launches)", rows[name])
    rec["rows"] = rows

    # Main paths: the pre-verify over the uniform layout, one attention
    # hop; A2's launches read just after each.
    ell.LAUNCHES = 0
    pruned = [semijoin_prune(g, q, c, device, iters=PREVERIFY_ROUNDS, ell=hel)
              for q, c in zip(queries, cands)]
    a2_prune = ell.LAUNCHES
    check(a2_prune > 0 and a2_prune % dev.launches_per_apply == 0
          and a2_prune <= PREVERIFY_ROUNDS * len(queries)
          * dev.launches_per_apply,
          f"uniform ell: {a2_prune} A2 launches for {len(queries)} pruned "
          f"queries")
    for i, (q, c, p) in enumerate(zip(queries, cands, pruned)):
        want = semijoin_prune(g, q, c, device, iters=PREVERIFY_ROUNDS)
        check(len(p) == len(want) and all(np.array_equal(a, b)
                                          for a, b in zip(p, want)),
              f"uniform ell: semijoin_prune(ell=) query {i} differs from the "
              "A1 form")
    dst = arc_endpoints(g.offsets)
    d = 16
    xk, xq, xv = (rng.rand(g.num_vertices, d).astype(np.float32)
                  for _ in range(3))
    t = lambda a: torch.from_numpy(a).to(device)
    ell.LAUNCHES = 0
    out = attention_aggregate(hel, t(g.neighbors), t(dst), t(xk), t(xq),
                              t(xv)).cpu().numpy()
    a2_attn = ell.LAUNCHES
    check(a2_attn == 2 * (len(dev.tables) - 1),
          f"uniform ell: {a2_attn} A2 launches in one attention hop")
    src = g.neighbors.astype(np.int64)
    s = (xk[src].astype(np.float64) * xq[dst].astype(np.float64)).sum(1)
    m = np.full(g.num_vertices, -np.inf)
    np.maximum.at(m, dst, s)
    e = np.exp(s - m[dst])
    w = e / np.bincount(dst, weights=e, minlength=g.num_vertices)[dst]
    ref = np.zeros((g.num_vertices, d))
    np.add.at(ref, dst, w[:, None] * xv[src].astype(np.float64))
    attn_err = float(np.abs(out - ref).max())
    check(np.allclose(out, ref, rtol=1e-4, atol=1e-6),
          f"uniform ell: attention leaves the f64 numpy hop by {attn_err}")
    sets = [np.unique(np.concatenate(c)) for c in cands[:2]]
    pads = [np.full(len(a) + 5, np.iinfo(np.int32).max, np.int32)
            for a in sets]
    for p, a in zip(pads, sets):
        p[:len(a)] = a
    valid = [t(np.arange(len(p)) < len(a)) for p, a in zip(pads, sets)]
    vals, hit = intersect.intersect_sorted_device(t(pads[0]), valid[0],
                                                  t(pads[1]), valid[1])
    both = np.intersect1d(sets[0], sets[1])
    bits = [t(intersect.bitset_from_ids(a, g.num_vertices).view(np.int32))
            for a in sets]
    count = int(intersect.bitset_count(intersect.bitset_and(*bits)))
    check(np.array_equal(vals[hit].cpu().numpy(), both) and count == len(both),
          f"uniform ell: intersect on the card {int(hit.sum())} / bitset "
          f"{count}, numpy {len(both)}")
    rec.update(prune_launches=a2_prune, attention_launches=a2_attn,
               attention_max_abs_err=attn_err,
               candidates_before=[int(sum(map(len, c))) for c in cands],
               candidates_after=[int(sum(map(len, p))) for p in pruned],
               intersect=[len(sets[0]), len(sets[1]), len(both)])
    print(f"uniform ell: semijoin_prune(ell=) equals the A1 form on "
          f"{len(queries)} queries ({a2_prune} A2 launches); attention D={d} "
          f"within {attn_err:.2e} of float64 numpy ({a2_attn} A2 launches); "
          f"intersect and bitset_count on the card equal numpy "
          f"({len(sets[0])} & {len(sets[1])} -> {len(both)})")
    return rows, a2_prune + a2_attn


def readout_rows(g, paths, device, record) -> dict:
    """The trainer's two fixed gathers at dblp (``readout_plans``: the
    label lookup, the readout of ``paths``), f32 D=2: each plan's
    backward by the segment-sum kernel (one launch) bit-equal to
    ``segment_sum_plain``, bit-identical over 3 calls and within rtol
    1e-4 of ``index_add_``; timed as in phase 3 with ``index_add_``
    (atomics, one call) as the library call, torch's own backward of
    ``x[idx]`` (``index_put_`` with ``accumulate=True``) beside it, and
    the earlier route of the same call, kernel A2's walk of the
    transposed index as a uniform-width ELL (``build_ell(8, 8)``), timed
    in turns with the kernel (walk, kernel, kernel, walk).  The bound
    counts what the function must move: the cotangent and the index (4
    bytes an entry) read once, the gradient written once.  Returns the
    kernel's rows."""
    import torch
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.models.train import readout_plans
    from gnnpe_tpu_torch.ops import gather
    from gnnpe_tpu_torch.ops.ell import build_ell
    model = PathGNN(dim=2, num_layers=1, labels_count=g.labels_count,
                    activation="softplus", device=device)
    t0 = time.perf_counter()
    plans = readout_plans(model, g, paths)
    rec = record["readout"] = dict(build_s=time.perf_counter() - t0)
    rng = np.random.RandomState(9)
    rows = {}
    for plan in plans:
        n, r, idx = plan.idx.numel(), plan.num_rows, plan.idx
        cot = torch.from_numpy(rng.rand(n, 2).astype(np.float32)).to(device)
        gather.LAUNCHES = 0
        got = plan.backward(cot)
        check(gather.LAUNCHES == plan.launches_per_backward == 1,
              f"readout {plan.name}: {gather.LAUNCHES} segment_sum launches "
              "for a backward")
        plain = plan.backward_plain(cot)
        again = [plan.backward(cot) for _ in range(3)]
        add = lambda: torch.zeros((r, 2), device=device).index_add_(
            0, idx, cot)
        put = lambda: torch.zeros((r, 2), device=device).index_put_(
            (idx,), cot, accumulate=True)
        walk = build_ell(plan.offsets.cpu().numpy().astype(np.int64),
                         plan.perm.cpu().numpy(), 8, 8,
                         num_sources=n).on(device)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"readout {plan.name}: segment_sum "
              f"differs from segment_sum_plain (max abs err {err})")
        check(all(torch.equal(got, a) for a in again),
              f"readout {plan.name}: segment_sum differs between calls")
        for what, lib in (("index_add_", add()), ("index_put_", put()),
                          ("the A2 walk", walk.apply(cot))):
            check(torch.allclose(lib, got, rtol=1e-4, atol=1e-4),
                  f"readout {plan.name}: {what} leaves the kernel by "
                  f"{float((lib - got).abs().max())}")
        name = f"readout_{plan.name.split('.')[-1]}_f32_d2"
        kern = lambda: plan.backward(cot)
        rows[name] = dict(max_abs_err=err, **_measure(
            lambda: plan.backward_plain(cot), kern, add,
            bytes_moved=n * 2 * 4 + n * 4 + r * 2 * 4,
            operations=n * 2, bytes_gathered=n * 2 * 4))
        w1, k1, k2, w2 = (cuda_ms(lambda: walk.apply(cot), 50),
                          cuda_ms(kern, 50), cuda_ms(kern, 50),
                          cuda_ms(lambda: walk.apply(cot), 50))
        state = plan.launch_state(2)
        rows[name].update(
            entries=n, rows=r, tiles=state.tiles, lanes=state.lanes,
            window=plan.window, threads=plan.threads, calls_bit_identical=3,
            index_put_accumulate_ms=cuda_ms(put, 5),
            a2_walk=dict(launches=walk.launches_per_apply,
                         ms=(w1 + w2) / 2, turns_ms=[w1, k1, k2, w2],
                         kernel_ms=(k1 + k2) / 2,
                         device_ms=graph_ms(lambda: walk.apply(cot)),
                         levels=[list(t.shape) for t in walk.tables]))
        _print_turns(f"segment_sum readout {name} (1 launch, "
                     f"{state.tiles} tiles of {plan.window} x "
                     f"{plan.threads})", rows[name])
        # The same plan at f64 D=2 (the kernel's second type).
        cot64 = cot.double()
        gather.LAUNCHES = 0
        got64 = plan.backward(cot64)
        check(gather.LAUNCHES == 1, f"readout {plan.name} f64: "
              f"{gather.LAUNCHES} segment_sum launches for a backward")
        plain64 = plan.backward_plain(cot64)
        err64 = float((got64 - plain64).abs().max())
        check(torch.equal(got64, plain64), f"readout {plan.name} f64: "
              f"segment_sum differs from segment_sum_plain (max abs err "
              f"{err64})")
        check(torch.equal(got64, plan.backward(cot64)),
              f"readout {plan.name} f64: segment_sum differs between calls")
        add64 = lambda: torch.zeros((r, 2), dtype=torch.float64,
                                    device=device).index_add_(0, idx, cot64)
        check(torch.allclose(add64(), got64, rtol=1e-12, atol=1e-12),
              f"readout {plan.name} f64: index_add_ leaves the kernel")
        name64 = name.replace("_f32_", "_f64_")
        rows[name64] = dict(
            max_abs_err=err64, entries=n, rows=r,
            tiles=plan.launch_state(2, torch.float64).tiles,
            calls_bit_identical=2, **_measure(
                lambda: plan.backward_plain(cot64),
                lambda: plan.backward(cot64), add64,
                bytes_moved=n * 2 * 8 + n * 4 + r * 2 * 8,
                operations=n * 2, bytes_gathered=n * 2 * 8))
        _print_turns(f"segment_sum readout {name64} (1 launch)",
                     rows[name64])
        w = rows[name]["a2_walk"]
        print(f"  {name}: {n} entries into {r} rows, bit-identical over 3 "
              f"calls; torch's x[idx] backward (index_put_ accumulate) "
              f"{rows[name]['index_put_accumulate_ms']:.4f} ms; the A2 walk "
              f"({w['launches']} launches, levels {w['levels']}) "
              f"{w['ms']:.4f} ms, on the card {w['device_ms']:.4f} ms (walk, "
              f"kernel, kernel, walk = "
              + ", ".join(f"{t:.4f}" for t in w["turns_ms"]) + ")")
        del walk
    rec["rows"] = rows
    return rows


# The full dblp path readout past N·D = 2^31: D=12 is the first width
# at which the 182,339,307 entries of the 60,779,769 paths pass it.
FULL_READOUT_D = 12
FULL_READOUT_SLICE = 4    # columns a plain-version pass holds at once
WIDE_READOUT_D = 4_100    # past the earlier cap of D < 4,096


def readout_limits(g, full_paths, device, record) -> dict:
    """The readout backward at the shapes the kernel took no earlier:
    (a) the full dblp path readout (``readout_plans`` over every path,
    before the trainer's subsample) at f32 D=12, N·D past 2^31: one
    launch, bit-equal to ``segment_sum_plain`` run on the card column
    slice by column slice (columns are independent, so a slice told the
    D=12 lanes keeps the order), bit-identical over 2 calls, within rtol
    1e-4 of ``index_add_``, timed by events and on the card alone, its
    peak device memory printed; (c) a small index at D = 4,100, f32 and f64,
    bit-equal; (d) an empty index through autograd: one launch, all rows
    zero.  Returns (a)'s row."""
    import torch
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.models.train import readout_plans
    from gnnpe_tpu_torch.ops import gather
    rec = record["readout_limits"] = {}
    model = PathGNN(dim=2, num_layers=1, labels_count=g.labels_count,
                    device=device)
    t0 = time.perf_counter()
    plan = readout_plans(model, g, full_paths)[1]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n, r, d = plan.idx.numel(), plan.num_rows, FULL_READOUT_D
    check(n * d >= 2 ** 31, f"full readout: N·D = {n * d} is under 2^31")
    gen = torch.Generator(device).manual_seed(11)
    cot = torch.rand((n, d), generator=gen, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gather.LAUNCHES = 0
    got = plan.backward(cot)
    torch.cuda.synchronize()
    kernel_peak = torch.cuda.max_memory_allocated() - base
    check(gather.LAUNCHES == 1, f"full readout: {gather.LAUNCHES} "
          "segment_sum launches for a backward")
    check(torch.equal(got, plan.backward(cot)),
          "full readout: segment_sum differs between calls")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    state = plan.launch_state(d)
    start.record()
    plain = torch.cat([plan.backward_plain(cot[:, c:c + FULL_READOUT_SLICE],
                                           state.lanes)
                       for c in range(0, d, FULL_READOUT_SLICE)], dim=1)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((got - plain).abs().max())
    check(torch.equal(got, plain), "full readout: segment_sum differs from "
          f"segment_sum_plain (max abs err {err})")
    del plain
    add = lambda: torch.zeros((r, d), device=device).index_add_(
        0, plan.idx, cot)
    check(torch.allclose(add(), got, rtol=1e-4, atol=1e-4),
          "full readout: index_add_ leaves the kernel")
    kern = lambda: plan.backward(cot)
    k1, k2 = cuda_ms(kern, 3), cuda_ms(kern, 3)
    by_bytes = (n * d * 4 + n * 4 + r * d * 4) / PEAK_BYTES_S * 1e3
    by_ops = n * d / PEAK_FLOP_S * 1e3
    row = dict(ms=(k1 + k2) / 2, turns_ms=[k1, k2], plain_ms=plain_ms,
               library_ms=cuda_ms(add, 3),
               device_ms=graph_ms(kern, calls=2, replays=3),
               cold_ms=cold_ms(kern, iters=3),
               bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations",
               bytes_moved=n * d * 4 + n * 4 + r * d * 4, max_abs_err=err,
               entries=n, rows=r, d=d, tiles=state.tiles,
               lanes=state.lanes, build_s=build_s,
               cotangent_bytes=n * d * 4, kernel_peak_bytes=kernel_peak,
               calls_bit_identical=2)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
    rec["full_paths_f32_d12"] = row
    print(f"segment_sum full path readout: {n} entries into {r} rows at f32 "
          f"D={d} (N·D = {n * d}, cotangent {n * d * 4} B), {state.tiles} "
          f"tiles of {state.lanes} lanes an entry, plan built in {build_s:.2f} s: 1 launch, bit-equal to "
          f"plain (in slices of {FULL_READOUT_SLICE} columns, "
          f"{plain_ms:.2f} ms), bit-identical over 2 calls, within rtol 1e-4 "
          f"of index_add_; kernel {row['ms']:.4f} ms by events ("
          f"{k1:.4f}, {k2:.4f}), on the card alone {row['device_ms']:.4f} "
          f"ms, L2 flushed {row['cold_ms']:.4f} ms; index_add_ "
          f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']}: {100 * row['device_share_of_bound']:.1f} % on "
          f"the card; the kernel's peak device memory {kernel_peak} B "
          "(output and scratch)")
    del plan, cot, got

    # (c) D = 4,100: a row of 3,000 entries spans three tiles of 1,024.
    rng = np.random.RandomState(12)
    idx = rng.permutation(np.concatenate([np.zeros(3_000, np.int64),
                                          rng.randint(0, 300, 2_000)]))
    wide = gather.GatherRows.build(idx, 300, device)
    for dtype in (torch.float32, torch.float64):
        g_w = torch.randn((len(idx), WIDE_READOUT_D), generator=gen,
                          dtype=dtype, device=device)
        gather.LAUNCHES = 0
        got = wide.backward(g_w)
        check(gather.LAUNCHES == 1, f"D={WIDE_READOUT_D} {dtype}: "
              f"{gather.LAUNCHES} launches")
        check(torch.equal(got, wide.backward_plain(g_w))
              and torch.equal(got, wide.backward(g_w)),
              f"D={WIDE_READOUT_D} {dtype}: segment_sum differs from "
              "segment_sum_plain or between calls")
    tiles = wide.launch_state(WIDE_READOUT_D).tiles
    rec["wide"] = dict(d=WIDE_READOUT_D, entries=len(idx), rows=300,
                       tiles=tiles, dtypes=["float32", "float64"])
    print(f"segment_sum at D={WIDE_READOUT_D} (f32, f64; {len(idx)} entries, "
          f"{tiles} tiles): 1 launch each, bit-equal to plain and over "
          "2 calls")

    # (d) An empty index, through autograd.
    empty = gather.GatherRows.build(np.zeros(0, np.int64), 7, device)
    x = torch.randn((7, 2), device=device, requires_grad=True)
    gather.LAUNCHES = 0
    empty(x).sum().backward()
    check(gather.LAUNCHES == 1 and not x.grad.any(),
          f"empty index: {gather.LAUNCHES} launches, gradient "
          f"{x.grad.abs().max().item()}")
    rec["empty"] = dict(rows=7, launches=1)
    print("segment_sum on an empty index: 1 launch through autograd, all 7 "
          "rows zero")
    torch.cuda.synchronize()
    return {"readout_paths_full_f32_d12": row}


PROFILE_STEPS = 5
PROFILE_TOP = 5
# Share of a warm binned step's device time in IndexBackward0 before the
# readout's gathers had a planned backward (PERF.md §5).
PROFILE_INDEX_BACKWARD_BEFORE = 0.9282
READOUT_RANGES = ("readout.labels.backward", "readout.paths.backward")


def _trace_events(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _cpu_events(events, name: str, cat: str) -> list:
    return [ev for ev in events if ev.get("ph") == "X"
            and ev.get("cat") == cat and ev.get("name") == name]


def _launched_inside(events, ranges, same_thread: bool = True) -> set:
    """Correlation ids of the launches (the trace's ``cuda_runtime`` and
    ``cuda_driver`` events) made inside the CPU events ``ranges``: on a
    range's own thread, or on any thread when not ``same_thread`` (the
    backward runs on autograd's thread)."""
    launches = [ev for ev in events if ev.get("ph") == "X"
                and ev.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in ev.get("args", {})]
    ids = set()
    for r in ranges:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        ids.update(ev["args"]["correlation"] for ev in launches
                   if lo <= ev["ts"] <= hi
                   and (not same_thread or ev["tid"] == r["tid"]))
    return ids


def _device_us(events, ids: set) -> dict:
    """Device time by name (us) of the kernels, copies and sets whose
    launches have these correlation ids."""
    out = {}
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") in GPU_CATS
                and ev.get("args", {}).get("correlation") in ids):
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"]
    return out


def profile_phase(g, paths, device, record, pge_engine, queries) -> None:
    """``utils/profiling.trace`` around PROFILE_STEPS warm binned steps of
    ``fit`` at dblp (the train phase's model, batch and pairs; two
    untraced steps first).  The step's device time is that of the work
    launched inside ``fit``'s ``fit.steps`` range (its set-up left out);
    its top device kernels by share of it, the share of the kernels
    launched inside each readout backward's range and inside
    ``IndexBackward0``; the top ops of the whole traced call; then a
    trace of one PGE ``online`` call must hold the engine's stage
    ranges."""
    import torch
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.models.train import fit
    from gnnpe_tpu_torch.utils.profiling import trace
    model = PathGNN(dim=2, num_layers=1, labels_count=g.labels_count,
                    activation="softplus", device=device)
    kw = dict(batch_size=1024, seed=0, negatives=True, learning_rate=1e-2,
              aggregation="binned", device=device)
    state = fit(model, g, paths, num_steps=2, **kw)
    with tempfile.TemporaryDirectory(prefix="gnnpe_trace_") as tmp:
        with trace(tmp, device) as prof:
            fit(model, g, paths, num_steps=PROFILE_STEPS, state=state, **kw)
        events = _trace_events(prof.trace_path)
        steps = _cpu_events(events, "fit.steps", "user_annotation")
        check(len(steps) == 1, f"profile: {len(steps)} fit.steps ranges")
        kernels = _device_us(events, _launched_inside(events, steps, False))
        total_us = sum(kernels.values())
        check(total_us > 0, "profile: the trace holds no device time")
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
        attr = ("self_device_time_total" if hasattr(
            prof.key_averages()[0], "self_device_time_total")
            else "self_cuda_time_total")
        ops = sorted(((e.key, getattr(e, attr)) for e in prof.key_averages()),
                     key=lambda r: -r[1])
        ops_us = sum(s for _, s in ops)

        def inside(name, cat):
            return sum(_device_us(events, _launched_inside(
                events, _cpu_events(events, name, cat))).values())

        index_bw = inside("IndexBackward0", "cpu_op")
        # Each readout backward's range: the device time of the kernels
        # launched inside it, and the span of its GPU annotation in the
        # trace (the gaps between its launches included).
        ranges = {name: dict(
            device_us=inside(name, "user_annotation"),
            span_us=sum(ev["dur"] for ev in _cpu_events(
                events, name, "gpu_user_annotation")))
            for name in READOUT_RANGES}
        online_dir = f"{tmp}/online"
        with trace(online_dir, device) as prof2:
            pge_engine.online(queries[0], union="device")
        names = {ev.get("name") for ev in _trace_events(prof2.trace_path)}
    stages = ("query_plan", "search", "refine")
    missing = [s for s in stages if s not in names]
    check(not missing, f"profile: stage ranges {missing} not in the trace of "
          "one online call")
    rec = record["profile"] = dict(
        steps=PROFILE_STEPS, device_us=total_us,
        step_device_ms=total_us / 1e3 / PROFILE_STEPS,
        top_kernels=[dict(name=n, us=us, share=us / total_us) for n, us in top],
        top_ops=[dict(op=k, self_us=s, share=s / ops_us)
                 for k, s in ops[:PROFILE_TOP]],
        index_backward_us=index_bw, index_backward_share=index_bw / total_us,
        index_backward_share_before=PROFILE_INDEX_BACKWARD_BEFORE,
        readout_ranges={name: dict(r, share=r["device_us"] / total_us,
                                   span_share=r["span_us"] / total_us)
                        for name, r in ranges.items()})
    for name, r in rec["readout_ranges"].items():
        check(r["device_us"] > 0 or r["span_us"] > 0,
              f"profile: no device time in the range {name}")
    print(f"profile: {PROFILE_STEPS} warm binned fit steps at dblp, "
          f"{rec['step_device_ms']:.3f} ms of device time a step; top "
          "kernels by share of device time:")
    for k in rec["top_kernels"]:
        print(f"  {100 * k['share']:6.2f} %  {k['us']:10.1f} us  {k['name']}")
    print("  top ops by self device time over the traced fit call, its "
          "set-up included:")
    for k in rec["top_ops"]:
        print(f"  {100 * k['share']:6.2f} %  {k['self_us']:10.1f} us  {k['op']}")
    for name, r in rec["readout_ranges"].items():
        print(f"profile: range {name}: {100 * r['share']:.2f} % of device "
              f"time ({r['device_us'] / PROFILE_STEPS:.1f} us a step by its "
              f"kernels; its GPU span {100 * r['span_share']:.2f} %)")
    print(f"profile: IndexBackward0 (the backward of the x[idx] gathers "
          f"left: the pair rows, one gather) "
          f"{100 * rec['index_backward_share']:.2f} % of device time "
          f"({index_bw / PROFILE_STEPS:.1f} us a step), "
          f"{100 * PROFILE_INDEX_BACKWARD_BEFORE:.2f} % before the readout "
          f"plans; the stage ranges {list(stages)} are in the trace "
          "of one online call")
    torch.cuda.synchronize()


# ---- the bench phase -----------------------------------------------------

# The port's bench at its default (the root bench's) size.
BENCH_SIZE = dict(num_vertices=100_000, num_edges=800_000, dim=128)
BENCH_TIMEOUT_S = 300


def _bench_kernel_rows(offs, nbr, device, record) -> tuple:
    """Both kernels at the bench's shapes — A1 over the CSR, A2 through
    the binned layout's plan, the uniform ELL's levels and the 1-shard
    binned-halo local group's plan, f32 D=128 — each held bit-equal to
    its plain version and timed beside its library call.  Returns (A1
    rows, A2 rows, A2 launches of one aggregation per implementation)."""
    import torch
    from gnnpe_tpu_torch.ops import ell, spmm
    from gnnpe_tpu_torch.parallel.binned_halo import BinnedHaloPlan
    v, d = BENCH_SIZE["num_vertices"], BENCH_SIZE["dim"]
    arcs = len(nbr)
    x = torch.from_numpy(np.random.RandomState(9).rand(v, d).astype(
        np.float32)).to(device)
    off_t = torch.from_numpy(offs).to(device)
    nbr_t = torch.from_numpy(nbr).to(device)
    binned = ell.BinnedEllDevice.from_host(ell.build_binned_ell(
        offs, nbr, feature_dim_hint=d, device=device), device)
    hier = ell.build_ell(offs, nbr, width=8, level2_width=8).on(device)
    plan = BinnedHaloPlan.build(offs, nbr, np.zeros(v, np.int64), 1,
                                feature_dim_hint=d, device=device)
    rect = plan.local_layouts[0].on(device)
    check(plan.halo_layouts[0].num_arcs == 0,
          "bench: the 1-shard plan's halo group has arcs")
    adj = torch.sparse_csr_tensor(
        off_t, nbr_t, torch.ones(arcs, dtype=x.dtype, device=device),
        size=(v, v))
    shapes = {
        "bench_flat_f32_d128": (
            "spmm_csr", lambda: spmm.neighbor_sum(off_t, nbr_t, x),
            lambda: spmm.neighbor_sum_plain(off_t, nbr_t, x),
            lambda: torch.sparse.mm(adj, x),
            4 * (v + 1) + 4 * arcs + 2 * v * d * 4, arcs, 1),
        "bench_binned_f32_d128": (
            "ell_gather_sum", lambda: binned.apply_perm(x),
            lambda: binned.apply_perm(x, gather=ell.gather_sum_plain),
            lambda: binned.apply_perm(x, gather=_bag),
            _hub_layout_bytes(binned, d, 1), binned.num_slots,
            binned.launches_per_apply),
        "bench_hier_f32_d128": (
            "ell_gather_sum", lambda: hier.apply(x),
            lambda: hier.apply_plain(x), lambda: _hier_library(hier, x),
            _hier_bytes(hier, d), hier.num_slots, hier.launches_per_apply),
        "bench_rect1_f32_d128": (
            "ell_gather_sum", lambda: rect.apply(x),
            lambda: rect.apply(x, gather=ell.gather_sum_plain),
            lambda: rect.apply(x, gather=_bag), _plan_bytes(rect, d),
            plan.local_layouts[0].num_slots, rect.launches_per_apply),
    }
    a1_rows, a2_rows = {}, {}
    for name, (kernel, kern, plain_fn, lib_fn, moved, slots,
               launches) in shapes.items():
        counter = spmm if kernel == "spmm_csr" else ell
        before = counter.LAUNCHES
        got = kern()
        check(counter.LAUNCHES - before == launches,
              f"bench: {name} launched {counter.LAUNCHES - before} times, "
              f"its plan says {launches}")
        plain = plain_fn()
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"{kernel} {name} differs from its "
              f"plain version (max abs err {err})")
        row = dict(max_abs_err=err, **_measure(
            plain_fn, kern, lib_fn, bytes_moved=moved,
            operations=slots * d, bytes_gathered=slots * d * 4))
        (a1_rows if kernel == "spmm_csr" else a2_rows)[name] = row
        _print_turns(f"{kernel} {name} ({launches} launches)", row)
    record["bench"]["kernel_shapes"] = dict(
        arcs=arcs, binned_slots=binned.num_slots, hier_slots=hier.num_slots,
        rect_slots=plan.local_layouts[0].num_slots,
        binned_hubs=0 if binned.hub_rows is None else len(binned.hub_rows))
    return a1_rows, a2_rows, {"binned": binned.launches_per_apply,
                              "ell": hier.launches_per_apply,
                              "binned_halo": rect.launches_per_apply,
                              "flat": 0}


def bench_phase(device, record) -> tuple:
    """The port's bench (gnnpe_tpu_torch/bench.py) at its default size:
    one aggregation of each implementation held to ``neighbor_sum_np``
    in f64 (rtol 1e-5, atol 1e-6); both kernels at the bench's shapes
    against their plain versions; then the main path, ``bench_aggregation``
    of each implementation with the counts set to 0 just before and read
    just after (each step's launches as its plan says, the share of the
    bound finite and positive); last ``python -m gnnpe_tpu_torch.bench
    --device cuda --skip-halo`` in a subprocess, whose last line must
    carry the root bench's four keys.  Returns (A1 rows, A2 rows, (A1,
    A2) launches of the main path)."""
    import os
    import torch
    from gnnpe_tpu_torch import bench
    from gnnpe_tpu_torch.ops import ell, spmm
    from gnnpe_tpu_torch.parallel.mesh import process_group
    v, e, d = (BENCH_SIZE[k] for k in ("num_vertices", "num_edges", "dim"))
    rec = record["bench"] = {}
    t0 = time.perf_counter()
    offs, nbr = bench.csr_of(*bench.synth_graph(v, e), v)
    x = np.random.RandomState(1).rand(v, d).astype(np.float32)
    want = spmm.neighbor_sum_np(offs, nbr, x)
    with process_group(device):
        for impl in bench.IMPLEMENTATIONS:
            a = bench.build_aggregation(offs, nbr, x, impl, device)
            with torch.no_grad():
                got = a.to_vertices(a.agg(a.x)).cpu().numpy()
            err = float(np.abs(got - want).max())
            check(got.shape == want.shape
                  and np.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"bench {impl}: one aggregation leaves the f64 sum by "
                  f"{err}")
            rec.setdefault("max_abs_err", {})[impl] = err
            del a
    print(f"bench: one aggregation of each of {bench.IMPLEMENTATIONS} within "
          f"rtol 1e-5 / atol 1e-6 of the f64 sum (max abs err "
          f"{rec['max_abs_err']})")
    a1_rows, a2_rows, a2_plan = _bench_kernel_rows(offs, nbr, device, record)
    torch.cuda.synchronize()

    spmm.LAUNCHES = ell.LAUNCHES = 0
    rows = {}
    for impl in bench.IMPLEMENTATIONS:
        r = rows[impl] = {}
        eps, frac, step_s = bench.bench_aggregation(
            implementation=impl, device=device, record=r, **BENCH_SIZE)
        check(np.isfinite(frac) and frac > 0 and eps > 0,
              f"bench {impl}: edges/s {eps}, share of the bound {frac}")
        want_launches = dict(a1=int(impl in ("flat", "binned_halo")),
                             a2=a2_plan[impl])
        check(r["launches_per_step"] == want_launches,
              f"bench {impl}: a step launched {r['launches_per_step']}, its "
              f"plan says {want_launches}")
        cont = r["continuity"]
        print(f"bench {impl}: {eps:.6e} edges/s, step {step_s * 1e3:.4f} ms "
              f"by events (q1 {r['step_q1_s'] * 1e3:.4f}, q3 "
              f"{r['step_q3_s'] * 1e3:.4f}), {r['graph_s'] * 1e3:.4f} ms "
              f"replayed from a CUDA graph; bound {r['bound_s'] * 1e3:.4f} ms "
              f"by {r['bound_by']} ({r['bytes']} B at "
              f"{r['memory_bytes_per_s'] / 1e12:.4f} TB/s measured): share "
              f"{frac:.4f} by events, {r['graph_share_of_bound']:.4f} on the "
              f"card; published-peak share "
              f"{r['published_share_of_bound']:.4f}; launches a step "
              f"{r['launches_per_step']}; {r['num_hubs']} hubs, "
              f"{r['num_slots']} slots; continuity (no bound here): "
              + ", ".join(f"{k} {cont[k]:.4f}" for k in (
                  "overlap_ratio", "additive_ratio", "hbm_byte_fraction")
                  if k in cont))
        if frac > 1.0:
            print(f"bench {impl}: FINDING: share of the bound {frac:.4f} > 1")
    launches = (spmm.LAUNCHES, ell.LAUNCHES)
    # Each bench_aggregation runs a warm-up loop and REPS timed loops of
    # ITERS steps, captures one loop in a CUDA graph (its launches are
    # made once, at capture) and reads one step's launches.
    calls = (bench.REPS + 2) * bench.ITERS + 1
    want_total = tuple(
        calls * sum(r["launches_per_step"][k] for r in rows.values())
        for k in ("a1", "a2"))
    check(launches == want_total and min(launches) > 0,
          f"bench: the main path launched (A1, A2) {launches}, its steps say "
          f"{want_total}")
    rec["rows"] = rows
    rec["halo_vs_binned"] = (rows["binned_halo"]["edges_per_sec"]
                             / rows["binned"]["edges_per_sec"])
    print(f"bench: binned_halo (1 shard) / binned = {rec['halo_vs_binned']:.4f}; "
          f"main path (A1, A2) launches {launches}")

    out = subprocess.run(
        [sys.executable, "-m", "gnnpe_tpu_torch.bench", "--device", "cuda",
         "--skip-halo"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    check(out.returncode == 0, f"python -m gnnpe_tpu_torch.bench exited "
          f"{out.returncode}: {out.stderr[-2000:]}")
    last = json.loads(out.stdout.strip().splitlines()[-1])
    check(list(last) == ["metric", "value", "unit", "vs_baseline"]
          and last["metric"] == "aggregation_edges_per_sec_chip"
          and last["unit"] == "edges/s" and last["value"] > 0
          and np.isfinite(last["vs_baseline"]),
          f"python -m gnnpe_tpu_torch.bench: last line {last}")
    rec["cli_last_line"] = last
    rec["phase_s"] = time.perf_counter() - t0
    print(f"bench: python -m gnnpe_tpu_torch.bench --device cuda --skip-halo "
          f"-> {json.dumps(last)} ({rec['phase_s']:.1f} s for the phase)")
    return a1_rows, a2_rows, launches


def _kernel_row(name, replaces, launches, rows, main_shape) -> dict:
    """One entry of the kernels record: the times and the bound at the
    main path's shape, and under ``shapes`` those of every shape."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    return {"name": name, "route": "cuda",
            "source": f"gnnpe_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            **{k: rows[main_shape][k] for k in keys[:-1]},
            "shapes": {shape: {k: r[k] for k in keys}
                       for shape, r in rows.items()}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from gnnpe_tpu_torch.io.datasets import load_dataset, sample_query

    started = time.perf_counter()
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

    laps = record["phase_s"] = {}
    last = [started]

    def fresh(done: str):
        """Free the card between phases; ``done`` names the phase(s) that
        ran since the previous call, whose wall time is recorded."""
        now = time.perf_counter()
        laps[done], last[0] = now - last[0], now
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak(prefix, base=0):
        record[prefix]["peak_device_bytes"] = (
            torch.cuda.max_memory_allocated() - base)

    fresh("build_data_kernel_ell")
    launches, pe_oracle = pe_phase(g, queries, device, record)
    peak("pe")
    fresh("pe")
    base = torch.cuda.memory_allocated()      # the array-mode PE index
    a1, table_eng = pe_table_phase(g, queries, device, record, pe_oracle)
    launches += a1
    peak("pe_table", base)
    fresh("pe_table")
    union_rows = union_phase(table_eng, queries, device, record)
    fresh("union")
    launches += pe_streamed_phase(g, queries, device, record, pe_oracle,
                                  table_eng)
    del table_eng
    fresh("pe_streamed")
    a1, pge_oracle = pge_phase(g, queries, device, record)
    launches += a1
    peak("pge")
    fresh("pge")
    (a1, a2_multi, seg_multi), a1_rect, a2_rect = multi_device_phase(
        g, queries, device, record, pe_oracle, pge_oracle,
        record["pe_table"]["index_file"])
    launches += a1
    rows.update(a1_rect)
    ell_rows.update(a2_rect)
    peak("multi")
    fresh("multi")
    launches += ladder_phase(device, record, pe_oracle, pge_oracle)
    peak("ladder")
    fresh("ladder")
    hier_rows, a2_hier = uniform_ell_phase(g, queries, device, record,
                                           pe_oracle["wants"])
    ell_rows.update(hier_rows)
    peak("uniform_ell")
    fresh("uniform_ell")
    pe_host = dict(paths=pe_oracle["paths"], vertices=pe_oracle["vertices"])
    paths = pe_host["paths"]
    paths = paths[np.sort(np.random.RandomState(3).choice(
        len(paths), size=500_000, replace=False))]
    seg_rows = readout_rows(g, paths, device, record)
    peak("readout")
    fresh("readout")
    seg_rows.update(readout_limits(g, pe_host["paths"], device, record))
    peak("readout_limits")
    fresh("readout_limits")
    profile_phase(g, paths, device, record,
                  pge_oracle["engine"].attach_device(device), queries)
    del pe_oracle, pge_oracle["engine"], paths
    fresh("profile")
    launches += pge_device_phase(g, queries, device, record, pge_oracle)
    peak("pge_device")
    del pge_oracle
    fresh("pge_device")
    (a1, a2, seg_train), seg_fit = train_phase(g, device, record)
    launches += a1
    peak("train")
    fresh("train")
    a1, a2_streamed, seg_streamed = train_streamed_phase(g, device, record,
                                                         pe_host)
    launches += a1
    del pe_host
    peak("train_streamed")
    fresh("train_streamed")
    ell_rows.update(probe_phase(device, smi, record))
    peak("probe")
    fresh("probe")
    a1_bench, a2_bench, bench_launches = bench_phase(device, record)
    rows.update(a1_bench)
    ell_rows.update(a2_bench)
    launches += bench_launches[0]
    peak("bench")
    fresh("bench")
    launches += scale_phase(device, record)
    fresh("scale")
    print("phase seconds: " + json.dumps(laps))
    kernel_launches = dict(
        spmm_csr=launches,
        ell_gather_sum=(a2 + a2_streamed + a2_multi + a2_hier
                        + bench_launches[1]),
        segment_sum=seg_train + seg_fit + seg_streamed + seg_multi,
        union_bitmap=sum(r["union_launches"] for r in record.values()
                         if isinstance(r, dict) and "union_launches" in r))
    check(min(kernel_launches.values()) > 0,
          f"a kernel did not launch on the main paths: {kernel_launches}")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "gnnpe_tpu"))
    check(not foreign, f"the port imported {foreign}")

    print("record: " + json.dumps(record))
    print(smi)
    print(json.dumps({"kernels": [
        _kernel_row("spmm_csr", "experiments/pallas_spmm.py:181",
                    kernel_launches["spmm_csr"], rows, "f64_d2"),
        _kernel_row("ell_gather_sum", "experiments/pallas_blocked_spmm.py:106",
                    kernel_launches["ell_gather_sum"], ell_rows, "f32_d2"),
        _kernel_row("segment_sum", "gnnpe_tpu/models/gnn.py:106,122 (the "
                    "jnp.take VJP, an XLA scatter-add, no Pallas kernel); in "
                    "the port the readout's walk on the A2 kernel of "
                    "experiments/pallas_blocked_spmm.py:106",
                    kernel_launches["segment_sum"], seg_rows,
                    "readout_paths_f32_d2"),
        _kernel_row("union_bitmap", "none: the search's device union (an "
                    "XLA scatter into a bool bitmap in gnnpe_tpu/index/"
                    "device_packed.py, no Pallas kernel)",
                    kernel_launches["union_bitmap"], union_rows,
                    "online_scatter")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
