"""Aggregation benchmark of the port: edges/s of one message-passing step
on one card (counterpart of the root ``bench.py``, gnnpe_tpu's).

    python -m gnnpe_tpu_torch.bench [--implementation binned] \\
        [--num-vertices 100000] [--num-edges 800000] [--dim 128] \\
        [--device cuda] [--skip-halo] [--test-dir DIR] \\
        [--metrics FILE] [--trace DIR]

The step is ``h = agg(h) * 0.1``: one neighbour sum over a synthetic
power-law multigraph (``synth_graph``, bit-equal to the root's) and the
elementwise tail of a GNN layer.  ``agg`` is one of four
implementations, each on the port's own layout and kernel:

  * ``binned``: ``ops/ell.py`` degree-binned layout, ``apply_perm`` in
    the permuted vertex space (kernel A2, one launch a level);
  * ``ell``: the uniform-width ``HierarchicalEll`` (8, 8) (A2, one launch
    a level);
  * ``binned_halo``: ``parallel/binned_halo.py`` at one shard on a mesh
    of one rank (A2 through ``RectBinned``'s launch plans, and A1 for
    the send gather);
  * ``flat``: the CSR neighbour sum ``ops/spmm.py:neighbor_sum`` (A1).

The last line printed has the root's keys::

    {"metric": "aggregation_edges_per_sec_chip", "value": N,
     "unit": "edges/s", "vs_baseline": frac}

``value`` is arcs over the median time of one step (CUDA events around
a loop of steps chained by data).  ``vs_baseline`` is the step's share
of a bound the card cannot beat (``step_bound``)::

    t_bound = max(bytes / B, ops / F)
    bytes   = 4·V·D  (x read once)
            + 4·V·D  (the neighbour sums written once)
            + 8·V·D  (the * 0.1: V·D f32 read and written)
            + the layout's index tensors as they sit on the card, each
              read once: int32 gather tables and f32 pad counts (binned,
              binned_halo: also the send gather's int32 CSR), int32
              level tables (ell), int32 offsets and neighbours (flat);
              with hubs the int64 hub rows and the f32 [V, H] counts
    ops     = E·D  (one add per arc and column) + V·D (the multiply)
    B, F    = utils/device_probe.device_constants(device): the memory
              bytes/s and f32 matmul flop/s measured in this run
    frac    = t_bound / t_step

Each byte is counted once whatever the kernel reads again, so L2 can
only help the kernel where a tensor is touched twice; a frac above 1.0
says the count missed something, and is printed as it is.  On the CPU,
``device_constants`` is the "cpu" row: the CPU run checks the program,
and its numbers are no device metric.

The root's ratios stay as continuity lines on stderr, named as such:
its slot-list gather probe (one ``index_select`` over the binned
layout's flat slot list, every class and head table, clamped into
``x``'s rows, and the hub product alone where the layout has hubs), the
overlap and additive ratios against it, and the "HBM-byte roofline
fraction".  On this card the probe is a library gather that A2 outruns,
so none of them is a bound.

The root's long/short-loop differencing (it cancelled a relay's fixed
dispatch cost) is dropped: events time the card's work.  The same step
is also replayed from a CUDA graph (the card alone, no host path).
Every implementation is captured at one rank: the collective helpers of
``parallel/collectives.py`` return without calling the backend for a
group of one, so the binned-halo step calls no collective here (with
more ranks it would, and it could not be captured).

``bench_query_latency`` builds PE and PGE on a Test/-style directory and
times ``online``; it runs only with ``--test-dir``.  Neither it nor the
binned-halo comparison is wrapped in a catch-all: a failure fails the
run.  The A1 and A2 launches of one step are read off the ``LAUNCHES``
counters of ``ops/spmm.py`` and ``ops/ell.py`` as a difference; the
counters are never reset here.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gnnpe_tpu_torch.ops import ell, spmm
from gnnpe_tpu_torch.utils.device import as_device
from gnnpe_tpu_torch.utils.device_probe import device_constants

__all__ = ["Aggregation", "IMPLEMENTATIONS", "bench_aggregation",
           "bench_query_latency", "build_aggregation", "main", "slot_list",
           "step_bound", "synth_graph"]

IMPLEMENTATIONS = ("binned", "ell", "binned_halo", "flat")
METRIC = "aggregation_edges_per_sec_chip"
# Steps a timed loop chains, and loops whose median is reported.
ITERS = 20
REPS = 11
GRAPH_REPLAYS = 10
# The H100 SXM data sheet's peaks, for the published-peak share beside
# the measured one: HBM bytes/s and f32 flop/s outside the tensor cores.
PUBLISHED_BYTES_S = 3.35e12
PUBLISHED_FLOP_S = 67e12


def synth_graph(num_vertices: int, num_edges: int, seed: int = 0):
    """Power-law-ish multigraph arcs (src, dst), sorted by dst — the
    root bench's draws: zipf-0.8 sources by inverse CDF, uniform
    destinations, a stable sort by destination."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, num_vertices + 1) ** 0.8
    cdf = np.cumsum(w / w.sum())
    src = np.searchsorted(cdf, rng.rand(num_edges)).astype(np.int32)
    src = np.minimum(src, num_vertices - 1)
    dst = rng.randint(0, num_vertices, size=num_edges).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def csr_of(src: np.ndarray, dst: np.ndarray, num_vertices: int):
    """(offsets int32 [V+1], neighbours) of arcs sorted by ``dst``, as
    the root bench builds them: repeated arcs and self-loops kept."""
    counts = np.bincount(dst, minlength=num_vertices)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return offs, src


def slot_list(layout: ell.BinnedEll) -> np.ndarray:
    """The root bench's probe slot list: every class table, then every
    head level, flattened, clamped into the layout's vertex rows (head
    levels past the first address intermediate rows)."""
    parts = [t.reshape(-1) for t in layout.class_tables]
    parts += [t.reshape(-1) for t in layout.head_tables]
    return np.minimum(np.concatenate(parts), layout.num_vertices - 1)


def _binned_bytes(tables, padcnts, hub_rows, hub_counts) -> int:
    """Bytes of a binned layout's tensors on the card (``upload_table``,
    ``from_host``): int32 tables, f32 pad counts, int64 hub rows and f32
    hub counts."""
    n = sum(4 * t.size for t in tables)
    n += sum(4 * p.size for p in padcnts if p is not None)
    if hub_rows is not None and len(hub_rows):
        n += 8 * hub_rows.size + 4 * hub_counts.size
    return int(n)


def _num_hubs(layout) -> int:
    return 0 if layout.hub_rows is None else len(layout.hub_rows)


@dataclass
class Aggregation:
    """One implementation on one device: ``agg`` maps ``x`` (rows in the
    layout's own order) to its neighbour sums in the same order, and
    ``to_vertices`` maps such rows back to vertex order.
    ``index_bytes`` counts the index tensors one step reads (the bound's
    term); ``slots`` and ``hub_part`` are the root's probe's, for the
    binned layout only."""
    implementation: str
    agg: Callable[[torch.Tensor], torch.Tensor]
    x: torch.Tensor
    to_vertices: Callable[[torch.Tensor], torch.Tensor]
    index_bytes: int
    num_slots: int
    num_hubs: int = 0
    num_hub_arcs: int = 0
    slots: Optional[np.ndarray] = None
    hub_part: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def build_aggregation(offsets: np.ndarray, neighbors: np.ndarray,
                      x: np.ndarray, implementation: str,
                      device) -> Aggregation:
    """``implementation`` on ``device`` for the CSR (``offsets``,
    ``neighbors``) and f32 features ``x`` [V, D]; hubs are priced with
    ``device``'s constants for width D.  ``binned_halo`` needs a process
    group up (``parallel/mesh.py:process_group``)."""
    device = as_device(device)
    v, dim = x.shape
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    if implementation == "binned":
        host = ell.build_binned_ell(offsets, neighbors, feature_dim_hint=dim,
                                    device=device)
        lay = ell.BinnedEllDevice.from_host(host, device)
        return Aggregation(
            implementation, lay.apply_perm, lay.permute(xt), lay.unpermute,
            _binned_bytes(host.class_tables + host.head_tables,
                          host.class_padcnt + host.head_padcnt,
                          host.hub_rows, host.hub_counts),
            host.num_slots, _num_hubs(host), host.num_hub_arcs,
            slots=slot_list(host),
            hub_part=lay._hub_part if lay.hub_rows is not None else None)
    if implementation == "ell":
        host = ell.build_ell(offsets, neighbors, width=8, level2_width=8)
        lay = host.on(device)
        return Aggregation(implementation, lay.apply, xt, lambda h: h,
                           sum(4 * t.numel() for t in lay.tables),
                           host.num_slots)
    if implementation == "binned_halo":
        from gnnpe_tpu_torch.parallel.binned_halo import BinnedHaloPlan
        from gnnpe_tpu_torch.parallel.mesh import make_mesh
        plan = BinnedHaloPlan.build(offsets, neighbors, np.zeros(v, np.int64),
                                    1, feature_dim_hint=dim, device=device)
        mesh = make_mesh(1, axes=("graph",), shape=(1,), device=device)
        rows = torch.from_numpy(plan.local_row).to(device)
        lays = plan.local_layouts + plan.halo_layouts
        send = plan.send_idx.reshape(-1)
        return Aggregation(
            implementation, plan.make_aggregate(mesh, device),
            torch.from_numpy(plan.shard_features(x)[0]).to(device),
            lambda h: h[rows],
            sum(_binned_bytes(l.class_tables + l.head_tables,
                              l.class_padcnt + l.head_padcnt,
                              l.hub_rows, l.hub_counts) for l in lays)
            + 4 * (len(send) + 1) + 4 * int((send >= 0).sum()),
            plan.num_slots, sum(_num_hubs(l) for l in lays),
            sum(l.num_hub_arcs for l in lays))
    if implementation == "flat":
        off = torch.from_numpy(np.asarray(offsets, np.int32)).to(device)
        nbr = torch.from_numpy(np.asarray(neighbors, np.int32)).to(device)
        return Aggregation(implementation,
                           lambda h: spmm.neighbor_sum(off, nbr, h), xt,
                           lambda h: h, 4 * (v + 1) + 4 * len(neighbors),
                           len(neighbors))
    raise ValueError(f"implementation {implementation!r} not in "
                     f"{IMPLEMENTATIONS}")


def step_bound(num_vertices: int, num_edges: int, dim: int,
               index_bytes: int, bytes_per_s: float,
               flop_per_s: float) -> dict:
    """The least time of one step (module docstring): its bytes and
    operations, each over its rate, and the larger of the two."""
    vd = num_vertices * dim
    moved = 4 * vd + 4 * vd + 8 * vd + index_bytes
    ops = num_edges * dim + vd
    by_bytes, by_ops = moved / bytes_per_s, ops / flop_per_s
    return dict(bytes=int(moved), index_bytes=int(index_bytes),
                ops=int(ops), bytes_s=by_bytes, ops_s=by_ops,
                bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _events_s(fn, calls: int, reps: int, device) -> list:
    """Seconds of one ``fn()``: per rep, ``calls`` calls between two CUDA
    events (host clock and no events on the CPU), after one untimed
    call."""
    fn()
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) * 1e-3 / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out.append((time.perf_counter() - t0) / calls)
    return out


def _step_time(agg, x: torch.Tensor, iters: int = ITERS,
               reps: int = REPS) -> dict:
    """Seconds of one step ``h = agg(h) * 0.1``, ``iters`` steps chained
    by data from ``x`` in a loop: the median, first and third quartiles
    over ``reps`` loops (CUDA events on a card), and on a card the same
    loop replayed from a CUDA graph (``graph_s``; None elsewhere)."""
    def loop():
        h = x
        for _ in range(iters):
            h = agg(h) * 0.1
        return h

    with torch.no_grad():
        per = np.array(_events_s(loop, 1, reps, x.device)) / iters
        graph_s = None
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                loop()
            graph_s = float(np.median(_events_s(
                graph.replay, GRAPH_REPLAYS, 3, x.device))) / iters
            del graph
    q1, med, q3 = np.percentile(per, [25, 50, 75])
    return dict(step_s=float(med), step_q1_s=float(q1),
                step_q3_s=float(q3), reps=reps, iters=iters, graph_s=graph_s)


def _launches() -> tuple:
    return spmm.LAUNCHES, ell.LAUNCHES


def _continuity(a: Aggregation, edges_per_sec: float, num_edges: int,
                bytes_per_s: float) -> dict:
    """The root bench's ratios, kept for continuity and no bound here:
    the slot-list gather probe (binned only; floored, as the root's, at
    every gathered row crossing memory once) with its hub probe, the
    overlap and additive ratios, and the HBM-byte roofline fraction."""
    x, dev = a.x, a.x.device
    v, dim = x.shape
    out = {}
    if a.slots is not None:
        gidx = torch.from_numpy(a.slots.astype(np.int64)).to(dev)
        with torch.no_grad():
            probe_s = float(np.median(_events_s(
                lambda: x.index_select(0, gidx), 5, 5, dev)))
            hub_s = 0.0
            if a.hub_part is not None:
                hub_s = float(np.median(_events_s(
                    lambda: a.hub_part(x), 5, 5, dev)))
        del gidx
        t_gather = max(probe_s, len(a.slots) * dim * 4 / bytes_per_s)
        out.update(probe_rows=len(a.slots), probe_s=probe_s,
                   probe_gather_s=t_gather, probe_hub_s=hub_s,
                   overlap_ratio=edges_per_sec * max(t_gather, hub_s)
                   / num_edges,
                   additive_ratio=edges_per_sec * (t_gather + hub_s)
                   / num_edges)
    per_edge = 4 * dim + 8 + 8 * dim * v / num_edges
    out["hbm_byte_fraction"] = edges_per_sec * per_edge / bytes_per_s
    return out


def bench_aggregation(num_vertices: int = 100_000, num_edges: int = 800_000,
                      dim: int = 128, implementation: str = "binned",
                      device="cuda", record: Optional[dict] = None):
    """Edges/s of one step of ``implementation`` on ``device`` and its
    share of ``step_bound``; returns (edges_per_sec, frac, step_s) as
    the root's does.  ``record``, when given, receives the details: step
    times (events and graph replay), the bound and its parts, the
    continuity ratios, the A1/A2 launches of one step and the layout's
    slots and hubs."""
    device = as_device(device)
    src, dst = synth_graph(num_vertices, num_edges)
    x = np.random.RandomState(1).rand(
        num_vertices, dim).astype(np.float32)
    offs, nbr = csr_of(src, dst, num_vertices)
    group = contextlib.nullcontext()
    if implementation == "binned_halo":
        from gnnpe_tpu_torch.parallel.mesh import process_group
        group = process_group(device)
    with group:
        t0 = time.perf_counter()
        a = build_aggregation(offs, nbr, x, implementation, device)
        build_s = time.perf_counter() - t0
        times = _step_time(a.agg, a.x)
        before = _launches()
        with torch.no_grad():
            a.agg(a.x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        per_step = tuple(n - b for n, b in zip(_launches(), before))
        step_s = times["step_s"]
        eps = num_edges / step_s
        bw, flops, _ = device_constants(device)
        bound = step_bound(num_vertices, num_edges, dim, a.index_bytes,
                           bw, flops)
        frac = bound["bound_s"] / step_s
        cont = _continuity(a, eps, num_edges, bw)
    if record is not None:
        record.update(
            implementation=implementation, device=str(device),
            num_vertices=num_vertices, num_edges=num_edges, dim=dim,
            build_s=build_s, edges_per_sec=eps, share_of_bound=frac,
            memory_bytes_per_s=bw, f32_flop_per_s=flops,
            launches_per_step=dict(a1=per_step[0], a2=per_step[1]),
            num_slots=a.num_slots, num_hubs=a.num_hubs,
            num_hub_arcs=a.num_hub_arcs, continuity=cont, **times, **bound)
        if times["graph_s"] is not None:
            record["graph_share_of_bound"] = bound["bound_s"] / times["graph_s"]
        if device.type == "cuda":
            published = step_bound(num_vertices, num_edges, dim,
                                   a.index_bytes, PUBLISHED_BYTES_S,
                                   PUBLISHED_FLOP_S)
            record["published_bound_s"] = published["bound_s"]
            record["published_share_of_bound"] = published["bound_s"] / step_s
    return eps, frac, step_s


def bench_query_latency(test_dir: str, want_pe: int = 45426,
                        want_pge: int = 221832, device="cuda"):
    """Median ms of 3 ``online`` calls of PE and of PGE on the named
    Test/-style directory (``data_graph.graph``, ``query_graph.graph``),
    each engine built first (``offline().build_index()``, then
    ``attach_device``); raises unless the answer counts are ``want_pe``
    and ``want_pge``."""
    from gnnpe_tpu_torch.config import PEConfig, PGEConfig
    from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
    from gnnpe_tpu_torch.graph.csr import CSRGraph
    device = as_device(device)
    g = CSRGraph.from_graph_file(os.path.join(test_dir, "data_graph.graph"))
    q = CSRGraph.from_graph_file(os.path.join(test_dir, "query_graph.graph"))
    medians = []
    for name, cls, cfg, want in (("PE", PEEngine, PEConfig, want_pe),
                                 ("PGE", PGEEngine, PGEConfig, want_pge)):
        t0 = time.perf_counter()
        eng = cls(cfg.from_cli(), g, device).offline().build_index()
        eng.attach_device(device)
        print(f"[bench] {name} offline+index "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms", file=sys.stderr)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = eng.online(q)
            times.append((time.perf_counter() - t0) * 1e3)
        if r.answer_count != want:
            raise RuntimeError(f"{name} answered {r.answer_count}, "
                               f"want {want}")
        medians.append(float(np.median(times)))
    return tuple(medians)


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return f"{device} (no card: host times, no device metric)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _print_row(rec: dict) -> None:
    """The row on stdout; the continuity lines on stderr."""
    ms = lambda s: None if s is None else s * 1e3
    print(f"[bench] {rec['implementation']}: step {ms(rec['step_s']):.4f} ms "
          f"by events (q1 {ms(rec['step_q1_s']):.4f}, q3 "
          f"{ms(rec['step_q3_s']):.4f}), "
          + ("not replayed" if rec["graph_s"] is None else
             f"{ms(rec['graph_s']):.4f} ms replayed from a CUDA graph")
          + f"; bound {ms(rec['bound_s']):.4f} ms by {rec['bound_by']} "
          f"({rec['bytes']} B, {rec['ops']} ops): share "
          f"{rec['share_of_bound']:.4f}; launches a step {rec['launches_per_step']}"
          f", {rec['num_hubs']} hubs", file=sys.stderr)
    c = rec["continuity"]
    if "probe_s" in c:
        print(f"[bench] continuity (root bench's gather probe: a library "
              f"gather, no bound on this card): index_select of "
              f"{c['probe_rows']} rows {ms(c['probe_s']):.4f} ms, hub "
              f"{ms(c['probe_hub_s']):.4f} ms; overlap ratio "
              f"{c['overlap_ratio']:.4f}, additive ratio "
              f"{c['additive_ratio']:.4f}", file=sys.stderr)
    print(f"[bench] continuity (root bench's HBM-byte roofline fraction, no "
          f"bound on this card): {c['hbm_byte_fraction']:.4f}",
          file=sys.stderr)
    if rec["share_of_bound"] > 1.0:
        print(f"[bench] FINDING: share of the bound "
              f"{rec['share_of_bound']:.4f} > 1: the byte count missed "
              f"something", file=sys.stderr)
    print("bench row: " + json.dumps(rec, sort_keys=True))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m gnnpe_tpu_torch.bench",
        description="aggregation edges/s of one message-passing step")
    ap.add_argument("--device", default="cuda",
                    help="torch device (no CPU fallback: pass cpu by name)")
    ap.add_argument("--implementation", default="binned",
                    choices=IMPLEMENTATIONS)
    ap.add_argument("--num-vertices", type=int, default=100_000)
    ap.add_argument("--num-edges", type=int, default=800_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--metrics", default=None,
                    help="append JSON-lines metrics to this file")
    ap.add_argument("--trace", default=None,
                    help="torch.profiler trace of the headline run into "
                         "this directory")
    ap.add_argument("--skip-halo", action="store_true",
                    help="skip the 1-shard binned_halo comparison")
    ap.add_argument("--test-dir", default=None,
                    help="Test/-style directory for the PE/PGE query "
                         "latency (not run without it)")
    return ap


def main(argv=None) -> int:
    from gnnpe_tpu_torch.utils.profiling import MetricsLog, trace
    args = build_parser().parse_args(argv)
    device = as_device(args.device)
    card = _card(device)
    print(card)
    sizes = dict(num_vertices=args.num_vertices, num_edges=args.num_edges,
                 dim=args.dim, device=device)
    log = MetricsLog(args.metrics)
    try:
        rec = {}
        tracing = (trace(args.trace, device) if args.trace
                   else contextlib.nullcontext())
        with tracing:
            eps, frac, step_s = bench_aggregation(
                implementation=args.implementation, record=rec, **sizes)
        _print_row(rec)
        log.log("aggregation", **rec)
        record = dict(card=card, implementation=args.implementation,
                      edges_per_sec=eps, vs_baseline=frac,
                      step_ms=step_s * 1e3)
        if not args.skip_halo and args.implementation != "binned_halo":
            halo = {}
            halo_eps, _, _ = bench_aggregation(
                implementation="binned_halo", record=halo, **sizes)
            _print_row(halo)
            record["binned_halo_ratio"] = halo_eps / eps
            print(f"[bench] binned_halo (1-shard sharded layout) "
                  f"{halo_eps / 1e6:.1f} M edges/s = "
                  f"{halo_eps / eps:.4f}x of {args.implementation}",
                  file=sys.stderr)
            log.log("binned_halo_1shard", edges_per_sec=halo_eps,
                    vs_implementation=halo_eps / eps)
        if args.test_dir:
            pe_ms, pge_ms = bench_query_latency(args.test_dir, device=device)
            record["query_latency"] = dict(pe_online_ms=pe_ms,
                                           pge_online_ms=pge_ms)
            print(f"[bench] PE online {pe_ms:.1f} ms; PGE online "
                  f"{pge_ms:.1f} ms", file=sys.stderr)
        else:
            record["query_latency"] = "not run (no --test-dir)"
        log.log("record", **record)
    finally:
        log.close()
    print("record: " + json.dumps(record, sort_keys=True))
    print(json.dumps({"metric": METRIC, "value": round(eps),
                      "unit": "edges/s", "vs_baseline": frac}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
