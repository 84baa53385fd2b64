"""Dataset-ladder run on one device or a group of ranks (counterpart of
gnnpe_tpu/frontends/ladder.py).

Runs the whole pipeline on one rung of ``io/datasets.py`` — offline
enumeration, index build, online candidate search and refinement over
sampled queries, a spot-check of two queries against the flat host
oracle, batched serving — and returns one row per variant (PE, then
PGE).  The reference's end-to-end contract being scaled is
GNN-PE/src/main.cpp:122-182.

    python -m gnnpe_tpu_torch.frontends.ladder --dataset dblp \\
        --device cuda [--out rows.jsonl]

Scale policy, as gnnpe_tpu's:
  * PE indexes one entry per path, l=2 (3-vertex paths) while the
    deduplicated path count is at most ``pe_max_paths``, else l=1.  The
    index is built on the device and streamed from the host where the
    table does not fit the card (``paths/pipeline.py``, ``resident``).
  * Queries: ``queries`` random-walk trees (labels inherited from the
    data graph, matches guaranteed), seeds ``seed``, ``seed + 1``, ...;
    p50 and p90 over all of them.
  * Spot verification: query 0 and the heaviest query (most phase-2
    chunks) are checked equal to the flat f64 host filter, which shares
    no code with the device search; a failure is recorded in the row.

Serving goes through ``attach_mesh`` on a mesh over the default process
group: world size 1 in a single process (a group is made and torn down
here), the launcher's world under ``torchrun``, where every rank builds
the rung and rank 0 alone writes the rows.  Rows go where ``--out``
says (one JSON line each, appended as produced) and to stdout.

In the row beside gnnpe_tpu's fields: ``candidates``, Σ|candidates| of
each query in order, which a caller can hold to an oracle where every
query's answers reach ``max_answers``.  Not in the row: ``warm_s`` (the
port compiles nothing ahead of a query, so there is no warm-up to time),
and the limb arrays in ``index_bytes`` (the port has none: it counts the
search's own device tensors).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gnnpe_tpu_torch.parallel.mesh import process_group
from gnnpe_tpu_torch.utils.device import as_device


def _pct(vals, q):
    return round(float(np.percentile(vals, q)), 1) if len(vals) else None


def _stage_pcts(stages, q):
    return {k: _pct(v, q) for k, v in stages.items()}


def _device_bytes(searcher) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in searcher.resident_tensors().values()))


def _free(eng, device) -> None:
    """Release an engine's index before the next one is built."""
    close = getattr(eng.searcher, "close", None)
    if close is not None:
        close()
    eng.searcher = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _candidates(result) -> int:
    """Σ|candidates| over the query vertices of one ``online`` result."""
    return int(sum(len(c) for c in result.candidates))


def _serve(eng, qs, answers, lat_ms) -> dict:
    """Every query at once through ``online_many`` with the device
    union, twice (the second pass is the steady state), answers held to
    the per-query loop's."""
    t0 = time.time()
    rs = eng.online_many(qs, union="device")
    cold_s = time.time() - t0
    if [r.answer_count for r in rs] != answers:
        raise AssertionError("online_many answers != per-query")
    t0 = time.time()
    rs = eng.online_many(qs, union="device")
    serving_s = time.time() - t0
    if [r.answer_count for r in rs] != answers:
        raise AssertionError("online_many answers != per-query")
    return dict(queries=len(qs), cold_s=round(cold_s, 2),
                serving_s=round(serving_s, 2),
                qps=round(len(qs) / serving_s, 2),
                amortized_ms=round(serving_s * 1e3 / len(qs), 1),
                speedup_vs_sequential=round(
                    float(np.sum(lat_ms)) / (serving_s * 1e3), 2))


def _spot(check, chunk_counts):
    """(ok, ok on the heaviest query, error): ``check(i)`` on query 0 and
    on the query with the most chunks; a failure is recorded, not
    raised, so a long rung keeps its measurements."""
    try:
        ok = check(0)
        heavy = int(np.argmax(chunk_counts)) if chunk_counts else 0
        return ok, (check(heavy) if heavy != 0 else ok), None
    except Exception as exc:                    # noqa: BLE001
        return False, False, repr(exc)[:300]


def run_rung(name: str, queries: int = 50, query_size: int = 8,
             seed: int = 0, block_size: int = 512,
             pe_max_paths: int = 2_000_000_000,
             max_answers: int = 100_000,
             pipelined: bool = True,
             prefill_seconds: float = 300.0,
             force_streamed: bool = False,
             serve: bool = True,
             ab_sequential: bool = False,
             pe_only: bool = False,
             pge_only: bool = False,
             pe_load: str = "",
             build_note: str = "",
             out_path: str = "", *, device) -> list:
    """The rows of rung ``name`` on ``device`` (PE, then PGE, as the
    flags say).  ``out_path``, where given, gets each row as a JSON line
    when it is produced (rank 0 only)."""
    from gnnpe_tpu_torch.io.datasets import load_dataset, sample_query
    from gnnpe_tpu_torch.parallel.mesh import make_mesh
    device = as_device(device)
    rows = []

    def emit(row):
        # Rows land on disk as produced: a crash in a later variant
        # must not lose a completed one.
        rows.append(row)
        if out_path and dist.get_rank() == 0:
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    t0 = time.time()
    g = load_dataset(name, seed=seed)
    gen_s = time.time() - t0
    deg = np.diff(g.offsets).astype(np.int64)
    est_paths3 = int((deg * (deg - 1)).sum())
    print(f"[ladder:{name}] V={g.num_vertices} E={g.num_edges} "
          f"maxdeg={deg.max()} gen={gen_s:.1f}s "
          f"est 3v-paths={est_paths3}", file=sys.stderr)
    qs = [sample_query(g, query_size, tree=True, seed=seed + i)
          for i in range(queries)]
    with process_group(device):
        world = dist.get_world_size()
        mesh = make_mesh(world, axes=("graph",), shape=(world,),
                         device=device)
        common = dict(rung=name, v=g.num_vertices, e=g.num_edges,
                      device=str(device), world_size=world)
        if not pge_only:
            _run_pe(g, qs, mesh, device, common, emit, est_paths3,
                    block_size, pe_max_paths, max_answers, pipelined,
                    prefill_seconds, force_streamed, serve, ab_sequential,
                    pe_load, build_note)
        if not pe_only:
            _run_pge(g, qs, mesh, device, common, emit, block_size,
                     max_answers, serve)
    return rows


def _run_pe(g, qs, mesh, device, common, emit, est_paths3, block_size,
            pe_max_paths, max_answers, pipelined, prefill_seconds,
            force_streamed, serve, ab_sequential, pe_load, build_note):
    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.embed.pde import gen_pde, gen_query_pde_table
    from gnnpe_tpu_torch.engine import PEEngine
    from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
    from gnnpe_tpu_torch.index import device_packed as dp
    from gnnpe_tpu_torch.match.filter import (pe_candidates,
                                              pe_candidates_chunked)
    from gnnpe_tpu_torch.match.plan import greedy_path_cover
    from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
    from gnnpe_tpu_torch.paths.pipeline import offline_build_pipelined
    name = common["rung"]
    pe_l = 2 if est_paths3 // 2 <= pe_max_paths else 1
    cfg = PEConfig.from_cli(l=pe_l, e=2, p=5, n=max_answers)
    eng = PEEngine(cfg, g, device)
    eng.vertices = eng._vde(g)
    pipe_timings = None
    forced = False if force_streamed else None
    if pe_load:
        # Serve a saved index (``save``'s npz, the port's or gnnpe_tpu's)
        # instead of building one, each rank reading its block range:
        # enumerate/build times then describe the load.
        t0 = time.time()
        eng.searcher = dp.load(pe_load, eng.vertices, device, mesh=mesh)
        build_s, enum_s = time.time() - t0, 0.0
        eng.paths = eng.searcher._host_vids[:eng.searcher.num_entries]
    elif pipelined:
        t0 = time.time()
        eng.paths, eng.searcher, pipe_timings = offline_build_pipelined(
            g, degree_sorted_nodes(g), cfg.path_length, eng.vertices,
            device, block_size=block_size, resident=forced)
        build_s = time.time() - t0
        enum_s = pipe_timings["enumerate_s"]
    else:
        t0 = time.time()
        eng.offline()
        enum_s = time.time() - t0
        t0 = time.time()
        eng.build_index(block_size=block_size, table=True, resident=forced)
        build_s = time.time() - t0
    if not pe_load:
        eng.attach_mesh(mesh, packed=True)
    idx = eng.searcher
    host_paths = (eng.paths.cpu().numpy() if isinstance(eng.paths,
                                                        torch.Tensor)
                  else np.asarray(eng.paths))
    num_paths = len(host_paths)
    # The same index built again sequentially — host enumeration, then
    # the build — for the pipelined build's speed-up, recorded in the row.
    ab = None
    if ab_sequential and pipelined:
        t0 = time.time()
        seq = PEEngine(cfg, g, device)
        seq.paths, _ = enumerate_paths(g, degree_sorted_nodes(g),
                                       cfg.path_length, dedup=True)
        seq.build_index(block_size=block_size, table=True, resident=forced)
        seq_s = time.time() - t0
        _free(seq, device)
        ab = round(seq_s / max(build_s, 1e-9), 2)
        print(f"[ladder:{name}] PE build A/B: sequential {seq_s:.1f}s"
              f" / pipelined {build_s:.1f}s = {ab}x", file=sys.stderr)
    data_pde = gen_pde(eng.vertices, host_paths) \
        if num_paths <= 20_000_000 else None
    # Streamed mode: popular leaf blocks go into the device pool during
    # the offline phase, so the first queries mostly hit.
    streamed = getattr(idx, "streamed", False)
    prefill_s = prefill_blocks = None
    if streamed:
        t0 = time.time()
        prefill_blocks = idx.prefill_cache(max_seconds=prefill_seconds)
        prefill_s = round(time.time() - t0, 2)

    lat, answers, cands = [], [], []
    stages = {"query_plan": [], "search": [], "refine": []}
    chunk_counts, survived, hit_rates = [], [], []
    for q in qs:
        t0 = time.time()
        r = eng.online(q, union="host")
        lat.append((time.time() - t0) * 1e3)
        answers.append(r.answer_count)
        cands.append(_candidates(r))
        for k in stages:
            stages[k].append(r.timings_ms.get(k, 0.0))
        st = idx.last_stats
        if st is not None:
            chunk_counts.append(st["chunks"])
            survived.append(st["survived"])
            if "cache_hits" in st:
                tot = st["cache_hits"] + st["cache_misses"]
                hit_rates.append(st["cache_hits"] / tot if tot else 1.0)

    def pe_spot(qi: int) -> bool:
        qg = qs[qi]
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                cfg.path_length, dedup=True)
        q_pde, w, _ = gen_query_pde_table(eng._vde(qg), qp)
        plan = greedy_path_cover(qp, w, qg.num_vertices)
        if data_pde is not None:
            oracle = pe_candidates(data_pde, q_pde, plan, qg.num_vertices,
                                   epsilon=cfg.epsilon)
        else:
            oracle = pe_candidates_chunked(eng.vertices, host_paths, q_pde,
                                           plan, qg.num_vertices,
                                           epsilon=cfg.epsilon)
        packed = idx.search(eng._stack([(q_pde, plan, qg.num_vertices)]))
        if not (len(oracle) == len(packed) and all(
                np.array_equal(a, b) for a, b in zip(oracle, packed))):
            raise AssertionError(f"packed search != host oracle on query "
                                 f"{qi}")
        return True

    spot_ok, spot_ok_p90, spot_err = _spot(pe_spot, chunk_counts)
    if spot_err:
        print(f"[ladder:{name}] PE SPOT-CHECK FAILED: {spot_err}",
              file=sys.stderr)

    serving = None
    if serve:
        try:
            serving = _serve(eng, qs, answers, lat)
        except torch.cuda.OutOfMemoryError as exc:
            # The stacked search competes with a full block pool for
            # device memory: a streamed index halves its pool and tries
            # once more before the failure is recorded.
            if not streamed:
                serving = dict(error=repr(exc)[:300])
            else:
                nb = idx.degrade_cache(0.5)
                torch.cuda.empty_cache()
                print(f"[ladder:{name}] PE serving OOM -> cache degraded "
                      f"to {nb / 1e9:.1f} GB, retrying", file=sys.stderr)
                try:
                    serving = _serve(eng, qs, answers, lat)
                    serving["degraded_cache_bytes"] = int(nb)
                except Exception as exc2:       # noqa: BLE001
                    serving = dict(error=repr(exc2)[:300],
                                   degraded_cache_bytes=int(nb))
        except Exception as exc:                # noqa: BLE001
            serving = dict(error=repr(exc)[:300])
        if "error" in serving:
            print(f"[ladder:{name}] PE SERVING FAILED: {serving}",
                  file=sys.stderr)
    index_bytes = _device_bytes(idx)
    emit(dict(
        common, variant="pe", l=pe_l, paths=num_paths,
        mode="streamed" if streamed else "resident",
        loaded_from=pe_load or None, build_note=build_note or None,
        enumerate_s=round(enum_s, 2), index_build_s=round(build_s, 2),
        build_phase_ms=idx.build_phase_ms,
        pipeline=pipe_timings, pipeline_vs_sequential=ab,
        prefill_s=prefill_s, prefill_blocks=prefill_blocks,
        index_bytes=index_bytes,
        host_table_bytes=int(idx._host_vids.nbytes) if streamed else None,
        queries=len(lat), max_answers=max_answers,
        online_p50_ms=_pct(lat, 50), online_p90_ms=_pct(lat, 90),
        stage_p50_ms=_stage_pcts(stages, 50),
        stage_p90_ms=_stage_pcts(stages, 90),
        chunks_p50=_pct(chunk_counts, 50), chunks_p90=_pct(chunk_counts, 90),
        blocks_survived_p50=_pct(survived, 50),
        cache_hit_rate_p50=(round(float(np.median(hit_rates)), 3)
                            if hit_rates else None),
        cache_hit_rate_min=(round(float(np.min(hit_rates)), 3)
                            if hit_rates else None),
        num_blocks=int(idx.num_blocks),
        mean_answers=round(float(np.mean(answers)), 1), candidates=cands,
        serving=serving, spot_verified=bool(spot_ok),
        spot_verified_p90=bool(spot_ok_p90), spot_error=spot_err))
    print(f"[ladder:{name}] PE l={pe_l}: paths={num_paths} "
          f"enum={enum_s:.1f}s build={build_s:.1f}s "
          f"idx={index_bytes / 1e6:.0f}MB p50={np.median(lat):.0f}ms "
          f"p90={np.percentile(lat, 90):.0f}ms", file=sys.stderr)
    # Free the PE index before the PGE fold: both at once may not fit.
    _free(eng, device)


def _run_pge(g, qs, mesh, device, common, emit, block_size, max_answers,
             serve):
    """The PGE half of a rung (``pge_only`` runs it alone, in a fresh
    process after a PE half that failed)."""
    from gnnpe_tpu_torch.config import PGEConfig
    from gnnpe_tpu_torch.embed.pde import path_groups
    from gnnpe_tpu_torch.engine import PGEEngine
    from gnnpe_tpu_torch.match.filter import (pge_candidates,
                                              pge_candidates_chunked)
    from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
    name = common["rung"]
    cfg = PGEConfig.from_cli(l=2, e=2, p=5, n=max_answers)
    eng = PGEEngine(cfg, g, device)
    t0 = time.time()
    eng.offline(device=True).build_index(block_size=block_size)
    off_s = time.time() - t0
    eng.attach_mesh(mesh, packed=True)
    idx = eng.searcher
    lat, answers, cands, qs_ok, skipped = [], [], [], [], 0
    stages = {"query_plan": [], "search": [], "refine": []}
    chunk_counts, survived = [], []
    for q in qs:
        t0 = time.time()
        try:
            r = eng.online(q)
        except ValueError:      # a query vertex with no path: skipped (the
            skipped += 1        # reference reads uninitialised memory)
            continue
        lat.append((time.time() - t0) * 1e3)
        answers.append(r.answer_count)
        cands.append(_candidates(r))
        qs_ok.append(q)
        for k in stages:
            stages[k].append(r.timings_ms.get(k, 0.0))
        st = idx.last_stats
        if st is not None:
            chunk_counts.append(st["chunks"])
            survived.append(st["survived"])

    def pge_spot(qi: int) -> bool:
        qg = qs_ok[qi]
        qv = eng._vde(qg)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                cfg.path_length, dedup=False)
        q_group, q_lgroup = path_groups(qv, qp[:, 0], qp, cfg.pde_dim)
        fn = (pge_candidates if g.num_vertices <= 5_000_000
              else pge_candidates_chunked)
        oracle = fn(eng.vertices.labels, eng.vertices.degrees, eng.group,
                    eng.label_group, qv.labels, qv.degrees, q_group,
                    q_lgroup, q_vertex_ids=list(range(qg.num_vertices)),
                    epsilon=cfg.epsilon)
        packed = idx.search(eng._stack([eng._query_table(qg)]))
        if not (len(oracle) == len(packed) and all(
                np.array_equal(a, b) for a, b in zip(oracle, packed))):
            raise AssertionError(f"PGE packed search != host oracle on "
                                 f"query {qi}")
        return True

    spot_ok = spot_ok_p90 = spot_err = None
    if qs_ok:
        spot_ok, spot_ok_p90, spot_err = _spot(pge_spot, chunk_counts)
        if spot_err:
            print(f"[ladder:{name}] PGE SPOT-CHECK FAILED: {spot_err}",
                  file=sys.stderr)
    serving = None
    if serve and qs_ok:
        try:
            serving = _serve(eng, qs_ok, answers, lat)
        except Exception as exc:                # noqa: BLE001
            serving = dict(error=repr(exc)[:300])
            print(f"[ladder:{name}] PGE SERVING FAILED: {serving}",
                  file=sys.stderr)
    emit(dict(
        common, variant="pge", l=2,
        offline_s=round(off_s, 2), index_bytes=_device_bytes(idx),
        host_group_bytes=int(eng.group.nbytes + eng.label_group.nbytes),
        queries=len(lat), skipped=skipped, max_answers=max_answers,
        online_p50_ms=_pct(lat, 50), online_p90_ms=_pct(lat, 90),
        stage_p50_ms=_stage_pcts(stages, 50),
        stage_p90_ms=_stage_pcts(stages, 90),
        chunks_p50=_pct(chunk_counts, 50), chunks_p90=_pct(chunk_counts, 90),
        blocks_survived_p50=_pct(survived, 50),
        num_blocks=int(idx.num_blocks),
        mean_answers=(round(float(np.mean(answers)), 1) if answers
                      else None), candidates=cands,
        serving=serving, spot_verified=bool(spot_ok),
        spot_verified_p90=bool(spot_ok_p90), spot_error=spot_err))
    print(f"[ladder:{name}] PGE l=2: offline="
          f"{off_s:.1f}s p50={np.median(lat) if lat else 0:.0f}ms "
          f"skipped={skipped}", file=sys.stderr)
    _free(eng, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="dblp",
                    help="ladder rung name or comma list")
    ap.add_argument("--device", required=True,
                    help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--query-size", type=int, default=8)
    ap.add_argument("--out", default="",
                    help="append each row to this file as a JSON line "
                         "(default: stdout only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-answers", type=int, default=100_000,
                    help="refinement emission cap (ref -n flag); the "
                         "dblp rung has queries with ~2.5e9 matches")
    ap.add_argument("--sequential", action="store_true",
                    help="host enumeration, then the build (no device "
                         "enumeration)")
    ap.add_argument("--force-streamed", action="store_true",
                    help="build the streamed PE index even where the "
                         "table would fit the device")
    ap.add_argument("--prefill-seconds", type=float, default=300.0,
                    help="cache-prefill budget for streamed rungs")
    ap.add_argument("--no-serve", action="store_true",
                    help="skip the batched-serving measurement")
    ap.add_argument("--ab-sequential", action="store_true",
                    help="also build the PE index sequentially and record "
                         "the pipelined build's speed-up in the row")
    ap.add_argument("--pe-only", action="store_true",
                    help="skip the PGE pass")
    ap.add_argument("--pge-only", action="store_true",
                    help="skip the PE pass (recover a PGE row in a fresh "
                         "process)")
    ap.add_argument("--pe-load", default="",
                    help="serve a saved PE index (the npz of "
                         "TablePESearch/StreamedPESearch.save) instead of "
                         "building one")
    ap.add_argument("--build-note", default="",
                    help="provenance note recorded in the PE row")
    ap.add_argument("--pe-max-paths", type=float, default=2_000_000_000,
                    help="PE l=2 feasibility cap in entries")
    args = ap.parse_args(argv)
    all_rows = []
    for name in args.dataset.split(","):
        all_rows.extend(run_rung(
            name.strip(), queries=args.queries, query_size=args.query_size,
            seed=args.seed, max_answers=args.max_answers,
            pipelined=not args.sequential,
            prefill_seconds=args.prefill_seconds,
            force_streamed=args.force_streamed, serve=not args.no_serve,
            ab_sequential=args.ab_sequential, pe_only=args.pe_only,
            pge_only=args.pge_only, pe_load=args.pe_load,
            build_note=args.build_note,
            pe_max_paths=int(args.pe_max_paths), out_path=args.out,
            device=args.device))
    if int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps(all_rows))


if __name__ == "__main__":
    main()
