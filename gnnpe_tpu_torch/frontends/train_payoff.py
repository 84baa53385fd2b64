"""Trained-embedding payoff on one device (counterpart of
gnnpe_tpu/frontends/train_payoff.py with ``device=True``).

Trains a PathGNN with the discriminative dominance objective
(models/train.py), serves it through the unchanged device search and
host refinement (engine.py with ``embedder=``), and measures on held-out
tree queries what training buys over the fixed label-seeded VDE: the
candidate-set size, the online latency by stage, and the blocks and
chunks the search walks.  The PGE variant builds its groups on the
device (``offline(device=True)``); the PE variant enumerates its paths
there (``offline(device=True)``) and builds its table-mode index
(``build_index(table=True)``): resident where it fits, else, or with
``force_streamed``, streamed from the host (``StreamedPESearch``, its
block pool prefilled before the queries), where fewer chunks mean fewer
bytes uploaded.  PGE's answers
are exact, so any dominance-preserving embedding must give the same
answers; PE's counts can in principle depend on the candidate sets (the
reference's one-orientation dedup), and ``run`` asserts equality per
query for both as gnnpe_tpu does, so such a case would be loud.

    python -m gnnpe_tpu_torch.frontends.train_payoff --dataset dblp \\
        --device cuda [--variant pe [--force-streamed]]

Prints one JSON row per embedder to stdout; writes files only where
``--out`` (JSON lines, appended) or ``--md`` (a table) name them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import List

import numpy as np

MAX_TRAIN_PATHS = 500_000


def evaluate(eng, queries):
    """(summary, results, stats): per-query answers, candidate sums and
    stage timings, and the surviving blocks and phase-2 chunks per
    query; ``results`` are the engine's ``MatchResult``s, ``stats`` the
    search's ``last_stats`` of each query (a streamed index's hold its
    cache hits, misses and uploaded bytes)."""
    results, total_ms, survived, chunks, stats = [], [], [], [], []
    for q in queries:
        t0 = time.perf_counter()
        r = eng.online(q)
        total_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(r)
        st = eng.searcher.last_stats
        stats.append(dict(st) if st else None)
        survived.append(st["survived"] if st else 0)
        chunks.append(st["chunks"] if st else 0)
    search = [r.timings_ms["search"] for r in results]
    refine = [r.timings_ms["refine"] for r in results]
    summary = dict(
        answers=[r.answer_count for r in results],
        cand_sum_mean=float(np.mean([sum(map(len, r.candidates))
                                     for r in results])),
        search_p50_ms=float(np.median(search)),
        search_min_ms=float(np.min(search)),
        search_max_ms=float(np.max(search)),
        refine_p50_ms=float(np.median(refine)),
        refine_min_ms=float(np.min(refine)),
        refine_max_ms=float(np.max(refine)),
        online_p50_ms=float(np.median(total_ms)),
        chunks_mean=float(np.mean(chunks)),
        blocks_survived_mean=float(np.mean(survived)))
    return summary, results, stats


@dataclass
class Payoff:
    """What ``run`` measured: the printed rows, the training state, the
    held-out queries with each embedder's results and search stats
    (``evaluate``'s), the trained engine (its ``vertices`` are the
    embedder's data-graph VDE) and the training paths."""
    rows: List[dict]
    state: object
    queries: list
    fixed: list
    trained: list
    engine: object
    train_paths: np.ndarray
    fixed_stats: list
    trained_stats: list


def sample_train_paths(g, length: int, seed: int) -> np.ndarray:
    """``run``'s training paths: ``g``'s deduplicated paths of ``length``
    vertices, subsampled at ``seed`` to at most MAX_TRAIN_PATHS rows to
    bound the cost of embedding every path each step."""
    from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
    from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), length, dedup=True)
    if len(paths) > MAX_TRAIN_PATHS:
        sel = np.random.RandomState(seed + 3).choice(
            len(paths), size=MAX_TRAIN_PATHS, replace=False)
        paths = paths[np.sort(sel)]
    return paths


def run(dataset: str = "yeast", queries: int = 20, query_size: int = 8,
        steps: int = 300, vde_dim: int = 2, l: int = 2, seed: int = 0,
        learning_rate: float = 1e-2, max_answers: int = 100_000,
        variant: str = "pge", *, device,
        force_streamed: bool = False) -> Payoff:
    """Fixed VDE, then a trained PathGNN, each served by an engine of
    ``variant`` ("pge" or "pe") built on ``device`` over the same
    held-out queries.  PE builds resident where the index fits and
    streamed otherwise, or always streamed with ``force_streamed`` (PGE
    ignores it); a streamed index prefills its block pool for up to 60 s
    before the queries, and PE rows carry the ``mode``.  The fixed
    engine's index is closed before the trained one is built, so the
    two are never on the device together.  The binned layout's hubs are
    priced with ``device``'s prices."""
    import torch

    from gnnpe_tpu_torch.config import PEConfig, PGEConfig
    from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
    from gnnpe_tpu_torch.io.datasets import load_dataset, sample_query
    from gnnpe_tpu_torch.models.embedder import model_embedder
    from gnnpe_tpu_torch.models.gnn import PathGNN
    from gnnpe_tpu_torch.models.train import fit
    from gnnpe_tpu_torch.utils.device import as_device

    if variant not in ("pe", "pge"):
        raise ValueError(f"variant must be 'pe' or 'pge', got {variant!r}")
    device = as_device(device)
    g = load_dataset(dataset, seed=seed)
    # Refinement emission is capped (the reference's -n flag): the
    # payoff under test is the filter, not match enumeration.
    cfg = (PGEConfig if variant == "pge" else PEConfig).from_cli(
        l=l, e=vde_dim, p=5, n=max_answers)

    def make_engine(embedder=None):
        if variant == "pge":
            eng = PGEEngine(cfg, g, device, embedder=embedder)
            return eng.offline(device=True).build_index().attach_device(
                device)
        eng = PEEngine(cfg, g, device, embedder=embedder)
        eng.offline(device=True).build_index(
            table=True, resident=False if force_streamed else None)
        if eng.searcher.streamed:
            eng.searcher.prefill_cache(max_seconds=60.0)
        return eng

    # Held-out queries: seeds disjoint from the training pair draws.
    qs = [sample_query(g, query_size, tree=True, seed=10_000 + seed + i)
          for i in range(queries)]
    fixed_eng = make_engine()
    mode = None
    if variant == "pe":
        mode = "streamed" if fixed_eng.searcher.streamed else "resident"
    base, fixed, fixed_stats = evaluate(fixed_eng, qs)
    close = getattr(fixed_eng.searcher, "close", None)
    if close is not None:
        close()
    del fixed_eng, close
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[payoff:{dataset}] fixed VDE: cands={base['cand_sum_mean']:.0f}"
          f" p50={base['online_p50_ms']:.1f}ms", file=sys.stderr)

    # Training pairs come from the deduplicated paths (PGE's groups
    # fold 3-vertex paths; PE indexes its own length).
    train_paths = sample_train_paths(
        g, max(l + 1, 2) if variant == "pge" else cfg.path_length, seed)
    model = PathGNN(dim=vde_dim, num_layers=1, labels_count=g.labels_count,
                    activation="softplus", device=device)
    aggregation = "binned" if g.num_edges > 100_000 else "segment"
    t0 = time.perf_counter()
    state = fit(model, g, train_paths, num_steps=steps, batch_size=1024,
                seed=seed, negatives=True, learning_rate=learning_rate,
                aggregation=aggregation, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    engine = make_engine(model_embedder(model, device))
    tr, trained, trained_stats = evaluate(engine, qs)
    if tr["answers"] != base["answers"]:
        raise AssertionError(f"exactness violated: {tr['answers']} vs "
                             f"{base['answers']}")
    red = 100.0 * (1 - tr["cand_sum_mean"] / max(base["cand_sum_mean"],
                                                 1e-9))
    print(f"[payoff:{dataset}] trained:   cands={tr['cand_sum_mean']:.0f} "
          f"(-{red:.1f}%) p50={tr['online_p50_ms']:.1f}ms "
          f"train={train_s:.1f}s loss {state.history[0]:.4f}->"
          f"{state.history[-1]:.4f}", file=sys.stderr)
    common = dict(dataset=dataset, variant=variant, vde_dim=vde_dim, l=l,
                  queries=queries, engine="device-packed",
                  device=str(device))
    if mode is not None:
        common["mode"] = mode
    rows = [
        dict(common, embedder="fixed-vde",
             **{k: v for k, v in base.items() if k != "answers"},
             answers_ok=True),
        dict(common, embedder="trained-pathgnn",
             **{k: v for k, v in tr.items() if k != "answers"},
             answers_ok=True, aggregation=aggregation,
             train_steps=state.step, train_s=train_s,
             step_ms=state.steps_s / max(state.step, 1) * 1e3,
             loss_first=state.history[0], loss_last=state.history[-1],
             candidate_reduction_pct=red),
    ]
    return Payoff(rows=rows, state=state, queries=qs, fixed=fixed,
                  trained=trained, engine=engine, train_paths=train_paths,
                  fixed_stats=fixed_stats, trained_stats=trained_stats)


def write_md(rows, path: str) -> None:
    """One table row per embedder row."""
    lines = [
        "# Trained-embedding payoff (PyTorch port)",
        "",
        "Produced by `python -m gnnpe_tpu_torch.frontends.train_payoff`;"
        " answers equal per query.",
        "",
        "| dataset | device | embedder | D | mean Σ\\|cands\\| | reduction "
        "| blocks | chunks | search p50 ms | refine p50 ms | online p50 ms |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        red = (f"-{r['candidate_reduction_pct']}%"
               if "candidate_reduction_pct" in r else "—")
        device = r["device"] + (f" ({r['mode']})" if "mode" in r else "")
        lines.append(
            f"| {r['dataset']} | {device} | {r['embedder']} | "
            f"{r['vde_dim']} | {r['cand_sum_mean']} | {red} | "
            f"{r['blocks_survived_mean']} | {r['chunks_mean']} | "
            f"{r['search_p50_ms']} | {r['refine_p50_ms']} | "
            f"{r['online_p50_ms']} |")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a PathGNN and serve it through PE or PGE "
                    "(port).")
    ap.add_argument("--dataset", default="yeast")
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--query-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--vde-dim", type=int, default=2)
    ap.add_argument("--l", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-answers", type=int, default=100_000)
    ap.add_argument("--variant", default="pge", choices=["pe", "pge"])
    ap.add_argument("--device", required=True,
                    help="torch device for training, VDE and the search "
                         "(e.g. cuda, cuda:0, cpu)")
    ap.add_argument("--force-streamed", action="store_true",
                    help="PE only: serve both embedders through the "
                         "streamed index (StreamedPESearch) even where the "
                         "table would fit on the device")
    ap.add_argument("--out", help="append the rows as JSON lines here")
    ap.add_argument("--md", help="write the rows as a Markdown table here")
    args = ap.parse_args(argv)
    rows = run(args.dataset, queries=args.queries,
               query_size=args.query_size, steps=args.steps,
               vde_dim=args.vde_dim, l=args.l, seed=args.seed,
               learning_rate=args.lr, max_answers=args.max_answers,
               variant=args.variant, device=args.device,
               force_streamed=args.force_streamed).rows
    for r in rows:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    if args.md:
        write_md(rows, args.md)


if __name__ == "__main__":
    main()
