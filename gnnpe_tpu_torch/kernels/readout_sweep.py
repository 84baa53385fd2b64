"""Time the trainer's readout backward (``ops/gather.py:GatherRows`` on
the segment-sum kernel, csrc/segment_sum.cu) over its tile shape, on one
CUDA card.

    python -m gnnpe_tpu_torch.kernels.readout_sweep [--dataset dblp]

The inputs are those of ``frontends/train_payoff.run`` at seed 0: the
dataset's 3-vertex paths, deduplicated and subsampled to 500,000, read
flat into the vertex rows (the path readout), and the vertex labels into
the label table (the label lookup); the cotangent is f32 D=2, the
trainer's width.  For every (``window``, ``threads``) of the grid, each
plan's backward is first held bit-equal to ``segment_sum_plain`` and to
itself over 3 calls, then timed: ``ms`` by CUDA events round a loop of
calls (host path included), ``device_ms`` replayed from a CUDA graph (the
card alone).  Beside them, once per gather, ``index_add_`` and torch's
own backward of ``x[idx]`` (``index_put_`` with ``accumulate=True``) by
events, and the earlier route of the same call, kernel A2's walk of the
transposed index as a uniform-width ELL (``build_ell(offsets, perm, 8,
8, num_sources=N)``), by events and on the card.  One JSON row per
point; the last line names the points with the least summed ``ms`` of
the two plans (what a step pays while it is bound by the host) and the
least summed ``device_ms``.  All times are device times of this run's
card, whose name and power limit are printed first.  The training step
of two checkouts in turns is ``kernels/compare_gather.py --parent DIR
--step``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

from gnnpe_tpu_torch.kernels.compare_gather import _events_ms, _graph_ms

WINDOWS = (4, 8, 16)
THREADS = (64, 128, 256, 512)


def readout_indices(dataset: str, seed: int = 0):
    """(label index, label rows, path index, vertex rows) of
    ``train_payoff.run``'s fit at ``seed`` (PGE, 3-vertex paths)."""
    from gnnpe_tpu_torch.frontends.train_payoff import sample_train_paths
    from gnnpe_tpu_torch.io.datasets import load_dataset
    g = load_dataset(dataset, seed=seed)
    paths = sample_train_paths(g, 3, seed)
    return g.labels, g.labels_count, paths.reshape(-1), g.num_vertices


def _earlier(plan, g):
    """``index_add_``, ``index_put_`` (accumulate) and the A2 walk of
    ``plan``'s transposed index, timed; the walk within rtol 1e-4 of the
    kernel."""
    import torch
    from gnnpe_tpu_torch.ops.ell import build_ell
    idx, shape = plan.idx, (plan.num_rows, g.shape[1])
    put = lambda: torch.zeros(shape, device=g.device).index_put_(
        (idx,), g, accumulate=True)
    add = lambda: torch.zeros(shape, device=g.device).index_add_(0, idx, g)
    walk = build_ell(plan.offsets.cpu().numpy().astype(np.int64),
                     plan.perm.cpu().numpy(), 8, 8,
                     num_sources=idx.numel()).on(g.device)
    if not torch.allclose(walk.apply(g), plan.backward(g), rtol=1e-4,
                          atol=1e-4):
        raise SystemExit(f"readout_sweep: {plan.name}: the A2 walk leaves "
                         "the kernel")
    return dict(index_put_accumulate_ms=_events_ms(put, 5),
                index_add_ms=_events_ms(add, 20),
                a2_walk_launches=walk.launches_per_apply,
                a2_walk_ms=_events_ms(lambda: walk.apply(g), 50),
                a2_walk_device_ms=_graph_ms(lambda: walk.apply(g)))


def sweep(dataset: str) -> None:
    import torch
    from gnnpe_tpu_torch.ops import gather
    from gnnpe_tpu_torch.ops.gather import GatherRows
    device = torch.device("cuda", torch.cuda.current_device())
    labels, num_labels, flat_paths, num_vertices = readout_indices(dataset)
    rng = np.random.RandomState(0)
    gathers = {"labels": (labels, num_labels),
               "paths": (flat_paths, num_vertices)}
    cot = {k: torch.from_numpy(rng.rand(len(i), 2).astype(np.float32)
                               ).to(device) for k, (i, _) in gathers.items()}
    for name, (idx, rows) in gathers.items():
        plan = GatherRows.build(idx, rows, device, name=name)
        print(json.dumps(dict(gather=name, entries=len(idx), rows=rows,
                              **_earlier(plan, cot[name]))))
    points = []
    for window in WINDOWS:
        for threads in THREADS:
            total = [0.0, 0.0]
            for name, (idx, rows) in gathers.items():
                plan = GatherRows.build(idx, rows, device, window, threads,
                                        name=name)
                g = cot[name]
                before = gather.LAUNCHES
                got = [plan.backward(g) for _ in range(3)]
                launches = gather.LAUNCHES - before
                if not all(torch.equal(got[0], o) for o in got[1:]):
                    raise SystemExit(f"readout_sweep: {name} at ({window}, "
                                     f"{threads}) differs between calls")
                if not torch.equal(got[0], plan.backward_plain(g)):
                    raise SystemExit(f"readout_sweep: {name} at ({window}, "
                                     f"{threads}) differs from "
                                     "segment_sum_plain")
                row = dict(gather=name, window=window, threads=threads,
                           launches=launches // 3,
                           tiles=plan.tile_rows.numel() - 1,
                           ms=_events_ms(lambda: plan.backward(g), 50),
                           device_ms=_graph_ms(lambda: plan.backward(g)))
                total[0] += row["ms"]
                total[1] += row["device_ms"]
                print(json.dumps(row))
                del plan
            points.append((window, threads, *total))
    by_ms, by_device = (min(points, key=lambda p: p[k]) for k in (2, 3))
    keys = ("window", "threads", "ms_both", "device_ms_both")
    print(json.dumps(dict(least_ms=dict(zip(keys, by_ms)),
                          least_device_ms=dict(zip(keys, by_device)))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="dblp")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("readout_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    sweep(args.dataset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
