"""Time the trainer's readout backward (``ops/gather.py:GatherRows`` on
kernel A2) over the layout's two widths, on one CUDA card.

    python -m gnnpe_tpu_torch.kernels.readout_sweep [--dataset dblp]

The inputs are those of ``frontends/train_payoff.run`` at seed 0: the
dataset's 3-vertex paths, deduplicated and subsampled to 500,000, read
flat into the vertex rows (the path readout), and the vertex labels into
the label table (the label lookup); the cotangent is f32 D=2, the
trainer's width.  For every (``width``, ``level2_width``) of the grid,
each plan's backward is first held bit-equal to its masked plain form,
then timed: ``ms`` by CUDA events round a loop of calls (host path
included), ``device_ms`` replayed from a CUDA graph (the card alone).
Beside them, once per gather, torch's own backward of ``x[idx]``
(``index_put_`` with ``accumulate=True``) and ``index_add_``, by
events.  One JSON row per point; the last line names the points with
the least summed ``ms`` of the two plans (what a step pays while its
launches are bound by the host) and the least summed ``device_ms``.
All times are device times of this run's card, whose name and power
limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

from gnnpe_tpu_torch.kernels.compare_gather import _events_ms, _graph_ms

WIDTHS = (4, 8, 16, 32)
LEVEL2_WIDTHS = (2, 4, 8, 16)


def readout_indices(dataset: str, seed: int = 0):
    """(label index, label rows, path index, vertex rows) of
    ``train_payoff.run``'s fit at ``seed`` (PGE, 3-vertex paths)."""
    from gnnpe_tpu_torch.frontends.train_payoff import sample_train_paths
    from gnnpe_tpu_torch.io.datasets import load_dataset
    g = load_dataset(dataset, seed=seed)
    paths = sample_train_paths(g, 3, seed)
    return g.labels, g.labels_count, paths.reshape(-1), g.num_vertices


def _library(idx, rows, g):
    """Torch's backward of ``x[idx]`` and ``index_add_``, timed."""
    import torch
    shape = (rows, g.shape[1])
    put = lambda: torch.zeros(shape, device=g.device).index_put_(
        (idx,), g, accumulate=True)
    add = lambda: torch.zeros(shape, device=g.device).index_add_(0, idx, g)
    return dict(index_put_accumulate_ms=_events_ms(put, 5),
                index_add_ms=_events_ms(add, 20))


def sweep(dataset: str) -> None:
    import torch
    from gnnpe_tpu_torch.ops import ell
    from gnnpe_tpu_torch.ops.gather import GatherRows
    device = torch.device("cuda", torch.cuda.current_device())
    labels, num_labels, flat_paths, num_vertices = readout_indices(dataset)
    rng = np.random.RandomState(0)
    gathers = {"labels": (labels, num_labels),
               "paths": (flat_paths, num_vertices)}
    cot = {k: torch.from_numpy(rng.rand(len(i), 2).astype(np.float32)
                               ).to(device) for k, (i, _) in gathers.items()}
    for name, (idx, rows) in gathers.items():
        lib = _library(torch.from_numpy(idx.astype(np.int64)).to(device),
                       rows, cot[name])
        print(json.dumps(dict(gather=name, entries=len(idx), rows=rows,
                              **lib)))
    points = []
    for width in WIDTHS:
        for level2 in LEVEL2_WIDTHS:
            total = [0.0, 0.0]
            for name, (idx, rows) in gathers.items():
                plan = GatherRows.build(idx, rows, device, width, level2)
                g = cot[name]
                before = ell.LAUNCHES
                got = plan.backward(g)
                launches = ell.LAUNCHES - before
                if not torch.equal(got, plan.backward_plain(g)):
                    raise SystemExit(f"readout_sweep: {name} at ({width}, "
                                     f"{level2}) differs from its plain "
                                     "form")
                row = dict(gather=name, width=width, level2_width=level2,
                           launches=launches,
                           levels=[list(t.shape) for t in plan.back.tables],
                           slots=int(sum(t.numel()
                                         for t in plan.back.tables)),
                           ms=_events_ms(lambda: plan.backward(g), 50),
                           device_ms=_graph_ms(lambda: plan.backward(g)))
                total[0] += row["ms"]
                total[1] += row["device_ms"]
                print(json.dumps(row))
                del plan
            points.append((width, level2, *total))
    by_ms, by_device = (min(points, key=lambda p: p[k]) for k in (2, 3))
    print(json.dumps(dict(least_ms=dict(zip(
        ("width", "level2_width", "ms_both", "device_ms_both"), by_ms)),
        least_device_ms=dict(zip(
            ("width", "level2_width", "ms_both", "device_ms_both"),
            by_device)))))


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
