"""Time the two gather-sum kernels (A1 ``ops.spmm.neighbor_sum``, A2
``ops.ell.BinnedEllDevice.apply_perm``) on the dblp-rung graph, on one
CUDA card, and compare two checkouts of the port in turns.

    python -m gnnpe_tpu_torch.kernels.compare_gather [--parent DIR] [--step]
    python -m gnnpe_tpu_torch.kernels.compare_gather --sweep

Without ``--parent`` the checkout this file lies in is measured twice.
With it, DIR (another checkout of the repository, for example an
unpacked ``git archive`` of an earlier commit) is measured in turns
with this one: parent, this, this, parent.  Each turn is a process of
its own (``--measure``, with ``PYTHONPATH`` naming the checkout), so
each builds its own kernels; the four shapes are A1 f64 D=2 and f32
D=128, A2 f32 D=2 and D=128.  Per shape a turn reports

  ``ms``        CUDA events round a loop of calls (host path included),
  ``device_ms`` the same calls replayed from a CUDA graph, which leaves
                the host out (L2 warm),
  ``cold_ms``   CUDA events round single calls with a 256 MB write
                between them, so the call finds L2 flushed,

and A1 on the graph's rows in degree-sorted order, A1 with the long-row
queue at several thresholds where the checkout has it, and A2's launches
per apply.  With ``--step`` a turn times the training step instead:
``frontends/train_payoff.run`` on dblp with 8 queries (300 binned
steps), its ``step_ms`` and ``train_s`` (host clock, the card
synchronised at both ends of the step loop) and its losses, after the
turn has built every kernel of its checkout (so no nvcc runs inside the
step loop; the libraries go to that checkout's ``build/``).  The summary
prints every turn and the ratio of the checkouts' means.

``--sweep`` measures what the wrappers' launch policy rests on
(``ops/spmm.py``: MIN_LANES, NARROW_LANES, LONG_ROWS; ``ops/ell.py``:
DEAL_BELOW_LANES): for both kernels over widths from 2 to 128 columns,
each lane shape (columns per lane, lanes per row) with the work dealt
round-robin over the blocks or not and, for A1 where it is dealt, the
long-row queue off or at 64; every variant is first held bit-equal to
the plain version.

All times are device times of this run's card, whose name and power
limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
LONG_ROWS = (-1, 16, 32, 64, 128)


def _events_ms(fn, iters):
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


def _graph_ms(fn, calls=20, replays=20):
    """Device time of one ``fn()``: ``calls`` of them captured in a CUDA
    graph, replayed ``replays`` times."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _events_ms(graph.replay, replays) / calls


def _cold_ms(fn, iters=20):
    """One ``fn()`` at a time, L2 flushed by a 256 MB write before it."""
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


def _times(fn, iters):
    return dict(ms=_events_ms(fn, iters), device_ms=_graph_ms(fn),
                cold_ms=_cold_ms(fn))


def _degree_sorted_rows(g):
    """The graph's CSR with its rows in descending-degree order (the
    neighbour ids, and so the gathered rows, unchanged)."""
    deg = np.diff(g.offsets).astype(np.int64)
    order = np.argsort(-deg, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(deg[order])])
    starts = np.repeat(g.offsets[order].astype(np.int64), deg[order])
    within = np.arange(offsets[-1]) - np.repeat(offsets[:-1], deg[order])
    return offsets.astype(np.int32), g.neighbors[starts + within]


def measure() -> dict:
    """The four shapes for the checkout on ``sys.path``."""
    import torch
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.io.datasets import load_dataset
    from gnnpe_tpu_torch.ops import ell, spmm
    from gnnpe_tpu_torch.ops.mt19937 import label_feature_table
    device = torch.device("cuda", torch.cuda.current_device())
    g = load_dataset("dblp", seed=0)
    off, nbr, labels, _ = to_device(g, device)
    rng = np.random.RandomState(0)
    out = {"package": str(pathlib.Path(spmm.__file__).resolve().parents[2])}

    table = torch.from_numpy(label_feature_table(g.labels_count, 2))
    xs = {"a1_f64_d2": table.to(device)[labels.long()],
          "a1_f32_d128": torch.from_numpy(rng.rand(
              g.num_vertices, 128).astype(np.float32)).to(device)}
    has_long = hasattr(spmm, "LONG_ROWS")
    s_off, s_nbr = (torch.from_numpy(a).to(device)
                    for a in _degree_sorted_rows(g))
    for name, x in xs.items():
        out[name] = _times(lambda: spmm.neighbor_sum(off, nbr, x), 200)
        out[name]["sorted_rows_device_ms"] = _graph_ms(
            lambda: spmm.neighbor_sum(s_off, s_nbr, x))
        if has_long:
            saved, out[name]["long_rows_device_ms"] = spmm.LONG_ROWS, {}
            for spmm.LONG_ROWS in LONG_ROWS:
                out[name]["long_rows_device_ms"][str(spmm.LONG_ROWS)] = \
                    _graph_ms(lambda: spmm.neighbor_sum(off, nbr, x))
            spmm.LONG_ROWS = saved

    lay = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors, device=device), device)
    for d in (2, 128):
        h = torch.from_numpy(rng.rand(g.num_vertices, d).astype(np.float32)
                             ).to(device)
        out[f"a2_f32_d{d}"] = _times(lambda: lay.apply_perm(h), 200)
    before = ell.LAUNCHES
    lay.apply_perm(h)
    out["a2_launches_per_apply"] = ell.LAUNCHES - before
    return out


def measure_step() -> dict:
    """The training step of ``train_payoff`` for the checkout on
    ``sys.path``, its kernels built first."""
    from gnnpe_tpu_torch.frontends.train_payoff import run
    from gnnpe_tpu_torch.kernels import _build
    csrc = pathlib.Path(_build.__file__).resolve().parents[1] / "csrc"
    for source in sorted(csrc.glob("*.cu")):
        _build.build(source.stem)
    row = run("dblp", queries=8, device="cuda").rows[-1]
    return {"package": str(csrc.parents[1]),
            "step": dict(step_ms=row["step_ms"], train_s=row["train_s"]),
            "loss_first": row["loss_first"], "loss_last": row["loss_last"]}


def _lane_shapes(pack_shape, d, elem_size):
    """The widest (vec, lanes) for a row and each halving of vec."""
    vec, lanes = pack_shape(d, elem_size, 0)
    shapes = [(vec, lanes)]
    while vec > 1 and lanes < 32:
        vec, lanes = vec // 2, lanes * 2
        shapes.append((vec, lanes))
    return shapes


def sweep() -> None:
    """Device µs of every launch variant, this checkout only."""
    import torch
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.io.datasets import load_dataset
    from gnnpe_tpu_torch.ops import ell, spmm
    device = torch.device("cuda", torch.cuda.current_device())
    g = load_dataset("dblp", seed=0)
    off, nbr, _, _ = to_device(g, device)
    rng = np.random.RandomState(0)
    deg = np.diff(g.offsets)
    print("rows with more than 32/64/128/256 neighbours:",
          [int((deg > t).sum()) for t in (32, 64, 128, 256)])
    widest = spmm.pack_shape
    for dtype in (np.float64, np.float32):
        for d in (2, 4, 8, 16, 32, 128):
            x = torch.from_numpy(rng.rand(g.num_vertices, d).astype(dtype)
                                 ).to(device)
            want = spmm.neighbor_sum_plain(off, nbr, x)
            for shape in _lane_shapes(widest, d, x.element_size())[:2]:
                spmm.pack_shape = lambda *a, s=shape, **k: s
                for narrow, queue in ((False, -1), (True, -1), (True, 64)):
                    spmm.NARROW_LANES = 32 if narrow else 0
                    spmm.LONG_ROWS = queue
                    assert torch.equal(spmm.neighbor_sum(off, nbr, x), want)
                    us = 1e3 * _graph_ms(
                        lambda: spmm.neighbor_sum(off, nbr, x))
                    print(f"A1 {dtype.__name__} d={d} (vec, lanes)={shape} "
                          f"dealt={narrow} queue={queue}: {us:.1f} us",
                          flush=True)
    lay = ell.BinnedEllDevice.from_host(
        ell.build_binned_ell(g.offsets, g.neighbors, device=device), device)
    widest = ell.pack_shape
    for d in (2, 4, 8, 16, 32, 64, 128):
        h = torch.from_numpy(rng.rand(g.num_vertices, d).astype(np.float32)
                             ).to(device)
        want = lay.apply_perm(h, gather=ell.gather_sum_plain)
        for shape in _lane_shapes(widest, d, 4):
            ell.pack_shape = lambda *a, s=shape, **k: s
            for dealt in (False, True):
                ell.DEAL_BELOW_LANES = 64 if dealt else 0
                lay.plan._descriptors.clear()
                assert torch.equal(lay.apply_perm(h), want)
                us = 1e3 * _graph_ms(lambda: lay.apply_perm(h))
                print(f"A2 d={d} (vec, lanes)={shape} dealt={dealt}: "
                      f"{us:.1f} us", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout to compare with")
    ap.add_argument("--measure", action="store_true",
                    help="measure the checkout on PYTHONPATH; print JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch variant of this checkout")
    ap.add_argument("--step", action="store_true",
                    help="time train_payoff's training step instead")
    args = ap.parse_args()
    if args.measure:
        print("MEASURED " + json.dumps(measure_step() if args.step
                                       else measure()))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if args.sweep:
        sys.path.insert(0, str(ROOT))
        sweep()
        return 0
    trees = [str(ROOT)] * 2
    if args.parent:
        parent = str(pathlib.Path(args.parent).resolve())
        trees = [parent, str(ROOT), str(ROOT), parent]
    turns = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run(
            [sys.executable, __file__, "--measure"]
            + (["--step"] if args.step else []),
            env=env, cwd=tree, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = [l for l in res.stdout.splitlines()
                if l.startswith("MEASURED ")][-1]
        turns.append(json.loads(line[len("MEASURED "):]))
        print(f"turn {len(turns)}: " + json.dumps(turns[-1]))
    if args.parent:
        keys = ("step_ms", "train_s") if args.step else (
            "ms", "device_ms", "cold_ms")
        shapes = [k for k, v in turns[0].items()
                  if isinstance(v, dict) and keys[0] in v]
        for shape in shapes:
            for key in keys:
                old = (turns[0][shape][key] + turns[3][shape][key]) / 2
                new = (turns[1][shape][key] + turns[2][shape][key]) / 2
                print(f"{shape} {key}: parent {old:.5f}, this {new:.5f}, "
                      f"this/parent {new / old:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
