"""Kernel A1 (``ops.spmm.neighbor_sum``, csrc/spmm_csr.cu) at a ladder
rung's full size, on one CUDA card: the data-graph VDE's sum, f64 D=2,
over the rung's CSR (synth100m: 20,000,000 rows, 200,000,000 arcs).

    python -m gnnpe_tpu_torch.kernels.vde_scale [--dataset synth100m]

The kernel's ``with_vde`` call (the one ``embed.vde.gen_vde`` makes) is
held bit-equal to ``neighbor_sum_plain`` and timed in turns with it
(plain, kernel, kernel, plain, by CUDA events round each call, host path
included), beside ``torch.sparse.mm`` of the same CSR adjacency (the
library call; the port never makes it), the kernel alone on the card
(calls replayed from a CUDA graph) and with L2 flushed.  The bound is the
larger of the bytes that must move (offsets and neighbours read once, x
read once, nx and vde written once) over 3.35 TB/s and one add per arc
and column, and one per row and column for vde, over 67 TFLOP/s.  The
card's name and power limit come first; the last line is the row as one
JSON object, with the kernel's launches in the timed run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from gnnpe_tpu_torch.kernels.compare_gather import (_cold_ms, _events_ms,
                                                     _graph_ms)

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12


def measure(name: str, seed: int = 0) -> dict:
    """The rung's A1 row (see the module's docstring)."""
    import torch
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.io.datasets import load_dataset
    from gnnpe_tpu_torch.ops import spmm
    from gnnpe_tpu_torch.ops.mt19937 import label_feature_table
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    g = load_dataset(name, seed=seed)
    gen_s = time.perf_counter() - t0
    off, nbr, labels, _ = to_device(g, device)
    x = torch.from_numpy(label_feature_table(g.labels_count, 2)).to(
        device)[labels.long()]
    v, arcs, d = g.num_vertices, int(nbr.numel()), 2
    kernel = lambda: spmm.neighbor_sum(off, nbr, x, with_vde=True)
    plain = lambda: spmm.neighbor_sum_plain(off, nbr, x)
    spmm.LAUNCHES = 0
    nx, vde = kernel()
    launches = spmm.LAUNCHES
    want = plain()
    err = float((nx - want).abs().max())
    if not (torch.equal(nx, want) and torch.equal(vde, x + want)):
        raise AssertionError(f"A1 at {name} differs from its plain version "
                             f"(max abs err {err})")
    adj = torch.sparse_csr_tensor(
        off, nbr, torch.ones(arcs, dtype=x.dtype, device=device),
        size=(v, v))
    library = lambda: torch.sparse.mm(adj, x)
    if not torch.allclose(library(), want, rtol=1e-12):
        raise AssertionError("torch.sparse.mm differs from the plain version")
    turns = [_events_ms(plain, 3), _events_ms(kernel, 20),
             _events_ms(kernel, 20), _events_ms(plain, 3)]
    by_bytes = (4 * (v + 1) + 4 * arcs + 3 * v * d * 8) / PEAK_BYTES_S * 1e3
    by_ops = (arcs * d + v * d) / PEAK_FLOP_S * 1e3
    row = dict(rung=name, v=v, arcs=arcs, gen_s=gen_s, launches=launches,
               max_abs_err=err, ms=(turns[1] + turns[2]) / 2,
               plain_ms=(turns[0] + turns[3]) / 2, turns_ms=turns,
               library_ms=_events_ms(library, 5), device_ms=_graph_ms(kernel),
               cold_ms=_cold_ms(kernel, 5), bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="synth100m")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(json.dumps(measure(args.dataset, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
