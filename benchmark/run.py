"""Run one cell of the benchmark once, on the machine it is started on:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit, which also close standard error).  Exits
without a result: 2 without the CUDA devices the cell asks for, 3 where
a module of JAX or of the JAX package is loaded at the end, 4 where the
harness cannot read what the program's timed path made.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "gnnpe_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, the names compared whole (``gnnpe_tpu_torch`` passes)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    # The program's nvcc and g++ builds go to build/gnnpe_tpu_torch/ in
    # the checkout; it uses neither Triton nor torch.utils.cpp_extension.
    from benchmark import harness, spec
    from benchmark.engines import Unreadable
    cell = spec.cell(ROOT, args.workload)
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             device="cuda", t_start=T_START)
    except harness.NoDevice as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    except Unreadable as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
