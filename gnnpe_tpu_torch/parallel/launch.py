"""Start the ranks of one multi-process run on this machine.

``run_ranks(n, "package.module:function", ..., group_device=)`` starts ``n`` Python
processes, one per rank, which rendezvous through a ``file://`` store
(no port to collide on), join the default process group, call
``function(rank, world, **kwargs)`` and leave.  The caller gets every
rank's output; a rank that fails or outlives ``timeout_s`` ends the run:
all ranks are killed and ``RuntimeError`` is raised with their output.
Several hosts are ``torchrun``'s job (it sets ``RANK`` and the rest,
which ``parallel.mesh.maybe_distributed_init`` reads); this is the
one-machine launcher the dry run, the tests and the smoke script share.

A rank runs with one torch thread, so that n ranks on a small machine
do not fight over its cores, and refuses to finish if ``jax`` or a
``gnnpe_tpu`` module was imported on its way.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional


def run_ranks(n: int, target: str, kwargs: Optional[dict] = None, *,
              group_device: str, timeout_s: float = 300.0,
              store_dir: Optional[str] = None) -> List[str]:
    """Run ``target`` ("module:function") on ``n`` ranks; returns their
    standard outputs in rank order.  ``group_device`` names the process
    group's device type and so its backend (gloo for "cpu", NCCL for
    "cuda"; required); ``kwargs`` must be JSON-serialisable."""
    own = None
    if store_dir is None:
        own = tempfile.TemporaryDirectory(prefix="gnnpe_ranks_")
        store_dir = own.name
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    # Every rank is on this machine: gloo talks over the loopback
    # interface, whatever the host's name resolves to.
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    try:
        for r in range(n):
            log = open(os.path.join(store_dir, f"rank{r}_{os.getpid()}.log"),
                       "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gnnpe_tpu_torch.parallel.launch",
                 target, str(r), str(n), "file://" + store, group_device,
                 str(timeout_s), json.dumps(kwargs or {})],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout_s
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"no end after {timeout_s} s"
            elif any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
            else:
                time.sleep(0.05)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = "a rank failed"
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
        if failed:
            raise RuntimeError(f"{target} on {n} ranks: {failed}\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode}) ---\n{o[-4000:]}"
                for r, (p, o) in enumerate(zip(procs, outs))))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
        if own is not None:
            own.cleanup()


def _rank_main(argv) -> None:
    target, rank, world, init_method, group_device, timeout_s, kwargs = argv
    import torch
    from gnnpe_tpu_torch.parallel.mesh import maybe_distributed_init
    torch.set_num_threads(1)
    maybe_distributed_init(group_device, init_method=init_method,
                           rank=int(rank), world_size=int(world),
                           timeout_s=float(timeout_s))
    module, fn = target.split(":")
    getattr(importlib.import_module(module), fn)(
        int(rank), int(world), **json.loads(kwargs))
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "gnnpe_tpu"))
    if foreign:
        raise RuntimeError(f"rank {rank} imported {foreign}")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
