"""Staged artifact store: checkpoint/resume for the offline pipeline.

The reference checkpoints by stage through loose files whose existence
is probed to skip rebuilds (membership.txt, all_paths.txt,
partition_paths.txt, data_vertices.bin, index.dat — SURVEY.md §5).
Here each stage's arrays live in one .npz keyed by a config fingerprint,
so a stale artifact from a different (l, e, p, dataset) can never be
resumed by accident — the reference *would* silently reuse an
``index.dat`` built with different flags (custom.h:218-234).

Also provides readers/writers for the reference's wire formats so the
two systems interoperate on the same dataset directories.
"""

# The port's own copy of gnnpe_tpu/io/artifacts.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np

from gnnpe_tpu_torch.config import Config


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------
    def fingerprint(self, config: Config, dataset: str,
                    extra: Optional[Dict] = None) -> str:
        """Stable hash of everything that invalidates derived arrays."""
        payload = {
            "variant": getattr(config, "variant", "?"),
            "vde_dim": config.vde_dim,
            "path_length": config.path_length,
            "partition_num": config.partition_num,
            "dataset": os.path.abspath(dataset),
            "dataset_mtime": (os.path.getmtime(dataset)
                              if os.path.exists(dataset) else 0),
        }
        if extra:
            payload.update(extra)
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def _path(self, stage: str, fp: str) -> str:
        return os.path.join(self.root, f"{stage}-{fp}.npz")

    def save(self, stage: str, fp: str, **arrays) -> str:
        path = self._path(stage, fp)
        tmp = path + ".tmp"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                   path)
        return path

    def load(self, stage: str, fp: str) -> Optional[Dict[str, np.ndarray]]:
        path = self._path(stage, fp)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def has(self, stage: str, fp: str) -> bool:
        return os.path.exists(self._path(stage, fp))

    # ------------------------------------------------------------------
    # Reference wire formats (read AND write, for interop).
    # ------------------------------------------------------------------
    @staticmethod
    def write_all_paths(path: str, paths: np.ndarray) -> None:
        """all_paths.txt: count line then space-separated vertex rows
        (GNN-PE/src/main.cpp:110-119)."""
        with open(path, "w") as f:
            f.write(f"{paths.shape[0]}\n")
            for row in paths:
                f.write(" ".join(map(str, row)) + " \n")
