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

    @staticmethod
    def read_all_paths(path: str) -> np.ndarray:
        tok = open(path).read().split()
        n = int(tok[0])
        arr = np.array(tok[1:], dtype=np.int64)
        return arr.reshape(n, -1) if n else arr.reshape(0, 0)

    @staticmethod
    def write_partition_paths(path: str, rows: np.ndarray) -> None:
        """partition_paths.txt: count then one path id per line
        (GNN-PE/src/main.cpp:98-108)."""
        with open(path, "w") as f:
            f.write(f"{len(rows)}\n")
            for r in rows:
                f.write(f"{r}\n")

    @staticmethod
    def write_data_vertices_bin(path: str, vde_dim: int, pde_dim: int,
                                labels, degrees, keys, x, nx, vde,
                                group, label_group) -> None:
        """GNN-PGE data_vertices.bin record layout
        (GNN-PGE/src/main.cpp:179-194): per vertex
        vid,label,degree (u32) key (f64) x,nx,vde (f64[vde_dim])
        path_group,path_label_group (f64[2*pde_dim] interleaved lo,hi)."""
        v = len(labels)
        with open(path, "wb") as f:
            f.write(np.uint32(v).tobytes())
            for i in range(v):
                f.write(np.array([i, labels[i], degrees[i]],
                                 dtype=np.uint32).tobytes())
                f.write(np.float64(keys[i]).tobytes())
                f.write(np.asarray(x[i], dtype=np.float64).tobytes())
                f.write(np.asarray(nx[i], dtype=np.float64).tobytes())
                f.write(np.asarray(vde[i], dtype=np.float64).tobytes())
                inter = np.empty(2 * pde_dim)
                inter[0::2], inter[1::2] = group[i, 0], group[i, 1]
                f.write(inter.tobytes())
                inter[0::2], inter[1::2] = (label_group[i, 0],
                                            label_group[i, 1])
                f.write(inter.tobytes())

    @staticmethod
    def read_data_vertices_bin(path: str, vde_dim: int, pde_dim: int):
        """Inverse of write_data_vertices_bin; returns dict of arrays."""
        raw = open(path, "rb").read()
        v = int(np.frombuffer(raw[:4], dtype=np.uint32)[0])
        rec = 12 + 8 + vde_dim * 8 * 3 + pde_dim * 2 * 8 * 2
        out = dict(labels=np.zeros(v, np.int32),
                   degrees=np.zeros(v, np.int32),
                   keys=np.zeros(v),
                   x=np.zeros((v, vde_dim)), nx=np.zeros((v, vde_dim)),
                   vde=np.zeros((v, vde_dim)),
                   group=np.zeros((v, 2, pde_dim)),
                   label_group=np.zeros((v, 2, pde_dim)))
        off = 4
        for _ in range(v):
            b = raw[off:off + rec]
            off += rec
            vid, label, degree = np.frombuffer(b[:12], dtype=np.uint32)
            vals = np.frombuffer(b[12:], dtype=np.float64)
            out["labels"][vid] = label
            out["degrees"][vid] = degree
            out["keys"][vid] = vals[0]
            d = vde_dim
            out["x"][vid] = vals[1:1 + d]
            out["nx"][vid] = vals[1 + d:1 + 2 * d]
            out["vde"][vid] = vals[1 + 2 * d:1 + 3 * d]
            pg = vals[1 + 3 * d:1 + 3 * d + 2 * pde_dim]
            out["group"][vid, 0], out["group"][vid, 1] = pg[0::2], pg[1::2]
            plg = vals[1 + 3 * d + 2 * pde_dim:]
            out["label_group"][vid, 0] = plg[0::2]
            out["label_group"][vid, 1] = plg[1::2]
        return out
