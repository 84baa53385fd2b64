"""ctypes bindings for the native refinement engine.

Builds refine.cpp into a shared library at first use, into
``build/gnnpe_tpu_torch/`` at the checkout root (never into a package
directory), named by a hash of the source, then exposes
:func:`explore_native`.  The boundary is a plain C ABI over borrowed
numpy buffers.  A failed build raises.
"""

# The port's own copy of gnnpe_tpu/match/native/; refine.cpp adds the
# search tree's counters (``out_stats``) to the copy and walks label runs
# where the copy reads whole rows.

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from gnnpe_tpu_torch.kernels._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "refine.cpp")
_LOCK = threading.Lock()
_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = str(BUILD_DIR / f"libgnnpe_refine_{digest}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                   "-fPIC", _SRC, "-o", tmp]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed for refine.cpp:\n"
                                   f"{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.gnnpe_refine.restype = ctypes.c_uint64
        lib.gnnpe_refine.argtypes = [
            i32p, i32p, ctypes.c_int32,              # data CSR
            i32p, i32p, ctypes.c_int32,              # its label runs
            i32p, i32p, i32p, ctypes.c_int32,        # query CSR
            i32p, i32p,                              # order, pivot
            i32p, i32p,                              # bn
            i32p, i64p,                              # candidates
            ctypes.c_uint64,                         # max_answers
            ctypes.c_void_p, ctypes.c_int64,         # out_embeddings
            ctypes.POINTER(ctypes.c_int64),          # out_emitted
            u64p,                                    # out_stats
        ]
        _LIB = lib
        return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def explore_native(data_graph, query_graph, candidates: List[np.ndarray],
                   order: np.ndarray, pivot: np.ndarray,
                   bn: List[np.ndarray], max_answers: int,
                   max_emit: int = 0,
                   stage: Callable = contextlib.nullcontext,
                   stats: Optional[dict] = None
                   ) -> Union[int, Tuple[int, np.ndarray]]:
    """Run the C++ explorer.  With max_emit > 0, also returns up to that
    many embeddings (int32[n, |Vq|], query-vertex-id indexed).
    ``stage(name)`` opens a timed span (``StageTimer.stage``) around
    ``refine.prepare``, the explorer's int32 arrays, and
    ``refine.explore``, the native call.  The explorer walks each
    pivot's label run (``data_graph.label_adjacency()``, borrowed, built
    on first use where the engine has not built it).  ``stats``, where
    given, gets the search tree's ``explore_nodes`` (the partial maps
    formed, the complete ones included), ``explore_scans`` (the entries
    read to extend them: the first vertex's candidates and each pivot's
    label run) and ``explore_row_arcs`` (the first vertex's candidates
    and each pivot's whole row length)."""
    lib = _load()
    nq = query_graph.num_vertices
    with stage("refine.prepare"):
        bn_off = np.zeros(nq + 1, dtype=np.int32)
        for i, b in enumerate(bn):
            bn_off[i + 1] = bn_off[i] + len(b)
        bn_flat = (np.concatenate([_i32(b) for b in bn])
                   if bn_off[-1] else np.zeros(0, dtype=np.int32))
        cand_off = np.zeros(nq + 1, dtype=np.int64)
        for i, c in enumerate(candidates):
            cand_off[i + 1] = cand_off[i] + len(c)
        cand_flat = (np.concatenate([_i32(c) for c in candidates])
                     if cand_off[-1] else np.zeros(0, dtype=np.int32))
        data = (_i32(data_graph.offsets), _i32(data_graph.neighbors),
                data_graph.num_vertices,
                *map(_i32, data_graph.label_adjacency()),
                data_graph.labels_count)
        query = (_i32(query_graph.offsets), _i32(query_graph.neighbors),
                 _i32(query_graph.labels))
        plan = (_i32(order), _i32(pivot))
        out_emb = (np.zeros((max_emit, nq), dtype=np.int32)
                   if max_emit > 0 else None)
        counters = np.zeros(3, dtype=np.uint64)
    emitted = ctypes.c_int64(0)
    with stage("refine.explore"):
        count = lib.gnnpe_refine(
            *data, *query, nq, *plan,
            bn_flat, bn_off, cand_flat, cand_off,
            ctypes.c_uint64(max_answers),
            out_emb.ctypes.data_as(ctypes.c_void_p) if out_emb is not None
            else None,
            ctypes.c_int64(max_emit), ctypes.byref(emitted), counters)
    if stats is not None:
        stats["explore_nodes"] = int(counters[0])
        stats["explore_scans"] = int(counters[1])
        stats["explore_row_arcs"] = int(counters[2])
    if max_emit > 0:
        return int(count), out_emb[:emitted.value]
    return int(count)
