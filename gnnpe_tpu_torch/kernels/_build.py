"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  The library is built at first use into
``build/gnnpe_tpu_torch/`` at the checkout root, named by a hash of its
source and of the headers beside it (``csrc/*.cuh``), so an edited
source rebuilds and an unchanged one is reused.
There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gnnpe_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}

_c = ctypes
# Every kernel entry point: (device, pointers..., sizes..., stream) -> int
_SIGNATURES = {
    # (device, offsets, neighbors, x, nx, vde, rows, d, vec, lanes,
    #  long_rows, deal, stream)
    "spmm_csr": {
        name: [_c.c_int] + [_c.c_void_p] * 5
        + [_c.c_longlong] + [_c.c_int] * 5 + [_c.c_void_p]
        for name in ("gnnpe_spmm_csr_f64", "gnnpe_spmm_csr_f32")},
    # (device, level, buf, out, d, vec, lanes, blocks, stream)
    "ell_gather_sum": {
        "gnnpe_ell_gather_sum_level_f32": [_c.c_int] + [_c.c_void_p] * 3
        + [_c.c_int] * 4 + [_c.c_void_p],
        "gnnpe_ell_max_tables": [], "gnnpe_ell_threads": []},
    # (device, plan, g, out, d, vec, stream); plan: a SegmentPlan struct
    "segment_sum": {
        name: [_c.c_int] + [_c.c_void_p] * 3 + [_c.c_int] * 2 + [_c.c_void_p]
        for name in ("gnnpe_segment_sum_f32", "gnnpe_segment_sum_f64")},
    # scatter: (device, mask, gate, vids, out_ids, words, hit_columns, cols,
    #  rows, block_size, k, width, num_out, num_vertices, row_words, stream);
    # offsets: (device, words, rows, row_words, seg_words, counts,
    #  seg_offsets, offsets, stream); write: (device, words, rows,
    #  row_words, seg_words, seg_offsets, ids, stream)
    "union_bitmap": {
        "gnnpe_union_scatter": [_c.c_int] + [_c.c_void_p] * 6
        + [_c.c_longlong, _c.c_int, _c.c_longlong, _c.c_longlong]
        + [_c.c_int] * 3 + [_c.c_longlong, _c.c_void_p],
        "gnnpe_union_offsets": [_c.c_int, _c.c_void_p]
        + [_c.c_longlong] * 3 + [_c.c_void_p] * 4,
        "gnnpe_union_write": [_c.c_int, _c.c_void_p]
        + [_c.c_longlong] * 3 + [_c.c_void_p] * 3},
    # (device, vids, blocks, gate, labels, degrees, vde, q_labels,
    #  q_degrees, q_thresh, out_ids, words, hit_rows, num_blocks,
    #  table_blocks, block_size, rows, width, dim, num_out, num_vertices,
    #  row_words, stream)
    "leaf_scatter": {
        "gnnpe_leaf_scatter": [_c.c_int] + [_c.c_void_p] * 12
        + [_c.c_longlong] * 2 + [_c.c_int] * 6 + [_c.c_longlong, _c.c_void_p]},
    # count: (device, ub, llo, lhi, deg, thresh, label, q_degrees, runs,
    #  bits, counts, offsets, counters, num_blocks, rows, width, dim,
    #  stream); write: (device, bits, offsets, num_blocks, rows, sel, gate,
    #  stream)
    "block_filter": {
        "gnnpe_block_filter_count": [_c.c_int] + [_c.c_void_p] * 12
        + [_c.c_longlong] + [_c.c_int] * 3 + [_c.c_void_p],
        "gnnpe_block_filter_write": [_c.c_int, _c.c_void_p, _c.c_void_p,
                                     _c.c_longlong, _c.c_int, _c.c_void_p,
                                     _c.c_void_p, _c.c_void_p],
        "gnnpe_block_filter_threads": []},
}


def pack_shape(d: int, elem_size: int, *pointers: int, min_lanes: int = 1):
    """(vec, lanes) of a gather-sum launch over rows of ``d`` elements
    of ``elem_size`` bytes (csrc/gather_rows.cuh): a lane owns ``vec``
    columns — as many as fit 16 bytes, divide ``d`` and keep every
    pointer aligned to the lane's load — and a row takes ``lanes`` lanes,
    the power of two that covers its ``d / vec`` loads, at most 32
    (wider rows loop over column tiles).  ``min_lanes`` halves ``vec``
    while a row would get fewer lanes than that."""
    vec = max(1, 16 // elem_size)
    while vec > 1 and (d % vec or d < vec * min_lanes
                       or any(p % (vec * elem_size) for p in pointers)):
        vec //= 2
    lanes = 1
    while lanes < 32 and lanes * vec < d:
        lanes *= 2
    return vec, lanes


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> pathlib.Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    for header in sorted(_CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists;
    nvcc's resource report (-Xptxas -v) is kept beside it as ``.log``."""
    so = _library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` with its entry points'
    argument types set (c_void_p for every pointer and the stream)."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]
