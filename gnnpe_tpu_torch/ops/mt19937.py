"""Bit-exact reproduction of the reference's label-seeded feature init.

The reference seeds a ``std::mt19937`` with the vertex *label*, draws
``vde_dim`` doubles from ``uniform_real_distribution<double>(0,1)``, and
normalizes them to sum 1 (GNN-PE/include/custom.h:492-511).  Exactness
here matters: every dominance comparison downstream keys off these values
(SURVEY.md §7.3 "hard parts").

Two implementation facts make parity achievable without C++:

  1. ``numpy.random.RandomState(seed)`` with an integer seed uses the
     canonical Knuth mt19937 initialization — identical state to
     ``std::mt19937(seed)`` — and ``randint(0, 2**32, dtype=uint64)``-style
     full-range draws consume exactly one 32-bit output each.
  2. libstdc++'s ``uniform_real_distribution<double>(0,1)`` is
     ``generate_canonical<double, 53>``: it takes **two** 32-bit draws
     g1, g2 and returns ``(g1 + g2·2^32) / 2^64`` evaluated in double
     arithmetic (clamped below 1.0).

We verify against fixtures dumped from a compiled probe of the reference
construction (tests/golden/vde_x_golden.txt).
"""

# The port's own copy of gnnpe_tpu/ops/mt19937.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

import functools

import numpy as np

_TWO32 = float(2 ** 32)
_TWO64 = float(2 ** 64)
_BELOW_ONE = np.nextafter(1.0, 0.0)


@functools.lru_cache(maxsize=65536)
def _raw_uniforms(seed: int, count: int) -> tuple:
    """``count`` doubles from libstdc++ uniform_real(0,1) on mt19937(seed)."""
    rs = np.random.RandomState(seed)
    raw = rs.randint(0, 2 ** 32, size=2 * count, dtype=np.uint64)
    g1 = raw[0::2].astype(np.float64)
    g2 = raw[1::2].astype(np.float64)
    vals = (g1 + g2 * _TWO32) / _TWO64
    np.minimum(vals, _BELOW_ONE, out=vals)
    return tuple(vals)


def label_seeded_x(label: int, dim: int) -> np.ndarray:
    """x-vector for one label: dim uniforms normalized to sum 1
    (custom.h:492-511).  All entries are positive — the property the
    dominance argument rests on (SURVEY.md §0.1)."""
    vals = np.array(_raw_uniforms(int(label), dim), dtype=np.float64)
    # Left-to-right fold, matching std::accumulate(begin, end, 0.0)
    # (custom.h:504) — numpy's pairwise sum() differs by 1 ulp at dim≥8.
    total = 0.0
    for v in vals:
        total += v
    return vals / total


def label_feature_table(labels_count: int, dim: int) -> np.ndarray:
    """float64[L, dim] features for labels 0..L-1.  Same-label vertices
    share identical x by construction, so one row per label suffices and
    per-vertex features are a gather."""
    table = np.empty((labels_count, dim), dtype=np.float64)
    for l in range(labels_count):
        table[l] = label_seeded_x(l, dim)
    return table
