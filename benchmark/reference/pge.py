"""Plain reference of GNN-PGE's candidates (Ye et al., VLDB 2024; its
code's GNN-PGE/include/custom.h and src/main.cpp), for paths of 2
vertices (GNN-PGE's default ``-l 2``).  NumPy only; nothing of the
program is imported.

Semantics:
  * every directed path of two vertices that starts at v is (v, w), one
    for each neighbour w of v;
  * v's group is the per-dimension [min, max] over those paths of
    concat(vde(v), vde(w)), its label group the same over the label
    features x; a vertex with no path gets the degenerate box
    [concat(vde(v), 0...)] at both ends (x alike; main.cpp:105-122);
  * a query's boxes are built the same way over the query's own graph
    and VDE, and each query vertex is one row of the query table;
  * v is a candidate of the query vertex u exactly where label(v) =
    label(u), degree(v) >= degree(u), the label boxes overlap in every
    dimension, and every entry g of v's group's upper end satisfies
    g >= q - max(eps, eps * |q|), q the entry of u's group's lower end
    (``reference.pe.threshold``).

Departures from GNN-PGE's code, each leaving its answers as they are:
  * the filter is the effective one: custom.h:337-345 holds a loop of
    VDE compares that never runs (its counter starts at vde_dim), so it
    is left out;
  * the group compare has the relative slack of ``threshold`` where
    GNN-PGE's is strict (custom.h:357-363): a true match whose two VDE
    sums differ by rounding fails a strict compare, and the slack only
    keeps more candidates, so the count, which refinement decides, is
    VF2's either way;
  * the groups are folded over each vertex's CSR row (``reduceat``), and
    no path is enumerated; the index, its R-tree and its blocks are not
    built: every vertex of the graph is tested;
  * a query vertex with no path is not served (GNN-PGE reads memory it
    never set there, main.cpp:284-330): ``query_table`` raises.
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.reference.graph import label_table
from benchmark.reference.graph import vde as vertex_embedding
from benchmark.reference.pe import _csr, threshold


def groups(offsets: np.ndarray, neighbors: np.ndarray,
           table: np.ndarray) -> np.ndarray:
    """[V, 2, 2 * dim]: each vertex's box over its paths (v, w) of the
    rows of ``table`` (the VDE, or the label features), lower end first;
    the degenerate box where v has no neighbour."""
    n, dim = table.shape
    out = np.zeros((n, 2, 2 * dim), table.dtype)
    out[:, :, :dim] = table[:, None, :]
    has = np.diff(offsets) > 0
    if has.any():
        rows = table[neighbors]
        starts = offsets[:-1][has]
        out[has, 0, dim:] = np.minimum.reduceat(rows, starts, axis=0)
        out[has, 1, dim:] = np.maximum.reduceat(rows, starts, axis=0)
    return out


class Data:
    """The data graph as the reference holds it: degrees, VDE, label
    features and both boxes of every vertex, in ``dtype``."""

    def __init__(self, offsets, neighbors, labels, dim: int,
                 dtype=np.float64):
        self.offsets, self.neighbors = offsets, neighbors
        self.labels = labels
        self.degrees = np.diff(offsets)
        self.vde = vertex_embedding(offsets, neighbors, labels, dim, dtype)
        x = label_table(int(labels.max(initial=-1)) + 1, dim).astype(dtype)
        self.group = groups(offsets, neighbors, self.vde)
        self.label_group = groups(offsets, neighbors, x[labels])
        order = np.argsort(labels, kind="stable")
        bounds = np.searchsorted(labels[order], np.arange(labels.max() + 2))
        self.by_label = [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def query_table(q_edges: np.ndarray, q_labels: np.ndarray, dim: int,
                length: int, dtype=np.float64) -> dict:
    """One row per query vertex: ``vids`` int[n, 1] (0..n-1), ``labels``,
    ``degrees``, ``group`` and ``label_group`` [n, 2, 2 * dim], and
    ``pde``, the four box ends side by side (group lower, group upper,
    label group lower, label group upper) [n, 8 * dim]."""
    if length != 2:
        raise ValueError(f"paths of {length} vertices: the reference "
                         "covers 2")
    n = len(q_labels)
    offsets, neighbors = _csr(n, q_edges)
    degrees = np.diff(offsets)
    if n and not degrees.all():
        raise ValueError("a query vertex with no path")
    q_vde = vertex_embedding(offsets, neighbors, q_labels, dim, dtype)
    x = label_table(int(q_labels.max(initial=-1)) + 1, dim).astype(dtype)
    group = groups(offsets, neighbors, q_vde)
    label_group = groups(offsets, neighbors, x[q_labels])
    pde = np.concatenate([group[:, 0], group[:, 1], label_group[:, 0],
                          label_group[:, 1]], 1)
    return dict(vids=np.arange(n, dtype=np.int64)[:, None],
                labels=np.asarray(q_labels), degrees=degrees, group=group,
                label_group=label_group, pde=pde, n=n)


def candidates(data: Data, table: dict, eps: float) -> List[np.ndarray]:
    """Sorted candidate ids of every query vertex."""
    out = []
    for u in range(table["n"]):
        label = int(table["labels"][u])
        if not 0 <= label < len(data.by_label):
            out.append(np.zeros(0, np.int64))
            continue
        ids = data.by_label[label]
        lo, hi = table["label_group"][u]
        thr = threshold(table["group"][u, 0], eps).astype(data.group.dtype)
        keep = ((data.degrees[ids] >= table["degrees"][u])
                & (data.label_group[ids, 1] >= lo).all(1)
                & (data.label_group[ids, 0] <= hi).all(1)
                & (data.group[ids, 1] >= thr).all(1))
        out.append(np.sort(ids[keep]).astype(np.int64))
    return out
