"""CSR graph core.

Array-first re-design of the reference ``Static_Graph``
(GNN-PE/include/graph/graph.h:51-239, libsrc/graph/graph.cpp:163-242):
the graph is a bundle of flat numpy arrays that map 1:1 onto device
buffers, instead of a pointer-rich C++ object.

Semantics preserved from the reference loader:
  * ``.graph`` text format: header ``t |V| |E|``, vertex lines
    ``v id label degree``, edge lines ``e u v`` (graph.cpp:163-242).
  * adjacency sorted ascending per row (graph.cpp:231-233) — this fixes
    path-enumeration order and enables binary-search edge checks
    (graph.h:215-236 → here vectorized ``searchsorted``).
  * ``labels_count = max(#distinct, max_label_id + 1)`` (graph.cpp:223).
  * label reverse index (graph.cpp:89-104) and NLF signatures
    (graph.cpp:107-123), stored as flat arrays / a CSR-like table.
"""

# The port's own copy of gnnpe_tpu/graph/csr.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).
# Without ``device_arrays`` (JAX), ``k_core``, ``meta`` and the networkx
# loader; ``to_device`` below is the port's.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["CSRGraph", "to_device"]


@dataclass
class CSRGraph:
    """Undirected labeled graph in CSR form (int32 ids for TPU friendliness).

    offsets:   int32[V+1]  row pointers
    neighbors: int32[2E]   column indices, sorted ascending within each row
    labels:    int32[V]    vertex labels
    """

    offsets: np.ndarray
    neighbors: np.ndarray
    labels: np.ndarray

    # Derived, computed in __post_init__.
    degrees: np.ndarray = field(init=False)
    labels_count: int = field(init=False)
    max_degree: int = field(init=False)
    max_label_frequency: int = field(init=False)
    label_frequency: np.ndarray = field(init=False)
    # Reverse index: vertices grouped by label (graph.cpp:89-104).
    reverse_index: np.ndarray = field(init=False)
    reverse_offsets: np.ndarray = field(init=False)
    _nlf: Optional[np.ndarray] = field(init=False, default=None)

    def __post_init__(self):
        self.offsets = np.asarray(self.offsets, dtype=np.int32)
        self.neighbors = np.asarray(self.neighbors, dtype=np.int32)
        self.labels = np.asarray(self.labels, dtype=np.int32)
        self.degrees = np.diff(self.offsets).astype(np.int32)
        v = self.num_vertices
        self.max_degree = int(self.degrees.max()) if v else 0
        max_label = int(self.labels.max()) if v else -1
        self.labels_count = max_label + 1
        self.label_frequency = np.bincount(
            self.labels, minlength=self.labels_count).astype(np.int32)
        self.max_label_frequency = (
            int(self.label_frequency.max()) if v else 0)
        # Vertices sorted by (label, id): reverse_index[reverse_offsets[l]:
        # reverse_offsets[l+1]] are the vertices with label l.
        order = np.argsort(self.labels, kind="stable").astype(np.int32)
        self.reverse_index = order
        self.reverse_offsets = np.concatenate(
            [[0], np.cumsum(self.label_frequency)]).astype(np.int32)

    # ------------------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return len(self.labels)

    @property
    def num_edges(self) -> int:
        """Undirected edge count (half the stored directed arcs)."""
        return len(self.neighbors) // 2

    def vertex_neighbors(self, v: int) -> np.ndarray:
        return self.neighbors[self.offsets[v]:self.offsets[v + 1]]

    def vertices_with_label(self, label: int) -> np.ndarray:
        lo, hi = self.reverse_offsets[label], self.reverse_offsets[label + 1]
        return self.reverse_index[lo:hi]

    # ------------------------------------------------------------------
    def has_edge(self, u, v) -> np.ndarray:
        """Vectorized edge-existence: binary search in u's sorted row.

        Replaces Static_Graph::checkEdgeExistence (graph.h:215-236); works
        elementwise on equal-shaped int arrays ``u``, ``v``.
        """
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        lo = self.offsets[u].astype(np.int64)
        hi = self.offsets[u + 1].astype(np.int64)
        # Global searchsorted over the flat neighbor array restricted per
        # row via the offset windows.
        pos = _searchsorted_rows(self.neighbors, lo, hi, v)
        found = (pos < hi) & (self.neighbors[np.minimum(
            pos, len(self.neighbors) - 1)] == v)
        return found

    # ------------------------------------------------------------------
    @property
    def nlf(self) -> np.ndarray:
        """Neighbor-label-frequency signatures as a dense int32[V, L] table
        (ref BuildNLF, graph.cpp:107-123, stored there as hash maps)."""
        if self._nlf is None:
            src = np.repeat(np.arange(self.num_vertices, dtype=np.int64),
                            self.degrees)
            nbr_label = self.labels[self.neighbors].astype(np.int64)
            flat = src * self.labels_count + nbr_label
            counts = np.bincount(
                flat, minlength=self.num_vertices * self.labels_count)
            self._nlf = counts.reshape(
                self.num_vertices, self.labels_count).astype(np.int32)
        return self._nlf

    # ------------------------------------------------------------------
    def label_adjacency(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-label adjacency (ref buildLabelOffset, graph.cpp:125-159):
        returns (label_neighbors int32[2E], label_offsets int32[V, L+1])
        where row v's neighbors are re-sorted by (label, id) and
        ``label_neighbors[offsets[v] + label_offsets[v, l] :
        offsets[v] + label_offsets[v, l+1]]`` are v's label-l neighbors.
        Lazy: the dense offset table is O(V·L) — build on demand.
        """
        if getattr(self, "_label_adj", None) is None:
            src = np.repeat(np.arange(self.num_vertices, dtype=np.int64),
                            self.degrees)
            nl = self.labels[self.neighbors].astype(np.int64)
            order = np.lexsort((self.neighbors, nl, src))
            label_neighbors = self.neighbors[order]
            counts = np.bincount(
                src * self.labels_count + nl,
                minlength=self.num_vertices * self.labels_count
            ).reshape(self.num_vertices, self.labels_count)
            label_offsets = np.concatenate(
                [np.zeros((self.num_vertices, 1), np.int64),
                 np.cumsum(counts, axis=1)], axis=1).astype(np.int32)
            self._label_adj = (label_neighbors, label_offsets)
        return self._label_adj

    def neighbors_with_label(self, v: int, label: int) -> np.ndarray:
        """v's neighbors carrying ``label`` (sorted ascending)."""
        ln, lo = self.label_adjacency()
        base = self.offsets[v]
        return ln[base + lo[v, label]: base + lo[v, label + 1]]

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_edges(cls, num_vertices: int, edges: np.ndarray,
                   labels: np.ndarray) -> "CSRGraph":
        """Build from an undirected edge list int[E, 2] (dedup not applied —
        callers pass simple graphs, as the reference format guarantees)."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=num_vertices)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return cls(offsets=offsets, neighbors=dst, labels=labels)

    @classmethod
    def from_graph_file(cls, path: str) -> "CSRGraph":
        """Parse the ``.graph`` text format (graph.cpp:163-242)."""
        with open(path, "r") as f:
            data = f.read().split()
        assert data[0] == "t", f"bad header in {path}"
        num_v, num_e = int(data[1]), int(data[2])
        toks = np.array(data[3:])
        # Vertex lines: v id label degree → 4 tokens; edges: e u v → 3.
        # The format emits all v lines then all e lines.
        v_block = toks[: 4 * num_v].reshape(num_v, 4)
        assert (v_block[:, 0] == "v").all()
        ids = v_block[:, 1].astype(np.int64)
        labels = np.zeros(num_v, dtype=np.int64)
        labels[ids] = v_block[:, 2].astype(np.int64)
        e_block = toks[4 * num_v:].reshape(num_e, 3)
        assert (e_block[:, 0] == "e").all()
        edges = e_block[:, 1:].astype(np.int64)
        return cls.from_edges(num_v, edges, labels)

    def to_graph_file(self, path: str) -> None:
        """Serialize in the reference text format."""
        with open(path, "w") as f:
            f.write(f"t {self.num_vertices} {self.num_edges}\n")
            for i in range(self.num_vertices):
                f.write(f"v {i} {self.labels[i]} {self.degrees[i]}\n")
            for u in range(self.num_vertices):
                for v in self.vertex_neighbors(u):
                    if u < v:
                        f.write(f"e {u} {v}\n")

    def coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Directed-arc COO view (src, dst), row-major sorted."""
        src = np.repeat(np.arange(self.num_vertices, dtype=np.int32),
                        self.degrees)
        return src, self.neighbors

def _searchsorted_rows(sorted_flat: np.ndarray, lo: np.ndarray,
                       hi: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """searchsorted of ``targets[i]`` within ``sorted_flat[lo[i]:hi[i]]``,
    returning global positions.  Rows of a CSR adjacency are themselves
    sorted, and row windows are disjoint and ordered, so one global
    searchsorted over (row, value) pairs would also work; a per-window
    binary search keeps it simple and exact."""
    lo = lo.copy()
    hi = hi.copy()
    out_lo, out_hi = lo.copy(), hi.copy()
    while (out_lo < out_hi).any():
        mid = (out_lo + out_hi) // 2
        midval = sorted_flat[np.minimum(mid, len(sorted_flat) - 1)]
        go_right = (out_lo < out_hi) & (midval < targets)
        out_lo = np.where(go_right, mid + 1, out_lo)
        out_hi = np.where((out_lo <= out_hi) & ~go_right &
                          (out_lo < out_hi), mid, out_hi)
    return out_lo


def to_device(graph: CSRGraph, device):
    """(offsets, neighbors, labels, degrees) as int32 tensors on
    ``device`` — the layout the CSR kernels take."""
    device = as_device(device)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (graph.offsets, graph.neighbors, graph.labels,
                           graph.degrees))
