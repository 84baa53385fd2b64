"""Dynamic graph with an update stream.

Parity target: the reference ``Dynamic_Graph`` (GNN-PE/include/graph/
graph.h:12-49, libsrc/graph/graph.cpp:444-676) — adjacency-list storage
plus a recorded stream of insert/delete updates (``InsertUnit`` records,
include/configuration/types.h:13-100).  The reference never instantiates
it from ``main()``; we keep the capability as a thin mutable wrapper that
can snapshot to :class:`~gnnpe_tpu_torch.graph.csr.CSRGraph` for device work.
"""

# The port's own copy of gnnpe_tpu/graph/dynamic.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from gnnpe_tpu_torch.graph.csr import CSRGraph


@dataclass
class Update:
    """One streamed update (ref InsertUnit, types.h:86-100)."""
    kind: str          # "v+" | "v-" | "e+" | "e-"
    id1: int
    id2: int = 0
    label: int = 0


@dataclass
class DynamicGraph:
    """Adjacency-list graph supporting vertex/edge insert+delete with an
    update log, snapshotable to CSR."""

    labels: List[int] = field(default_factory=list)
    adj: List[set] = field(default_factory=list)
    updates: List[Update] = field(default_factory=list)

    @classmethod
    def from_csr(cls, g: CSRGraph) -> "DynamicGraph":
        dg = cls()
        dg.labels = [int(l) for l in g.labels]
        dg.adj = [set(map(int, g.vertex_neighbors(v)))
                  for v in range(g.num_vertices)]
        return dg

    @property
    def num_vertices(self) -> int:
        return len(self.labels)

    def add_vertex(self, label: int) -> int:
        vid = len(self.labels)
        self.labels.append(label)
        self.adj.append(set())
        self.updates.append(Update("v+", vid, label=label))
        return vid

    def remove_vertex(self, v: int) -> None:
        for u in list(self.adj[v]):
            self.adj[u].discard(v)
        self.adj[v] = set()
        self.labels[v] = -1
        self.updates.append(Update("v-", v))

    def add_edge(self, u: int, v: int) -> None:
        self.adj[u].add(v)
        self.adj[v].add(u)
        self.updates.append(Update("e+", u, v))

    def remove_edge(self, u: int, v: int) -> None:
        self.adj[u].discard(v)
        self.adj[v].discard(u)
        self.updates.append(Update("e-", u, v))

    def snapshot(self) -> CSRGraph:
        """Freeze into CSR (sorted adjacency), dropping removed vertices'
        edges but keeping id space stable."""
        edges = []
        for u, nbrs in enumerate(self.adj):
            for v in nbrs:
                if u < v:
                    edges.append((u, v))
        edges_arr = (np.array(edges, dtype=np.int64)
                     if edges else np.zeros((0, 2), dtype=np.int64))
        labels = np.array([max(l, 0) for l in self.labels], dtype=np.int64)
        return CSRGraph.from_edges(self.num_vertices, edges_arr, labels)
