"""Path enumeration on the device: frontier expansion hop by hop
(counterpart of gnnpe_tpu/paths/device_enumerate.py, ROADMAP Queue B8).

One hop takes the rows int32[N, k] and returns int32[N', k+1]:

  * a cumsum of the last vertices' degrees gives each row's slot range;
  * ``searchsorted`` maps every output slot to its parent row;
  * each slot gathers its neighbour, and a row survives if the new
    vertex is not already on it (simple paths);
  * boolean-mask indexing compacts the survivors, in order.

Rows are expanded in order with neighbours ascending, so the output
equals ``enumerate_paths_from`` in rows and order.  A start chunk is
sized by each start's slots in the last hop (exact for 3-vertex paths:
the degrees of its neighbours summed), so a hub's chunk is as small as
its own paths make it.  A hop whose slots would pass ``cap`` is an
overflow: the start chunk halves and runs again, and a single start
that still overflows raises.  Rows are never dropped.  Where no cap is
given it is taken again before every chunk from the memory then free,
so it shrinks with whatever the caller has allocated since (the
deduplicated output, a fold's tables).  Callers that fold paths as they
come (the orientation dedup, PGE's path groups) take them chunk by
chunk from ``chunks``, so the cap also bounds their temporaries; the
deduplicated rows, whose count is known for 2- and 3-vertex paths, are
written into one table allocated before the first chunk.  What the TPU
version needed and this one drops: the static [cap, k] buffers with a
validity mask, the argsort compaction, and the callers' own start-chunk
sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnpe_tpu_torch.graph.csr import CSRGraph
from gnnpe_tpu_torch.paths.enumerate import start_ranks
from gnnpe_tpu_torch.utils.device import as_device, free_bytes


def default_cap(device, num_vertices_per_path: int,
                row_bytes: int = 0) -> int:
    """Slots one hop may expand to on ``device``: half its free memory
    over a hop's bytes per slot (slot, parent and neighbour positions in
    int64, the parent row and the new row in int32) plus ``row_bytes``,
    what the caller allocates per output row to fold a chunk."""
    per_slot = 32 + 8 * (num_vertices_per_path + 1) + row_bytes
    return max(1, free_bytes(device) // 2 // per_slot)


def known_path_count(graph: CSRGraph, num_vertices_per_path: int):
    """The deduplicated path count before enumeration, for 2- and
    3-vertex paths (one orientation per edge; Σ deg·(deg−1) directed
    3-vertex paths, halved by the dedup); None for other lengths."""
    if num_vertices_per_path == 2:
        return int(graph.num_edges)
    if num_vertices_per_path == 3:
        deg = np.diff(graph.offsets).astype(np.int64)
        return int((deg * (deg - 1)).sum()) // 2
    return None


def last_hop_slots(graph: CSRGraph, num_vertices_per_path: int) -> np.ndarray:
    """float64[V]: an upper bound on the slots each start's paths take in
    their last hop — the start's degree for 2-vertex paths, the degrees
    of its neighbours summed for 3-vertex paths (exact: every 2-vertex
    path expands by its last vertex's degree), and that sum times the
    largest degree for each hop beyond."""
    deg = np.diff(graph.offsets).astype(np.float64)
    if num_vertices_per_path <= 2:
        return deg
    two = np.zeros(len(deg))
    rows = np.nonzero(deg > 0)[0]
    if len(rows):
        two[rows] = np.add.reduceat(deg[graph.neighbors],
                                    graph.offsets[:-1][rows].astype(np.int64))
    max_deg = max(float(deg.max(initial=1.0)), 1.0)
    return two * max_deg ** (num_vertices_per_path - 3)


def dedup_mask(rows: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """bool[P] keep-mask of the orientation dedup on the device: the
    rule ``rank[first] < rank[last]`` of gnnpe_tpu's
    ``dedup_orientations_streaming`` (rows in start-rank order)."""
    if rows.shape[1] == 1:          # a 1-vertex path is its own reverse
        return torch.ones(rows.shape[0], dtype=torch.bool,
                          device=rows.device)
    return rank[rows[:, 0].long()] < rank[rows[:, -1].long()]


class PathEnumerator:
    """The data graph's CSR on ``device``; call with start vertices and
    a path length to get every directed simple path from them.

    cap: slots one hop may hold (default ``default_cap`` with
    ``row_bytes``)."""

    def __init__(self, graph: CSRGraph, device, cap: int = None,
                 row_bytes: int = 0):
        self.device = as_device(device)
        self.cap = cap
        self.row_bytes = row_bytes
        self.offsets = torch.from_numpy(
            graph.offsets.astype(np.int64)).to(self.device)
        self.neighbors = torch.from_numpy(
            graph.neighbors.astype(np.int32)).to(self.device)
        self._graph = graph

    def __call__(self, starts, num_vertices_per_path: int) -> torch.Tensor:
        """int32[P, L] on the device, in emission order."""
        parts = list(self.chunks(starts, num_vertices_per_path))
        if not parts:
            return torch.zeros((0, num_vertices_per_path), dtype=torch.int32,
                               device=self.device)
        return torch.cat(parts)

    def chunks(self, starts, num_vertices_per_path: int):
        """The same rows as int32[n, L] tensors, one per start chunk, in
        emission order."""
        l = num_vertices_per_path
        starts = np.asarray(starts, dtype=np.int32)
        est = np.maximum(last_hop_slots(self._graph, l)[starts], 1.0)
        i, chunk = 0, len(starts)
        while i < len(starts):
            cap = (default_cap(self.device, l, self.row_bytes)
                   if self.cap is None else self.cap)
            chunk = min(chunk, len(starts) - i)
            while chunk > 1 and est[i:i + chunk].sum() > cap:
                chunk //= 2
            got = self._run(starts[i:i + chunk], l, cap)
            if got is None:             # a hop overflowed: split
                if chunk == 1:
                    raise ValueError(
                        f"cap={cap} too small for start {starts[i]}")
                chunk //= 2
                continue
            yield got
            i += chunk
            chunk *= 2

    def _run(self, batch: np.ndarray, l: int, cap: int):
        """The paths of length ``l`` from ``batch``; None on overflow."""
        rows = torch.from_numpy(batch).to(self.device)[:, None]
        for _ in range(l - 1):
            rows = self._hop(rows, cap)
            if rows is None:
                return None
        return rows

    def _hop(self, rows: torch.Tensor, cap: int):
        last = rows[:, -1].long()
        first = self.offsets[last]
        deg = self.offsets[last + 1] - first
        ends = torch.cumsum(deg, 0)
        total = int(ends[-1]) if len(ends) else 0
        if total > cap:
            return None
        slot = torch.arange(total, device=self.device)
        parent = torch.searchsorted(ends, slot, right=True)
        local = slot - (ends - deg)[parent]
        nbr = self.neighbors[first[parent] + local]
        out = torch.cat([rows[parent], nbr[:, None]], dim=1)
        simple = (out[:, :-1] != out[:, -1:]).all(dim=1)
        return out[simple]


def enumerate_paths_device(graph: CSRGraph, starts,
                           num_vertices_per_path: int, device,
                           cap: int = None) -> torch.Tensor:
    """All directed simple paths of ``num_vertices_per_path`` vertices
    from ``starts`` (emission order), as int32[P, L] on ``device``."""
    return PathEnumerator(graph, device, cap)(starts, num_vertices_per_path)


def dedup_chunks(graph: CSRGraph, order, num_vertices_per_path: int,
                 device):
    """``enumerate_paths(graph, order, L, dedup=True)``'s rows as int32
    [n, L] tensors on ``device``, one per start chunk, in order: every
    chunk deduplicated as it comes, so the directed rows of one chunk at
    most are held at once.  The cap counts the dedup's bytes per row
    (two int64 ranks, the mask and the kept row)."""
    device = as_device(device)
    l = num_vertices_per_path
    rank = torch.from_numpy(start_ranks(order, graph.num_vertices)).to(device)
    enum = PathEnumerator(graph, device, row_bytes=17 + 4 * l)
    for rows in enum.chunks(order, l):
        yield rows[dedup_mask(rows, rank)]


def enumerate_dedup_device(graph: CSRGraph, order,
                           num_vertices_per_path: int, device) -> torch.Tensor:
    """``dedup_chunks`` in one int32[P, L] tensor on ``device``: written
    chunk by chunk into a table of ``known_path_count`` rows allocated
    first (so no chunk is held beside a concatenated copy; a graph with
    self-loops fills a prefix of it), or for longer paths, whose count
    is not known, concatenated."""
    device = as_device(device)
    l = num_vertices_per_path
    p = known_path_count(graph, l)
    if p is None:
        parts = list(dedup_chunks(graph, order, l, device))
        return (torch.cat(parts) if parts else
                torch.zeros((0, l), dtype=torch.int32, device=device))
    out = torch.empty((p, l), dtype=torch.int32, device=device)
    pos = 0
    for rows in dedup_chunks(graph, order, l, device):
        if pos + len(rows) > p:
            raise ValueError(f"more than the {p} deduplicated paths "
                             f"counted from the degrees")
        out[pos:pos + len(rows)] = rows
        pos += len(rows)
    return out if pos == p else out[:pos]
