"""Distributed online candidate search over the flat entry table
(counterpart of gnnpe_tpu/parallel/query.py).

The entry table (paths for PE, vertices for PGE) is split by rows over
one mesh axis: every rank is given the whole host table, uploads its own
contiguous run and drops the rest.  A search is the dominance filter of
the rank's rows, whose hits go into the packed searches' bit-packed
bitmap (``union_bitmap.scatter``, one query row a gate row), and their
finish, ``union_bitmap.unite``: the ranks' words OR-ed (``or_words_``),
in place of gnnpe_tpu's psum, then compacted into sorted ids.

Every compare is native f64 (match/device_filter.py), so the lists
equal the f64 host filter's.  gnnpe_tpu's three-limb tables and its
power-of-two query buckets are not needed here (no f64-less ALU, no
compiled shapes), and no shard is padded: the last rank's run is shorter
or empty.  ``pad_rows`` stays for callers that want equal shards.

Both classes answer the packed searches' protocol, ``search(query)``
with a ``PEQuery`` or ``PGEQuery``; the call is collective and returns
the same lists on every rank.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.index.device_packed import PEQuery, PGEQuery
from gnnpe_tpu_torch.match.device_filter import (FLAT_CHUNK_ELEMS,
                                                 pe_mask_exact,
                                                 pge_mask_exact)
from gnnpe_tpu_torch.match.filter import eps_threshold
from gnnpe_tpu_torch.ops import union_bitmap
from gnnpe_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                           shard_bounds)
from gnnpe_tpu_torch.utils.device import as_device


def pad_rows(arr: np.ndarray, n_shards: int, fill) -> np.ndarray:
    """Pad the leading dim to a multiple of n_shards.  Label fills must
    differ between data (-2) and query (-1) sides: equal fills would
    let a padded query row "match" a padded data row and scatter a
    spurious (0, 0) hit into the candidate bitmap."""
    p = len(arr)
    per = -(-max(p, 1) // n_shards)
    pad = per * n_shards - p
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


class _FlatSearch:
    """What the two flat searches share: the rank's row range, the
    upload, and the filter's mask into the candidate bitmap."""

    def _shard(self, mesh, axis: str, rows: int, device) -> slice:
        self.device = as_device(device)
        self.group = axis_group(mesh, axis)
        lo, hi = shard_bounds(rows, axis_size(mesh, axis),
                              axis_rank(mesh, axis))
        self.row_range = (lo, hi)
        return slice(lo, hi)

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _scatter(self, words, mask, vids, out_ids) -> None:
        """OR the hits of ``mask`` bool[Q, n] into ``words``: column c
        sets ``vids[c]`` in the rows ``out_ids`` of each row it hits (one
        gate a row, open; the hit count is not kept)."""
        gate = torch.ones((len(mask), 1), dtype=torch.bool,
                          device=self.device)
        hits = torch.zeros(1, dtype=torch.int64, device=self.device)
        union_bitmap.scatter(words, self.num_vertices, mask, gate, vids,
                             out_ids, hits)


class ShardedPESearch(_FlatSearch):
    """PE candidate search with the path table split by rows over one
    mesh axis; the rank's rows live on ``device`` (labels, degrees, vids
    and f64 pde)."""

    def __init__(self, mesh, data_pde, device, axis: str = "graph",
                 base_epsilon: float = EPSILON):
        self.num_paths = data_pde.num_paths
        self.base_epsilon = base_epsilon
        self.num_vertices = int(data_pde.vids.max(initial=0)) + 1
        rows = self._shard(mesh, axis, self.num_paths, device)
        self.d_labels = self._put(data_pde.labels[rows])
        self.d_degrees = self._put(data_pde.degrees[rows])
        self.d_pde = self._put(data_pde.pde[rows])
        self.d_vids = self._put(data_pde.vids[rows].astype(np.int32))

    def search(self, query: PEQuery) -> List[np.ndarray]:
        rows = np.asarray(query.plan_rows, dtype=np.int64)
        t, nq = query.pde, query.num_query_vertices
        if len(rows) == 0 or nq == 0:          # the same on every rank
            return [np.zeros(0, dtype=np.int64) for _ in range(nq)]
        q_labels = self._put(t.labels[rows])
        q_degrees = self._put(t.degrees[rows])
        q_thresh = self._put(eps_threshold(t.pde[rows], self.base_epsilon))
        out_ids = self._put(t.vids[rows].astype(np.int32))
        words = union_bitmap.new_words(nq, self.num_vertices, self.device)
        p = self.d_labels.shape[0]
        step = max(1, FLAT_CHUNK_ELEMS // (len(rows) * self.d_pde.shape[1]))
        for lo in range(0, p, step):
            m = pe_mask_exact(self.d_labels[lo:lo + step],
                              self.d_degrees[lo:lo + step],
                              self.d_pde[lo:lo + step], q_labels, q_degrees,
                              q_thresh)
            self._scatter(words, m, self.d_vids[lo:lo + step], out_ids)
        return union_bitmap.unite(words, self.num_vertices, self.group)[0]


class ShardedPGESearch(_FlatSearch):
    """PGE candidate search with the vertex table split by rows over one
    mesh axis.  The filter's output is the per-query-vertex candidate
    mask over the rank's vertices, so a shard's candidates are its row
    offset plus the mask's columns."""

    def __init__(self, mesh, labels, degrees, group, label_group, device,
                 axis: str = "graph", base_epsilon: float = EPSILON):
        self.base_epsilon = base_epsilon
        self.num_vertices = len(labels)
        rows = self._shard(mesh, axis, self.num_vertices, device)
        self.d_labels = self._put(labels[rows])
        self.d_degrees = self._put(degrees[rows])
        self.d_ghi = self._put(group[rows, 1, :])
        self.d_llo = self._put(label_group[rows, 0, :])
        self.d_lhi = self._put(label_group[rows, 1, :])
        self.d_vids = torch.arange(*self.row_range, dtype=torch.int32,
                                   device=self.device)[:, None]

    def search(self, query: PGEQuery) -> List[np.ndarray]:
        nq = len(query.labels)
        if nq == 0:
            return []
        mask = pge_mask_exact(
            self.d_labels, self.d_degrees, self.d_ghi, self.d_llo, self.d_lhi,
            self._put(query.labels), self._put(query.degrees),
            self._put(eps_threshold(query.group[:, 0, :], self.base_epsilon)),
            self._put(query.label_group[:, 0, :]),
            self._put(query.label_group[:, 1, :]))
        words = union_bitmap.new_words(nq, self.num_vertices, self.device)
        self._scatter(words, mask, self.d_vids,
                      torch.arange(nq, dtype=torch.int32,
                                   device=self.device)[:, None])
        return union_bitmap.unite(words, self.num_vertices, self.group)[0]
