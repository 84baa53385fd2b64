"""Distributed online candidate search over the flat entry table
(counterpart of gnnpe_tpu/parallel/query.py).

The entry table (paths for PE, vertices for PGE) is split by rows over
one mesh axis: every rank is given the whole host table, uploads its own
contiguous run and drops the rest.  A search is the dominance filter of
the rank's rows and one collective:

  * ``union="host"`` — each rank extracts its shard's candidates on the
    host; the lists are gathered and united (sorted ids, so the union is
    exact whatever the shard order);
  * ``union="device"`` — each rank writes its hits into a bool[nq, V]
    vertex bitmap on its device and the bitmaps OR-combine with one
    ``all_reduce`` (MAX over bytes), in place of gnnpe_tpu's psum.

Every compare is native f64 (match/device_filter.py), so both unions
equal the f64 host filter.  gnnpe_tpu's three-limb tables and its
power-of-two query buckets are not needed here (no f64-less ALU, no
compiled shapes), and no shard is padded: the last rank's run is shorter
or empty.  ``pad_rows`` stays for callers that want equal shards.

Both classes answer the packed searches' protocol, ``search(query,
union=)`` with a ``PEQuery`` or ``PGEQuery``; the call is collective and
returns the same lists on every rank.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.index.device_packed import PEQuery, PGEQuery
from gnnpe_tpu_torch.match.device_filter import (FLAT_CHUNK_ELEMS,
                                                 extract_candidates,
                                                 pe_mask_exact,
                                                 pge_mask_exact)
from gnnpe_tpu_torch.match.filter import eps_threshold
from gnnpe_tpu_torch.parallel.collectives import (or_bitmaps_,
                                                  union_candidates)
from gnnpe_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                           shard_bounds)
from gnnpe_tpu_torch.utils.device import as_device


def pad_rows(arr: np.ndarray, n_shards: int, fill) -> np.ndarray:
    """Pad the leading dim to a multiple of n_shards.  Label fills must
    differ between data (-2) and query (-1) sides: equal fills would
    let a padded query row "match" a padded data row and scatter a
    spurious (0, 0) hit into the device-union bitmap."""
    p = len(arr)
    per = -(-max(p, 1) // n_shards)
    pad = per * n_shards - p
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


class _FlatSearch:
    """What the two flat searches share: the rank's row range, the
    upload, and the two unions."""

    def _shard(self, mesh, axis: str, rows: int, device) -> slice:
        self.device = as_device(device)
        self.group = axis_group(mesh, axis)
        lo, hi = shard_bounds(rows, axis_size(mesh, axis),
                              axis_rank(mesh, axis))
        self.row_range = (lo, hi)
        return slice(lo, hi)

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _bitmap(self, nq: int) -> torch.Tensor:
        return torch.zeros((nq, self.num_vertices), dtype=torch.bool,
                           device=self.device)

    def _unite(self, nq: int, union: str, bitmap, cands) -> List[np.ndarray]:
        if union == "device":
            or_bitmaps_(bitmap, self.group)
            return [np.nonzero(r)[0].astype(np.int64)
                    for r in bitmap.cpu().numpy()]
        return union_candidates(cands, self.group)


def _check_union(union: str) -> None:
    if union not in ("host", "device"):
        raise ValueError(f"union must be 'host' or 'device', got {union!r}")


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
        self.d_vids = self._put(data_pde.vids[rows])
        self._host_vids = data_pde.vids[rows]

    def search(self, query: PEQuery, union: str = "host") -> List[np.ndarray]:
        _check_union(union)
        rows = np.asarray(query.plan_rows, dtype=np.int64)
        t, nq = query.pde, query.num_query_vertices
        if len(rows) == 0 or nq == 0:          # the same on every rank
            return [np.zeros(0, dtype=np.int64) for _ in range(nq)]
        q_labels = self._put(t.labels[rows])
        q_degrees = self._put(t.degrees[rows])
        q_thresh = self._put(eps_threshold(t.pde[rows], self.base_epsilon))
        q_vids = t.vids[rows]
        d_qvids = self._put(q_vids).long()
        bitmap = self._bitmap(nq) if union == "device" else None
        p = self.d_labels.shape[0]
        step = max(1, FLAT_CHUNK_ELEMS // (len(rows) * self.d_pde.shape[1]))
        masks, cols = [np.zeros((len(rows), 0), bool)], [np.zeros(0, np.int64)]
        for lo in range(0, p, step):
            m = pe_mask_exact(self.d_labels[lo:lo + step],
                              self.d_degrees[lo:lo + step],
                              self.d_pde[lo:lo + step], q_labels, q_degrees,
                              q_thresh)
            if union == "device":
                qi, col = torch.nonzero(m, as_tuple=True)
                bitmap[d_qvids[qi].reshape(-1),
                       self.d_vids[col + lo].long().reshape(-1)] = True
            else:
                hit = torch.nonzero(m.any(0)).squeeze(1)
                masks.append(m[:, hit].cpu().numpy())
                cols.append(hit.cpu().numpy() + lo)
        cands = None
        if union == "host":
            cands = extract_candidates(
                np.concatenate(masks, axis=1),
                self._host_vids[np.concatenate(cols)], q_vids, nq)
        return self._unite(nq, union, bitmap, cands)


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

    def search(self, query: PGEQuery, union: str = "host"
               ) -> List[np.ndarray]:
        _check_union(union)
        nq = len(query.labels)
        if nq == 0:
            return []
        mask = pge_mask_exact(
            self.d_labels, self.d_degrees, self.d_ghi, self.d_llo, self.d_lhi,
            self._put(query.labels), self._put(query.degrees),
            self._put(eps_threshold(query.group[:, 0, :], self.base_epsilon)),
            self._put(query.label_group[:, 0, :]),
            self._put(query.label_group[:, 1, :]))
        lo, hi = self.row_range
        if union == "device":
            bitmap = self._bitmap(nq)
            bitmap[:, lo:hi] = mask
            return self._unite(nq, union, bitmap, None)
        host = mask.cpu().numpy()
        return self._unite(nq, union, None, [
            np.nonzero(host[j])[0].astype(np.int64) + lo for j in range(nq)])
