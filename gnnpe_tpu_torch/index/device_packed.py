"""Device-resident packed dominance index with its two-phase search,
for PE (one entry per path) and PGE (one entry per vertex), on one
device.

Counterpart of gnnpe_tpu/index/device_packed.py's
``DevicePackedPESearch`` and ``DevicePackedPGESearch`` in array
(resident) mode.  The constructor takes the gnnpe_tpu host index — its
fields are numpy arrays — and uploads it; both classes answer one
protocol, ``search(query, union=)``:

  phase 1 — block mask bool[Q, NB]: every query row against every block
    summary (label window, degree bound, upper-bound dominance; PGE adds
    its label-range prune, since its blocks are label-sorted).
  selection — the blocks that survive for any row.
  phase 2 — the surviving blocks' rows are gathered and leaf-tested,
    gated by per-(row, block) survival.  Blocks go in chunks sized so
    that the [Q, K·B, width] compare stays under ``CHUNK_ELEMS``.
  union — "host": the hit columns come back and candidates are
    extracted on the host; "device": a bool bitmap [nq, V] is written
    with index_put_ of True, which is idempotent and so deterministic.

Every dominance decision is a native f64 compare against thresholds
computed on the host with ``eps_threshold``, so candidate sets equal
the f64 host filter.  What the TPU version needed and this one drops:
uint32 mask packing, the fixed K chunk and power-of-two query buckets
(they only avoided recompiles), the fused single dispatch, ``warm()``,
and the ±3e38 pad sentinels — pad rows carry label -2, which no query
label equals, and blocks are not padded.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.embed.pde import PathEmbeddings
from gnnpe_tpu_torch.match.device_filter import (extract_candidates,
                                                 pe_mask_exact,
                                                 pge_mask_exact)
from gnnpe_tpu_torch.match.filter import eps_threshold
from gnnpe_tpu_torch.utils.device import as_device

# Bound on the elements of one [Q, rows, width] compare (phase 1 and
# each phase-2 chunk): 128M bools.  Read at search time.
CHUNK_ELEMS = 1 << 27


@dataclass
class PEQuery:
    """PE search input: the rows ``plan_rows`` of a query path table
    whose ``vids`` are query-vertex ids in [0, num_query_vertices)."""
    pde: PathEmbeddings
    plan_rows: np.ndarray
    num_query_vertices: int


@dataclass
class PGEQuery:
    """PGE search input: one row per query vertex (candidates come back
    in row order)."""
    labels: np.ndarray        # int[Q]
    degrees: np.ndarray       # int[Q]
    group: np.ndarray         # f64[Q, 2, D]
    label_group: np.ndarray   # f64[Q, 2, D]


class _PackedSearch:
    """The two-phase search shared by both variants.  Subclasses set
    the fields below and supply ``_prepare``, ``_phase1``,
    ``_leaf_mask``, ``_scatter`` and ``_extract``."""

    device: torch.device
    block_size: int
    num_blocks: int
    num_vertices: int
    width: int              # embedding columns of one entry

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload(self, a: np.ndarray, rows: int, fill) -> torch.Tensor:
        """``a`` padded with ``fill`` to ``rows`` rows, straight into
        device memory (no padded host copy)."""
        out = torch.full((rows,) + a.shape[1:], fill,
                         dtype=torch.from_numpy(a[:0]).dtype,
                         device=self.device)
        out[:len(a)] = self._put(a)
        return out

    def resident_tensors(self) -> dict:
        """The index tensors this search keeps on its device."""
        return {k: v for k, v in vars(self).items()
                if isinstance(v, torch.Tensor)}

    def search(self, query, union: str = "host") -> List[np.ndarray]:
        """Sorted candidate vertex ids per query vertex."""
        if union not in ("host", "device"):
            raise ValueError(f"union must be 'host' or 'device', "
                             f"got {union!r}")
        q = self._prepare(query)
        empty = [np.zeros(0, dtype=np.int64) for _ in range(q.num_out)]
        self.last_stats = None
        if q.rows == 0 or self.num_blocks == 0:
            return empty
        nb, b = self.num_blocks, self.block_size
        step = max(1, CHUNK_ELEMS // (q.rows * self.width))
        bmask = torch.cat([self._phase1(q, lo, min(lo + step, nb))
                           for lo in range(0, nb, step)], dim=1)
        sel = torch.nonzero(bmask.any(0)).squeeze(1)
        k = max(1, CHUNK_ELEMS // (q.rows * b * self.width))
        n_sel = sel.numel()
        self.last_stats = dict(blocks=nb, survived=n_sel,
                               chunks=-(-n_sel // k))
        if n_sel == 0:
            return empty
        offs = torch.arange(b, device=self.device)
        if union == "device":
            bitmap = torch.zeros((q.num_out, self.num_vertices),
                                 dtype=torch.bool, device=self.device)
        masks, hit_rows = [], []
        for lo in range(0, n_sel, k):
            blk = sel[lo:lo + k]
            rows = (blk[:, None] * b + offs[None]).reshape(-1)
            m = (self._leaf_mask(q, rows)
                 & bmask[:, blk].repeat_interleave(b, dim=1))
            if union == "device":
                qi, col = torch.nonzero(m, as_tuple=True)
                self._scatter(bitmap, q, qi, rows[col])
            else:
                hit = torch.nonzero(m.any(0)).squeeze(1)
                masks.append(m[:, hit].cpu().numpy())
                hit_rows.append(rows[hit].cpu().numpy())
        if union == "device":
            return [np.nonzero(r)[0].astype(np.int64)
                    for r in bitmap.cpu().numpy()]
        return self._extract(q, np.concatenate(masks, axis=1),
                             np.concatenate(hit_rows))


class DevicePackedPESearch(_PackedSearch):
    """PE packed index (``PackedDominanceIndex``) resident on
    ``device``: labels, degrees and vids int32[P, L], pde f64[P, L·D],
    plus the block summaries."""

    def __init__(self, index, device, base_epsilon: float = EPSILON):
        self.device = as_device(device)
        self.base_epsilon = base_epsilon
        self.block_size = b = index.block_size
        self.num_blocks = nb = len(index.blk_ub)
        self.width = index.pde.shape[1]
        rows = nb * b
        self.d_labels = self._upload(index.labels, rows, -2)
        self.d_degrees = self._upload(index.degrees, rows, 0)
        self.d_vids = self._upload(index.vids, rows, 0)
        self.d_pde = self._upload(index.pde, rows, 0.0)
        self.b_ub = self._put(index.blk_ub)
        self.b_llo = self._put(index.blk_label_lo)
        self.b_lhi = self._put(index.blk_label_hi)
        self.b_deg = self._put(index.blk_max_deg)
        self._host_vids = index.vids
        self.num_vertices = int(index.vids.max(initial=0)) + 1
        self.last_stats = None

    def _prepare(self, query: PEQuery):
        rows = np.asarray(query.plan_rows, dtype=np.int64)
        t = query.pde
        vids = t.vids[rows]
        return SimpleNamespace(
            rows=len(rows), num_out=query.num_query_vertices,
            labels=self._put(t.labels[rows]),
            degrees=self._put(t.degrees[rows]),
            thresh=self._put(eps_threshold(t.pde[rows],
                                           self.base_epsilon)),
            pde_label=self._put(t.pde_label[rows]),
            vids=vids, d_vids=self._put(vids).long())

    def _phase1(self, q, lo: int, hi: int) -> torch.Tensor:
        dom = (self.b_ub[None, lo:hi] >= q.thresh[:, None]).all(-1)
        inside = ((q.pde_label[:, None] >= self.b_llo[None, lo:hi]) &
                  (self.b_lhi[None, lo:hi] >= q.pde_label[:, None])
                  ).all(-1)
        deg = (q.degrees[:, None] <= self.b_deg[None, lo:hi]).all(-1)
        return dom & inside & deg

    def _leaf_mask(self, q, rows: torch.Tensor) -> torch.Tensor:
        return pe_mask_exact(self.d_labels[rows], self.d_degrees[rows],
                             self.d_pde[rows], q.labels, q.degrees,
                             q.thresh)

    def _scatter(self, bitmap, q, qi, rows) -> None:
        bitmap[q.d_vids[qi].reshape(-1),
               self.d_vids[rows].long().reshape(-1)] = True

    def _extract(self, q, mask, rows) -> List[np.ndarray]:
        return extract_candidates(mask, self._host_vids[rows], q.vids,
                                  q.num_out)


class DevicePackedPGESearch(_PackedSearch):
    """PGE packed vertex index (``PGEPackedIndex``) resident on
    ``device``: per-vertex labels, degrees, group upper bounds and
    label-group boxes, the entry→vertex order, and block summaries."""

    def __init__(self, index, device, base_epsilon: float = EPSILON):
        self.device = as_device(device)
        self.base_epsilon = base_epsilon
        self.block_size = b = index.block_size
        self.num_blocks = nb = len(index.blk_group_ub)
        self.width = index.group.shape[2]
        rows = nb * b
        self.d_labels = self._upload(index.labels, rows, -2)
        self.d_degrees = self._upload(index.degrees, rows, 0)
        self.d_ghi = self._upload(index.group[:, 1, :], rows, 0.0)
        self.d_llo = self._upload(index.label_group[:, 0, :], rows, 0.0)
        self.d_lhi = self._upload(index.label_group[:, 1, :], rows, 0.0)
        self.d_order = self._upload(index.order, rows, -1)
        self.b_gub = self._put(index.blk_group_ub)
        self.b_llo = self._put(index.blk_lgroup_lo)
        self.b_lhi = self._put(index.blk_lgroup_hi)
        self.b_deg = self._put(index.blk_max_deg)
        # Entries are label-sorted, so a query vertex's exact-label
        # matches live in one contiguous block run [first, last].
        nv = len(index.order)
        lab = index.labels.astype(np.int64)
        self._blk_lab_first = lab[np.arange(nb) * b]
        self._blk_lab_last = lab[np.minimum(np.arange(1, nb + 1) * b,
                                            nv) - 1]
        self._order = index.order
        self.num_vertices = int(index.order.max(initial=0)) + 1
        self.last_stats = None

    def _prepare(self, query: PGEQuery):
        lab = np.asarray(query.labels, dtype=np.int64)
        return SimpleNamespace(
            rows=len(lab), num_out=len(lab),
            labels=self._put(query.labels),
            degrees=self._put(query.degrees),
            glo=self._put(eps_threshold(query.group[:, 0, :],
                                        self.base_epsilon)),
            llo=self._put(query.label_group[:, 0, :]),
            lhi=self._put(query.label_group[:, 1, :]),
            run_lo=self._put(np.searchsorted(self._blk_lab_last, lab,
                                             side="left")),
            run_hi=self._put(np.searchsorted(self._blk_lab_first, lab,
                                             side="right")))

    def _phase1(self, q, lo: int, hi: int) -> torch.Tensor:
        dom = (self.b_gub[None, lo:hi] >= q.glo[:, None]).all(-1)
        overlap = ((self.b_lhi[None, lo:hi] >= q.llo[:, None]) &
                   (q.lhi[:, None] >= self.b_llo[None, lo:hi])).all(-1)
        deg = q.degrees[:, None] <= self.b_deg[None, lo:hi]
        cols = torch.arange(lo, hi, device=self.device)[None]
        in_run = (cols >= q.run_lo[:, None]) & (cols < q.run_hi[:, None])
        return dom & overlap & deg & in_run

    def _leaf_mask(self, q, rows: torch.Tensor) -> torch.Tensor:
        return pge_mask_exact(self.d_labels[rows], self.d_degrees[rows],
                              self.d_ghi[rows], self.d_llo[rows],
                              self.d_lhi[rows], q.labels, q.degrees,
                              q.glo, q.llo, q.lhi)

    def _scatter(self, bitmap, q, qi, rows) -> None:
        bitmap[qi, self.d_order[rows]] = True

    def _extract(self, q, mask, rows) -> List[np.ndarray]:
        vid_cols = self._order[rows]
        return [np.unique(vid_cols[mask[j]]).astype(np.int64)
                for j in range(q.num_out)]
