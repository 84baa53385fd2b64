"""Exact dominance masks on the device, in native f64.

Counterparts of gnnpe_tpu/match/device_filter.py's
``pe_mask_device_exact`` and ``pge_mask_device_exact``.  Those split
every f64 into three f32 limbs (``split3``/``ge3``) because the TPU has
no f64 ALU; a GPU compares f64 directly, so the decisions here are the
reference's f64 compares as they stand.  Thresholds (q - ε) are
computed on the host with ``match.filter.eps_threshold`` and uploaded.

``extract_candidates`` (host: mask → sorted candidates per query
vertex) is the port's copy of gnnpe_tpu's, and ``pe_candidates_device``
is the flat filter over every data path: the device mask, then the host
extraction.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.match.filter import eps_threshold
from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["extract_candidates", "pe_candidates_device", "pe_mask_exact",
           "pge_mask_exact"]

# Bound on the elements of one [Q, rows, L·D] compare of the flat filter.
FLAT_CHUNK_ELEMS = 1 << 27


def pe_mask_exact(d_labels, d_degrees, d_pde, q_labels, q_degrees,
                  q_thresh) -> torch.Tensor:
    """bool[Q, P] position-wise PE leaf test (custom.h:410-434):
    labels equal, q degree ≤ data degree, data pde ≥ q_thresh.
    d_*: [P, L] / [P, L·D]; q_*: [Q, L] / [Q, L·D]."""
    label_ok = (q_labels[:, None, :] == d_labels[None]).all(-1)
    degree_ok = (q_degrees[:, None, :] <= d_degrees[None]).all(-1)
    pde_ok = (d_pde[None] >= q_thresh[:, None, :]).all(-1)
    return label_ok & degree_ok & pde_ok


def pge_mask_exact(d_labels, d_degrees, d_group_hi, d_lgroup_lo,
                   d_lgroup_hi, q_labels, q_degrees, q_group_lo_thresh,
                   q_lgroup_lo, q_lgroup_hi) -> torch.Tensor:
    """bool[Q, V] PGE filter chain (GNN-PGE custom.h:330-372): degree,
    label, label-group overlap, and d_group_hi ≥ q_group_lo_thresh."""
    ok = ((q_degrees[:, None] <= d_degrees[None]) &
          (q_labels[:, None] == d_labels[None]))
    overlap = ((d_lgroup_hi[None] >= q_lgroup_lo[:, None, :]) &
               (q_lgroup_hi[:, None, :] >= d_lgroup_lo[None])).all(-1)
    dom = (d_group_hi[None] >= q_group_lo_thresh[:, None, :]).all(-1)
    return ok & overlap & dom


def pe_candidates_device(data_pde, q_pde, plan_rows: np.ndarray,
                         num_query_vertices: int, device,
                         base_epsilon: float = EPSILON) -> List[np.ndarray]:
    """Flat PE candidate generation on ``device``: every plan row
    against every data path with ``pe_mask_exact``, then the host
    extraction.  Candidate sets equal the f64 host filter's
    (``match.filter.pe_candidates``, with which it shares
    ``eps_threshold``).

    The data paths go to the device in chunks sized so that one
    [Q, rows, L·D] compare stays under ``FLAT_CHUNK_ELEMS``, and only
    the columns some row hits come back, so no [Q, P] mask is held."""
    device = as_device(device)
    plan_rows = np.asarray(plan_rows)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    q_labels = put(q_pde.labels[plan_rows])
    q_degrees = put(q_pde.degrees[plan_rows])
    q_thresh = put(eps_threshold(q_pde.pde[plan_rows], base_epsilon))
    q, p = len(plan_rows), data_pde.num_paths
    step = max(1, FLAT_CHUNK_ELEMS // max(1, q * data_pde.pde.shape[1]))
    masks, cols = [np.zeros((q, 0), bool)], [np.zeros(0, np.int64)]
    for lo in range(0, p if q else 0, step):
        hi = min(lo + step, p)
        m = pe_mask_exact(put(data_pde.labels[lo:hi]),
                          put(data_pde.degrees[lo:hi]),
                          put(data_pde.pde[lo:hi]), q_labels, q_degrees,
                          q_thresh)
        hit = torch.nonzero(m.any(0)).squeeze(1)
        masks.append(m[:, hit].cpu().numpy())
        cols.append(hit.cpu().numpy() + lo)
    return extract_candidates(np.concatenate(masks, axis=1),
                              data_pde.vids[np.concatenate(cols)],
                              q_pde.vids[plan_rows], num_query_vertices)


def extract_candidates(mask: np.ndarray, data_vids: np.ndarray,
                       plan_vids: np.ndarray,
                       num_query_vertices: int) -> List[np.ndarray]:
    """Host: mask bool[Q, P] → sorted unique candidates per query vertex
    (custom.h:429-433 semantics)."""
    per_vertex: List[List[np.ndarray]] = [
        [] for _ in range(num_query_vertices)]
    l = plan_vids.shape[1]
    for qi in range(mask.shape[0]):
        hit = np.nonzero(mask[qi])[0]
        if not len(hit):
            continue
        dv = data_vids[hit]
        for k in range(l):
            per_vertex[int(plan_vids[qi, k])].append(dv[:, k])
    return [np.unique(np.concatenate(s).astype(np.int64))
            if s else np.zeros(0, dtype=np.int64) for s in per_vertex]
