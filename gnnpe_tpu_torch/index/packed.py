"""Packed dominance index — the TPU-era replacement for the disk R*-tree.

The reference builds a page-based R*-tree over path embeddings and
walks it best-first with a heap (custom.h:196-490; rtree/rtnode.cpp).
On TPU the idiomatic equivalent is **not a pointer tree** (SURVEY.md
§7.1.3): entries are sorted into blocks, per-block summaries are folded
with segment-min/max, and queries evaluate masked vector compares
against all block summaries at once, then only descend into surviving
blocks.  Construction is sort-based and therefore deterministic under
sharding — unlike R*-tree shape, which depended on insert order
(SURVEY.md §7.3).

Block summaries mirror the reference's auxiliary index exactly
(custom.h:264-364):
  * ub            — per-dimension upper bounds (entry MBR fold)
  * label_mbr     — min/max of pde_label over the block
  * max_degrees   — per-position max degree (PE) / scalar (PGE)

Sort order: label signature first (groups label-identical paths so the
equality test kills whole blocks), then -Σpde (the reference's key,
custom.h:319-323) within a group.
"""

# The port's own copy of gnnpe_tpu/index/packed.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from gnnpe_tpu_torch.match.filter import eps_threshold as _eps_threshold

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.embed.pde import PathEmbeddings


@dataclass
class PackedDominanceIndex:
    """Flat sorted entry arrays + one level of block summaries.

    One summary level suffices: with B≈512 a 100M-entry set has ~200k
    blocks, and the block-mask pass is itself a vectorized compare; a
    second level can be added by treating summaries as entries.
    """

    order: np.ndarray            # int64[P] permutation into sorted order
    block_size: int
    # Sorted entry arrays:
    labels: np.ndarray           # int32[P, L]
    degrees: np.ndarray          # int32[P, L]
    pde: np.ndarray              # f64[P, D]
    vids: np.ndarray             # int32[P, L]
    # Block summaries:
    blk_ub: np.ndarray           # f64[NB, D] max pde per dim
    blk_label_lo: np.ndarray     # f64[NB, D] min pde_label
    blk_label_hi: np.ndarray     # f64[NB, D] max pde_label
    blk_max_deg: np.ndarray      # int32[NB, L]
    blk_label_uniform: np.ndarray  # bool[NB] all rows share label sig
    blk_labels: np.ndarray       # int32[NB, L] label sig of first row

    @classmethod
    def build(cls, paths: PathEmbeddings, block_size: int = 512,
              rows: Optional[np.ndarray] = None) -> "PackedDominanceIndex":
        rows = (np.arange(paths.num_paths)
                if rows is None else np.asarray(rows))
        labels = paths.labels[rows]
        key = -paths.pde[rows].sum(axis=1)
        # lexsort: last key is primary → label columns primary (left to
        # right), then ascending -Σpde.
        sort_cols = [key] + [labels[:, j] for j in range(
            labels.shape[1] - 1, -1, -1)]
        order_local = np.lexsort(sort_cols)
        order = rows[order_local]

        labels = paths.labels[order]
        degrees = paths.degrees[order]
        pde = paths.pde[order]
        pde_label = paths.pde_label[order]
        vids = paths.vids[order]

        p = len(order)
        nb = -(-p // block_size) if p else 0
        pad = nb * block_size - p

        def blockify(a, fill):
            a2 = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) \
                if pad else a
            return a2.reshape(nb, block_size, *a.shape[1:])

        pde_b = blockify(pde, -np.inf)
        lbl_b = blockify(pde_label, np.nan)
        deg_b = blockify(degrees, 0)
        lab_b = blockify(labels, -1)

        blk_ub = pde_b.max(axis=1)
        blk_label_lo = np.nanmin(lbl_b, axis=1)
        blk_label_hi = np.nanmax(lbl_b, axis=1)
        blk_max_deg = deg_b.max(axis=1)
        first = lab_b[:, 0, :]
        uniform = ((lab_b == first[:, None, :]) |
                   (lab_b < 0)).all(axis=(1, 2))
        return cls(order=order, block_size=block_size, labels=labels,
                   degrees=degrees, pde=pde, vids=vids, blk_ub=blk_ub,
                   blk_label_lo=blk_label_lo, blk_label_hi=blk_label_hi,
                   blk_max_deg=blk_max_deg, blk_label_uniform=uniform,
                   blk_labels=first)

    # ------------------------------------------------------------------
    def query_block_mask(self, q_pde: np.ndarray, q_pde_label: np.ndarray,
                         q_degrees: np.ndarray,
                         epsilon: float = EPSILON) -> np.ndarray:
        """bool[Q, NB]: which blocks can contain matches for each query
        path — the vectorized analogue of the internal-node pruning
        (custom.h:439-484) plus the aux degree bound."""
        dom = (q_pde[:, None, :] <= self.blk_ub[None] + epsilon).all(-1)
        inside = ((q_pde_label[:, None, :] >= self.blk_label_lo[None]) &
                  (q_pde_label[:, None, :] <= self.blk_label_hi[None])
                  ).all(-1)
        deg = (q_degrees[:, None, :] <= self.blk_max_deg[None]).all(-1)
        return dom & inside & deg

    def search(self, query: PathEmbeddings, plan_rows: np.ndarray,
               num_query_vertices: int,
               epsilon: float = EPSILON) -> List[np.ndarray]:
        """Pruned PE candidate search: block mask → exact position-wise
        leaf test on surviving blocks only.  Identical output to the
        flat filter (gnnpe_tpu.match.filter.pe_candidates)."""
        q_idx = np.asarray(plan_rows)
        q_pde = query.pde[q_idx]
        q_lbl = query.pde_label[q_idx]
        q_deg = query.degrees[q_idx]
        q_labels = query.labels[q_idx]
        q_vids = query.vids[q_idx]
        bmask = self.query_block_mask(q_pde, q_lbl, q_deg, epsilon)

        out_sets: List[List[np.ndarray]] = [
            [] for _ in range(num_query_vertices)]
        p = len(self.order)
        l = self.labels.shape[1]
        for qi in range(len(q_idx)):
            blocks = np.nonzero(bmask[qi])[0]
            if not len(blocks):
                continue
            # Entry rows of surviving blocks (clipped to real entries).
            spans = [np.arange(b * self.block_size,
                               min((b + 1) * self.block_size, p))
                     for b in blocks]
            rows = np.concatenate(spans)
            ok = ((self.labels[rows] == q_labels[qi]).all(-1) &
                  (self.degrees[rows] >= q_deg[qi]).all(-1) &
                  (self.pde[rows]
                   >= _eps_threshold(q_pde[qi], epsilon)).all(-1))
            hit = rows[ok]
            if len(hit):
                dv = self.vids[hit]
                for k in range(l):
                    out_sets[int(q_vids[qi, k])].append(dv[:, k])
        return [np.unique(np.concatenate(s).astype(np.int64))
                if s else np.zeros(0, dtype=np.int64)
                for s in out_sets]


@dataclass
class PGEPackedIndex:
    """PGE variant: one entry per VERTEX, boxed by its path group
    (GNN-PGE custom.h:160-186) — block summaries mirror the PGE
    auxiliary index (scalar max degree + label MBR,
    GNN-PGE custom.h:197-290)."""

    order: np.ndarray          # int64[V'] sorted vertex ids
    block_size: int
    labels: np.ndarray         # int32[V']
    degrees: np.ndarray        # int32[V']
    group: np.ndarray          # f64[V', 2, D]
    label_group: np.ndarray    # f64[V', 2, D]
    blk_group_ub: np.ndarray   # f64[NB, D] max of upper bounds
    blk_lgroup_lo: np.ndarray  # f64[NB, D]
    blk_lgroup_hi: np.ndarray  # f64[NB, D]
    blk_max_deg: np.ndarray    # int32[NB]
    blk_labels: np.ndarray     # int32[NB] first label in block

    @classmethod
    def build(cls, labels, degrees, group, label_group,
              block_size: int = 512,
              rows: Optional[np.ndarray] = None) -> "PGEPackedIndex":
        rows = (np.arange(len(labels))
                if rows is None else np.asarray(rows))
        key = -group[rows, 1, :].sum(axis=1)
        order_local = np.lexsort([key, labels[rows]])
        order = rows[order_local]
        labels_s = labels[order]
        degrees_s = degrees[order]
        group_s = group[order]
        lgroup_s = label_group[order]
        v = len(order)
        nb = -(-v // block_size) if v else 0
        pad = nb * block_size - v

        def blockify(a, fill):
            a2 = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) \
                if pad else a
            return a2.reshape(nb, block_size, *a.shape[1:])

        return cls(
            order=order, block_size=block_size, labels=labels_s,
            degrees=degrees_s, group=group_s, label_group=lgroup_s,
            blk_group_ub=blockify(group_s[:, 1, :], -np.inf).max(axis=1),
            blk_lgroup_lo=np.nanmin(
                blockify(lgroup_s[:, 0, :], np.nan), axis=1),
            blk_lgroup_hi=np.nanmax(
                blockify(lgroup_s[:, 1, :], np.nan), axis=1),
            blk_max_deg=blockify(degrees_s, 0).max(axis=1),
            blk_labels=blockify(labels_s, -1)[:, 0])

    def search(self, q_labels, q_degrees, q_group, q_label_group,
               q_vertex_ids, epsilon: float = 0.0) -> List[np.ndarray]:
        """Pruned PGE search, identical output to pge_candidates
        (including its ``epsilon`` dominance slack — see
        match/filter.py:pge_candidates for why strict compares
        falsely prune)."""
        out: List[np.ndarray] = []
        v = len(self.order)
        for j, _ in enumerate(q_vertex_ids):
            bm = ((self.blk_max_deg >= q_degrees[j]) &
                  (self.blk_group_ub
                   >= _eps_threshold(q_group[j, 0, :], epsilon)
                   ).all(-1) &
                  ((self.blk_lgroup_hi >= q_label_group[j, 0, :]) &
                   (self.blk_lgroup_lo <= q_label_group[j, 1, :])
                   ).all(-1))
            blocks = np.nonzero(bm)[0]
            if not len(blocks):
                out.append(np.zeros(0, dtype=np.int64))
                continue
            rows = np.concatenate(
                [np.arange(b * self.block_size,
                           min((b + 1) * self.block_size, v))
                 for b in blocks])
            ok = ((q_degrees[j] <= self.degrees[rows]) &
                  (q_labels[j] == self.labels[rows]) &
                  ((self.label_group[rows, 1, :] >=
                    q_label_group[j, 0, :]) &
                   (self.label_group[rows, 0, :] <=
                    q_label_group[j, 1, :])).all(-1) &
                  (self.group[rows, 1, :]
                   >= _eps_threshold(q_group[j, 0, :], epsilon)
                   ).all(-1))
            out.append(np.sort(self.order[rows[ok]]).astype(np.int64))
        return out


def _dataclass_arrays(obj) -> dict:
    import dataclasses
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (np.asarray(v) if isinstance(v, np.ndarray)
                       else np.array(v))
    return out


def save_index(store, stage: str, fp: str, index) -> str:
    """Persist a packed index's arrays (the reference's index.dat
    resume, custom.h:218-234 — but config-fingerprinted so a stale
    index can never be silently reused)."""
    return store.save(stage, fp, **_dataclass_arrays(index))


def load_index(store, stage: str, fp: str, cls):
    arrays = store.load(stage, fp)
    if arrays is None:
        return None
    import dataclasses
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            # Schema drift (artifact from an older code version):
            # treat as a miss so the caller rebuilds and overwrites.
            return None
        v = arrays[f.name]
        kwargs[f.name] = (v if v.ndim else v.item())
    return cls(**kwargs)
