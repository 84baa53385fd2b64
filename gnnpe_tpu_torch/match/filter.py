"""Candidate generation as flat vectorized dominance filters.

The reference answers candidate queries with a best-first R*-tree search
(GNN-PE/include/custom.h:366-489).  Analysis (SURVEY.md §7.1): every
internal-node filter is *implied* by the leaf test — a (data, query)
pair passing the leaf test passes all its ancestors' label-MBR and
upper-bound dominance checks, and the heap's early-exit can only fire
inside the ε-slack band (Q_map keys satisfy key ≥ node_key − D·ε by the
traversal filter itself).  The candidate set therefore equals a flat
filter over all pairs — a dense masked compare that is the natural TPU
formulation (VPU-friendly; batched over query paths).  The packed-box
hierarchy in gnnpe_tpu.index prunes the same filter for huge path sets.

Leaf-test semantics (must match exactly):
  PE  (custom.h:401-438): position-wise label ==, q.deg ≤ d.deg, then
      q.pde[k] ≤ d.pde[k] + ε for all k (ε from custom.h:43).
  PGE (GNN-PGE custom.h:330-372): q.deg ≤ d.deg, label ==, label-group
      interval overlap, then d.pg_ub[k] ≥ q.pg_lb[k] (strict, NO ε —
      note the reference's vde loop there is dead code, :337-345).
"""

# The port's own copy of gnnpe_tpu/match/filter.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.embed.pde import PathEmbeddings


def eps_threshold(q: np.ndarray, epsilon: float) -> np.ndarray:
    """Lower dominance threshold with RELATIVE slack:
    ``q - max(ε, ε·|q|)`` per element.  The reference's absolute
    ε=1e-6 (custom.h:43) silently becomes a no-op once |q| exceeds
    ~1e10 in f64 (one ULP > ε), reinstating the strict-compare false
    prune for trained embedders with large feature scales (ADVICE
    r2).  Relative slack can only WIDEN the candidate superset;
    refinement keeps the final answers exact either way.  Every
    filter path (flat, host packed, sharded, device packed) uses this
    same helper so their candidate sets stay mutually identical."""
    q = np.asarray(q)
    return q - np.maximum(epsilon, epsilon * np.abs(q))


def pe_pair_mask(data: PathEmbeddings, query: PathEmbeddings,
                 query_rows: Optional[np.ndarray] = None,
                 epsilon: float = EPSILON) -> np.ndarray:
    """bool[Q, P]: query path q matches data path p position-wise."""
    q_idx = (np.arange(query.num_paths)
             if query_rows is None else np.asarray(query_rows))
    q_labels = query.labels[q_idx]          # [Q, L]
    q_degrees = query.degrees[q_idx]
    q_pde = query.pde[q_idx]                # [Q, L*D]
    label_ok = (q_labels[:, None, :] == data.labels[None, :, :]).all(-1)
    degree_ok = (q_degrees[:, None, :] <= data.degrees[None, :, :]).all(-1)
    # custom.h:422: fail iff q > d AND |q-d| > ε  ⇒ pass iff q - ε ≤ d
    # (relative slack; see eps_threshold).
    pde_ok = (eps_threshold(q_pde, epsilon)[:, None, :]
              <= data.pde[None, :, :]).all(-1)
    return label_ok & degree_ok & pde_ok


def pe_candidates(data: PathEmbeddings, query: PathEmbeddings,
                  plan_rows: np.ndarray, num_query_vertices: int,
                  data_rows: Optional[np.ndarray] = None,
                  epsilon: float = EPSILON) -> List[np.ndarray]:
    """Candidate vertex sets per query vertex (sorted unique ids).

    On a match, each position's data vertex becomes a candidate for the
    corresponding query-path vertex (custom.h:429-433).

    data_rows: optional subset of data paths (a partition's paths).
    """
    rows = (np.arange(data.num_paths)
            if data_rows is None else np.asarray(data_rows))
    sub = PathEmbeddings(vids=data.vids[rows], labels=data.labels[rows],
                         degrees=data.degrees[rows], pde=data.pde[rows],
                         pde_label=data.pde_label[rows])
    mask = pe_pair_mask(sub, query, plan_rows, epsilon)   # [Q, P']
    out: List[np.ndarray] = [np.zeros(0, dtype=np.int64)
                             for _ in range(num_query_vertices)]
    q_vids = query.vids[plan_rows]                        # [Q, L]
    l = q_vids.shape[1]
    per_vertex: List[List[np.ndarray]] = [[] for _ in range(num_query_vertices)]
    for qi in range(mask.shape[0]):
        hit = np.nonzero(mask[qi])[0]
        if not len(hit):
            continue
        dvids = sub.vids[hit]                             # [H, L]
        for k in range(l):
            per_vertex[int(q_vids[qi, k])].append(dvids[:, k])
    for v in range(num_query_vertices):
        if per_vertex[v]:
            out[v] = np.unique(np.concatenate(per_vertex[v]).astype(np.int64))
    return out


def pge_candidates(d_labels: np.ndarray, d_degrees: np.ndarray,
                   d_group: np.ndarray, d_label_group: np.ndarray,
                   q_labels: np.ndarray, q_degrees: np.ndarray,
                   q_group: np.ndarray, q_label_group: np.ndarray,
                   q_vertex_ids: Sequence[int],
                   data_vertex_ids: Optional[np.ndarray] = None,
                   epsilon: float = 0.0) -> List[np.ndarray]:
    """PGE vertex-level filter chain (GNN-PGE custom.h:330-372).

    Groups are f64[N, 2, pde_dim] ([:,0]=lower, [:,1]=upper).
    Returns sorted candidate arrays per query vertex id.

    epsilon: slack on the path-group dominance compare.  The
    reference's compare is strict (custom.h:357-363, no ε) and has a
    latent false-prune: a true match u↦v with identical neighbor-label
    multisets sums vde in different adjacency orders, so the two f64
    sums differ by ULPs and the strict ≥ fails (measured at vde_dim=4
    on Test/: a 10,880-match query answered 0).  At the reference's
    only shipped config (e=2, its query) the bug never fires, so
    ε=0 reproduces reference behavior; the engine passes the PE
    epsilon (1e-6, custom.h:43), which keeps candidates supersets —
    refinement verifies, so answers stay exact."""
    n_data = len(d_labels)
    ids = (np.arange(n_data, dtype=np.int64)
           if data_vertex_ids is None else np.asarray(data_vertex_ids))
    out: List[np.ndarray] = []
    for j, qv in enumerate(q_vertex_ids):
        ok = (q_degrees[j] <= d_degrees) & (q_labels[j] == d_labels)
        # label-group overlap (custom.h:348-354): fail iff
        # v.ub < q.lb or v.lb > q.ub in any dim.
        overlap = ((d_label_group[:, 1, :] >= q_label_group[j, 0, :]) &
                   (d_label_group[:, 0, :] <= q_label_group[j, 1, :])).all(-1)
        # path-group lower-bound dominance (custom.h:357-363; ε slack
        # per docstring — strict reference compare falsely prunes
        # order-of-summation ULP differences):
        dom = (d_group[:, 1, :]
               >= eps_threshold(q_group[j, 0, :], epsilon)).all(-1)
        out.append(np.sort(ids[ok & overlap & dom]))
    return out


def pge_candidates_chunked(d_labels: np.ndarray, d_degrees: np.ndarray,
                           d_group: np.ndarray,
                           d_label_group: np.ndarray,
                           q_labels: np.ndarray, q_degrees: np.ndarray,
                           q_group: np.ndarray,
                           q_label_group: np.ndarray,
                           q_vertex_ids: Sequence[int],
                           epsilon: float = 0.0,
                           chunk: int = 1 << 21) -> List[np.ndarray]:
    """Flat exact PGE filter streamed over data-vertex chunks — the
    big-V spot-check oracle (VERDICT r4 item 5: rungs beyond 5M
    vertices previously fell back to the host packed-index walk, the
    same family as the thing under test; this shares no code with any
    packed index).  Semantically identical to ``pge_candidates``:
    chunks partition the vertex ids, per-chunk results are ascending,
    and chunks concatenate in id order."""
    n = len(d_labels)
    outs: List[List[np.ndarray]] = [[] for _ in q_vertex_ids]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        part = pge_candidates(
            d_labels[lo:hi], d_degrees[lo:hi], d_group[lo:hi],
            d_label_group[lo:hi], q_labels, q_degrees, q_group,
            q_label_group, q_vertex_ids,
            data_vertex_ids=np.arange(lo, hi, dtype=np.int64),
            epsilon=epsilon)
        for j, p in enumerate(part):
            if len(p):
                outs[j].append(p)
    return [np.concatenate(s) if s else np.zeros(0, dtype=np.int64)
            for s in outs]


def pe_candidates_chunked(vertices, paths: np.ndarray,
                          query: PathEmbeddings,
                          plan_rows: np.ndarray,
                          num_query_vertices: int,
                          epsilon: float = EPSILON,
                          chunk: int = 1 << 22) -> List[np.ndarray]:
    """Flat exact PE filter streamed over path chunks — the spot-check
    oracle for billion-path rungs, where materializing the full f64
    PathEmbeddings (gen_pde) would cost tens of GB of host RAM.

    Semantically identical to ``pe_candidates(gen_pde(vertices,
    paths), ...)``: per chunk it applies label equality and the degree
    bound first (cheap int compares), then the f64 ε-slack dominance
    test on survivors only (custom.h:401-438 order of tests, same
    eps_threshold)."""
    rows = np.asarray(plan_rows)
    out_sets: List[List[np.ndarray]] = [
        [] for _ in range(num_query_vertices)]
    q_labels = query.labels[rows]
    q_deg = query.degrees[rows]
    q_thresh = eps_threshold(query.pde[rows], epsilon)
    q_vids = query.vids[rows]
    labs, degs, vde = vertices.labels, vertices.degrees, vertices.vde
    l = paths.shape[1]
    d = vde.shape[1]
    for lo in range(0, len(paths), chunk):
        pc = paths[lo:lo + chunk]
        pl = labs[pc]
        pd = degs[pc]
        for qi in range(len(rows)):
            m = ((pl == q_labels[qi]).all(-1) &
                 (pd >= q_deg[qi]).all(-1))
            if not m.any():
                continue
            hit_rows = pc[m]
            pde = vde[hit_rows].reshape(len(hit_rows), l * d)
            ok = (pde >= q_thresh[qi]).all(-1)
            hit = hit_rows[ok]
            if len(hit):
                for k in range(l):
                    out_sets[int(q_vids[qi, k])].append(hit[:, k])
    return [np.unique(np.concatenate(s).astype(np.int64))
            if s else np.zeros(0, dtype=np.int64) for s in out_sets]
