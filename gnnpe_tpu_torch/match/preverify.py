"""Candidate pre-verification on the device (semi-join pruning) —
counterpart of gnnpe_tpu/match/preverify.py.

Arc consistency over the candidate relation: candidate v of query
vertex q survives iff for every query edge (q, q') some candidate of q'
is adjacent to v in the data graph.  Every vertex of a true match
survives, so the pruned sets still hold every real match.

Answer counts: under exact semantics (PGE, or any candidate sets that
are supersets of the true match images) the count does not move, since
refinement checks every edge itself.  PE's candidate sets are not such
supersets (its orientation dedup drops real matches) and its count
depends on which vertex refinement starts from, so with pruning the PE
count can move, towards the true count.  Leave it off where the
reference's PE count is wanted.

Device form: the candidate sets stacked as C ∈ {0, 1}^[V, nq] in f32;
one neighbour sum ``reach = A @ C`` — ``ops.spmm.neighbor_sum``, the
CSR kernel on a CUDA device and its plain version on the CPU — and

    C[v, q] &= ∀ q' ∈ N(q): reach[v, q'] > 0

per round, to a fixpoint or for ``iters`` rounds (pruning is monotone,
so every prefix is sound).  With ``ell=`` (a ``HierarchicalEll`` of the
data graph, ops/ell.py) the neighbour sum is ``ell.apply(C)`` instead:
one kernel launch per level of the uniform-width layout.  A sum of at
most max-degree ones is exact in f32 whatever the order of the adds, so
``reach > 0`` and the result are bit-equal to gnnpe_tpu's; the kernels
add in f32 and must keep doing so.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.ops.spmm import neighbor_sum
from gnnpe_tpu_torch.utils.device import as_device

__all__ = ["semijoin_prune"]


def semijoin_prune(data_graph: CSRGraph, query_graph: CSRGraph,
                   candidates: List[np.ndarray], device, iters: int = 2,
                   csr=None, ell=None) -> List[np.ndarray]:
    """Candidate sets pruned by ``iters`` rounds of arc consistency on
    ``device`` (each round is sound; the fixpoint needs at most V, and
    2-3 bring almost all of the benefit).

    csr: the data graph's int32 (offsets, neighbors) already on
    ``device``, for a caller that prunes many queries over one graph;
    by default they are uploaded here.  Each round costs one kernel
    launch and one small device-to-host read for the fixpoint test.
    ell: a ``HierarchicalEll`` of the data graph (or one already ``on``
    ``device``), reused across queries, whose ``apply`` is the neighbour
    sum in place of the CSR kernel's; ``csr`` is then not used."""
    device = as_device(device)
    if ell is not None:
        agg = ell.apply
    else:
        offsets, neighbors = (to_device(data_graph, device)[:2]
                              if csr is None else csr)
        agg = lambda c: neighbor_sum(offsets, neighbors, c)
    v, nq = data_graph.num_vertices, query_graph.num_vertices
    # The 0/1 matrix is made on the device from the candidate ids, and
    # only the surviving (query vertex, data vertex) pairs come back.
    ids = [np.asarray(cand, dtype=np.int64) for cand in candidates]
    rows = torch.from_numpy(np.concatenate(ids)).to(device)
    cols = torch.from_numpy(np.repeat(np.arange(nq), [len(c) for c in ids])
                            ).to(device)
    cur = torch.zeros((v, nq), dtype=torch.float32, device=device)
    cur[rows, cols] = 1.0
    # need[q, q']: the reach columns that must be positive for a
    # candidate of q to survive.
    need = np.zeros((nq, nq), dtype=bool)
    for q in range(nq):
        need[q, query_graph.vertex_neighbors(q)] = True
    free = ~torch.from_numpy(need).to(device)
    for _ in range(iters):
        reach = agg(cur) > 0.0
        ok = (reach[:, None, :] | free[None]).all(-1)
        nxt = cur * ok.to(cur.dtype)
        done = torch.equal(nxt, cur)
        cur = nxt
        if done:
            break
    # Pairs (q, vertex) in row-major order: per q, vertices ascending.
    alive = torch.nonzero(cur.t() > 0.0).cpu().numpy()
    cuts = np.searchsorted(alive[:, 0], np.arange(1, nq))
    return np.split(alive[:, 1].astype(np.int64, copy=False), cuts)
