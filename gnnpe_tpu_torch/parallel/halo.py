"""Vertex-partitioned aggregation with halo (boundary) exchange
(counterpart of gnnpe_tpu/parallel/halo.py).

parallel/dist.py's edge-parallel form reduces a FULL [V, D] buffer every
hop — exact and simple, but its collective volume is O(V·D) per rank
regardless of the cut.  Here vertices are partitioned across the mesh
axis, each rank owns its feature rows, and one ``all_to_all`` moves only
the boundary rows the neighbours actually need (O(cut·D)); aggregation
then runs entirely on local arc lists.

Layout (host-built once per graph and shard count, ``HaloPlan.build``,
the port's own copy of gnnpe_tpu's numpy code):
  * vertices are assigned to ``n`` contiguous ranges after permutation
    by the partition membership (so "owned rows" are a slice);
  * ``send_idx[s, t, H]`` — local row ids shard s must ship to shard t
    (padded to the max pair count; -1 = pad row, zeros sent);
  * per-shard arc lists (local-dst sorted) whose src ids index the
    shard's EXTENDED buffer: [own rows | halo rows from shard 0 | …].

The rank's step (``make_device_fn``): gather the send rows → all_to_all
→ concatenate with the owned rows → the neighbour sum of the local arcs.
Both the send gather and the neighbour sum are rectangular CSR sums on
kernel A1 (ops/spmm.py ``CsrSum``): a shard's arcs are sorted by
destination row, so the plan gives each rank CSR offsets, and the
backward runs the same kernel over the transposed arcs.  Exactness:
equals the dense aggregation row for row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnnpe_tpu_torch.ops.spmm import CsrPair, CsrSum
from gnnpe_tpu_torch.parallel.collectives import AllToAll


def send_pair(send_idx: np.ndarray, own_pad: int, device) -> CsrPair:
    """The gather of a rank's send rows as a rectangular sum: slot k of
    ``send_idx`` (flattened [n·H]) reads own row ``send_idx[k]``, and a
    -1 slot reads nothing and so sends zeros."""
    flat = np.asarray(send_idx).reshape(-1)
    slots = np.nonzero(flat >= 0)[0]
    return CsrPair.from_arcs(slots, flat[slots], len(flat), own_pad, device)


@dataclass
class HaloPlan:
    num_shards: int
    perm: np.ndarray          # int64[V] new→old vertex order (owned runs)
    rank: np.ndarray          # int64[V] old→new
    bounds: np.ndarray        # int64[n+1] owned ranges in permuted space
    own_pad: int              # padded owned-rows per shard
    halo_pad: int             # padded per-pair halo count
    arc_pad: int              # padded per-shard arc count
    send_idx: np.ndarray      # int32[n, n, halo_pad] local row ids (-1 pad)
    arc_src: np.ndarray       # int32[n, arc_pad] ext-buffer row ids (-1 pad)
    arc_dst: np.ndarray       # int32[n, arc_pad] local dst row ids

    @classmethod
    def build(cls, offsets: np.ndarray, neighbors: np.ndarray,
              membership: np.ndarray, num_shards: int) -> "HaloPlan":
        """Fully vectorized: all grouping is np.unique / searchsorted /
        bincount over flat arc arrays, O(E log E) with numpy constants
        (shard loops and per-arc Python loops cost minutes of host time
        at patents scale)."""
        n = num_shards
        v = len(offsets) - 1
        membership = np.asarray(membership, dtype=np.int64)
        # Contiguous ownership: permute vertices by (shard, id).
        perm = np.lexsort((np.arange(v), membership))
        rank = np.empty(v, dtype=np.int64)
        rank[perm] = np.arange(v)
        counts = np.bincount(membership, minlength=n)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        own_pad = int(counts.max()) if v else 1

        deg = np.diff(offsets)
        dst_old = np.repeat(np.arange(v), deg)
        src_old = np.asarray(neighbors)
        s_dst = membership[dst_old]          # owning shard of each arc
        s_src = membership[src_old]
        cross = s_src != s_dst

        # Halo sets: distinct (src-owner s, consumer t, src u) triples,
        # grouped by sorting the packed key (np.unique returns sorted).
        key = ((s_src[cross] * n + s_dst[cross]) * v
               + src_old[cross]).astype(np.int64)
        uk = np.unique(key)
        us = uk // (n * v)
        ut = (uk // v) % n
        uu = uk % v
        pair = us * n + ut
        pcnt = np.bincount(pair, minlength=n * n)
        halo_pad = max(1, int(pcnt.max()))
        k_within = np.arange(len(uk)) - (np.cumsum(pcnt) - pcnt)[pair]
        send_idx = np.full((n, n, halo_pad), -1, dtype=np.int32)
        # local row of vertex u on its owner = rank[u] - bounds[s]
        send_idx[us, ut, k_within] = (rank[uu] - bounds[us]).astype(
            np.int32)

        # Extended-buffer row of every arc's src on its consumer:
        #   [0, own_pad)                owned rows
        #   own_pad + s*halo_pad + k    halo row k from shard s
        rows = np.empty(len(src_old), dtype=np.int32)
        rows[~cross] = (rank[src_old[~cross]]
                        - bounds[s_dst[~cross]]).astype(np.int32)
        j = np.searchsorted(uk, key)
        rows[cross] = (own_pad + us[j] * halo_pad
                       + k_within[j]).astype(np.int32)

        arc_pad = max(1, int(np.bincount(s_dst, minlength=n).max()))
        arc_src = np.full((n, arc_pad), -1, dtype=np.int32)
        arc_dst = np.zeros((n, arc_pad), dtype=np.int32)
        order = np.argsort(s_dst, kind="stable")
        cuts = np.searchsorted(s_dst[order], np.arange(n + 1))
        dst_rows = (rank[dst_old] - bounds[s_dst]).astype(np.int32)
        for t in range(n):
            sl = order[cuts[t]:cuts[t + 1]]
            arc_src[t, :len(sl)] = rows[sl]
            arc_dst[t, :len(sl)] = dst_rows[sl]
        return cls(num_shards=n, perm=perm, rank=rank,
                   bounds=bounds, own_pad=own_pad, halo_pad=halo_pad,
                   arc_pad=arc_pad, send_idx=send_idx,
                   arc_src=arc_src, arc_dst=arc_dst)

    # ------------------------------------------------------------------
    def shard_features(self, x: np.ndarray) -> np.ndarray:
        """Host: [V, D] → [n, own_pad, D] owned rows per shard."""
        n, d = self.num_shards, x.shape[1]
        out = np.zeros((n, self.own_pad, d), dtype=x.dtype)
        for s in range(n):
            lo, hi = self.bounds[s], self.bounds[s + 1]
            out[s, :hi - lo] = x[self.perm[lo:hi]]
        return out

    def unshard_features(self, shards: np.ndarray) -> np.ndarray:
        """Host: [n, own_pad, D] → [V, D] in original vertex order."""
        v = len(self.perm)
        parts = [shards[s, :self.bounds[s + 1] - self.bounds[s]]
                 for s in range(self.num_shards)]
        stacked = np.concatenate(parts, axis=0)
        return stacked[self.rank]

    def own_vertex_ids(self) -> np.ndarray:
        """int32[n, own_pad]: original vertex id at each owned row
        (pad rows → 0; their values are never read downstream)."""
        out = np.zeros((self.num_shards, self.own_pad), np.int32)
        for t in range(self.num_shards):
            lo, hi = self.bounds[t], self.bounds[t + 1]
            out[t, :hi - lo] = self.perm[lo:hi]
        return out

    def row_of_vertex(self) -> np.ndarray:
        """int32[V]: flat row in the all-gathered [n*own_pad, D]."""
        shard = np.searchsorted(self.bounds, self.rank, side="right") - 1
        return (shard * self.own_pad
                + (self.rank - self.bounds[shard])).astype(np.int32)

    def local_pair(self, rank: int, device) -> CsrPair:
        """Shard ``rank``'s arcs as CSR over its ``own_pad`` output rows
        (and transposed over its extended buffer's rows), on ``device``."""
        cnt = int((self.arc_src[rank] >= 0).sum())
        return CsrPair.from_arcs(
            self.arc_dst[rank, :cnt], self.arc_src[rank, :cnt], self.own_pad,
            self.own_pad + self.num_shards * self.halo_pad, device)

    def make_device_fn(self, group, rank: int, device):
        """This rank's aggregation: x_own [own_pad, D] → [own_pad, D], a
        collective call over ``group`` (the mesh axis's process group;
        ``rank`` is the rank's place along it).  Differentiable; the
        backward exchanges the cotangent's halo rows the other way.
        ``agg.launches`` says what one call launches on a CUDA tensor:
        ((A1, A2) of the forward, (A1, A2) of the backward)."""
        send = send_pair(self.send_idx[rank], self.own_pad, device)
        local = self.local_pair(rank, device)

        def agg(x_own: torch.Tensor) -> torch.Tensor:
            out_rows = CsrSum.apply(x_own, send)            # [n·H, D]
            handle = AllToAll.start(out_rows, group)
            halo = AllToAll.finish(out_rows, handle, group)
            return CsrSum.apply(torch.cat([x_own, halo]), local)

        # The send gather and the local sum, each way.
        agg.launches = ((2, 0), (2, 0))
        return agg

    def make_aggregate(self, mesh, device, axis: str = "graph"):
        """The rank's step for ``mesh``'s ``axis``: its [own_pad, D]
        block of ``shard_features`` → the same block aggregated."""
        from gnnpe_tpu_torch.parallel.mesh import axis_group, axis_rank
        return self.make_device_fn(axis_group(mesh, axis),
                                   axis_rank(mesh, axis), device)
