"""Graph partitioning for the staged pipeline.

The reference delegates to pymetis k-way partitioning (gnnpe.py:62-66) and
writes ``membership.txt`` in degree-ascending node order (gnnpe.py:68-75);
the engine reads it back and both (a) assigns paths/vertices to partitions
and (b) fixes the path-enumeration order (GNN-PE/src/main.cpp:77-96).

Membership only shards work — the candidate-set union and final answer
count are invariant to it (SURVEY.md §3.3) — so any balanced partitioner
is behavior-preserving.  We provide:

  * ``degree_sorted_nodes``: the enumeration-order contract (stable sort
    by degree ascending, mirroring python ``sorted`` in gnnpe.py:68-69).
  * ``partition_graph``: balanced edge-locality partitioning via BFS
    region growing (a METIS stand-in with no native dependency), plus
    "round_robin" and "block" strategies.  For the distributed layer the
    same membership shards paths/vertices across chips.
"""

# The port's own copy of gnnpe_tpu/graph/partition.py (numpy only; the
# two packages share no code, so the tests can hold one against the
# other).

from __future__ import annotations

import numpy as np

from gnnpe_tpu_torch.graph.csr import CSRGraph


def degree_sorted_nodes(graph: CSRGraph) -> np.ndarray:
    """Vertices sorted by degree ascending, ties by id (stable) —
    the reference's fixed enumeration order (gnnpe.py:68-69)."""
    return np.argsort(graph.degrees, kind="stable").astype(np.int32)


def partition_graph(graph: CSRGraph, num_parts: int,
                    strategy: str = "multilevel") -> np.ndarray:
    """Return int32[V] membership in [0, num_parts).

    strategy:
      "auto"        — "multilevel" up to 200k vertices, "block" beyond
                      (the Python multilevel partitioner costs tens of
                      minutes at patents scale, and membership only
                      shards work for the engines — the candidate
                      union is invariant, SURVEY §3.3.  Halo plans,
                      where cut quality sets the collective volume,
                      should request "multilevel"/"metis" explicitly).
      "multilevel"  — METIS-style multilevel: heavy-edge-matching
                      coarsening → BFS growing at the coarsest level →
                      uncoarsen with greedy boundary refinement.  The
                      default: edge cut directly sets the halo-exchange
                      collective volume (parallel/halo.py ships
                      O(cut·D) rows per hop).
      "metis"       — pymetis k-way (the reference's partitioner,
                      gnnpe.py:62-66) when importable; falls back to
                      "multilevel" with a warning otherwise.
      "bfs"         — balanced BFS region growing (edge-locality aware).
      "round_robin" — node i → i % num_parts.
      "block"       — contiguous id blocks.
    """
    v = graph.num_vertices
    if num_parts <= 1:
        return np.zeros(v, dtype=np.int32)
    if strategy == "auto":
        strategy = "multilevel" if v <= 200_000 else "block"
    if strategy == "metis":
        try:
            import pymetis
            adj = [graph.vertex_neighbors(u).tolist() for u in range(v)]
            _, mem = pymetis.part_graph(num_parts, adjacency=adj,
                                        recursive=True)
            return np.asarray(mem, dtype=np.int32)
        except ImportError:
            import warnings
            warnings.warn("pymetis not installed; using 'multilevel'")
            strategy = "multilevel"
    if strategy == "multilevel":
        return _multilevel_partition(graph, num_parts)
    if strategy == "round_robin":
        return (np.arange(v) % num_parts).astype(np.int32)
    if strategy == "block":
        return np.minimum(np.arange(v) * num_parts // max(v, 1),
                          num_parts - 1).astype(np.int32)
    if strategy != "bfs":
        raise ValueError(f"unknown partition strategy: {strategy}")

    target = (v + num_parts - 1) // num_parts
    membership = np.full(v, -1, dtype=np.int32)
    # Seed each region at the highest-degree unassigned vertex and grow
    # breadth-first until the size target, like greedy graph growing.
    order = np.argsort(-graph.degrees, kind="stable")
    assigned = 0
    for part in range(num_parts):
        if assigned >= v:
            break
        seed = next((int(s) for s in order if membership[s] < 0), None)
        if seed is None:
            break
        frontier = [seed]
        membership[seed] = part
        size = 1
        assigned += 1
        while frontier and size < target:
            nxt = []
            for u in frontier:
                for w in graph.vertex_neighbors(u):
                    w = int(w)
                    if membership[w] < 0:
                        membership[w] = part
                        nxt.append(w)
                        size += 1
                        assigned += 1
                        if size >= target:
                            break
                if size >= target:
                    break
            frontier = nxt
    # Any leftover isolated vertices: spread round-robin over the
    # least-loaded parts.
    leftovers = np.nonzero(membership < 0)[0]
    if len(leftovers):
        counts = np.bincount(membership[membership >= 0],
                             minlength=num_parts)
        for u in leftovers:
            p = int(np.argmin(counts))
            membership[u] = p
            counts[p] += 1
    return membership


def _handshake_matching(src, dst, w, vw, num_v, max_cluster_w, rng):
    """Vectorized heavy-edge matching: each vertex proposes to its
    heaviest neighbor (ties by a random priority); mutual proposals
    match.  Pairs whose combined vertex weight exceeds
    ``max_cluster_w`` are excluded — without this cap hub clusters
    snowball and the coarsest level cannot be balanced (classic METIS
    constraint).  Returns match[v] (own id if unmatched)."""
    match = np.arange(num_v, dtype=np.int64)
    free = np.ones(num_v, dtype=bool)
    prio = rng.rand(num_v)
    for _ in range(8):
        live = (free[src] & free[dst] &
                (vw[src] + vw[dst] <= max_cluster_w))
        if not live.any():
            break
        s, d, ww = src[live], dst[live], w[live]
        # Proposal of u = neighbor with max (weight, random prio).
        key = ww.astype(np.float64) + prio[d]  # weight-dominant tiebreak
        order = np.argsort(key, kind="stable")
        prop = np.full(num_v, -1, dtype=np.int64)
        prop[s[order]] = d[order]              # last write = max key
        has = prop >= 0
        mutual = has.copy()
        mutual[has] = prop[prop[has]] == np.nonzero(has)[0]
        a = np.nonzero(mutual & (np.arange(num_v) < prop))[0]
        b = prop[a]
        match[a] = b
        match[b] = a
        free[a] = free[b] = False
    return match


def _multilevel_partition(graph: CSRGraph, num_parts: int,
                          coarsest: int = 0, seed: int = 0,
                          imbalance: float = 1.05) -> np.ndarray:
    """METIS-style multilevel k-way partitioning (pure numpy).

    Coarsen by heavy-edge matching until ~64·k super-vertices, grow k
    weighted BFS regions at the coarsest level, then uncoarsen with a
    greedy positive-gain boundary refinement pass per level.  Replaces
    the reference's pymetis call (gnnpe.py:62-66) without a native
    dependency; candidate unions are membership-invariant (SURVEY
    §3.3), so only cut quality — i.e. halo volume — is at stake.
    """
    rng = np.random.RandomState(seed)
    coarsest = coarsest or max(64 * num_parts, 256)
    src, dst = graph.coo()
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    w = np.ones(len(src), dtype=np.int64)
    vw = np.ones(graph.num_vertices, dtype=np.int64)
    num_v = graph.num_vertices
    projections = []          # cmap per level (fine id -> coarse id)

    max_cluster_w = max(1, int(vw.sum()) // (num_parts * 32))
    while num_v > coarsest:
        match = _handshake_matching(src, dst, w, vw, num_v,
                                    max_cluster_w, rng)
        cluster = np.minimum(np.arange(num_v), match)
        uniq, cmap = np.unique(cluster, return_inverse=True)
        nv2 = len(uniq)
        if nv2 >= num_v * 0.99:   # diminishing returns: stop coarsening
            break
        # Stash this level's arrays for uncoarsening-time refinement.
        projections.append((cmap, src, dst, w, vw))
        vw = np.bincount(cmap, weights=vw, minlength=nv2).astype(np.int64)
        cs, cd = cmap[src], cmap[dst]
        live = cs != cd
        key = cs[live] * nv2 + cd[live]
        uk, inv = np.unique(key, return_inverse=True)
        w = np.bincount(inv, weights=w[live]).astype(np.int64)
        src, dst = uk // nv2, uk % nv2
        num_v = nv2

    # ---- initial partition at the coarsest level: greedy region
    # growing by MAX CONNECTION WEIGHT (BFS order floods across weak
    # boundaries; absorbing the strongest-attached vertex follows the
    # community structure the coarsening exposed).
    total = vw.sum()
    target = total / num_parts
    mem = np.full(num_v, -1, dtype=np.int32)
    order = np.argsort(-vw, kind="stable")
    loads = np.zeros(num_parts)
    adj_off, adj_nbr, adj_w = _csr_from_coo_w(src, dst, w, num_v)
    for part in range(num_parts):
        seedv = next((int(s) for s in order if mem[s] < 0), None)
        if seedv is None:
            break
        mem[seedv] = part
        loads[part] += vw[seedv]
        conn = np.zeros(num_v, dtype=np.int64)   # attachment to region
        span = slice(adj_off[seedv], adj_off[seedv + 1])
        np.add.at(conn, adj_nbr[span], adj_w[span])
        conn[mem >= 0] = -1
        while loads[part] < target:
            u = int(np.argmax(conn))
            if conn[u] <= 0:     # region exhausted its component
                break
            mem[u] = part
            loads[part] += vw[u]
            span = slice(adj_off[u], adj_off[u + 1])
            np.add.at(conn, adj_nbr[span], adj_w[span])
            conn[u] = -1
            conn[mem >= 0] = -1
    for u in np.nonzero(mem < 0)[0]:
        p = int(np.argmin(loads))
        mem[u] = p
        loads[p] += vw[u]

    # ---- uncoarsen with refinement at EVERY level (where multilevel
    # actually wins: each projection exposes finer boundary moves).
    # Imbalance schedule: loose at coarse levels (a misplaced coarse
    # cluster needs headroom to move — tight bounds deadlock it into a
    # balanced-but-wrong local minimum), tightening to ``imbalance`` at
    # the finest level where moves are single vertices.
    nlev = len(projections)
    mem = _refine_boundary(src, dst, w, mem, num_parts, 1.30,
                           vw=vw, passes=4)
    for i, (cmap, ls, ld, lw, lvw) in enumerate(reversed(projections)):
        frac = (i + 1) / max(nlev, 1)
        imb = 1.30 + (imbalance - 1.30) * frac
        mem = mem[cmap]
        mem = _refine_boundary(ls, ld, lw, mem, num_parts, imb,
                               vw=lvw, passes=2)
    if projections:
        ls, ld, lw = projections[0][1], projections[0][2], \
            projections[0][3]
    else:
        ls, ld, lw = src, dst, w
    mem = _force_balance(ls, ld, lw, mem, num_parts, imbalance)
    mem = _refine_boundary(ls, ld, lw, mem, num_parts, imbalance,
                           passes=2)
    return mem.astype(np.int32)


def _force_balance(src, dst, w, mem, num_parts, imbalance):
    """Evict minimum-loss boundary vertices from overfull parts until
    every part is within the imbalance bound (gain-only refinement has
    no rebalancing force; the coarse levels run loose on purpose)."""
    v = int(mem.shape[0])
    hi = v / num_parts * imbalance
    sizes = np.bincount(mem, minlength=num_parts).astype(np.float64)
    if (sizes <= hi).all():
        return mem
    mem = mem.copy()
    conn = np.bincount(src * num_parts + mem[dst], weights=w,
                       minlength=v * num_parts).reshape(v, num_parts)
    cur = conn[np.arange(v), mem]
    for p in np.nonzero(sizes > hi)[0]:
        excess = int(np.ceil(sizes[p] - hi))
        members = np.nonzero(mem == p)[0]
        # loss of evicting u = edges kept in p minus best alternative
        alt = conn[members].copy()
        alt[:, p] = -1
        best_alt = np.argmax(alt, axis=1)
        loss = cur[members] - alt[np.arange(len(members)), best_alt]
        order = np.argsort(loss, kind="stable")
        moved = 0
        for idx in order:
            if moved >= excess:
                break
            tgt = int(best_alt[idx])
            if sizes[tgt] + 1 > hi:
                under = np.nonzero(sizes + 1 <= hi)[0]
                if not len(under):
                    break
                tgt = int(under[np.argmax(conn[members[idx], under])])
            mem[members[idx]] = tgt
            sizes[p] -= 1
            sizes[tgt] += 1
            moved += 1
    return mem


def _csr_from_coo_w(src, dst, w, num_v):
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=num_v)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return off, dst[order], w[order]


def _refine_boundary(src, dst, w, mem, num_parts, imbalance,
                     vw=None, passes: int = 3) -> np.ndarray:
    """Greedy positive-gain boundary moves with (weighted) balance
    bounds — the KL/FM-flavored refinement of the multilevel scheme."""
    v = int(mem.shape[0])
    if vw is None:
        vw = np.ones(v, dtype=np.int64)
    hi = float(vw.sum()) / num_parts * imbalance
    mem = mem.copy()
    for _ in range(passes):
        conn = np.bincount(src * num_parts + mem[dst], weights=w,
                           minlength=v * num_parts
                           ).reshape(v, num_parts)
        cur = conn[np.arange(v), mem]
        best_p = np.argmax(conn, axis=1).astype(np.int32)
        gain = conn[np.arange(v), best_p] - cur
        cand = np.nonzero((gain > 0) & (best_p != mem))[0]
        if not len(cand):
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")][:200_000]
        sizes = np.bincount(mem, weights=vw,
                            minlength=num_parts).astype(np.float64)
        moved = 0
        for u in cand:
            p0, p1 = mem[u], best_p[u]
            if sizes[p1] + vw[u] > hi:
                continue
            mem[u] = p1
            sizes[p0] -= vw[u]
            sizes[p1] += vw[u]
            moved += 1
        if moved == 0:
            break
    return mem


def write_membership(path: str, graph: CSRGraph,
                     membership: np.ndarray) -> None:
    """Emit the reference ``membership.txt`` wire format: one
    ``node part`` line per vertex, in degree-ascending order
    (gnnpe.py:72-75)."""
    order = degree_sorted_nodes(graph)
    with open(path, "w") as f:
        for node in order:
            f.write(f"{node} {membership[node]}\n")
