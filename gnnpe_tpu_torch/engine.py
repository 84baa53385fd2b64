"""End-to-end PE / PGE engines on one device or over a mesh of ranks
(counterpart of gnnpe_tpu/engine.py).

  offline      → paths (PE) / VDE + per-vertex path groups (PGE), on
                 the host, or with ``device=True`` on the engine's device
  build_index  → VDE + PDE (PE) and the host packed index; PE with
                 ``table=True`` builds the table-mode index on the device
                 instead (index/device_packed.py ``TablePESearch``), or,
                 where ``resident`` says so, the streamed index on the
                 host (``StreamedPESearch``)
  attach_device → the host index uploaded (index/device_packed.py)
  attach_mesh  → the same over a mesh axis: the packed index split by
                 block range, or with ``packed=False`` the flat table
                 split by rows (parallel/query.py); every rank holds its
                 shard and ``online`` becomes a collective call
  online       → VDE + plan → device search → optional pre-verify on
                 the device → host refinement → count

VDE runs on the engine's device for the data graph and for every
query.  Partitions only shard work and the candidate union does not
depend on them, so the single-device engines do not partition.  Both
variants' searches answer one protocol, ``search(query, union=)``; the
variant supplies only its query table.  The engines serve from an
attached index only: there is no search on the host, and the CPU is a
device like any other, asked for by name (``PEEngine(cfg, g, "cpu")``).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.embed.pde import (PathEmbeddings, gen_pde,
                                       gen_query_pde_table, path_groups,
                                       path_groups_device)
from gnnpe_tpu_torch.embed.vde import gen_vde
from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
from gnnpe_tpu_torch.index.bucket_build import (BUILD_CHUNK_PATHS,
                                                build_streamed_from_chunks)
from gnnpe_tpu_torch.index.device_packed import (DevicePackedPESearch,
                                                 DevicePackedPGESearch,
                                                 PEQuery, PGEQuery,
                                                 TablePESearch,
                                                 builds_resident)
from gnnpe_tpu_torch.index.packed import PackedDominanceIndex, PGEPackedIndex
from gnnpe_tpu_torch.match.plan import greedy_path_cover
from gnnpe_tpu_torch.match.preverify import semijoin_prune
from gnnpe_tpu_torch.match.refine import refinement
from gnnpe_tpu_torch.parallel.query import ShardedPESearch, ShardedPGESearch
from gnnpe_tpu_torch.paths.device_enumerate import enumerate_dedup_device
from gnnpe_tpu_torch.paths.enumerate import enumerate_paths
from gnnpe_tpu_torch.utils.device import as_device
from gnnpe_tpu_torch.utils.profiling import annotate
from gnnpe_tpu_torch.utils.timers import StageTimer


@dataclass
class MatchResult:
    answer_count: int
    candidates: List[np.ndarray]
    timings_ms: dict
    embeddings: Optional[np.ndarray] = None


class _Engine:
    """Shared online path; subclasses define offline/build_index, the
    search class, and how a query graph becomes a query table."""

    search_cls = None

    def __init__(self, config, data_graph: CSRGraph, device,
                 embedder=None, membership: Optional[np.ndarray] = None):
        """device: where VDE and the search run.  embedder:
        callable(graph) -> VertexEmbeddings for the data graph and every
        query, in place of the fixed label-seeded VDE (a trained
        non-negative PathGNN, models/embedder.py, keeps answers exact).
        membership: int[V] partition of the data graph's vertices, kept
        for the callers that shard work by it (the halo plans of
        parallel/; PE's ``partition_rows``); the candidate union does not
        depend on it, so None computes none."""
        self.config = config
        self.graph = data_graph
        self.device = as_device(device)
        self.embedder = embedder
        self.membership = (None if membership is None
                           else np.asarray(membership))
        self.vertices = None
        self.index = None
        self.searcher = None
        self._csr = None

    def _prune(self, query_graph, cands, iters: int):
        """``semijoin_prune`` over the data graph's CSR, which goes to
        the device once per engine."""
        if self._csr is None:
            self._csr = to_device(self.graph, self.device)[:2]
        return semijoin_prune(self.graph, query_graph, cands, self.device,
                              iters=iters, csr=self._csr)

    def _vde(self, graph: CSRGraph):
        if self.embedder is not None:
            return self.embedder(graph)
        return gen_vde(graph, self.config.vde_dim, self.device)

    def attach_device(self, device):
        """Upload the host index to ``device`` for the online search
        (query VDE runs there too).  ``device`` must be the one the
        engine was made with, where the data-graph VDE ran.  Requires
        build_index() first; an index built on the device (table mode)
        is already attached."""
        if self.index is None and self.searcher is None:
            raise RuntimeError("call build_index() before attach_device()")
        if as_device(device) != self.device:
            raise ValueError(f"attach_device({device!r}): the engine was "
                             f"made for {self.device}")
        if self.index is not None:
            self.searcher = self.search_cls(
                self.index, self.device, base_epsilon=self.config.epsilon)
        return self

    def attach_mesh(self, mesh, axis: str = "graph", packed: bool = False):
        """Shard the search over ``mesh``'s ``axis`` (gnnpe_tpu's
        ``attach_mesh``): ``packed=True`` splits the packed index by
        block range — the host index of ``build_index()``, or the table
        or streamed index ``build_index(table=True)`` left attached;
        ``packed=False`` splits the flat entry table by rows
        (parallel/query.py).  Every rank of the axis calls it, on an
        engine built with the same arguments; ``online`` and
        ``online_many`` are collective from then on and return the same
        answer on every rank."""
        if packed and self.index is None and self.searcher is not None:
            self.searcher.shard(mesh, axis)
        elif packed:
            if self.index is None:
                raise RuntimeError("call build_index() before "
                                   "attach_mesh(packed=True)")
            self.searcher = self.search_cls(
                self.index, self.device,
                base_epsilon=self.config.epsilon).shard(mesh, axis)
        else:
            self.searcher = self._flat_search(mesh, axis)
        return self

    def online(self, query_graph: CSRGraph, engine: str = "native",
               return_embeddings: bool = False, union: str = "device",
               preverify: int = 0) -> MatchResult:
        """union: the search's candidate union, "device" (the bitmap
        built and compacted on the device) or "host" (the hit masks
        copied back and extracted there); the same lists either way.
        preverify: rounds of semi-join pruning of the candidates on
        the device before refinement (match/preverify.py), 0 = off.  PGE
        counts do not move with it; PE counts can, by design.
        return_embeddings: also the matches themselves, int32[N, |Vq|]
        indexed by query vertex id, in ``MatchResult.embeddings``."""
        if self.searcher is None:
            raise RuntimeError("call attach_device() before online()")
        t = StageTimer(self.device)
        with t.stage("query_plan"):
            query = self._stack([self._query_table(query_graph)])
        with t.stage("search"):
            cands = self.searcher.search(query, union=union)
        if preverify:
            with t.stage("preverify"):
                cands = self._prune(query_graph, cands, preverify)
        with t.stage("refine"):
            res = refinement(self.graph, query_graph, cands,
                             self.config.max_answers, engine=engine,
                             return_embeddings=return_embeddings)
        count, emb = res if return_embeddings else (res, None)
        return MatchResult(answer_count=int(count), candidates=cands,
                           timings_ms=t.times_ms, embeddings=emb)

    def online_many(self, query_graphs, engine: str = "native",
                    union: str = "device",
                    preverify: int = 0) -> List[MatchResult]:
        """Batched serving: all queries' rows stack into one search
        (query-vertex ids offset into one disjoint space), then the
        candidates split per query for ``preverify`` rounds of pruning
        (as in ``online``) and refinement.  Each result's
        ``timings_ms`` holds ``query_plan``, ``search``, [``preverify``],
        ``refine``, as ``online``'s does; its ``query_plan`` and
        ``search`` are the batch's, the same in every result."""
        if self.searcher is None:
            raise RuntimeError("call attach_device() before online_many()")
        t = StageTimer(self.device)
        with t.stage("query_plan"):
            query = self._stack([self._query_table(qg)
                                 for qg in query_graphs])
        with t.stage("search"):
            cands_all = self.searcher.search(query, union=union)
        per_query, base = [], 0
        for qg in query_graphs:
            per_query.append(cands_all[base:base + qg.num_vertices])
            base += qg.num_vertices
        prune = ((lambda qg, c: self._prune(qg, c, preverify))
                 if preverify else None)
        return _refine_batch(self.graph, query_graphs, per_query,
                             self.config.max_answers, engine, prune,
                             t.times_ms)


def _refine_batch(graph, query_graphs, per_query_cands, max_answers,
                  engine, prune, shared_ms: dict) -> List[MatchResult]:
    """The tail of ``online_many``: ``prune(query, candidates)`` per
    query where one is given (timed as ``preverify``; it returns host
    arrays, so the device has finished), then refinement per query,
    threaded when the native engine runs (its ctypes call releases the
    GIL).  Every query's timings start from ``shared_ms``, the batch's
    stages.  The calling thread holds a ``refine`` range over both
    steps: the profiler records no range that a pool thread opens."""
    timers = [StageTimer() for _ in query_graphs]
    for t in timers:
        t.times_ms.update(shared_ms)

    def one(qg, cands, t):
        with t.stage("refine"):
            count = refinement(graph, qg, cands, max_answers,
                               engine=engine)
        return MatchResult(answer_count=int(count), candidates=cands,
                           timings_ms=t.times_ms)

    with annotate("refine"):
        if prune is not None:
            pruned = []
            for t, qg, c in zip(timers, query_graphs, per_query_cands):
                with t.stage("preverify"):
                    pruned.append(prune(qg, c))
            per_query_cands = pruned
        if engine != "python" and len(query_graphs) > 1:
            with ThreadPoolExecutor(
                    max_workers=min(8, len(query_graphs))) as pool:
                return list(pool.map(one, query_graphs, per_query_cands,
                                     timers))
        return [one(qg, c, t)
                for qg, c, t in zip(query_graphs, per_query_cands, timers)]


class PEEngine(_Engine):
    """GNN-PE variant: one index entry per path, position-wise test."""

    search_cls = DevicePackedPESearch

    def __init__(self, config: PEConfig, data_graph: CSRGraph, device,
                 embedder=None, membership: Optional[np.ndarray] = None):
        super().__init__(config, data_graph, device, embedder, membership)
        self.paths = None
        self.partition_rows = None
        self.data_pde = None
        self.build_timings = None

    def offline(self, device: bool = False):
        """Enumerate paths from degree-sorted starts, one orientation
        each (ref main.cpp:75-120): numpy on the host, or with
        ``device=True`` an int32 tensor enumerated and deduplicated on
        the engine's device chunk by chunk — the same paths in the same
        order."""
        order = degree_sorted_nodes(self.graph)
        if device:
            self.paths = enumerate_dedup_device(
                self.graph, order, self.config.path_length, self.device)
            self.partition_rows = None
        else:
            self.paths, self.partition_rows = enumerate_paths(
                self.graph, order, self.config.path_length, dedup=True,
                membership=self.membership)
        return self

    def build_index(self, block_size: int = 512, table: bool = False,
                    resident=None, spill_dir=None, cache_bytes=None,
                    cache: bool = True, packed: bool = True,
                    budget_bytes=None):
        """VDE on the device, then either PDE and the host packed index
        (attach_device uploads it), or with ``table=True`` the
        table-mode index from the paths and the VDE, ready for
        ``online``.  ``packed=False`` stops at the PDE table
        (``data_pde``), which ``attach_mesh(packed=False)`` shards flat;
        the packed build keeps ``data_pde`` too.

        resident (table mode): True builds ``TablePESearch`` on the
        device and raises ``MemoryError`` where it does not fit; False
        builds ``StreamedPESearch`` on the host, bucket by bucket from
        chunks of the paths (index/bucket_build.py), its partitions and
        sorted table in
        ``spill_dir`` where one is named and in host memory otherwise;
        None builds resident where ``auto_resident`` says so (with
        ``budget_bytes`` as its budget; None means ``RESIDENT_SHARE`` of
        the device's free memory) and the build fits
        (``builds_resident``).  ``cache_bytes`` and ``cache`` are the
        streamed search's."""
        self.vertices = self._vde(self.graph)
        self.build_timings = None
        self.data_pde = None
        if not table:
            self.searcher = None        # until attach_device uploads
            paths = torch.as_tensor(self.paths).cpu().numpy()
            self.data_pde = gen_pde(self.vertices, paths)
            self.index = (PackedDominanceIndex.build(
                self.data_pde, block_size=block_size) if packed else None)
            return self
        self.index = None
        p, l = self.paths.shape
        if resident is None:
            on_device = (isinstance(self.paths, torch.Tensor)
                         and self.paths.device == self.device)
            resident = builds_resident(p, l, block_size, self.device,
                                       on_device, self.vertices.num_vertices,
                                       self.vertices.dim, budget_bytes)
        if resident:
            self.searcher = TablePESearch.build_from_paths(
                self.paths, self.vertices, self.device,
                block_size=block_size, base_epsilon=self.config.epsilon)
            return self
        paths = torch.as_tensor(self.paths).cpu().numpy()
        chunks = (paths[lo:lo + BUILD_CHUNK_PATHS]
                  for lo in range(0, p, BUILD_CHUNK_PATHS))
        self.searcher, self.build_timings = build_streamed_from_chunks(
            chunks, p, self.graph, degree_sorted_nodes(self.graph), l,
            self.vertices, self.device, block_size=block_size,
            spill_dir=spill_dir, base_epsilon=self.config.epsilon,
            cache_bytes=cache_bytes, cache=cache)
        return self

    def _flat_search(self, mesh, axis: str):
        if self.data_pde is None:
            raise RuntimeError("attach_mesh(packed=False) needs the PDE "
                               "table: call build_index() without table=True")
        return ShardedPESearch(mesh, self.data_pde, self.device, axis=axis,
                               base_epsilon=self.config.epsilon)

    def _query_table(self, qg: CSRGraph):
        qv = self._vde(qg)
        q_paths, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                     self.config.path_length, dedup=True)
        q_pde, weight, _ = gen_query_pde_table(qv, q_paths)
        plan = greedy_path_cover(q_paths, weight, qg.num_vertices)
        return q_pde, plan, qg.num_vertices

    @staticmethod
    def _stack(tables) -> PEQuery:
        names = [f.name for f in dataclasses.fields(PathEmbeddings)]
        parts, base = [], 0
        for q_pde, plan, n in tables:
            part = {k: getattr(q_pde, k)[plan] for k in names}
            part["vids"] = part["vids"] + base
            parts.append(part)
            base += n
        big = PathEmbeddings(**{k: np.concatenate([p[k] for p in parts])
                                for k in names})
        return PEQuery(big, np.arange(big.num_paths), base)


class PGEEngine(_Engine):
    """GNN-PGE variant: one index entry per vertex, boxed by its path
    group."""

    search_cls = DevicePackedPGESearch

    def __init__(self, config: PGEConfig, data_graph: CSRGraph, device,
                 embedder=None, membership: Optional[np.ndarray] = None):
        super().__init__(config, data_graph, device, embedder, membership)
        self.group = None
        self.label_group = None

    def offline(self, device: bool = False):
        """VDE on the device and per-vertex path groups
        (ref GNN-PGE/src/main.cpp:91-177): folded on the host, or with
        ``device=True`` enumerated and folded chunk by chunk on the
        engine's device (``path_groups_device``) — the same groups bit
        for bit."""
        self.vertices = self._vde(self.graph)
        order = degree_sorted_nodes(self.graph)
        if device:
            self.group, self.label_group = path_groups_device(
                self.vertices, self.graph, order, self.config.path_length,
                self.config.pde_dim, self.device)
        else:
            paths, _ = enumerate_paths(self.graph, order,
                                       self.config.path_length, dedup=False)
            self.group, self.label_group = path_groups(
                self.vertices, paths[:, 0], paths, self.config.pde_dim)
        return self

    def build_index(self, block_size: int = 512):
        self.index = PGEPackedIndex.build(
            self.vertices.labels, self.vertices.degrees, self.group,
            self.label_group, block_size=block_size)
        return self

    def _flat_search(self, mesh, axis: str):
        if self.group is None:
            raise RuntimeError("call offline() before attach_mesh()")
        return ShardedPGESearch(mesh, self.vertices.labels,
                                self.vertices.degrees, self.group,
                                self.label_group, self.device, axis=axis,
                                base_epsilon=self.config.epsilon)

    def _query_table(self, qg: CSRGraph) -> PGEQuery:
        qv = self._vde(qg)
        q_paths, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                     self.config.path_length, dedup=False)
        if len(q_paths) == 0:
            raise ValueError(
                "query has a vertex with no path; unsupported (the "
                "reference reads uninitialized memory here, "
                "GNN-PGE/src/main.cpp:284-330)")
        group, label_group = path_groups(qv, q_paths[:, 0], q_paths,
                                         self.config.pde_dim)
        return PGEQuery(qv.labels, qv.degrees, group, label_group)

    @staticmethod
    def _stack(tables) -> PGEQuery:
        return PGEQuery(**{
            f.name: np.concatenate([getattr(t, f.name) for t in tables])
            for f in dataclasses.fields(PGEQuery)})
