"""Device-resident packed dominance index with its two-phase search,
for PE (one entry per path) and PGE (one entry per vertex), on one
device.

Counterpart of gnnpe_tpu/index/device_packed.py's
``DevicePackedPESearch`` and ``DevicePackedPGESearch`` in resident
mode.  PE has two classes, one per layout:

  ``DevicePackedPESearch`` (array mode) — the constructor takes the
    gnnpe_tpu host index (its fields are numpy arrays) and uploads
    labels, degrees, vids and f64 pde for every entry;
  ``TablePESearch`` (table mode) — ``build_from_paths`` builds the index
    on the device from the paths and the f64 vertex embeddings: the
    composite sort key, a stable ``torch.sort``, and the permute-fold of
    the block summaries (ROADMAP Queue B4).  Only the int32 vid row is
    stored per entry; labels, degrees and vde are gathered through
    per-vertex tables.  ``save``/``load`` write and read gnnpe_tpu's own
    npz format.

Every class answers one protocol,
``search(query, union=)``:

  phase 1 — block mask bool[Q, NB]: every query row against every block
    summary (label window, degree bound, upper-bound dominance).
  range prune — blocks outside a query row's contiguous run of possible
    exact-label matches go: PGE's blocks are label-sorted, table-mode
    PE's are sorted by label signature.
  selection — the blocks that survive for any row.
  phase 2 — the surviving blocks' rows are gathered and leaf-tested,
    gated by per-(row, block) survival.  Blocks go in chunks sized so
    that the [Q, K·B, width] compare stays under ``CHUNK_ELEMS``.
  union — "host": the hit columns come back and candidates are
    extracted on the host; "device": a bool bitmap [nq, V] is written
    with index_put_ of True, which is idempotent and so deterministic.

Every leaf decision is a native f64 compare against thresholds computed
on the host with ``eps_threshold``, so candidate sets equal the f64 host
filter.  Table-mode summaries are outward-rounded f32 (gnnpe_tpu's
layout); they widen to f64 exactly in the phase-1 compare and can only
keep more blocks, never lose a candidate.  What the TPU version needed
and this one drops: uint32 mask packing, the fixed K chunk and
power-of-two query, path and vertex buckets (they only avoided
recompiles), the fused single dispatch, ``warm()``, the three-limb
tables, and the ±3e38 pad sentinels — pad rows carry label -2, which no
query label equals.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

# The host sort-key helpers are numpy; gnnpe_tpu's module imports no JAX
# at module level.
from gnnpe_tpu.index.device_packed import (_outward, composite_sort_key,
                                           key_tables, path_sig,
                                           sig_radix_of)
from gnnpe_tpu_torch.config import EPSILON
from gnnpe_tpu_torch.embed.pde import PathEmbeddings
from gnnpe_tpu_torch.match.device_filter import (extract_candidates,
                                                 pe_mask_exact,
                                                 pge_mask_exact)
from gnnpe_tpu_torch.match.filter import eps_threshold
from gnnpe_tpu_torch.utils.device import as_device, free_bytes
from gnnpe_tpu_torch.utils.timers import StageTimer

__all__ = ["CHUNK_ELEMS", "DevicePackedPESearch", "DevicePackedPGESearch",
           "PEQuery", "PGEQuery", "TablePESearch", "composite_sort_key",
           "composite_sort_key_device", "key_tables", "key_tables_device",
           "path_sig", "permute_fold", "sig_radix_of"]

# Bound on the elements of one [Q, rows, width] compare (phase 1 and
# each phase-2 chunk): 128M bools.  Read at search time.
CHUNK_ELEMS = 1 << 27
# Blocks folded per step of ``permute_fold`` (bounds its gathers).
FOLD_BLOCKS = 1 << 16
# A saved vid table larger than this goes to a raw ``.vids.bin`` sidecar
# (gnnpe_tpu's rule: np.savez would buffer the whole table).
SIDECAR_BYTES = 1 << 30
# Bytes a table-mode build holds per path beyond the vid rows: the key,
# the sorted key and the permutation (int64 each), and the key's
# per-position temporaries.
BUILD_BYTES_PER_PATH = 48


def key_tables_device(vertices, device):
    """``key_tables`` on ``device``: (outward-rounded f32 vde [V, D],
    signature radix, int64 labels [V])."""
    vde_up, radix, labels = key_tables(vertices)
    return (torch.from_numpy(vde_up).to(device), int(radix),
            torch.from_numpy(labels).to(device))


def composite_sort_key_device(paths: torch.Tensor, vertices,
                              tables=None) -> torch.Tensor:
    """int64[P] ``composite_sort_key`` of int32[P, L] paths, on their
    device and bit-equal to the numpy one: the signature fold in int64,
    Σ vde_up in f32 position by position with each position's D columns
    added left to right as numpy does for D < 8, the f32 bits of -Σ
    read as int32 and folded to an order-preserving unsigned value in
    int64.  ``tables``: ``key_tables_device(vertices, device)``."""
    vde_up, radix, labels = (key_tables_device(vertices, paths.device)
                             if tables is None else tables)
    p, l = paths.shape
    sig = torch.zeros(p, dtype=torch.int64, device=paths.device)
    s32 = torch.zeros(p, dtype=torch.float32, device=paths.device)
    for j in range(l):
        col = paths[:, j].long()
        sig = (sig * radix + (labels[col] + 2)) & ((1 << 30) - 1)
        g = vde_up[col]
        row = g[:, 0]
        for k in range(1, g.shape[1]):
            row = row + g[:, k]
        s32 = s32 + row
    bits = (-s32).view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(bits >= (1 << 31), 0xFFFFFFFF - bits, bits | (1 << 31))
    return (sig << 32) | u


def _vertex_tables(vertices, device) -> dict:
    """Per-vertex tables with one sentinel row at index V (label -2,
    degree 0, zero embeddings) that pad rows gather through: the leaf
    test's labels, degrees and f64 vde, and the fold's outward-rounded
    f32 vde and x."""
    def put(a, fill):
        pad = np.full((1,) + a.shape[1:], fill, a.dtype)
        return torch.from_numpy(np.concatenate([a, pad])).to(device)

    return dict(
        labels=put(vertices.labels.astype(np.int32), -2),
        degrees=put(vertices.degrees.astype(np.int32), 0),
        vde=put(np.asarray(vertices.vde, np.float64), 0.0),
        vde_up=put(_outward(vertices.vde, True), 0.0),
        x_up=put(_outward(vertices.x, True), 0.0),
        x_dn=put(_outward(vertices.x, False), 0.0))


def permute_fold(paths: torch.Tensor, order: torch.Tensor, tables: dict,
                 block_size: int):
    """The sorted vid table and its block summaries (gnnpe_tpu's
    ``_compiled_permute_fold``, ROADMAP Queue B4), on the paths' device.

    vids int32[NB·B, L] are ``paths[order]`` padded with the sentinel
    vertex V; per block: max of vde_up, min of x_dn and max of x_up
    (f32 [NB, L·D], position-major) and max degree (int32 [NB, L]).
    Max and min select, so the summaries equal gnnpe_tpu's bit for bit,
    pad rows included."""
    p, l = paths.shape
    b = block_size
    v = tables["labels"].shape[0] - 1
    nb = -(-p // b)
    dev = paths.device
    vids = torch.full((nb * b, l), v, dtype=torch.int32, device=dev)
    torch.index_select(paths, 0, order, out=vids[:p])
    d = tables["vde_up"].shape[1]
    ub = torch.empty((nb, l * d), dtype=torch.float32, device=dev)
    llo, lhi = torch.empty_like(ub), torch.empty_like(ub)
    deg = torch.empty((nb, l), dtype=torch.int32, device=dev)
    for lo in range(0, nb, FOLD_BLOCKS):
        hi = min(lo + FOLD_BLOCKS, nb)
        rows = vids[lo * b:hi * b].long()
        for j in range(l):
            col, cs = rows[:, j], slice(j * d, (j + 1) * d)
            ub[lo:hi, cs] = tables["vde_up"][col].view(-1, b, d).amax(1)
            lhi[lo:hi, cs] = tables["x_up"][col].view(-1, b, d).amax(1)
            llo[lo:hi, cs] = tables["x_dn"][col].view(-1, b, d).amin(1)
            deg[lo:hi, j] = tables["degrees"][col].view(-1, b).amax(1)
    return vids, (ub, llo, lhi, deg)


def _check_fits(need: int, device, what: str) -> None:
    """Raise unless ``need`` bytes are free on ``device``; a table that
    does not fit would need the streamed mode, which is not ported.
    Callers count the tables they keep and the per-path temporaries, not
    the fixed-size ones (a fold step, the vertex tables), so ``need`` is
    a lower bound: a build that passes can still meet CUDA's own
    out-of-memory error, which raises too."""
    free = free_bytes(device)
    if need > free:
        raise MemoryError(
            f"{what} needs {need} B and {device} has {free} B free; an "
            "index past device memory needs the streamed mode (ROADMAP "
            "Queue A 9), which is not ported")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """``t`` in host memory as numpy: one copy into pinned memory from a
    CUDA tensor, a view of a CPU one."""
    if t.device.type == "cpu":
        return t.numpy()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h.numpy()


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
    the fields below and supply ``_prepare``, ``_phase1``, ``_prune``,
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

    def _range_prune(self, bmask, lo, hi) -> torch.Tensor:
        """``bmask`` kept only on the block columns [lo[i], hi[i]) of
        each row i (host int arrays)."""
        cols = torch.arange(bmask.shape[1], device=self.device)[None]
        return (bmask & (cols >= self._put(lo)[:, None])
                & (cols < self._put(hi)[:, None]))

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
        phase1 = int(bmask.any(0).sum())
        bmask = self._prune(q, bmask)
        sel = torch.nonzero(bmask.any(0)).squeeze(1)
        k = max(1, CHUNK_ELEMS // (q.rows * b * self.width))
        n_sel = sel.numel()
        self.last_stats = dict(blocks=nb, phase1=phase1, survived=n_sel,
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


class _PESearch(_PackedSearch):
    """What both PE modes share: the query rows, phase 1 over the block
    summaries (f64 in array mode; table mode's f32 widen to f64 exactly
    in each compare) and the vid lookups of the two unions.  A mode
    supplies ``d_vids``, ``_host_vids`` and ``_leaf_mask``."""

    def _prepare(self, query: PEQuery):
        rows = np.asarray(query.plan_rows, dtype=np.int64)
        t = query.pde
        vids = t.vids[rows]
        return SimpleNamespace(
            rows=len(rows), num_out=query.num_query_vertices,
            host_labels=t.labels[rows],
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

    def _prune(self, q, bmask: torch.Tensor) -> torch.Tensor:
        return bmask

    def _scatter(self, bitmap, q, qi, rows) -> None:
        bitmap[q.d_vids[qi].reshape(-1),
               self.d_vids[rows].long().reshape(-1)] = True

    def _extract(self, q, mask, rows) -> List[np.ndarray]:
        return extract_candidates(mask, self._host_vids[rows], q.vids,
                                  q.num_out)


class DevicePackedPESearch(_PESearch):
    """PE packed index resident on ``device`` in array mode, uploaded
    from a ``PackedDominanceIndex``: labels, degrees and vids int32[P,
    L] and pde f64[P, L·D] per entry, and f64 block summaries."""

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

    def _leaf_mask(self, q, rows: torch.Tensor) -> torch.Tensor:
        return pe_mask_exact(self.d_labels[rows], self.d_degrees[rows],
                             self.d_pde[rows], q.labels, q.degrees, q.thresh)


class TablePESearch(_PESearch):
    """PE packed index resident on ``device`` in table mode, built there
    by ``build_from_paths`` or read by ``load``: vids int32[NB·B, L] per
    entry; the per-vertex tables ``t_labels``, ``t_degrees`` and
    ``t_vde`` (f64) with a sentinel row at V, through which the leaf
    test gathers; f32 block summaries; and the per-block signature
    ranges of the sort key, which prune blocks after phase 1."""

    def __init__(self, vertices, tables, vids, host_vids, summaries,
                 sig_first, sig_last, sig_radix, num_entries, block_size,
                 base_epsilon: float = EPSILON):
        self.device = vids.device
        self.base_epsilon = base_epsilon
        self.block_size = block_size
        self.num_entries = num_entries
        self.num_blocks = summaries[0].shape[0]
        self.width = summaries[0].shape[1]
        self.num_vertices = vertices.num_vertices
        self.d_vids = vids
        self.t_labels = tables["labels"]
        self.t_degrees = tables["degrees"]
        self.t_vde = tables["vde"]
        self.b_ub, self.b_llo, self.b_lhi, self.b_deg = summaries
        self._host_vids = host_vids
        self._blk_sig_first = sig_first
        self._blk_sig_last = sig_last
        self._sig_radix = sig_radix
        self.build_phase_ms = None
        self.last_stats = None

    @classmethod
    def build_from_paths(cls, paths, vertices, device,
                         block_size: int = 512,
                         base_epsilon: float = EPSILON) -> "TablePESearch":
        """The index built on ``device`` (gnnpe_tpu's
        ``DevicePackedPESearch.build_from_paths``, resident).

        paths: int32[P, L], numpy or a tensor (on ``device`` it is used
        in place); vertices: the f64 ``VertexEmbeddings``.  The
        composite sort key is sorted stably with ``torch.sort`` (the
        permutation of numpy's stable argsort), the vid table is
        permuted and folded into block summaries, and one copy of the
        sorted table comes back for the host union and ``save``.  Stage
        times (ms, the device synchronised at each edge) land in
        ``build_phase_ms``.  Raises ``MemoryError`` when the build does
        not fit ``device``."""
        device = as_device(device)
        if block_size < 1:
            raise ValueError(f"block_size must be positive: {block_size}")
        p, l = paths.shape
        nb = -(-p // block_size)
        on_device = (isinstance(paths, torch.Tensor)
                     and paths.device == device)
        _check_fits(nb * block_size * l * 4 + p * BUILD_BYTES_PER_PATH
                    + (0 if on_device else p * l * 4),
                    device, f"a table-mode build of {p} paths")
        t = StageTimer(device)
        with t.stage("tables"):
            tables = _vertex_tables(vertices, device)
        with t.stage("upload"):
            paths = torch.as_tensor(paths, dtype=torch.int32, device=device)
        with t.stage("key"):
            key = composite_sort_key_device(
                paths, vertices, (tables["vde_up"], sig_radix_of(vertices),
                                  tables["labels"].long()))
        with t.stage("sort"):
            key, order = torch.sort(key, stable=True)
        with t.stage("permute_fold"):
            vids, summaries = permute_fold(paths, order, tables, block_size)
            del order
        with t.stage("sig_ranges"):
            sig = key >> 32
            first = torch.arange(nb, device=device) * block_size
            last = torch.clamp(first + block_size, max=p) - 1
            sig_first, sig_last = sig[first].cpu().numpy(), \
                sig[last].cpu().numpy()
            del key, sig
        with t.stage("d2h"):
            host_vids = _host_copy(vids)
        self = cls(vertices, tables, vids, host_vids, summaries, sig_first,
                   sig_last, sig_radix_of(vertices), p, block_size,
                   base_epsilon)
        self.build_phase_ms = t.times_ms
        return self

    def save(self, path: str) -> None:
        """Write the index in gnnpe_tpu's npz format (its ``save``): the
        sorted vid table, the f32 summaries, the signature ranges and
        ``meta`` = [entries, block size, blocks, blocks per shard,
        streamed, signature radix, sidecar, L].  A table above
        ``SIDECAR_BYTES`` goes raw to ``<path>.vids.bin``.  The
        per-vertex tables are not stored: ``load`` rebuilds them from
        the embeddings."""
        hv = self._host_vids
        big = hv.nbytes > SIDECAR_BYTES
        if big:
            step = max(1, (1 << 26) // hv.shape[1])
            with open(path + ".vids.bin", "wb") as f:
                for lo in range(0, len(hv), step):
                    f.write(np.ascontiguousarray(hv[lo:lo + step]).tobytes())
        np.savez(path,
                 blk_ub=self.b_ub.cpu().numpy(),
                 blk_llo=self.b_llo.cpu().numpy(),
                 blk_lhi=self.b_lhi.cpu().numpy(),
                 blk_deg=self.b_deg.cpu().numpy(),
                 blk_sig_first=self._blk_sig_first,
                 blk_sig_last=self._blk_sig_last,
                 meta=np.array([self.num_entries, self.block_size,
                                self.num_blocks, self.num_blocks, 0,
                                self._sig_radix, int(big), hv.shape[1]],
                               np.int64),
                 host_vids=(np.zeros((0, hv.shape[1]), np.int32) if big
                            else hv))

    @classmethod
    def load(cls, path: str, vertices, device,
             base_epsilon: float = EPSILON) -> "TablePESearch":
        """The index from a file ``save`` wrote, here or in gnnpe_tpu
        (with any number of shards: its pad blocks carry the signature
        range 2^62 and never survive).  ``vertices`` are the embeddings
        the index was built from.  A streamed index raises
        ``NotImplementedError``; one that does not fit raises
        ``MemoryError``."""
        device = as_device(device)
        with np.load(path) as z:
            meta = [int(x) for x in z["meta"]]
            if meta[4]:
                raise NotImplementedError(
                    f"{path} holds a streamed index; the streamed mode "
                    "(ROADMAP Queue A 9) is not ported")
            arrays = {k: z[k] for k in z.files}
        p, b, sig_radix = meta[0], meta[1], meta[5]
        if len(meta) > 6 and meta[6]:
            hv = np.fromfile(path + ".vids.bin", dtype=np.int32).reshape(
                -1, meta[7])
        else:
            hv = arrays["host_vids"]
        nb = len(arrays["blk_ub"])
        if len(hv) != nb * b:
            raise ValueError(f"{path}: {len(hv)} vid rows for {nb} blocks "
                             f"of {b}")
        _check_fits(hv.nbytes, device, f"loading {path}")
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(vertices, _vertex_tables(vertices, device), put(hv), hv,
                   tuple(put(arrays[k]) for k in ("blk_ub", "blk_llo",
                                                  "blk_lhi", "blk_deg")),
                   arrays["blk_sig_first"], arrays["blk_sig_last"],
                   sig_radix, p, b, base_epsilon)

    def _prune(self, q, bmask: torch.Tensor) -> torch.Tensor:
        """A row's exact-label matches lie in the blocks whose signature
        range holds its signature (conservative: equal labels give equal
        signatures)."""
        qsig = path_sig(q.host_labels, self._sig_radix)
        return self._range_prune(
            bmask, np.searchsorted(self._blk_sig_last, qsig, side="left"),
            np.searchsorted(self._blk_sig_first, qsig, side="right"))

    def _leaf_mask(self, q, rows: torch.Tensor) -> torch.Tensor:
        vid = self.d_vids[rows].long()
        return pe_mask_exact(self.t_labels[vid], self.t_degrees[vid],
                             self.t_vde[vid].reshape(len(rows), -1),
                             q.labels, q.degrees, q.thresh)


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
        return SimpleNamespace(
            rows=len(query.labels), num_out=len(query.labels),
            host_labels=np.asarray(query.labels, dtype=np.int64),
            labels=self._put(query.labels),
            degrees=self._put(query.degrees),
            glo=self._put(eps_threshold(query.group[:, 0, :],
                                        self.base_epsilon)),
            llo=self._put(query.label_group[:, 0, :]),
            lhi=self._put(query.label_group[:, 1, :]))

    def _phase1(self, q, lo: int, hi: int) -> torch.Tensor:
        dom = (self.b_gub[None, lo:hi] >= q.glo[:, None]).all(-1)
        overlap = ((self.b_lhi[None, lo:hi] >= q.llo[:, None]) &
                   (q.lhi[:, None] >= self.b_llo[None, lo:hi])).all(-1)
        deg = q.degrees[:, None] <= self.b_deg[None, lo:hi]
        return dom & overlap & deg

    def _prune(self, q, bmask: torch.Tensor) -> torch.Tensor:
        """A query vertex's exact-label matches lie in its label's run
        of blocks."""
        lab = q.host_labels
        return self._range_prune(
            bmask, np.searchsorted(self._blk_lab_last, lab, side="left"),
            np.searchsorted(self._blk_lab_first, lab, side="right"))

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
