"""The port's streamed PE index (``StreamedPESearch``, the leaf-block
cache ``DeviceChunkCache``, ``auto_resident``) against gnnpe_tpu's
streamed mode on a 1-device CPU mesh and against the port's own table
mode.  Every comparison is exact (tolerance 0): vid tables, f32
summaries, signature ranges and candidate arrays.

gnnpe_tpu pads its streamed layout to a multiple of 32 blocks; the
port does not, so arrays are compared over the port's blocks and
gnnpe_tpu's pad blocks are checked to be pads.

This file imports no JAX at module level (the mesh is made inside a
fixture), so its CUDA test also runs on a machine without JAX:
    python -m pytest --noconftest -q -m cuda tests/test_torch_streamed.py
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu.embed.pde import gen_query_pde_table
from gnnpe_tpu.embed.vde import gen_vde
from gnnpe_tpu.graph.partition import degree_sorted_nodes
from gnnpe_tpu.index import device_packed as jax_dp
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.index.device_packed import (DeviceChunkCache, PEQuery,
                                                 StreamedPESearch,
                                                 TablePESearch,
                                                 auto_resident)

BLOCK = 16


def _queries(g, seeds, size=6):
    out = []
    for s in seeds:
        qg = sample_query(g, size, seed=s)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices), 3,
                                dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde(qg, 2), qp)
        out.append((q_pde, greedy_path_cover(qp, weight, qg.num_vertices),
                    qg.num_vertices))
    return out


@pytest.fixture(scope="module")
def case():
    g = powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), 3, dedup=True)
    vertices = gen_vde(g, 2)
    table = TablePESearch.build_from_paths(paths, vertices, "cpu",
                                           block_size=BLOCK)
    queries = _queries(g, range(4))
    want = [table.search(PEQuery(*q)) for q in queries]
    assert sum(len(c) for w in want for c in w) > 0
    return paths, vertices, table, queries, want


@pytest.fixture(scope="module")
def ref(case):
    """gnnpe_tpu's streamed index of the same paths."""
    from gnnpe_tpu.parallel.mesh import make_mesh
    paths, vertices = case[:2]
    mesh = make_mesh(1, axes=("graph",), shape=(1,))
    return jax_dp.DevicePackedPESearch.build_from_paths(
        mesh, paths, vertices, block_size=BLOCK, resident=False)


def _streamed(case, **kw):
    paths, vertices = case[:2]
    return StreamedPESearch.build_from_paths(paths, vertices, "cpu",
                                             block_size=BLOCK, **kw)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _block_bytes(case):
    return BLOCK * case[0].shape[1] * 4


# -- build ---------------------------------------------------------------
@pytest.mark.parametrize("block", [16, 64, 512])
def test_streamed_build_equals_jax_and_table(case, block):
    from gnnpe_tpu.parallel.mesh import make_mesh
    paths, vertices = case[:2]
    p = len(paths)
    nb = -(-p // block)
    port = StreamedPESearch.build_from_paths(paths, vertices, "cpu",
                                             block_size=block)
    table = TablePESearch.build_from_paths(paths, vertices, "cpu",
                                           block_size=block)
    theirs = jax_dp.DevicePackedPESearch.build_from_paths(
        make_mesh(1, axes=("graph",), shape=(1,)), paths, vertices,
        block_size=block, resident=False)
    assert isinstance(port, StreamedPESearch) and port.num_blocks == nb
    assert not hasattr(port, "d_vids")
    assert port._host_vids.dtype == np.int32
    assert np.array_equal(port._host_vids, table._host_vids)
    assert np.array_equal(port._host_vids, theirs._host_vids[:nb * block])
    # What gnnpe_tpu has beyond the port's blocks is padding.
    assert (theirs._host_vids[nb * block:] == vertices.num_vertices).all()
    assert (theirs._blk_sig_first[nb:] == 1 << 62).all()
    for mine, their in (("b_ub", theirs.b_ub3[0]), ("b_llo", theirs.b_llo3[0]),
                        ("b_lhi", theirs.b_lhi3[0]), ("b_deg", theirs.b_deg)):
        got = getattr(port, mine)
        assert torch.equal(got, getattr(table, mine)), mine
        want = np.asarray(their)[:nb]
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want), mine
    for name in ("_blk_sig_first", "_blk_sig_last"):
        assert np.array_equal(getattr(port, name), getattr(table, name))
        assert np.array_equal(getattr(port, name), getattr(theirs, name)[:nb])
    assert set(port.build_phase_ms) >= {"host_sort", "host_vids",
                                        "host_fold"}


def test_streamed_build_takes_a_tensor_and_no_paths(case):
    paths, vertices = case[:2]
    a = StreamedPESearch.build_from_paths(torch.from_numpy(paths[:999]),
                                          vertices, "cpu", block_size=BLOCK)
    b = StreamedPESearch.build_from_paths(paths[:999], vertices, "cpu",
                                          block_size=BLOCK)
    assert np.array_equal(a._host_vids, b._host_vids)
    empty = StreamedPESearch.build_from_paths(paths[:0], vertices, "cpu",
                                              block_size=BLOCK)
    q = case[3][0]
    assert empty.num_blocks == 0
    assert [len(c) for c in empty.search(PEQuery(*q))] == [0] * q[2]
    with pytest.raises(ValueError):
        StreamedPESearch.build_from_paths(paths, vertices, "cpu",
                                          block_size=0)


# -- search --------------------------------------------------------------
@pytest.mark.parametrize("ref_union", ["host", "device"])
def test_streamed_search_uncached_parity(case, ref, ref_union, monkeypatch):
    queries, want = case[3:]
    port = _streamed(case, cache=False)
    monkeypatch.setenv("GNNPE_STREAM_CACHE", "0")
    ref._cache = None
    for q, w in zip(queries, want):
        got = port.search(PEQuery(*q))
        _same(got, w)
        _same(got, ref.search(*q, union=ref_union))
        st = port.last_stats
        assert "cache_hits" not in st and "cache_hits" not in ref.last_stats
        assert {k: st[k] for k in ("phase1", "survived")} == \
            {k: ref.last_stats[k] for k in ("phase1", "survived")}
        # Every surviving block was uploaded, whole.
        assert st["uploaded_bytes"] == st["survived"] * _block_bytes(case)
    assert port._cache is None and "cache_pool" not in port.resident_tensors()


@pytest.mark.parametrize("ref_union", ["host", "device"])
def test_streamed_cache_evicts_and_hits(case, ref, ref_union, monkeypatch):
    """A pool that holds the largest query's blocks and not all queries'
    together: misses, then evictions across queries, then hits on a
    repeat; capacity as gnnpe_tpu's for the same budget."""
    queries, want = case[3:]
    probe = _streamed(case, cache=False)
    survived = []
    for q in queries:
        probe.search(PEQuery(*q))
        survived.append(probe.last_stats["survived"])
    cap = max(max(survived), 2 * ref.k_chunk)
    assert cap < sum(survived), "fixture too small: nothing would evict"
    budget = cap * _block_bytes(case)
    monkeypatch.setenv("GNNPE_CACHE_BYTES", str(budget))
    monkeypatch.delenv("GNNPE_STREAM_CACHE", raising=False)
    ref._cache = None
    port = _streamed(case, cache_bytes=budget)
    for i, (q, w) in enumerate(zip(queries, want)):
        got = port.search(PEQuery(*q))
        _same(got, w)
        _same(got, ref.search(*q, union=ref_union))
        st = port.last_stats
        assert st["cache_misses"] > 0
        assert st["cache_hits"] + st["cache_misses"] == st["survived"]
        assert st["uploaded_bytes"] == st["cache_misses"] * _block_bytes(case)
        if i == 0:
            assert st["cache_hits"] == 0
            assert ref.last_stats["cache_misses"] > 0
    cache = port._cache
    assert isinstance(cache, DeviceChunkCache)
    assert cache.capacity == cap == ref._cache.capacity
    assert cache.evictions > 0 and len(cache.map) == cap
    assert cache.buf.shape == (cap * BLOCK, 3)
    assert port.resident_tensors()["cache_pool"] is cache.buf
    # The last query again: its blocks are the most recently used.
    _same(port.search(PEQuery(*queries[-1])), want[-1])
    assert port.last_stats["cache_misses"] == 0
    assert port.last_stats["cache_hits"] == survived[-1]
    assert port.last_stats["uploaded_bytes"] == 0
    ref.search(*queries[-1], union=ref_union)
    assert ref.last_stats["cache_hits"] > 0
    # Every pooled block holds its host rows.
    pool = cache.buf.view(cap, BLOCK, 3).numpy()
    host = port._host_vids.reshape(-1, BLOCK, 3)
    for blk, slot in cache.map.items():
        assert np.array_equal(pool[slot], host[blk])


@pytest.mark.parametrize("pool_blocks", [5, 1])
def test_small_pool_shrinks_the_chunk(case, pool_blocks):
    """A pool smaller than a query's surviving blocks is not switched
    off: the chunk shrinks to the pool, whose blocks are protected while
    their chunk is read; down to a pool of one block, the smallest that
    holds a block."""
    queries, want = case[3:]
    port = _streamed(case, cache_bytes=pool_blocks * _block_bytes(case))
    for q, w in zip(queries, want):
        _same(port.search(PEQuery(*q)), w)
        st = port.last_stats
        assert st["survived"] > 5
        assert st["chunks"] == -(-st["survived"] // pool_blocks)
    assert port._cache.capacity == pool_blocks
    assert port._cache.evictions > 0
    with pytest.raises(ValueError, match="holds no block"):
        _streamed(case, cache_bytes=_block_bytes(case) - 1).search(
            PEQuery(*queries[0]))


def test_staging_ring_reuses_its_buffers(case, monkeypatch):
    """Pieces smaller than a chunk, so that every upload goes round the
    ring of staging buffers several times."""
    queries, want = case[3:]
    monkeypatch.setattr(device_packed, "STAGING_ROWS", 3 * BLOCK)
    for kw in (dict(cache=False), dict(cache_bytes=1 << 20)):
        port = _streamed(case, **kw)
        assert port._ring.blocks == 3
        for q, w in zip(queries, want):
            _same(port.search(PEQuery(*q)), w)
            assert port.last_stats["survived"] > 3 * device_packed.STAGING_RING


@pytest.mark.parametrize("order", ["popular", "index"])
def test_prefill_cache(case, ref, order, monkeypatch):
    """With a budget that holds the index, a prefilled pool answers
    with hits only; prefilled blocks count as neither hits nor misses."""
    queries, want = case[3:]
    budget = 2 * case[2]._host_vids.nbytes
    port = _streamed(case, cache_bytes=budget)
    loaded = port.prefill_cache(order=order)
    cache = port._cache
    assert loaded == port.num_blocks == cache.capacity
    assert cache.hits == 0 and cache.misses == 0
    monkeypatch.setenv("GNNPE_CACHE_BYTES", str(budget))
    monkeypatch.delenv("GNNPE_STREAM_CACHE", raising=False)
    ref._cache = None
    if order == "popular":     # gnnpe_tpu's index order counts pad blocks
        assert ref.prefill_cache(order=order) == loaded
    for q, w in zip(queries, want):
        _same(port.search(PEQuery(*q)), w)
        assert port.last_stats["cache_misses"] == 0
        assert port.last_stats["cache_hits"] == port.last_stats["survived"]
    assert port.prefill_cache(order=order) == 0        # nothing is missing
    assert _streamed(case, cache=False).prefill_cache() == 0
    with pytest.raises(ValueError):
        port.prefill_cache(order="random")


def test_prefill_order_and_time_limit(case, monkeypatch):
    port = _streamed(case, cache_bytes=40 * _block_bytes(case))
    assert port.prefill_cache(order="index") == 40
    assert sorted(port._cache.map) == list(range(40))
    popular = _streamed(case, cache_bytes=40 * _block_bytes(case))
    assert popular.prefill_cache(order="popular") == 40
    # The blocks of the longest runs of one signature.
    sig = popular._blk_sig_first
    runs = {s: int((sig == s).sum()) for s in np.unique(sig)}
    longest = sorted(runs.values(), reverse=True)
    got = sorted((runs[sig[b]] for b in popular._cache.map), reverse=True)
    assert got[0] == longest[0] and min(got) >= longest[
        np.searchsorted(np.cumsum(longest), 40)]
    # A time limit already passed stops after the first step.
    monkeypatch.setattr(device_packed, "PREFILL_BLOCKS", 8)
    timed = _streamed(case, cache_bytes=40 * _block_bytes(case))
    assert timed.prefill_cache(max_seconds=-1.0, order="index") == 8


def test_degrade_cache(case):
    queries, want = case[3:]
    budget = 64 * _block_bytes(case)
    port = _streamed(case, cache_bytes=budget)
    _same(port.search(PEQuery(*queries[0])), want[0])
    assert port._cache.capacity == 64
    assert port.degrade_cache(0.5) == budget / 2
    assert port._cache is None and "cache_pool" not in port.resident_tensors()
    for q, w in zip(queries, want):
        _same(port.search(PEQuery(*q)), w)
    assert port._cache.capacity == 32
    assert port.degrade_cache(0.25) == budget / 8


def test_default_cache_budget_is_a_share_of_free_memory(case, monkeypatch):
    queries, want = case[3:]
    free = 100 * _block_bytes(case)
    monkeypatch.setattr(device_packed, "free_bytes", lambda device: free)
    port = _streamed(case)
    _same(port.search(PEQuery(*queries[0])), want[0])
    assert port._cache.capacity == int(device_packed.CACHE_SHARE * 100)
    assert port.degrade_cache(0.5) == device_packed.CACHE_SHARE * free / 2
    fresh = _streamed(case)
    assert fresh.degrade_cache(0.5) == device_packed.CACHE_SHARE * free / 2


def test_auto_resident_both_sides_of_a_budget(case, monkeypatch):
    paths, vertices = case[:2]
    p, l = paths.shape
    table_bytes = -(-p // 512) * 512 * l * 4
    assert auto_resident(p, l, 512, "cpu", budget_bytes=table_bytes)
    assert not auto_resident(p, l, 512, "cpu", budget_bytes=table_bytes - 1)
    # None: a share of the device's free memory.
    share = device_packed.RESIDENT_SHARE
    monkeypatch.setattr(device_packed, "free_bytes",
                        lambda device: int(table_bytes / share) + 1)
    assert auto_resident(p, l, 512, "cpu")
    monkeypatch.setattr(device_packed, "free_bytes",
                        lambda device: int(table_bytes / share) - 8)
    assert not auto_resident(p, l, 512, "cpu")
    # gnnpe_tpu pads the path count to a power of two, so the two agree
    # away from the boundary.
    for scale, want in ((4.0, True), (0.25, False)):
        monkeypatch.setenv("GNNPE_HBM_BYTES", str(scale * table_bytes / share))
        assert jax_dp.auto_resident(p, l, 512, vertices.num_vertices,
                                    1) == want
        assert auto_resident(p, l, 512, "cpu",
                             budget_bytes=scale * table_bytes) == want


def test_close_frees_and_a_closed_search_raises(case):
    queries = case[3]
    port = _streamed(case, cache_bytes=1 << 20)
    port.search(PEQuery(*queries[0]))
    port.close()
    assert port.resident_tensors() == {} and port._host_vids is None
    with pytest.raises(RuntimeError, match="closed"):
        port.search(PEQuery(*queries[0]))
    with pytest.raises(RuntimeError, match="closed"):
        port.prefill_cache()
    port.close()                                   # twice is harmless


def test_cuda_device_raises_without_cuda(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths, vertices = case[:2]
    with pytest.raises(RuntimeError):
        StreamedPESearch.build_from_paths(paths, vertices, "cuda")
    with pytest.raises(RuntimeError):
        auto_resident(len(paths), 3, 512, "cuda")


@pytest.mark.cuda
def test_streamed_search_and_preverify_spmm_on_cuda():
    """On the card: the streamed search through the pool (misses, then
    evictions, then hits) and through per-chunk uploads equals table
    mode, and kernel A1 at the pre-verify shape (f32,
    D = 8, a 0/1 matrix) equals its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from gnnpe_tpu_torch.graph.csr import to_device
    from gnnpe_tpu_torch.match.preverify import semijoin_prune
    from gnnpe_tpu_torch.ops import spmm
    dev = torch.device("cuda")
    g = powerlaw_graph(20000, 80000, 12, seed=0, max_degree=300)
    paths, _ = enumerate_paths(g, degree_sorted_nodes(g), 3, dedup=True)
    vertices = gen_vde(g, 2)
    queries = _queries(g, range(4), size=8)
    table = TablePESearch.build_from_paths(paths, vertices, dev,
                                           block_size=64)
    plain = StreamedPESearch.build_from_paths(paths, vertices, dev,
                                              block_size=64, cache=False)
    assert np.array_equal(plain._host_vids, table._host_vids)
    survived = []
    for q in queries:
        plain.search(PEQuery(*q))
        survived.append(plain.last_stats["survived"])
    # A pool that holds any one query's blocks and not all queries'.
    assert max(survived) < sum(survived)
    pooled = StreamedPESearch.build_from_paths(
        paths, vertices, dev, block_size=64,
        cache_bytes=max(survived) * 64 * 3 * 4)
    for q in queries:
        want = table.search(PEQuery(*q))
        _same(pooled.search(PEQuery(*q)), want)
        _same(plain.search(PEQuery(*q)), want)
        # Again at once: every block is in the pool.
        _same(pooled.search(PEQuery(*q)), want)
        assert pooled.last_stats["cache_misses"] == 0
        assert pooled.last_stats["uploaded_bytes"] == 0
    cache = pooled._cache
    assert cache.buf.is_cuda and cache.misses > 0 and cache.hits > 0
    assert cache.evictions > 0
    off, nbr = to_device(g, dev)[:2]
    c = torch.from_numpy((np.random.RandomState(0).rand(
        g.num_vertices, 8) < 0.1).astype(np.float32)).to(dev)
    before = spmm.LAUNCHES
    got = spmm.neighbor_sum(off, nbr, c)
    torch.cuda.synchronize()
    assert spmm.LAUNCHES == before + 1
    assert torch.equal(got, spmm.neighbor_sum_plain(off, nbr, c))
    q = sample_query(g, 8, seed=0)
    cands = table.search(PEQuery(*queries[0]))
    _same(semijoin_prune(g, q, cands, dev, iters=3),
          semijoin_prune(g, q, cands, "cpu", iters=3))
