"""The port's bucketed out-of-core streamed build
(gnnpe_tpu_torch/index/bucket_build.py, and the streamed branch of
paths/pipeline.py) against gnnpe_tpu's on a 1-device CPU mesh, and
against the port's monolithic streamed build and its table build.  The
contract is exact: the concatenated sorted buckets equal the global
stable argsort row for row, so vid tables, f32 summaries and signature
ranges are compared with tolerance 0.  gnnpe_tpu pads its layout to a
multiple of 32 blocks; arrays are compared over the port's blocks."""

import os

import numpy as np
import pytest
import torch

from gnnpe_tpu.embed.pde import gen_query_pde_table
from gnnpe_tpu.embed.vde import gen_vde
from gnnpe_tpu.graph.partition import degree_sorted_nodes
from gnnpe_tpu.index import bucket_build as jax_bb
from gnnpe_tpu.index import device_packed as jax_dp
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu.paths import pipeline as jax_pipeline
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu_torch.index import bucket_build
from gnnpe_tpu_torch.index.bucket_build import (BucketSpill,
                                                build_streamed_bucketed,
                                                build_streamed_from_chunks,
                                                sample_key_boundaries)
from gnnpe_tpu_torch.index.device_packed import (PEQuery, StreamedPESearch,
                                                 TablePESearch,
                                                 composite_sort_key)
from gnnpe_tpu_torch.paths import device_enumerate, pipeline

BLOCK = 64


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, axes=("graph",), shape=(1,))


@pytest.fixture(scope="module")
def case():
    g = powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)
    order = degree_sorted_nodes(g)
    paths, _ = enumerate_paths(g, order, 3, dedup=True)
    vertices = gen_vde(g, 2)
    mono = StreamedPESearch.build_from_paths(paths, vertices, "cpu",
                                             block_size=BLOCK)
    return g, order, paths, vertices, mono


@pytest.fixture(scope="module")
def ties():
    """One label and few distinct degrees: most sort keys are shared by
    many paths, so the order within a key is the order of arrival."""
    g = powerlaw_graph(400, 1200, 1, seed=3, max_degree=12)
    order = degree_sorted_nodes(g)
    paths, _ = enumerate_paths(g, order, 3, dedup=True)
    vertices = gen_vde(g, 2)
    keys = composite_sort_key(paths, vertices)
    assert len(np.unique(keys)) < len(keys) // 4
    return g, order, paths, vertices, keys


def _chunks(paths, sizes=(1000, 1, 37000, 13, 50000)):
    """``paths`` cut into uneven pieces, in order."""
    lo, i = 0, 0
    while lo < len(paths):
        n = sizes[i % len(sizes)]
        yield paths[lo:lo + n]
        lo, i = lo + n, i + 1


def _feed(spill, paths, vertices):
    for rows in _chunks(paths):
        spill.append(spill.partition(rows,
                                     composite_sort_key(rows, vertices)))
    return spill


def _assert_same_index(got, want):
    """Vid table, summaries and signature ranges of two of the port's
    indexes, exactly."""
    assert got.num_blocks == want.num_blocks
    assert got.num_entries == want.num_entries
    assert np.array_equal(np.asarray(got._host_vids), want._host_vids)
    for name in ("b_ub", "b_llo", "b_lhi", "b_deg"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("_blk_sig_first", "_blk_sig_last"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def _assert_same_as_jax(port, theirs):
    nb, b = port.num_blocks, port.block_size
    assert np.array_equal(np.asarray(port._host_vids),
                          np.asarray(theirs._host_vids)[:nb * b])
    for mine, their in (("b_ub", theirs.b_ub3[0]), ("b_llo", theirs.b_llo3[0]),
                        ("b_lhi", theirs.b_lhi3[0]), ("b_deg", theirs.b_deg)):
        want = np.asarray(their)[:nb]
        got = getattr(port, mine).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), mine
    assert np.array_equal(port._blk_sig_first, theirs._blk_sig_first[:nb])
    assert np.array_equal(port._blk_sig_last, theirs._blk_sig_last[:nb])


def _quantile_bounds(keys, n_buckets):
    k = np.sort(keys)
    return k[len(k) * np.arange(1, n_buckets) // n_buckets]


def test_host_ram_and_bucket_count():
    assert bucket_build.host_ram_bytes() == jax_bb.host_ram_bytes() > 1e8
    assert [bucket_build.num_buckets(p) for p in
            (1, 10**8, 32_000_000 * 2000)] == [8, 8, 1024]
    assert bucket_build.num_buckets(32_000_000 * 20) == 21


def test_sample_key_boundaries_equal_jax(case):
    g, order, _, vertices, _ = case
    for n_buckets, starts in ((8, 8192), (5, 300)):
        got = sample_key_boundaries(g, order, 3, vertices, n_buckets,
                                    sample_starts=starts, seed=1)
        want = jax_bb.sample_key_boundaries(g, order, 3, vertices, n_buckets,
                                            sample_starts=starts, seed=1)
        assert got.dtype == np.int64 and len(got) == n_buckets - 1
        assert np.array_equal(got, want)
    lonely = powerlaw_graph(50, 0, 2, seed=0)
    assert len(sample_key_boundaries(lonely, np.arange(50), 3,
                                     gen_vde(lonely, 2), 4)) == 0


@pytest.mark.parametrize("disk", [False, True], ids=["ram", "disk"])
@pytest.mark.parametrize("n_buckets", [1, 3, 8, 37])
def test_bucketed_equals_monolithic_table_and_jax(case, mesh, tmp_path, disk,
                                                  n_buckets):
    _, _, paths, vertices, mono = case
    bounds = _quantile_bounds(composite_sort_key(paths, vertices), n_buckets)
    spill_dir = str(tmp_path / "spill") if disk else None
    table_path = str(tmp_path / "table.bin") if disk else None
    spill = _feed(BucketSpill(bounds, 3, spill_dir), paths, vertices)
    assert spill.total == len(paths) and spill.nb == n_buckets
    assert (spill.spilled_bytes > 0) == disk
    # A block straddles a bucket boundary (unless there is one bucket).
    cuts = np.cumsum(spill.counts)[:-1]
    assert n_buckets == 1 or (cuts % BLOCK != 0).any()
    port = build_streamed_bucketed(spill, vertices, 3, "cpu",
                                   block_size=BLOCK, table_path=table_path,
                                   workers=3)
    assert isinstance(port, StreamedPESearch)
    assert isinstance(port._host_vids, np.memmap) == disk
    _assert_same_index(port, mono)
    table = TablePESearch.build_from_paths(paths, vertices, "cpu",
                                           block_size=BLOCK)
    _assert_same_index(port, table)
    jdir = str(tmp_path / "jspill") if disk else None
    jspill = _feed(jax_bb.BucketSpill(bounds, 3, jdir), paths, vertices)
    assert np.array_equal(jspill.counts, spill.counts)
    theirs = jax_bb.build_streamed_bucketed(
        mesh, jspill, vertices, 3, block_size=BLOCK,
        table_path=str(tmp_path / "jtable.bin") if disk else None)
    _assert_same_as_jax(port, theirs)
    assert set(port.build_phase_ms) == set(theirs.build_phase_ms)
    if disk:
        # Every bucket's files went as its segment was written; the
        # index owns the table file and close() unlinks it.
        assert os.listdir(spill_dir) == []
        assert os.path.exists(table_path)
        port.close()
        assert not os.path.exists(table_path)
        theirs.close()


@pytest.mark.parametrize("disk", [False, True], ids=["ram", "disk"])
def test_heavy_ties_and_boundaries_on_keys(ties, tmp_path, disk):
    """Boundaries equal to keys that many paths share: equal keys land
    in one bucket in arrival order, or the table would differ from the
    stable argsort's."""
    _, _, paths, vertices, keys = ties
    uniq, counts = np.unique(keys, return_counts=True)
    heavy = np.sort(uniq[np.argsort(-counts)[:6]])
    spill = BucketSpill(heavy, 3, str(tmp_path / "s") if disk else None)
    for rows in _chunks(paths, sizes=(7, 300, 1, 999)):
        part = spill.partition(rows, composite_sort_key(rows, vertices))
        # A key equal to a boundary goes above it.
        for b in range(spill.nb - 1):
            assert (part[1][part[2][b]:part[2][b + 1]] < heavy[b]).all()
        spill.append(part)
    port = build_streamed_bucketed(spill, vertices, 3, "cpu", block_size=16)
    want = paths[np.argsort(keys, kind="stable")]
    assert np.array_equal(port._host_vids[:len(paths)], want)
    _assert_same_index(port, StreamedPESearch.build_from_paths(
        paths, vertices, "cpu", block_size=16))
    _assert_same_index(port, TablePESearch.build_from_paths(
        paths, vertices, "cpu", block_size=16))


def test_empty_buckets_and_a_short_index(case):
    """Boundaries outside the keys' range leave buckets empty, and fewer
    paths than one block make a single partial block."""
    _, _, paths, vertices, _ = case
    few = paths[:40]
    spill = _feed(BucketSpill(np.array([0, 1, 1 << 62], np.int64), 3), few,
                  vertices)
    assert (spill.counts == 0).sum() == 3
    port = build_streamed_bucketed(spill, vertices, 3, "cpu",
                                   block_size=BLOCK)
    _assert_same_index(port, StreamedPESearch.build_from_paths(
        few, vertices, "cpu", block_size=BLOCK))
    assert port.num_blocks == 1


@pytest.mark.parametrize("disk", [False, True], ids=["ram", "disk"])
def test_build_streamed_from_chunks(case, tmp_path, disk):
    g, order, paths, vertices, mono = case
    spill_dir = str(tmp_path / "spill") if disk else None
    idx, timings = build_streamed_from_chunks(
        _chunks(paths), len(paths), g, order, 3, vertices, "cpu",
        block_size=BLOCK, spill_dir=spill_dir, workers=3,
        cache_bytes=1 << 20)
    _assert_same_index(idx, mono)
    assert idx.cache_bytes == 1 << 20
    assert timings["mode"] == "streamed" and timings["n_buckets"] == 8
    assert timings["table_memmap"] == disk
    assert (timings["spilled_bytes"] == len(paths) * (3 * 4 + 8)) == disk
    if disk:
        # The build's own directory, holding the table alone.
        (own,) = os.listdir(spill_dir)
        assert own.startswith("spill_")
        assert idx._owned_dir == os.path.join(spill_dir, own)
        assert os.listdir(idx._owned_dir) == ["leaf_table.bin"]
        idx.close()
        assert os.listdir(spill_dir) == []
    with pytest.raises(ValueError, match="announced"):
        build_streamed_from_chunks(_chunks(paths[:500]), 501, g, order, 3,
                                   vertices, "cpu")


def test_many_workers_on_shared_tables(case, tmp_path):
    """More threads than cores, switching often, over 37 disk buckets:
    every bucket job writes its own rows of the shared table, summaries
    and signature ranges, so a lost or misplaced write would break the
    equality with the build made in one piece."""
    import sys
    g, order, paths, vertices, mono = case
    bounds = _quantile_bounds(composite_sort_key(paths, vertices), 37)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        spill = _feed(BucketSpill(bounds, 3, str(tmp_path / "s")), paths,
                      vertices)
        port = build_streamed_bucketed(spill, vertices, 3, "cpu",
                                       block_size=BLOCK, workers=32,
                                       table_path=str(tmp_path / "t.bin"))
        idx, _ = build_streamed_from_chunks(
            _chunks(paths, sizes=(997,)), len(paths), g, order, 3, vertices,
            "cpu", block_size=BLOCK, workers=32)
    finally:
        sys.setswitchinterval(interval)
    _assert_same_index(port, mono)
    _assert_same_index(idx, mono)
    port.close()


def _candidates(idx, g, seeds):
    out = []
    for s in seeds:
        qg = sample_query(g, 6, seed=s)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices), 3,
                                dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde(qg, 2), qp)
        plan = greedy_path_cover(qp, weight, qg.num_vertices)
        out.append(idx.search(PEQuery(q_pde, plan, qg.num_vertices)))
    return out


def test_two_builds_share_a_spill_dir(case, ties, tmp_path):
    """Two disk-tier builds into one directory in one process, the first
    still open (the ladder's A/B build; ranks under one launcher): each
    writes only into a directory of its own, so the second leaves the
    first's table as it was, and closing both leaves the directory as
    it was found."""
    g1, order1, paths1, vertices1, _ = ties
    g2, order2, paths2, vertices2, _ = case
    spill = tmp_path / "spill"
    first, t1 = build_streamed_from_chunks(
        _chunks(paths1), len(paths1), g1, order1, 3, vertices1, "cpu",
        block_size=BLOCK, spill_dir=str(spill), cache=False)
    before = _candidates(first, g1, range(4))
    assert sum(len(c) for q in before for c in q) > 0
    second, t2 = build_streamed_from_chunks(
        _chunks(paths2), len(paths2), g2, order2, 3, vertices2, "cpu",
        block_size=BLOCK, spill_dir=str(spill), cache=False)
    assert t1["table_memmap"] and t2["table_memmap"]
    assert first._host_vids.nbytes < second._host_vids.nbytes
    after = _candidates(first, g1, range(4))
    assert all(np.array_equal(a, b) for qa, qb in zip(before, after)
               for a, b in zip(qa, qb))
    dirs = sorted(os.listdir(spill))
    assert len(dirs) == 2 and all(d.startswith("spill_") for d in dirs)
    assert sorted([first._owned_dir, second._owned_dir]) == [
        str(spill / d) for d in dirs]
    for idx in (first, second):
        assert os.listdir(idx._owned_dir) == ["leaf_table.bin"]
        assert idx._host_vids.filename == os.path.join(idx._owned_dir,
                                                        "leaf_table.bin")
    first.close()
    assert os.listdir(spill) == [os.path.basename(second._owned_dir)]
    second.close()
    assert os.listdir(spill) == []


def test_a_failed_build_removes_its_directory(case, tmp_path):
    g, order, paths, vertices, _ = case
    spill = tmp_path / "spill"
    with pytest.raises(ValueError, match="announced"):
        build_streamed_from_chunks(_chunks(paths[:500]), 501, g, order, 3,
                                   vertices, "cpu", spill_dir=str(spill))
    assert os.listdir(spill) == []
    blocked = tmp_path / "a_file"
    blocked.write_text("")
    with pytest.raises(OSError):
        build_streamed_from_chunks(_chunks(paths), len(paths), g, order, 3,
                                   vertices, "cpu", spill_dir=str(blocked))


def test_no_spill_dir_and_no_room_raises(case, monkeypatch):
    g, order, paths, vertices, _ = case
    monkeypatch.setattr(bucket_build, "host_ram_bytes", lambda: 1e6)
    with pytest.raises(MemoryError, match="spill_dir"):
        build_streamed_from_chunks(_chunks(paths), len(paths), g, order, 3,
                                   vertices, "cpu")


@pytest.mark.parametrize("l", [2, 3])
def test_offline_build_pipelined_streamed(case, mesh, tmp_path, l,
                                          monkeypatch):
    """``resident=False`` through the device enumeration, chunk by
    chunk, against gnnpe_tpu's streamed pipeline: the paths come back in
    index order, the same rows as the sequential enumeration's."""
    g, order, _, vertices, _ = case
    seq, _ = enumerate_paths(g, order, l, dedup=True)
    monkeypatch.setattr(device_enumerate, "default_cap", lambda *a: 5000)
    paths, idx, timings = pipeline.offline_build_pipelined(
        g, order, l, vertices, "cpu", block_size=BLOCK, resident=False,
        spill_dir=str(tmp_path / "spill"))
    ref_paths, ref, ref_t = jax_pipeline.offline_build_pipelined(
        g, order, l, vertices, mesh, block_size=BLOCK, chunk_starts=777,
        resident=False)
    assert isinstance(idx, StreamedPESearch)
    assert isinstance(idx._host_vids, np.memmap)
    assert timings["mode"] == ref_t["mode"] == "streamed"
    # gnnpe_tpu builds 2-vertex paths (the arc list) in one piece.
    assert timings["n_buckets"] == ref_t.get("n_buckets", 8)
    # ... and returns them in enumeration order, not index order.
    assert np.array_equal(ref_paths, paths if l == 3 else seq)
    assert np.array_equal(paths, seq[np.argsort(
        composite_sort_key(seq, vertices), kind="stable")])
    _assert_same_as_jax(idx, ref)
    _assert_same_index(idx, StreamedPESearch.build_from_paths(
        seq, vertices, "cpu", block_size=BLOCK))
    idx.close()
    ref.close()


def test_offline_build_pipelined_asks_auto_resident(case, monkeypatch):
    g, order, paths, vertices, mono = case
    table_bytes = mono._host_vids.nbytes
    _, idx, _ = pipeline.offline_build_pipelined(
        g, order, 3, vertices, "cpu", block_size=BLOCK,
        budget_bytes=table_bytes)
    assert isinstance(idx, TablePESearch)
    got, idx, timings = pipeline.offline_build_pipelined(
        g, order, 3, vertices, "cpu", block_size=BLOCK,
        budget_bytes=table_bytes - 1, cache=False)
    assert isinstance(idx, StreamedPESearch) and not idx.use_cache
    assert not isinstance(idx._host_vids, np.memmap)       # no spill_dir
    assert timings["spilled_bytes"] == 0
    _assert_same_index(idx, mono)
    # gnnpe_tpu makes the same choice on either side of its budget.
    for scale, streamed in ((8.0, False), (0.125, True)):
        monkeypatch.setenv("GNNPE_HBM_BYTES",
                           str(scale * table_bytes / 0.35))
        assert jax_dp.auto_resident(len(paths), 3, BLOCK, g.num_vertices,
                                    1) != streamed
        _, idx, _ = pipeline.offline_build_pipelined(
            g, order, 3, vertices, "cpu", block_size=BLOCK,
            budget_bytes=scale * table_bytes)
        assert isinstance(idx, StreamedPESearch) == streamed
    # Paths of 4 vertices: no count beforehand, so None means resident
    # and False builds in one piece on the host.
    few = order[:40]
    _, idx, _ = pipeline.offline_build_pipelined(g, few, 4, vertices, "cpu",
                                                 block_size=BLOCK,
                                                 budget_bytes=1)
    assert isinstance(idx, TablePESearch)
    paths4, idx4, _ = pipeline.offline_build_pipelined(
        g, few, 4, vertices, "cpu", block_size=BLOCK, resident=False)
    assert isinstance(idx4, StreamedPESearch)
    assert np.array_equal(idx4._host_vids, idx._host_vids)


def test_bucketed_index_answers_as_jax(case, mesh):
    g, order, paths, vertices, _ = case
    idx, _ = build_streamed_from_chunks(_chunks(paths), len(paths), g, order,
                                        3, vertices, "cpu", block_size=BLOCK,
                                        cache_bytes=200 * BLOCK * 12)
    ref = jax_dp.DevicePackedPESearch.build_from_paths(
        mesh, paths, vertices, block_size=BLOCK, resident=False)
    for s in range(3):
        qg = sample_query(g, 6, seed=s)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices), 3,
                                dedup=True)
        q_pde, weight, _ = gen_query_pde_table(gen_vde(qg, 2), qp)
        plan = greedy_path_cover(qp, weight, qg.num_vertices)
        got = idx.search(PEQuery(q_pde, plan, qg.num_vertices))
        for ref_union in ("host", "device"):
            want = ref.search(q_pde, plan, qg.num_vertices, union=ref_union)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert idx._cache.misses > 0
