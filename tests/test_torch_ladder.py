"""The dataset-ladder entry point on the CPU: the yeast rung's PE and PGE
rows against gnnpe_tpu's ``run_rung`` on JAX's CPU (same queries, same
paths, same answers), and the flags: streamed, a saved index, the A/B
build, the OOM retry, where rows are written."""

import json
import os

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.frontends import ladder


@pytest.fixture(scope="module")
def rows():
    return ladder.run_rung("yeast", queries=4, device="cpu")


def test_yeast_rows_match_gnnpe_tpu(rows):
    from gnnpe_tpu.frontends.ladder import run_rung as jax_run_rung
    want = jax_run_rung("yeast", queries=4)
    assert [r["variant"] for r in rows] == [r["variant"] for r in want] \
        == ["pe", "pge"]
    pe, pge = rows
    jpe, jpge = want
    for ours, theirs in ((pe, jpe), (pge, jpge)):
        assert ours["spot_verified"] and ours["spot_verified_p90"]
        assert ours["spot_error"] is None
        assert theirs["spot_verified"] and theirs["spot_verified_p90"]
        assert "error" not in ours["serving"]
        for k in ("rung", "variant", "l", "v", "e", "queries",
                  "max_answers", "mean_answers"):
            assert ours[k] == theirs[k], k
        assert "warm_s" not in ours and ours["index_bytes"] > 0
    assert pe["paths"] == jpe["paths"] == 414_640
    assert pe["mode"] == jpe["mode"] == "resident"
    # gnnpe_tpu's count holds the pad blocks of its 32-aligned shards
    # (dropped by the port): the port counts ceil(paths / block) blocks.
    assert pe["num_blocks"] == -(-pe["paths"] // 512) <= jpe["num_blocks"]
    assert pge["skipped"] == jpge["skipped"] == 0
    assert pe["world_size"] == pge["world_size"] == 1


def test_rows_candidates_equal_gnnpe_tpus_engines(rows):
    """Each row's Σ|candidates| per query equals gnnpe_tpu's engines' on
    the same queries (the row's field the answers cannot stand in for
    where every query reaches ``max_answers``)."""
    from gnnpe_tpu.config import PEConfig, PGEConfig
    from gnnpe_tpu.engine import PEEngine, PGEEngine
    from gnnpe_tpu.io.datasets import load_dataset, sample_query
    g = load_dataset("yeast", seed=0)
    qs = [sample_query(g, 8, tree=True, seed=i) for i in range(4)]
    pe = PEEngine(PEConfig.from_cli(l=2, e=2, p=5, n=100_000), g)
    pe.offline()
    pe.build_index(block_size=512)
    pge = PGEEngine(PGEConfig.from_cli(l=2, e=2, p=5, n=100_000), g)
    pge.offline()
    for row, eng in zip(rows, (pe, pge)):
        want = [int(sum(len(c) for c in eng.online(q).candidates))
                for q in qs]
        assert row["candidates"] == want and min(want) > 0


def test_stage_percentiles_and_serving(rows):
    pe, pge = rows
    for row in rows:
        assert set(row["stage_p50_ms"]) == {"query_plan", "search", "refine"}
        assert row["online_p90_ms"] >= row["online_p50_ms"] > 0
        assert row["serving"]["queries"] == 4
        assert row["chunks_p50"] >= 1
    assert pe["pipeline"]["total_s"] > 0 and pe["build_phase_ms"]
    assert pe["cache_hit_rate_p50"] is None and pe["prefill_s"] is None


def test_streamed_saved_and_sequential_builds(tmp_path, rows):
    mean = rows[0]["mean_answers"]
    streamed = ladder.run_rung("yeast", queries=4, force_streamed=True,
                               pe_only=True, prefill_seconds=5, device="cpu")
    (row,) = streamed
    assert row["mode"] == "streamed" and row["spot_verified"]
    assert row["prefill_blocks"] > 0 and row["cache_hit_rate_p50"] is not None
    assert row["host_table_bytes"] == row["num_blocks"] * 512 * 3 * 4
    assert row["mean_answers"] == mean and "error" not in row["serving"]

    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.engine import PEEngine
    from gnnpe_tpu_torch.io.datasets import load_dataset
    eng = PEEngine(PEConfig.from_cli(l=2, e=2), load_dataset("yeast"), "cpu")
    eng.offline(device=True).build_index(table=True)
    path = str(tmp_path / "yeast_pe.npz")
    eng.searcher.save(path)
    (loaded,) = ladder.run_rung("yeast", queries=4, pe_only=True,
                                pe_load=path, build_note="saved", serve=False,
                                device="cpu")
    assert loaded["loaded_from"] == path and loaded["build_note"] == "saved"
    assert loaded["paths"] == rows[0]["paths"] and loaded["spot_verified"]
    assert loaded["mean_answers"] == mean and loaded["serving"] is None

    (seq,) = ladder.run_rung("yeast", queries=2, pe_only=True, serve=False,
                             pipelined=False, device="cpu")
    assert seq["pipeline"] is None and seq["spot_verified"]
    (ab,) = ladder.run_rung("yeast", queries=2, pe_only=True, serve=False,
                            ab_sequential=True, device="cpu")
    assert ab["pipeline_vs_sequential"] > 0


def test_oom_retry_degrades_a_streamed_pool_only(monkeypatch):
    from gnnpe_tpu_torch.engine import PEEngine
    real = PEEngine.online_many
    calls = []

    def once_oom(self, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real(self, *a, **k)

    monkeypatch.setattr(PEEngine, "online_many", once_oom)
    (row,) = ladder.run_rung("yeast", queries=2, force_streamed=True,
                             pe_only=True, prefill_seconds=1, device="cpu")
    assert "error" not in row["serving"]
    assert row["serving"]["degraded_cache_bytes"] > 0
    calls.clear()
    (row,) = ladder.run_rung("yeast", queries=2, pe_only=True, device="cpu")
    assert "OutOfMemoryError" in row["serving"]["error"]
    assert row["spot_verified"]


def test_main_writes_rows_only_where_told(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rows.jsonl"
    ladder.main(["--dataset", "yeast", "--device", "cpu", "--queries", "2",
                 "--pge-only", "--no-serve", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines == printed and [r["variant"] for r in lines] == ["pge"]
    assert sorted(os.listdir(tmp_path)) == ["rows.jsonl"]
    with pytest.raises(SystemExit):
        ladder.main(["--dataset", "yeast"])      # --device is required
    assert np.isfinite(lines[0]["online_p50_ms"])


# ---- the streamed tier's options: disk tier, pool, resident budget ----

TINY_RAM = 1e6      # host memory a yeast streamed build must spill past


@pytest.fixture(scope="module")
def in_memory_streamed():
    (row,) = ladder.run_rung("yeast", queries=4, force_streamed=True,
                             pe_only=True, prefill_seconds=5, device="cpu")
    return row


@pytest.fixture
def tiny_host(monkeypatch):
    from gnnpe_tpu_torch.index import bucket_build
    monkeypatch.setattr(bucket_build, "host_ram_bytes", lambda: TINY_RAM)


def test_streamed_past_host_memory_needs_a_spill_dir(tiny_host):
    with pytest.raises(MemoryError, match="spill_dir"):
        ladder.run_rung("yeast", queries=2, force_streamed=True,
                        pe_only=True, serve=False, device="cpu")


def test_disk_tier_row_equals_in_memory_and_resident(rows, in_memory_streamed,
                                                     tiny_host, tmp_path):
    spill = tmp_path / "spill"
    (row,) = ladder.run_rung("yeast", queries=4, force_streamed=True,
                             pe_only=True, prefill_seconds=5,
                             spill_dir=str(spill), device="cpu")
    assert row["mode"] == row["pipeline"]["mode"] == "streamed"
    assert row["pipeline"]["spilled_bytes"] > 0
    assert row["pipeline"]["table_memmap"] is True
    assert row["spot_verified"] and row["spot_verified_p90"]
    assert "error" not in row["serving"]
    for want in (in_memory_streamed, rows[0]):
        for k in ("paths", "num_blocks", "candidates", "mean_answers"):
            assert row[k] == want[k], k
    assert in_memory_streamed["pipeline"]["spilled_bytes"] == 0
    assert row["spill_dir"] == str(spill) and row["cache"] is True
    assert row["spill_dir_bytes_left"] == 0 and os.listdir(spill) == []
    assert in_memory_streamed["spill_dir_bytes_left"] is None


def test_resident_budget_and_a_small_pool(rows, tiny_host, tmp_path):
    """A resident budget under the table makes the rule (no flag) choose
    streamed; a pool of 20 blocks misses, and no pool at all gives the
    same candidates through per-chunk uploads."""
    table_bytes = rows[0]["num_blocks"] * 512 * 3 * 4
    block_bytes = 512 * 3 * 4
    spill = tmp_path / "spill"
    (pooled,) = ladder.run_rung(
        "yeast", queries=4, pe_only=True, prefill_seconds=5,
        spill_dir=str(spill), cache_bytes=20 * block_bytes,
        resident_budget_bytes=table_bytes - 1, device="cpu")
    assert pooled["mode"] == pooled["pipeline"]["mode"] == "streamed"
    assert pooled["pipeline"]["rule_need_bytes"] > 0
    assert pooled["pipeline"]["rule_free_bytes"] > 0
    assert pooled["resident_budget_bytes"] == table_bytes - 1
    assert pooled["cache_bytes"] == 20 * block_bytes
    assert pooled["pool_blocks"] == 20
    assert pooled["cache_misses_sum"] > 0
    assert pooled["cache_misses_p90"] >= pooled["cache_misses_p50"] >= 0
    assert pooled["uploaded_bytes_sum"] > 0
    assert pooled["candidates"] == rows[0]["candidates"]
    assert pooled["mean_answers"] == rows[0]["mean_answers"]
    assert pooled["spot_verified"] and pooled["spot_verified_p90"]
    assert pooled["spill_dir_bytes_left"] == 0 and os.listdir(spill) == []
    (uncached,) = ladder.run_rung(
        "yeast", queries=4, pe_only=True, serve=False, spill_dir=str(spill),
        cache=False, resident_budget_bytes=table_bytes - 1, device="cpu")
    assert uncached["mode"] == "streamed" and uncached["cache"] is False
    assert uncached["pool_blocks"] == 0
    assert uncached["cache_misses_sum"] is None
    assert uncached["uploaded_bytes_p50"] > 0
    assert uncached["candidates"] == rows[0]["candidates"]
    assert uncached["spot_verified"] and uncached["spill_dir_bytes_left"] == 0
    # A budget that holds the table leaves the rung resident.
    (resident,) = ladder.run_rung(
        "yeast", queries=2, pe_only=True, serve=False,
        resident_budget_bytes=table_bytes, device="cpu")
    assert resident["mode"] == resident["pipeline"]["mode"] == "resident"
    assert resident["pool_blocks"] is None


def test_sequential_build_honours_the_resident_budget(rows, tiny_host,
                                                      tmp_path):
    table_bytes = rows[0]["num_blocks"] * 512 * 3 * 4
    (row,) = ladder.run_rung(
        "yeast", queries=2, pe_only=True, serve=False, pipelined=False,
        spill_dir=str(tmp_path), resident_budget_bytes=table_bytes - 1,
        device="cpu")
    assert row["mode"] == "streamed" and row["pipeline"] is None
    assert row["candidates"] == rows[0]["candidates"][:2]
    assert row["spill_dir_bytes_left"] == 0 and os.listdir(tmp_path) == []


def test_main_passes_the_streamed_tier_on(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(ladder, "run_rung",
                        lambda name, **kw: seen.append((name, kw)) or [])
    ladder.main(["--dataset", "youtube,patents", "--device", "cpu",
                 "--spill-dir", "/some/dir", "--cache-bytes", "2.5e8",
                 "--no-cache", "--resident-budget-bytes", "5.6e9"])
    assert [name for name, _ in seen] == ["youtube", "patents"]
    for _, kw in seen:
        assert kw["spill_dir"] == "/some/dir"
        assert kw["cache_bytes"] == 2.5e8 and kw["cache"] is False
        assert kw["resident_budget_bytes"] == 5.6e9
    ladder.main(["--dataset", "yeast", "--device", "cpu"])
    kw = seen[-1][1]
    assert kw["spill_dir"] is None and kw["cache_bytes"] is None
    assert kw["cache"] is True and kw["resident_budget_bytes"] is None
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == []


def test_disk_tier_row_as_gnnpe_tpus(tiny_host, tmp_path, monkeypatch):
    """gnnpe_tpu spills by itself past its share of host memory
    (``GNNPE_HOST_RAM_BYTES``, into ``GNNPE_SPILL_DIR``); the port where
    it is told to: the same rung, mode and answers, both spilled."""
    from gnnpe_tpu.frontends.ladder import run_rung as jax_run_rung
    monkeypatch.setenv("GNNPE_SPILL_DIR", str(tmp_path / "jspill"))
    monkeypatch.setenv("GNNPE_HOST_RAM_BYTES", str(TINY_RAM))
    (theirs,) = jax_run_rung("yeast", queries=4, force_streamed=True,
                             pe_only=True, prefill_seconds=5)
    (ours,) = ladder.run_rung("yeast", queries=4, force_streamed=True,
                              pe_only=True, prefill_seconds=5,
                              spill_dir=str(tmp_path / "spill"),
                              device="cpu")
    for k in ("paths", "mode", "mean_answers", "l", "queries"):
        assert ours[k] == theirs[k], k
    assert theirs["mode"] == "streamed"
    assert theirs["pipeline"]["spilled_to_disk"] is True
    assert ours["pipeline"]["spilled_bytes"] > 0
    assert theirs["pipeline"]["table_memmap"] \
        == ours["pipeline"]["table_memmap"] is True
    assert ours["spot_verified"] and theirs["spot_verified"]
