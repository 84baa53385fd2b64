"""The index search's spans and copy counters
(gnnpe_tpu_torch/index/device_packed.py): every searcher, under both
unions, leaves ``filter_ms``, ``phase2_ms``, ``copy_ms`` and
``extract_ms`` in ``last_stats`` beside ``hit_rows``, ``copied_bytes``,
``union`` and ``cand_ids``; the copies fall where the spans say; and on
a card the spans add no ``torch.cuda.synchronize``.

This file imports no JAX, so its ``cuda`` case runs on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_search_spans.py
"""

import time

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.ops import leaf_scatter, union_bitmap

KEYS = ["filter_ms", "phase2_ms", "copy_ms", "extract_ms"]
DELAY_S = 0.03


@pytest.fixture(scope="module")
def graph():
    g = powerlaw_graph(800, 3200, 6, seed=3, max_degree=50)
    return g, [sample_query(g, 5, seed=s) for s in range(3)]


def _engine(kind: str, g, device="cpu"):
    if kind == "pge":
        eng = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, device).offline()
        return eng.build_index(block_size=16).attach_device(device)
    eng = PEEngine(PEConfig.from_cli(l=2, e=2), g, device)
    if kind == "array":
        return eng.offline().build_index(block_size=64).attach_device(device)
    eng.offline(device=True)
    if kind == "table":
        return eng.build_index(block_size=64, table=True, resident=True)
    return eng.build_index(block_size=64, table=True, resident=False,
                           cache_bytes=40 * 64 * 2 * 4)


def _rows(query) -> int:
    """The query table's rows Q: the [Q, H] hit mask's height."""
    return (len(query.labels) if isinstance(query, device_packed.PGEQuery)
            else len(query.plan_rows))


def _probe(eng):
    """Wrap the searcher's ``search`` to keep the query it is handed."""
    seen, inner = [], eng.searcher.search

    def search(query, *args, **kwargs):
        seen.append(query)
        return inner(query, *args, **kwargs)
    eng.searcher.search = search
    return seen


@pytest.mark.parametrize("union", ["host", "device"])
@pytest.mark.parametrize("kind", ["array", "table", "streamed", "pge"])
def test_spans_and_copy_counters_in_last_stats(graph, kind, union):
    """Both unions count the same hit rows (the device union's in its
    kernel) and say which ran; the host union copies each hit column's
    mask and row, the device union only its offsets and ids."""
    g, queries = graph
    eng = _engine(kind, g)
    seen = _probe(eng)
    hits = 0
    for q in queries:
        r = eng.online(q, union=union)
        st = eng.searcher.last_stats
        assert list(st)[:4] == ["blocks", "phase1", "survived", "chunks"]
        assert all(st[k] >= 0.0 for k in KEYS)
        assert sum(st[k] for k in KEYS) <= r.timings_ms["search"]
        assert st["union"] == union
        assert st["cand_ids"] == sum(map(len, r.candidates))
        if union == "host":
            assert st["copied_bytes"] == (_rows(seen[-1]) + 8) * st["hit_rows"]
            assert st["copy_ms"] > 0.0 or st["survived"] == 0
        else:
            nq = len(r.candidates)
            assert st["copy_ms"] == 0.0
            assert st["copied_bytes"] == 8 * (nq + 1) + 4 * st["cand_ids"]
            host = eng.online(q, union="host")
            assert eng.searcher.last_stats["hit_rows"] == st["hit_rows"]
            assert all(np.array_equal(a, b) for a, b in
                       zip(r.candidates, host.candidates))
        hits += st["hit_rows"]
    assert hits > 0


def _slowed(monkeypatch, owner, name, calls):
    """``owner.name`` held back ``DELAY_S`` a call, each call's first
    argument's shape kept in ``calls``."""
    inner = getattr(owner, name)

    def slow(self, *args, **kwargs):
        calls.append(tuple(self.shape))
        time.sleep(DELAY_S)
        return inner(self, *args, **kwargs)
    monkeypatch.setattr(owner, name, slow)


@pytest.mark.parametrize("union,kind", [
    ("host", "table"), ("device", "table"), ("device", "array"),
    ("device", "pge")], ids=["host", "device", "device-array", "device-pge"])
def test_copies_fall_in_their_spans(graph, monkeypatch, union, kind):
    """Each ``.cpu()`` of a search is held back ``DELAY_S``: the table
    index's host union's two copies a chunk land in ``copy_ms``.  The
    device union copies nothing in its chunk loop.  On the table index
    its one fused leaf test over every surviving block (no union
    scatter), held back the same, lands in ``phase2_ms``; on the mask
    path (array layout, PGE) each chunk's union scatter, held back the
    same, lands there instead.  Either way the compaction (with the
    copies of the offsets and ids) lands in ``extract_ms``."""
    g, queries = graph
    eng = _engine(kind, g)
    query = eng._stack([eng._query_table(queries[0])])
    calls, scatters, fused, compactions = [], [], [], []
    _slowed(monkeypatch, torch.Tensor, "cpu", calls)
    _slowed(monkeypatch, union_bitmap, "scatter", scatters)
    _slowed(monkeypatch, leaf_scatter, "scatter", fused)
    _slowed(monkeypatch, union_bitmap, "compact", compactions)
    got = eng.searcher.search(query, union=union)
    st = eng.searcher.last_stats
    assert st["survived"] > 0
    if union == "host":
        assert len(calls) == 2 * st["chunks"]
        assert st["copy_ms"] >= 1e3 * DELAY_S * len(calls)
        assert scatters == fused == compactions == []
    else:
        nq, v = len(got), eng.searcher.num_vertices
        assert calls == [] and st["copy_ms"] == 0.0
        launched = [(nq, -(-v // 32))] * st["chunks"]
        if kind == "table":
            assert scatters == [] and st["chunks"] == 1
            assert fused == launched
        else:
            assert fused == [] and scatters == launched
            assert st["leaf_fused_rows"] == 0
        assert st["phase2_ms"] >= 1e3 * DELAY_S * st["chunks"]
        assert compactions == [(nq, -(-v // 32))]
        assert st["extract_ms"] >= 1e3 * DELAY_S


def test_host_extraction_falls_in_extract_span(graph, monkeypatch):
    g, queries = graph
    eng = _engine("table", g)
    inner = device_packed.extract_candidates

    def slow_extract(*args, **kwargs):
        time.sleep(DELAY_S)
        return inner(*args, **kwargs)
    monkeypatch.setattr(device_packed, "extract_candidates", slow_extract)
    eng.online(queries[0], union="host")
    st = eng.searcher.last_stats
    assert st["extract_ms"] >= 1e3 * DELAY_S


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("union", ["host", "device"])
def test_search_spans_add_no_synchronize_on_card(graph, cuda_device,
                                                 monkeypatch, union):
    g, queries = graph
    eng = _engine("table", g, cuda_device)
    query = eng._stack([eng._query_table(q) for q in queries])
    eng.searcher.search(query, union=union)            # warm
    count, inner = [0], torch.cuda.synchronize

    def counted(*args, **kwargs):
        count[0] += 1
        return inner(*args, **kwargs)
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    eng.searcher.search(query, union=union)
    st = eng.searcher.last_stats
    assert count[0] == 0
    assert st["survived"] > 0 and all(st[k] >= 0.0 for k in KEYS)
    # The counter sees the engine's own stages, which do synchronise.
    eng.online(queries[0], union=union)
    assert count[0] > 0
