"""The index search's spans and copy counters
(gnnpe_tpu_torch/index/device_packed.py): every searcher, for one query
and for a stacked batch, leaves ``filter_ms``, ``phase2_ms`` and
``extract_ms`` in ``last_stats`` beside ``hit_rows``, ``copied_bytes``
and ``cand_ids``; the copies fall where the spans say; and on a card the
spans add no ``torch.cuda.synchronize``.

This file imports no JAX, so its ``cuda`` case runs on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_search_spans.py
"""

import time

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.ops import leaf_scatter, union_bitmap

KEYS = ["filter_ms", "phase2_ms", "extract_ms"]
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


def _counted_hits(monkeypatch):
    """Wrap ``union_bitmap.scatter_plain``, which every phase 2 on the
    CPU ends in (the fused leaf test's plain version too), to count in
    numpy the columns with any gated hit that each call is handed."""
    counts, inner = [], union_bitmap.scatter_plain

    def scatter_plain(words, num_vertices, mask, gate, vids, out_ids, hits):
        m, g = mask.numpy(), gate.numpy()
        if m.size:
            m = m & np.repeat(g, m.shape[1] // g.shape[1], axis=1)
            counts.append(int(m.any(0).sum()))
        return inner(words, num_vertices, mask, gate, vids, out_ids, hits)
    monkeypatch.setattr(union_bitmap, "scatter_plain", scatter_plain)
    return counts


@pytest.mark.parametrize("serve", ["single", "stacked"])
@pytest.mark.parametrize("kind", ["array", "table", "streamed", "pge"])
def test_spans_and_copy_counters_in_last_stats(graph, monkeypatch, kind,
                                               serve):
    """One query's search, and the stacked search of a batch whose spans
    the ``.batch`` metrics read: the spans' ms, the hit rows that the
    plain scatter counts, and only the compacted offsets and ids copied
    to the host."""
    g, queries = graph
    eng = _engine(kind, g)
    counts = _counted_hits(monkeypatch)
    batches = [[q] for q in queries] if serve == "single" else [queries]
    hits = 0
    for batch in batches:
        counts.clear()
        rs = ([eng.online(batch[0])] if serve == "single"
              else eng.online_many(batch))
        st = eng.searcher.last_stats
        cands = [c for r in rs for c in r.candidates]
        assert list(st)[:4] == ["blocks", "phase1", "survived", "chunks"]
        assert all(st[k] >= 0.0 for k in KEYS) and "copy_ms" not in st
        assert sum(st[k] for k in KEYS) <= rs[0].timings_ms["search"]
        assert st["cand_ids"] == sum(map(len, cands))
        assert st["copied_bytes"] == 8 * (len(cands) + 1) + 4 * st["cand_ids"]
        assert st["hit_rows"] == sum(counts)
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


@pytest.mark.parametrize("kind", ["table", "streamed", "array", "pge"])
def test_copies_fall_in_their_spans(graph, monkeypatch, kind):
    """Each ``.cpu()`` of a search is held back ``DELAY_S``, and so is
    each launch of phase 2 and the compaction.  On the table index the
    one fused leaf test over every surviving block (no union scatter)
    lands in ``phase2_ms``; on the streamed index a fused launch a chunk
    does, beside the copy of the chunk's block ids to the host that its
    pool reads; on the mask path (array layout, PGE) each chunk's union
    scatter does, and nothing is copied in the chunk loop.  Either way
    the compaction (with the copies of the offsets and ids) lands in
    ``extract_ms``."""
    g, queries = graph
    eng = _engine(kind, g)
    query = eng._stack([eng._query_table(queries[0])])
    calls, scatters, fused, compactions = [], [], [], []
    _slowed(monkeypatch, torch.Tensor, "cpu", calls)
    _slowed(monkeypatch, union_bitmap, "scatter", scatters)
    _slowed(monkeypatch, leaf_scatter, "scatter", fused)
    _slowed(monkeypatch, union_bitmap, "compact", compactions)
    got = eng.searcher.search(query)
    st = eng.searcher.last_stats
    assert st["survived"] > 0 and "copy_ms" not in st
    nq, v = len(got), eng.searcher.num_vertices
    assert len(calls) == (st["chunks"] if kind == "streamed" else 0)
    launched = [(nq, -(-v // 32))] * st["chunks"]
    if kind in ("table", "streamed"):
        assert scatters == [] and fused == launched
        assert kind == "streamed" or st["chunks"] == 1
    else:
        assert fused == [] and scatters == launched
        assert st["leaf_fused_rows"] == 0
    assert st["phase2_ms"] >= 1e3 * DELAY_S * (st["chunks"] + len(calls))
    assert compactions == [(nq, -(-v // 32))]
    assert st["extract_ms"] >= 1e3 * DELAY_S


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_search_spans_add_no_synchronize_on_card(graph, cuda_device,
                                                 monkeypatch):
    g, queries = graph
    eng = _engine("table", g, cuda_device)
    query = eng._stack([eng._query_table(q) for q in queries])
    eng.searcher.search(query)            # warm
    count, inner = [0], torch.cuda.synchronize

    def counted(*args, **kwargs):
        count[0] += 1
        return inner(*args, **kwargs)
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    eng.searcher.search(query)
    st = eng.searcher.last_stats
    assert count[0] == 0
    assert st["survived"] > 0 and all(st[k] >= 0.0 for k in KEYS)
    # The counter sees the engine's own stages, which do synchronise.
    eng.online(queries[0])
    assert count[0] > 0
