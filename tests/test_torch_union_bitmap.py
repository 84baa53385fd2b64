"""The index search's candidate union on a bit-packed bitmap
(gnnpe_tpu_torch/ops/union_bitmap.py, csrc/union_bitmap.cu): ``scatter``
and ``compact`` against a numpy reference at the layout's edges, and the
device union against the host union through every searcher, one query
at a time and stacked.

This file imports no JAX, so its ``cuda`` cases run on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_union_bitmap.py
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.ops import union_bitmap


def _chunk(rng, q, k, b, width, nq, v, p_hit=0.2, p_gate=0.7):
    """A chunk's (mask, gate, vids, out_ids) as numpy, with some ids out
    of the bitmap (-1 and ``v``, as pad rows carry)."""
    mask = rng.rand(q, k * b) < p_hit
    gate = rng.rand(q, k) < p_gate
    vids = rng.randint(-1, v + 1, (k * b, width)).astype(np.int32)
    out_ids = rng.randint(0, nq, (q, width)).astype(np.int32)
    return mask, gate, vids, out_ids


def _reference(chunks, nq, v):
    """Per row, the sorted vertex ids the chunks' gated hits set, and the
    hit columns summed over chunks."""
    sets = [set() for _ in range(nq)]
    hit_columns = 0
    for mask, gate, vids, out_ids in chunks:
        b = mask.shape[1] // gate.shape[1]
        m = mask & np.repeat(gate, b, axis=1)
        hit_columns += int(m.any(0).sum())
        for q, c in zip(*np.nonzero(m)):
            for o, x in zip(out_ids[q], vids[c]):
                if 0 <= o < nq and 0 <= x < v:
                    sets[o].add(int(x))
    return [np.array(sorted(s), np.int64) for s in sets], hit_columns


def _run(chunks, nq, v, device):
    words = union_bitmap.new_words(nq, v, device)
    hits = torch.zeros(1, dtype=torch.int64, device=device)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    for mask, gate, vids, out_ids in chunks:
        union_bitmap.scatter(words, v, put(mask), put(gate), put(vids),
                             put(out_ids), hits)
    offsets, ids = union_bitmap.compact(words, v)
    return words, int(hits), offsets, ids


def _same_lists(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)


# Each case: (chunks as (Q, K, B, L'), nq, V, what it covers).
CASES = {
    "v_not_32": ([(3, 4, 8, 3), (3, 2, 8, 3)], 5, 37),
    "one_word": ([(2, 3, 4, 1)], 2, 32),
    "bits_31": ([(4, 2, 16, 2)], 3, 64),
    "one_column": ([(1, 1, 1, 1)], 1, 1),
    "many_rows": ([(6, 5, 8, 3)] * 3, 40, 1000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_scatter_and_compact_equal_numpy(case):
    shapes, nq, v = CASES[case]
    rng = np.random.RandomState(len(case))
    chunks = [_chunk(rng, q, k, b, w, nq, v) for q, k, b, w in shapes]
    want, want_hits = _reference(chunks, nq, v)
    words, hits, offsets, ids = _run(chunks, nq, v, "cpu")
    assert words.shape == (nq, -(-v // 32)) and words.dtype == torch.int32
    assert hits == want_hits
    assert offsets.dtype == np.int64 and ids.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == len(ids)
    _same_lists(union_bitmap.split(offsets, ids), want)


def test_plain_edges():
    """The last vertex V - 1 and the last bit of a word, a row that
    gets no candidate, a chunk with no hit, a gated-off hit and ids out
    of the bitmap."""
    v, nq = 70, 3
    vids = np.array([[v - 1, 31], [32, 0], [-1, v], [5, 6]], np.int32)
    out_ids = np.array([[0, 2], [2, 0]], np.int32)       # row 1 gets none
    mask = np.array([[1, 1, 1, 1], [0, 0, 1, 1]], bool)
    gate = np.array([[1, 0], [1, 1]], bool)              # blocks of 2
    nothing = (np.zeros_like(mask), gate, vids, out_ids)
    words, hits, offsets, ids = _run([nothing, (mask, gate, vids, out_ids),
                                      nothing], nq, v, "cpu")
    lists = union_bitmap.split(offsets, ids)
    # Row 0 of the query hits columns 0 and 1 (its gate is off on 2, 3),
    # row 1 columns 2 (whose ids are out of the bitmap) and 3.
    _same_lists(lists, [np.array([6, 32, v - 1]), np.zeros(0, np.int64),
                        np.array([0, 5, 31])])
    assert hits == 4
    assert words[0, 2].item() & (1 << 5) and words[2, 0].item() < 0


def test_pack_unpack_roundtrip():
    rng = np.random.RandomState(1)
    bits = torch.from_numpy(rng.rand(4, 96) < 0.5)
    bits[:, 31] = bits[:, 63] = True
    words = union_bitmap.pack(bits)
    assert torch.equal(union_bitmap.unpack(words, 96), bits)
    want = np.zeros((4, 3), np.uint32)
    for r, c in zip(*np.nonzero(bits.numpy())):
        want[r, c // 32] |= np.uint32(1 << (c % 32))
    assert np.array_equal(words.numpy().view(np.uint32), want)


def test_scatter_rejects_what_the_kernel_does_not_take():
    words = union_bitmap.new_words(2, 40, "cpu")
    hits = torch.zeros(1, dtype=torch.int64)
    mask = torch.ones((2, 8), dtype=torch.bool)
    gate = torch.ones((2, 2), dtype=torch.bool)
    vids = torch.zeros((8, 3), dtype=torch.int32)
    out_ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        union_bitmap.scatter(words, 40, mask, gate, vids.long(), out_ids,
                             hits)
    with pytest.raises(ValueError):
        union_bitmap.scatter(words, 40, mask, gate[:, :1].repeat(1, 3),
                             vids, out_ids, hits)
    with pytest.raises(ValueError):
        union_bitmap.scatter(words, 65, mask, gate, vids, out_ids, hits)
    with pytest.raises(ValueError):
        union_bitmap.scatter(words, 40, mask, gate, vids.t(), out_ids, hits)
    with pytest.raises(ValueError):
        union_bitmap.compact(words, 80)


# ---- through the searchers ---

@pytest.fixture(scope="module")
def graph():
    g = powerlaw_graph(700, 2800, 6, seed=5, max_degree=40)
    return g, [sample_query(g, 5, seed=s) for s in range(4)]


def _engine(kind: str, g, device="cpu"):
    if kind == "pge":
        eng = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, device).offline()
        return eng.build_index(block_size=16).attach_device(device)
    eng = PEEngine(PEConfig.from_cli(l=2, e=2), g, device)
    if kind == "array":
        return eng.offline().build_index(block_size=32).attach_device(device)
    eng.offline(device=True)
    if kind == "table":
        return eng.build_index(block_size=32, table=True, resident=True)
    return eng.build_index(block_size=32, table=True, resident=False,
                           cache_bytes=30 * 32 * 3 * 4)


def _queries(eng, queries):
    """Each query's search input, then all of them stacked."""
    return ([eng._stack([eng._query_table(q)]) for q in queries]
            + [eng._stack([eng._query_table(q) for q in queries])])


@pytest.mark.parametrize("kind", ["array", "table", "streamed", "pge"])
def test_device_union_equals_host_union(graph, kind):
    g, queries = graph
    eng = _engine(kind, g)
    hits = 0
    for query in _queries(eng, queries):
        host = eng.searcher.search(query, union="host")
        st_host = dict(eng.searcher.last_stats)
        dev = eng.searcher.search(query)            # the default
        st = eng.searcher.last_stats
        _same_lists(dev, host)
        assert (st_host["union"], st["union"]) == ("host", "device")
        assert st["hit_rows"] == st_host["hit_rows"]
        assert st["cand_ids"] == st_host["cand_ids"] == sum(map(len, dev))
        hits += st["hit_rows"]
    assert hits > 0


# ---- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits_np(words: torch.Tensor, v: int) -> np.ndarray:
    w = words.cpu().numpy().view(np.uint8)
    return np.unpackbits(w, axis=1, bitorder="little")[:, :v].astype(bool)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["v_not_32", "bits_31", "many_rows",
                                  "segments", "scan_loop"])
def test_kernels_equal_plain_on_card(cuda_device, case):
    """The kernels' words bit for bit, hit count and compacted lists
    equal the plain path's; 'segments' cuts rows into several segments
    of several tiles, 'scan_loop' has more (row, segment) pairs than the
    scan's block has threads."""
    shapes, nq, v = {
        **CASES,
        "segments": ([(8, 40, 64, 3)] * 2, 6, 300_001),
        "scan_loop": ([(12, 30, 32, 2)], 400, 300_001),
    }[case]
    rng = np.random.RandomState(11)
    chunks = [_chunk(rng, q, k, b, w, nq, v, p_hit=0.3)
              for q, k, b, w in shapes]
    launches = union_bitmap.LAUNCHES
    words, hits, offsets, ids = _run(chunks, nq, v, cuda_device)
    torch.cuda.synchronize()
    assert union_bitmap.LAUNCHES - launches == len(chunks) + 2 + (len(ids) > 0)
    want, want_hits = _reference(chunks, nq, v)
    assert hits == want_hits
    _same_lists(union_bitmap.split(offsets, ids), want)
    bits = np.zeros((nq, v), bool)
    for r, ids_r in enumerate(want):
        bits[r, ids_r] = True
    assert np.array_equal(_bits_np(words, v), bits)
    if nq * v <= 10 ** 6:
        plain, plain_hits, p_off, p_ids = _run(chunks, nq, v, "cpu")
        assert torch.equal(words.cpu(), plain) and hits == plain_hits
        assert np.array_equal(offsets, p_off) and np.array_equal(ids, p_ids)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["table", "pge"])
def test_search_on_card_equals_plain(graph, cuda_device, monkeypatch, kind):
    """A PE table index and a PGE index on the card: the device union's
    lists and counters equal the plain path's on the CPU and the host
    union's, with the union's launches counted and no
    ``torch.cuda.synchronize`` in a search."""
    g, queries = graph
    card, cpu = _engine(kind, g, cuda_device), _engine(kind, g)
    card_queries, cpu_queries = _queries(card, queries), _queries(cpu, queries)
    card.searcher.search(card_queries[0])                  # warm
    count, inner = [0], torch.cuda.synchronize

    def counted(*args, **kwargs):
        count[0] += 1
        return inner(*args, **kwargs)
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    for cq, pq in zip(card_queries, cpu_queries):
        launches = union_bitmap.LAUNCHES
        got = card.searcher.search(cq)
        st = card.searcher.last_stats
        assert union_bitmap.LAUNCHES - launches == (
            st["chunks"] + 2 + (st["cand_ids"] > 0) if st["survived"] else 0)
        want = cpu.searcher.search(pq)
        _same_lists(got, want)
        for key in ("hit_rows", "cand_ids", "copied_bytes", "survived"):
            assert st[key] == cpu.searcher.last_stats[key], key
        _same_lists(got, card.searcher.search(cq, union="host"))
    assert count[0] == 0
    inner()                     # a fault in any launch surfaces here
