"""PE phase 1 fused (gnnpe_tpu_torch/ops/block_filter.py,
csrc/block_filter.cu): ``filter``'s plain version against a numpy
reference of the conjunction (the box tests over f32 summaries widened to
f64, then each row's signature run) at ragged block counts, at query rows
around a word of 32, with empty runs, with nothing surviving and with
summaries an ulp either side of an f64 threshold; and the PE table
layouts' search, which runs it, against the same reference.

This file imports no JAX, so its ``cuda`` cases run on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_block_filter.py
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.index.device_packed import path_sig
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.ops import block_filter

# Each case: keyword arguments of ``_case`` beside the defaults (L=3, D=2,
# 300 blocks, 6 query rows).
CASES = {
    "random": {},
    "ragged_37_blocks": dict(nb=37),
    "ragged_257_blocks": dict(nb=257),
    "rows_1": dict(q=1),
    "rows_31": dict(q=31),
    "rows_32": dict(q=32),
    "rows_33": dict(q=33),
    "rows_96": dict(q=96, nb=700),
    "empty_runs": dict(runs="empty"),
    "whole_runs": dict(runs="whole"),
    "nothing_survives": dict(runs="none"),
    "width_1_dim_1": dict(l=1, d=1),
    "width_4_dim_4": dict(l=4, d=4),
    "width_5_dim_2": dict(l=5, d=2),
    "width_3_dim_6": dict(l=3, d=6),
}


def _case(seed, l=3, d=2, nb=300, q=6, runs="random"):
    """Block summaries (f32 upper bounds and label windows, int32 degree
    bounds) and query rows that pass each column of most blocks' tests,
    each row passing its own block ``src``, with each row's run of
    blocks; as numpy arrays."""
    rng = np.random.RandomState(seed)
    w = l * d
    ub = (0.5 + 0.5 * rng.rand(nb, w)).astype(np.float32)
    llo = (0.3 * rng.rand(nb, w)).astype(np.float32)
    lhi = (0.7 + 0.3 * rng.rand(nb, w)).astype(np.float32)
    deg = rng.randint(1, 8, (nb, l)).astype(np.int32)
    src = rng.randint(0, nb, q)
    thresh = np.minimum(ub[src], 0.5 + 0.15 * rng.rand(q, w))
    label = np.clip(0.25 + 0.5 * rng.rand(q, w), llo[src], lhi[src])
    degrees = np.minimum(deg[src], rng.randint(0, 4, (q, l))).astype(
        np.int32)
    lo = rng.randint(0, nb, q)
    hi = lo + rng.randint(0, nb // 2 + 1, q)
    if runs == "empty":
        hi = lo - rng.randint(0, 3, q)          # lo >= hi: nothing kept
        hi[::2] = lo[::2] + nb // 3             # but on every other row
    elif runs == "whole":
        lo, hi = np.zeros(q, np.int64), np.full(q, nb)
    elif runs == "none":
        hi = lo.copy()
    return dict(ub=ub, llo=llo, lhi=lhi, deg=deg, thresh=thresh,
                label=label, degrees=degrees,
                runs=np.stack([lo, hi]).astype(np.int64))


def _reference(c):
    """(sel, gate [n, Q], phase1, survived) in numpy: the conjunction over
    every (row, block) in f64, then the rows' runs."""
    ub, llo, lhi = (c[k].astype(np.float64) for k in ("ub", "llo", "lhi"))
    th, lab = c["thresh"], c["label"]
    box = ((ub[None] >= th[:, None]).all(-1)
           & (lab[:, None] >= llo[None]).all(-1)
           & (lhi[None] >= lab[:, None]).all(-1)
           & (c["degrees"][:, None] <= c["deg"][None]).all(-1))
    k = np.arange(len(ub))[None]
    keep = box & (k >= c["runs"][0][:, None]) & (k < c["runs"][1][:, None])
    sel = np.nonzero(keep.any(0))[0]
    return sel, keep[:, sel].T, int(box.any(0).sum()), len(sel)


def _run(c, device, fn=block_filter.filter):
    t = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for k, a in c.items()}
    sel, gate, phase1, survived = fn(t["ub"], t["llo"], t["lhi"], t["deg"],
                                     t["thresh"], t["label"], t["degrees"],
                                     t["runs"])
    return sel.cpu(), gate.cpu(), phase1, survived


def _same(got, want):
    sel, gate, phase1, survived = got
    assert sel.dtype == torch.int64 and gate.dtype == torch.bool
    assert np.array_equal(sel.numpy(), want[0])
    assert gate.shape == want[1].shape and np.array_equal(gate.numpy(),
                                                          want[1])
    assert (phase1, survived) == want[2:]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_reference(case):
    c = _case(len(case), **CASES[case])
    want = _reference(c)
    _same(_run(c, "cpu"), want)
    _same(_run(c, "cpu", block_filter.filter_plain), want)
    assert want[2] < len(c["ub"])       # some block fails the box tests
    runs = CASES[case].get("runs")
    if runs == "none":
        assert want[3] == 0 < want[2]
    elif runs == "whole":
        assert want[3] == want[2]
    else:
        assert 0 < want[3] < want[2]


def test_plain_chunks_join(monkeypatch):
    """Box tests over chunks of 7 blocks give the one-chunk answer."""
    c = _case(3, nb=257, q=33)
    monkeypatch.setattr(block_filter, "CHUNK_ELEMS", 7 * 33 * 6)
    _same(_run(c, "cpu"), _reference(c))


def _edge_case():
    """Row 0 takes block 5's summary as it is, as an f64 threshold and
    label feature; every other (row, block) is loosened to pass.  Rows
    1-6 move one column by one f64 ulp: thresholds up (fail) and down
    (pass); a label feature past the window's low and high ends (fail)
    and back inside from each (pass)."""
    c = _case(11, nb=20, q=7, runs="whole")
    ub, llo, lhi = c["ub"], c["llo"], c["lhi"]
    ub[5] = np.float32(0.7) + np.arange(6, dtype=np.float32) / 64
    llo[5] = np.float32(0.2) + np.arange(6, dtype=np.float32) / 64
    lhi[5] = llo[5] + np.float32(0.1)
    c["deg"][:] = 10
    c["degrees"][:] = 1
    c["thresh"][:] = ub[5].astype(np.float64)
    c["label"][:] = llo[5].astype(np.float64)
    c["thresh"][1, 2] = np.nextafter(np.float64(ub[5, 2]), 2.0)
    c["thresh"][2, 2] = np.nextafter(np.float64(ub[5, 2]), -2.0)
    c["label"][3, 4] = np.nextafter(np.float64(llo[5, 4]), -2.0)
    c["label"][4, 4] = np.nextafter(np.float64(llo[5, 4]), 2.0)
    c["label"][5, 1] = np.nextafter(np.float64(lhi[5, 1]), 2.0)
    c["label"][6, 1] = np.float64(lhi[5, 1])
    # Every other block passes every row unless it is an ulp case.
    others = np.arange(20) != 5
    ub[others], llo[others], lhi[others] = 2.0, -1.0, 2.0
    return c


def test_ulp_edges():
    c = _edge_case()
    want = _reference(c)
    _same(_run(c, "cpu"), want)
    at = list(want[0]).index(5)
    # Equal passes; one f64 ulp the wrong way fails, where rounding the
    # threshold to f32 would have passed it.
    assert want[1][at].tolist() == [True, False, True, False, True, False,
                                    True]
    assert np.float32(c["thresh"][1, 2]) == c["ub"][5, 2]


def test_takes_and_rejects():
    c = _case(0)
    t = {k: torch.from_numpy(a) for k, a in c.items()}
    args = [t[k] for k in ("ub", "llo", "lhi", "deg", "thresh", "label",
                           "degrees", "runs")]
    block_filter.filter(*args)
    for i, bad, err in ((0, t["ub"].double(), TypeError),
                        (3, t["deg"].long(), TypeError),
                        (6, t["degrees"].long(), TypeError),
                        (7, t["runs"].int(), TypeError),
                        (7, t["runs"].t(), ValueError),
                        (1, t["llo"][1:], ValueError),
                        (3, t["deg"][:, :2].contiguous(), ValueError),
                        (4, t["thresh"][:, :5].contiguous(), ValueError),
                        (4, t["thresh"].t().contiguous().t(), ValueError)):
        with pytest.raises(err):
            block_filter.filter(*args[:i], bad, *args[i + 1:])
    sel, gate, phase1, survived = block_filter.filter(
        *(a[:0] if i < 4 else a for i, a in enumerate(args)))
    assert sel.numel() == 0 and gate.shape == (0, 6)
    assert phase1 == survived == 0


# ---- through the searchers ---

BLOCK = 32


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
        return eng.offline().build_index(block_size=BLOCK).attach_device(
            device)
    eng.offline(device=True)
    return eng.build_index(block_size=BLOCK, table=True,
                           resident=kind == "table",
                           cache_bytes=5 * BLOCK * 3 * 4)


def _queries(eng, queries):
    """Each query's search input, then all of them stacked."""
    return ([eng._stack([eng._query_table(q)]) for q in queries]
            + [eng._stack([eng._query_table(q) for q in queries])])


def _index_reference(searcher, query):
    """``_reference`` over the searcher's own summaries and the query's
    rows, their runs found from the blocks' signature ranges."""
    q = searcher._prepare(query)
    sig = path_sig(q.host_labels, searcher._sig_radix)
    runs = np.stack([np.searchsorted(searcher._blk_sig_last, sig, "left"),
                     np.searchsorted(searcher._blk_sig_first, sig, "right")])
    return _reference(dict(
        ub=searcher.b_ub.cpu().numpy(), llo=searcher.b_llo.cpu().numpy(),
        lhi=searcher.b_lhi.cpu().numpy(), deg=searcher.b_deg.cpu().numpy(),
        thresh=q.thresh.cpu().numpy(), label=q.pde_label.cpu().numpy(),
        degrees=q.degrees.cpu().numpy(), runs=runs))


@pytest.mark.parametrize("kind", ["table", "streamed", "array", "pge"])
def test_search_fuses_the_filter(graph, kind):
    """The PE table layouts run phase 1, the prune and the selection as
    the fused filter over every block (``filter_fused_blocks``), their
    ``phase1`` and ``survived`` the reference's; the array layout and PGE
    keep the chunked compares."""
    g, queries = graph
    eng = _engine(kind, g)
    fused = kind in ("table", "streamed")
    assert eng.searcher.fuses_filter == fused
    for query in _queries(eng, queries):
        eng.searcher.search(query)
        st = eng.searcher.last_stats
        assert st["filter_fused_blocks"] == (st["blocks"] if fused else 0)
        assert list(st)[:4] == ["blocks", "phase1", "survived", "chunks"]
        if fused:
            want = _index_reference(eng.searcher, query)
            assert (st["phase1"], st["survived"]) == want[2:]
            assert st["survived"] > 0


# ---- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["ulp_edges"])
def test_kernel_equals_plain_on_card(cuda_device, case):
    """The kernels' survivors, gate rows and both counts equal the plain
    version's bit for bit: three launches a call, two where nothing
    survives."""
    c = _edge_case() if case == "ulp_edges" else _case(len(case),
                                                       **CASES[case])
    launches = block_filter.LAUNCHES
    got = _run(c, cuda_device)
    torch.cuda.synchronize()
    assert block_filter.LAUNCHES - launches == (3 if got[3] else 2)
    _same(got, _run(c, "cpu"))


@pytest.mark.cuda
def test_kernel_many_tiles_on_card(cuda_device):
    """Past one scan's 1,024 tiles and one shared tile of query rows:
    300,000 blocks and 300 rows (two shared tiles of 256), and summaries
    of width 48, held by no template, whose 300 rows take ten tiles of
    32.  Summaries of 95 columns, whose 32 rows pass a thread block's
    shared memory, raise."""
    for c in (_case(5, nb=300_000, q=300),
              _case(6, l=4, d=12, nb=5_000, q=300)):
        got = _run(c, cuda_device)
        _same(got, _run(c, "cpu"))
        assert got[3] > 0
    with pytest.raises(RuntimeError):
        _run(_case(7, l=1, d=95, nb=40), cuda_device)
    _run(_case(7, l=1, d=94, nb=40), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["table", "streamed"])
def test_search_on_card_equals_plain(graph, cuda_device, kind):
    """The PE table layouts on the card: the fused filter's counts, and
    the search's lists and counters, equal the plain path's on the CPU,
    three filter launches a search."""
    g, queries = graph
    card, cpu = _engine(kind, g, cuda_device), _engine(kind, g, "cpu")
    for cq, pq in zip(_queries(card, queries), _queries(cpu, queries)):
        launches = block_filter.LAUNCHES
        got = card.searcher.search(cq)
        st = card.searcher.last_stats
        assert block_filter.LAUNCHES - launches == 3
        want = cpu.searcher.search(pq)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        for key in ("phase1", "survived", "hit_rows", "cand_ids",
                    "filter_fused_blocks"):
            assert st[key] == cpu.searcher.last_stats[key], key
    torch.cuda.synchronize()
