"""PE phase 2 fused (gnnpe_tpu_torch/ops/leaf_scatter.py,
csrc/leaf_scatter.cu): ``scatter``'s plain version against a numpy
reference word for word, at the layout's edges and at shapes past the
kernel's register-held ones; and the PE table layouts' search, which
runs it at every shape, against the flat f64 filter.

This file imports no JAX, so its ``cuda`` cases run on the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_leaf_scatter.py
"""

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.config import PEConfig, PGEConfig
from gnnpe_tpu_torch.embed.pde import gen_pde
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.index.device_packed import PGEQuery
from gnnpe_tpu_torch.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu_torch.match.filter import (pe_candidates, pe_pair_mask,
                                          pge_candidates)
from gnnpe_tpu_torch.ops import leaf_scatter, union_bitmap

# Each case: keyword arguments of ``_case`` beside the defaults (L=3, D=2,
# blocks of 8 rows, 7 of 12 blocks tested, 5 query rows, 6 output rows).
CASES = {
    "random": {},
    "pad_rows": dict(pad=0.5),
    "thresh_equal": dict(equal=True),
    "gate_all_off": dict(gate="off"),
    "gate_all_on": dict(gate="on"),
    "ids_out_of_range": dict(bad_ids=True),
    "blocks_out_of_table": dict(bad_blocks=True),
    "width_1_dim_1": dict(l=1, d=1),
    "width_4_dim_4": dict(l=4, d=4, v=30),
    "width_5_dim_2": dict(l=5, d=2, v=30),
    "width_3_dim_6": dict(l=3, d=6),
    "wide_tiles": dict(b=300, nb=4, k=3, q=300, nq=40),
}


def _case(seed, l=3, d=2, b=8, nb=12, k=7, q=5, nq=6, v=50, pad=0.1,
          gate="random", equal=False, bad_ids=False, bad_blocks=False):
    """A vid table, its tested blocks and gate, the vertex tables (the
    sentinel at row V: label -2, degree 0, zero VDE) and query rows drawn
    from the tested blocks' own rows (a pad id drawn anew), so that rows
    hit; as numpy arrays."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, v + 1).astype(np.int32)
    degrees = rng.randint(1, 6, v + 1).astype(np.int32)
    vde = rng.rand(v + 1, d)
    labels[v], degrees[v], vde[v] = -2, 0, 0.0
    vids = rng.randint(0, v, (nb * b, l)).astype(np.int32)
    vids[rng.rand(nb * b) < pad] = v                 # whole pad rows
    blocks = rng.choice(nb, k, replace=False).astype(np.int64)
    src = vids[blocks[rng.randint(0, k, q)] * b + rng.randint(0, b, q)]
    src = np.where(src == v, rng.randint(0, v, src.shape), src)
    q_labels = labels[src]
    q_degrees = np.maximum(degrees[src] - rng.randint(0, 2, (q, l)),
                           0).astype(np.int32)
    q_thresh = vde[src] - 0.3 * rng.rand(q, l, d)
    out_ids = rng.randint(0, nq, (q, l)).astype(np.int32)
    if equal:
        # The thresholds exactly the data VDE on half the rows, one ulp
        # above it on the rest: a pass at equality, a miss just above.
        q_thresh = np.where(np.arange(q)[:, None, None] % 2 == 0, vde[src],
                            np.nextafter(vde[src], 2.0))
    if bad_ids:
        flat = vids.reshape(-1)
        at = rng.choice(flat.size, flat.size // 6, replace=False)
        flat[at] = rng.choice([-1, v + 1, 2 ** 31 - 1, -2 ** 31], len(at))
        out_ids[0, 0], out_ids[-1, -1] = nq, -1
    if bad_blocks:
        blocks[:2] = (-1, nb)
    gate = {"random": rng.rand(k, q) < 0.6, "off": np.zeros((k, q), bool),
            "on": np.ones((k, q), bool)}[gate]
    return dict(v=v, b=b, nq=nq, vids=vids, blocks=blocks, gate=gate,
                labels=labels, degrees=degrees, vde=vde, q_labels=q_labels,
                q_degrees=q_degrees, q_thresh=q_thresh.reshape(q, l * d),
                out_ids=out_ids)


def _reference(c):
    """The bitmap as bool [nq, V] and the rows with any gated pass, in
    numpy, block by block."""
    v, b, nq = c["v"], c["b"], c["nq"]
    l = c["vids"].shape[1]
    d = c["vde"].shape[1]
    bits, hits = np.zeros((nq, v), bool), 0
    for i, blk in enumerate(c["blocks"]):
        if not 0 <= blk < len(c["vids"]) // b:
            continue
        rows = c["vids"][blk * b:(blk + 1) * b].astype(np.int64)
        t = np.where((rows < 0) | (rows > v), v, rows)
        ok = ((c["labels"][t][None] == c["q_labels"][:, None]).all(-1)
              & (c["q_degrees"][:, None] <= c["degrees"][t][None]).all(-1)
              & (c["vde"][t].reshape(b, l * d)[None]
                 >= c["q_thresh"][:, None]).all(-1)
              & c["gate"][i][:, None])                 # [Q, B]
        hits += int(ok.any(0).sum())
        for qi, r in zip(*np.nonzero(ok)):
            for o, x in zip(c["out_ids"][qi], rows[r]):
                if 0 <= o < nq and 0 <= x < v:
                    bits[o, x] = True
    return bits, hits


def _tensors(c, device):
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {k: put(a) if isinstance(a, np.ndarray) else a
            for k, a in c.items()}


def _fused(c, device):
    """``scatter`` on ``device``: the words on the host and the hits."""
    t = _tensors(c, device)
    words = union_bitmap.new_words(c["nq"], c["v"], device)
    hits = torch.zeros(1, dtype=torch.int64, device=device)
    leaf_scatter.scatter(words, c["v"], t["vids"], t["blocks"], c["b"],
                         t["gate"], t["labels"], t["degrees"], t["vde"],
                         t["q_labels"], t["q_degrees"], t["q_thresh"],
                         t["out_ids"], hits)
    return words.cpu(), int(hits)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_reference_and_old_chain(case):
    c = _case(len(case), **CASES[case])
    bits, want_hits = _reference(c)
    words, hits = _fused(c, "cpu")
    assert torch.equal(union_bitmap.unpack(words, c["v"]),
                       torch.from_numpy(bits))
    assert hits == want_hits
    if CASES[case].get("gate") == "off":
        assert hits == 0 and not words.any()
    else:
        assert hits > 0
    if case == "thresh_equal":
        # Rows pass at equality: one ulp more on every threshold loses hits.
        up = np.nextafter(c["q_thresh"], 2.0)
        assert _reference(dict(c, q_thresh=up))[1] < hits


def test_takes_and_rejects():
    c = _tensors(_case(0), "cpu")
    words = union_bitmap.new_words(6, 50, "cpu")
    hits = torch.zeros(1, dtype=torch.int64)
    args = dict(words=words, num_vertices=50, vids=c["vids"],
                blocks=c["blocks"], block_size=8, gate=c["gate"],
                labels=c["labels"], degrees=c["degrees"], vde=c["vde"],
                q_labels=c["q_labels"], q_degrees=c["q_degrees"],
                q_thresh=c["q_thresh"], out_ids=c["out_ids"], hits=hits)
    leaf_scatter.scatter(**args)
    # A VDE wider than the register-held shapes is taken like any other.
    leaf_scatter.scatter(**dict(
        args, vde=torch.zeros(51, 5, dtype=torch.float64),
        q_thresh=torch.zeros(5, 15, dtype=torch.float64)))
    for bad, err in ((dict(vids=c["vids"].long()), TypeError),
                     (dict(q_labels=c["q_labels"].long()), TypeError),
                     (dict(gate=c["gate"].t()), ValueError),
                     (dict(gate=c["gate"][1:]), ValueError),
                     (dict(block_size=7), ValueError),
                     (dict(num_vertices=49), ValueError),
                     (dict(q_thresh=c["q_thresh"][:, :4]), ValueError),
                     (dict(vde=torch.zeros(51, 5, dtype=torch.float64)),
                      ValueError)):
        with pytest.raises(err):
            leaf_scatter.scatter(**dict(args, **bad))


# ---- through the searchers ---

BLOCK = 32


@pytest.fixture(scope="module")
def graph():
    g = powerlaw_graph(700, 2800, 6, seed=5, max_degree=40)
    return g, [sample_query(g, 5, seed=s) for s in range(4)]


def _engine(kind: str, g, device="cpu", pool_blocks=30):
    if kind == "pge":
        eng = PGEEngine(PGEConfig.from_cli(l=2, e=2), g, device).offline()
        return eng.build_index(block_size=16).attach_device(device)
    # "table_e6": VDEs of 6 columns, past the kernel's register-held ones.
    eng = PEEngine(PEConfig.from_cli(l=2, e=6 if kind == "table_e6" else 2),
                   g, device)
    if kind == "array":
        return eng.offline().build_index(block_size=BLOCK).attach_device(
            device)
    eng.offline(device=True)
    if kind in ("table", "table_e6"):
        return eng.build_index(block_size=BLOCK, table=True, resident=True)
    return eng.build_index(block_size=BLOCK, table=True, resident=False,
                           cache_bytes=pool_blocks * BLOCK * 3 * 4)


def _queries(eng, queries):
    """Each query's search input, then all of them stacked."""
    return ([eng._stack([eng._query_table(q)]) for q in queries]
            + [eng._stack([eng._query_table(q) for q in queries])])


def _same_lists(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)


def _flat(eng, query):
    """The flat f64 filter's lists for ``query``, and the index entries
    that some query row hits.  A hit passes its block's summaries and
    prune, so those entries are the search's ``hit_rows``."""
    eps = eng.config.epsilon
    if isinstance(query, PGEQuery):
        v = eng.vertices
        lists = pge_candidates(v.labels, v.degrees, eng.group,
                               eng.label_group, query.labels, query.degrees,
                               query.group, query.label_group,
                               range(len(query.labels)), epsilon=eps)
        return lists, len(np.unique(np.concatenate(lists)))
    data = gen_pde(eng.vertices, torch.as_tensor(eng.paths).numpy())
    rows = query.plan_rows
    lists = pe_candidates(data, query.pde, rows, query.num_query_vertices,
                          epsilon=eps)
    hit = pe_pair_mask(data, query.pde, rows, eps).any(0)
    return lists, int(hit.sum())


@pytest.mark.parametrize("kind",
                         ["table", "streamed", "array", "pge", "table_e6"])
def test_device_union_fuses_the_leaf_test(graph, kind):
    """The PE table layouts run phase 2 as the fused leaf test, at the
    served VDE width and a wider one: the flat f64 filter's lists and
    hit rows, every surviving row taken (``leaf_fused_rows``), one
    launch over the resident table and a launch a pool-sized chunk
    streamed (a pool of 5 blocks, fewer than survive); the array layout
    and PGE keep the mask path."""
    g, queries = graph
    eng = _engine(kind, g, pool_blocks=5)
    fused = kind in ("table", "streamed", "table_e6")
    survived = 0
    for query in _queries(eng, queries):
        got = eng.searcher.search(query)
        st = eng.searcher.last_stats
        want, hit_rows = _flat(eng, query)
        _same_lists(got, want)
        assert st["hit_rows"] == hit_rows
        block = 16 if kind == "pge" else BLOCK
        assert st["leaf_fused_rows"] == (st["survived"] * block if fused
                                         else 0)
        if kind in ("table", "table_e6"):
            assert st["chunks"] == 1
        if kind == "streamed":
            assert st["chunks"] == -(-st["survived"] // 5)
        survived = max(survived, st["survived"])
    assert survived > 5


@pytest.mark.parametrize("kind", ["table", "streamed"])
def test_nothing_survives(graph, kind):
    """A query row whose labels no path has: no block survives, and the
    fused search returns empty lists with nothing taken."""
    g, queries = graph
    eng = _engine(kind, g)
    query = _queries(eng, queries)[0]
    query.pde.labels[:] = 10 ** 6
    got = eng.searcher.search(query)
    st = eng.searcher.last_stats
    assert st["survived"] == st["leaf_fused_rows"] == st["hit_rows"] == 0
    assert len(got) == query.num_query_vertices and not any(map(len, got))


# ---- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_on_card(cuda_device, case):
    """The kernel's words bit for bit and its hit rows equal the plain
    version's, one launch a call; 'wide_tiles' has more rows a block and
    more query rows than the kernel's block has threads."""
    c = _case(len(case), **CASES[case])
    launches = leaf_scatter.LAUNCHES
    words, hits = _fused(c, cuda_device)
    torch.cuda.synchronize()
    assert leaf_scatter.LAUNCHES - launches == 1
    plain_words, plain_hits = _fused(c, "cpu")
    assert torch.equal(words, plain_words) and hits == plain_hits


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["table", "streamed", "table_e6"])
def test_search_on_card_equals_plain(graph, cuda_device, kind):
    """The PE table layouts on the card, at the served VDE width and a
    wider one: the fused search's lists and counters equal the
    plain path's on the CPU, a launch a chunk."""
    g, queries = graph
    card, cpu = _engine(kind, g, cuda_device, 5), _engine(kind, g, "cpu", 5)
    for cq, pq in zip(_queries(card, queries), _queries(cpu, queries)):
        launches = leaf_scatter.LAUNCHES
        got = card.searcher.search(cq)
        st = card.searcher.last_stats
        assert leaf_scatter.LAUNCHES - launches == st["chunks"]
        _same_lists(got, cpu.searcher.search(pq))
        for key in ("hit_rows", "cand_ids", "survived", "leaf_fused_rows"):
            assert st[key] == cpu.searcher.last_stats[key], key
    torch.cuda.synchronize()
