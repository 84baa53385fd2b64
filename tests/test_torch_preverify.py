"""The port's semi-join pre-verify (gnnpe_tpu_torch/match/preverify.py)
and the engines' ``preverify=`` against gnnpe_tpu's on the CPU.  On the
CPU ``reach = A @ C`` runs the plain version of kernel A1; sums of at
most max-degree ones are exact in f32, so every comparison is exact:
pruned candidate arrays equal gnnpe_tpu's for every number of rounds,
PGE answer counts do not move, and PE candidates and counts equal
gnnpe_tpu's under the same ``preverify``."""

import numpy as np
import pytest

from gnnpe_tpu.config import PEConfig, PGEConfig
from gnnpe_tpu.engine import PEEngine as RefPEEngine
from gnnpe_tpu.engine import PGEEngine as RefPGEEngine
from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
from gnnpe_tpu.match import preverify as jax_preverify
from gnnpe_tpu.ops.spmm import neighbor_sum_np
from gnnpe_tpu.parallel.mesh import make_mesh
from gnnpe_tpu_torch.engine import PEEngine, PGEEngine
from gnnpe_tpu_torch.graph.csr import to_device
from gnnpe_tpu_torch.match import preverify
from gnnpe_tpu_torch.match.preverify import semijoin_prune
from gnnpe_tpu_torch.ops import spmm

REFINE_SPANS = ("refine.order", "refine.prepare", "refine.explore")


@pytest.fixture(scope="module")
def graphs():
    g = powerlaw_graph(1500, 6000, 12, seed=0, max_degree=60)
    return g, [sample_query(g, 6, seed=s) for s in range(4)]


@pytest.fixture(scope="module")
def engines(graphs):
    g, _ = graphs
    mesh = make_mesh(1, axes=("graph",), shape=(1,))
    out = {}
    for name, cfg, ref_cls, cls in (
            ("pe", PEConfig.from_cli(l=2, e=2), RefPEEngine, PEEngine),
            ("pge", PGEConfig.from_cli(l=2, e=2), RefPGEEngine, PGEEngine)):
        ref = ref_cls(cfg, g)
        ref.offline()
        if name == "pe":
            ref.build_index(block_size=64)
        ref.attach_mesh(mesh, packed=True)
        port = cls(cfg, g, "cpu").offline().build_index(block_size=64)
        out[name] = (ref, port.attach_device("cpu"))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)


def _oracle(g, q, cands, iters):
    """Arc consistency in numpy over the 0/1 matrix."""
    c = np.zeros((g.num_vertices, q.num_vertices))
    for i, cand in enumerate(cands):
        c[cand, i] = 1.0
    for _ in range(iters):
        reach = neighbor_sum_np(g.offsets, g.neighbors, c) > 0
        keep = c.copy()
        for i in range(q.num_vertices):
            for j in q.vertex_neighbors(i):
                keep[:, i] *= reach[:, j]
        if np.array_equal(keep, c):
            break
        c = keep
    return [np.nonzero(c[:, i])[0].astype(np.int64)
            for i in range(q.num_vertices)]


@pytest.mark.parametrize("variant", ["pe", "pge"])
@pytest.mark.parametrize("iters", [0, 1, 2, 3, 50])
def test_semijoin_prune_equals_jax(graphs, engines, variant, iters):
    """Rounds 1-3 and the fixpoint (50 rounds are more than it needs)."""
    g, queries = graphs
    _, port = engines[variant]
    pruned = 0
    for q in queries:
        cands = port.online(q).candidates
        got = semijoin_prune(g, q, cands, "cpu", iters=iters)
        _same(got, jax_preverify.semijoin_prune(g, q, cands, iters=iters))
        _same(got, _oracle(g, q, cands, iters))
        assert all(np.isin(a, b).all() for a, b in zip(got, cands))
        pruned += sum(map(len, cands)) - sum(map(len, got))
    assert (pruned > 0) == (iters > 0)


def test_semijoin_prune_rounds_and_csr_reuse(graphs, engines, monkeypatch):
    """One neighbour sum per round, the loop ends at the fixpoint, and a
    CSR already on the device is used as it is."""
    g, queries = graphs
    _, port = engines["pe"]
    q = queries[0]
    cands = port.online(q).candidates
    calls = []
    real = spmm.neighbor_sum
    monkeypatch.setattr(preverify, "neighbor_sum",
                        lambda off, nbr, x: calls.append((off, x)) or
                        real(off, nbr, x))
    csr = to_device(g, "cpu")[:2]
    fix = semijoin_prune(g, q, cands, "cpu", iters=50, csr=csr)
    rounds = len(calls)
    assert 1 < rounds < 50
    assert all(off is csr[0] for off, _ in calls)
    assert all(x.dtype.is_floating_point and x.element_size() == 4
               and x.shape == (g.num_vertices, q.num_vertices)
               for _, x in calls)
    # The last round changed nothing; one round fewer is not the fixpoint.
    _same(fix, semijoin_prune(g, q, cands, "cpu", iters=rounds))
    short = semijoin_prune(g, q, cands, "cpu", iters=rounds - 2)
    assert sum(map(len, short)) > sum(map(len, fix))
    # Empty candidate sets prune everything next to them.
    none = semijoin_prune(g, q, [c[:0] for c in cands], "cpu")
    assert [len(c) for c in none] == [0] * q.num_vertices


@pytest.mark.parametrize("serve", ["online", "online_many"])
def test_pge_counts_unchanged_under_preverify(graphs, engines, serve):
    g, queries = graphs
    ref, port = engines["pge"]
    if serve == "online":
        plains = [port.online(q) for q in queries]
        gots = [port.online(q, preverify=2) for q in queries]
    else:
        plains = port.online_many(queries)
        gots = port.online_many(queries, preverify=2)
    shrunk = 0
    for q, plain, got in zip(queries, plains, gots):
        want = ref.online(q, engine="native", preverify=2)
        assert got.answer_count == plain.answer_count == want.answer_count
        _same(got.candidates, want.candidates)
        assert list(got.timings_ms) == ["query_plan", "search", "preverify",
                                        "refine", *REFINE_SPANS]
        assert "preverify" not in plain.timings_ms
        shrunk += sum(map(len, plain.candidates)) - sum(map(len,
                                                            got.candidates))
    assert shrunk > 0
    # The data graph's CSR went to the device once.
    csr = port._csr
    port.online(queries[0], preverify=1)
    assert port._csr is csr


@pytest.mark.parametrize("preverify_rounds", [1, 2, 3])
def test_pe_preverify_equals_jax(graphs, engines, preverify_rounds):
    """PE counts may move under pruning; they move as gnnpe_tpu's do."""
    g, queries = graphs
    ref, port = engines["pe"]
    for q in queries:
        got = port.online(q, preverify=preverify_rounds)
        want = ref.online(q, engine="native", preverify=preverify_rounds)
        _same(got.candidates, want.candidates)
        assert got.answer_count == want.answer_count


@pytest.mark.parametrize("variant", ["pe", "pge"])
def test_online_many_preverify_equals_jax(graphs, engines, variant):
    g, queries = graphs
    ref, port = engines[variant]
    got = port.online_many(queries, preverify=2)
    want = ref.online_many(queries, engine="native", preverify=2,
                           union="device")
    single = [port.online(q, preverify=2) for q in queries]
    for a, b, c in zip(got, want, single):
        _same(a.candidates, b.candidates)
        _same(a.candidates, c.candidates)
        assert a.answer_count == b.answer_count == c.answer_count
        assert list(a.timings_ms) == ["query_plan", "search", "preverify",
                                      "refine", *REFINE_SPANS]
    off = port.online_many(queries)
    assert all(list(r.timings_ms) == ["query_plan", "search", "refine",
                                      *REFINE_SPANS] for r in off)
    # One query, and the python engine, take the unthreaded path.
    one = port.online_many(queries[:1], engine="python", preverify=2)
    assert one[0].answer_count == got[0].answer_count
