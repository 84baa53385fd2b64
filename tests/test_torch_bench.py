"""The port's aggregation benchmark (gnnpe_tpu_torch/bench.py) against the
root ``bench.py`` and gnnpe_tpu's four aggregations, on the CPU at a
small size (V=2,000, 16,000 arcs, D=8).

Tolerances: rtol 1e-5, atol 1e-6 for one step of each implementation
against gnnpe_tpu's, f32 sums in another order (as tests/test_torch_ell.py
states); the graph and the probe's slot list bit for bit.  The CUDA test
skips without a card:
    python -m pytest --noconftest -q -m cuda tests/test_torch_bench.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch import bench
from gnnpe_tpu_torch.parallel.mesh import process_group

V, E, D = 2_000, 16_000, 8
SMALL = ["--device", "cpu", "--num-vertices", str(V), "--num-edges", str(E),
         "--dim", str(D)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed=0):
    src, dst = bench.synth_graph(V, E, seed)
    offs, nbr = bench.csr_of(src, dst, V)
    x = np.random.RandomState(seed + 1).rand(V, D).astype(np.float32)
    return src, dst, offs, nbr, x


def _port_step(offs, nbr, x, implementation):
    with process_group("cpu"):
        a = bench.build_aggregation(offs, nbr, x, implementation, "cpu")
        with torch.no_grad():
            return a.to_vertices(a.agg(a.x)).numpy()


def _gnnpe_tpu_step(src, dst, offs, nbr, x, implementation):
    """The root bench's aggregation of ``implementation`` (bench.py:
    116-148), one step, in vertex order."""
    import jax.numpy as jnp
    if implementation == "binned":
        from gnnpe_tpu.ops.ell import build_binned_ell
        lay = build_binned_ell(offs, nbr, feature_dim_hint=D)
        assert lay.hub_rows is not None and len(lay.hub_rows)
        return np.asarray(lay.unpermute(lay.apply_perm(
            lay.permute(jnp.asarray(x)))))
    if implementation == "ell":
        from gnnpe_tpu.ops.ell import build_ell
        return np.asarray(build_ell(offs, nbr, width=8, level2_width=8)
                          .apply(jnp.asarray(x)))
    if implementation == "binned_halo":
        from gnnpe_tpu.parallel.binned_halo import BinnedHaloPlan
        from gnnpe_tpu.parallel.mesh import make_mesh
        plan = BinnedHaloPlan.build(offs, nbr, np.zeros(V, np.int64), 1,
                                    feature_dim_hint=D)
        agg = plan.make_aggregate(make_mesh(1, axes=("graph",), shape=(1,)))
        return plan.unshard_features(np.asarray(agg(jnp.asarray(
            plan.shard_features(x)))))
    from gnnpe_tpu.ops.spmm import neighbor_sum
    return np.asarray(neighbor_sum(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(x), V))


@pytest.mark.parametrize("num_vertices,num_edges,seed",
                         [(V, E, 0), (V, E, 5), (100_000, 800_000, 0)])
def test_synth_graph_bit_equal_to_root(num_vertices, num_edges, seed):
    import bench as root_bench
    got = bench.synth_graph(num_vertices, num_edges, seed)
    want = root_bench.synth_graph(num_vertices, num_edges, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # The CSR the root builds (bench.py:114-115): a multigraph as it is.
    offs, nbr = bench.csr_of(*got, num_vertices)
    counts = np.bincount(want[1], minlength=num_vertices)
    assert np.array_equal(offs, np.concatenate([[0], np.cumsum(counts)]))
    assert offs.dtype == np.int32 and np.array_equal(nbr, want[0])


@pytest.mark.parametrize("implementation", bench.IMPLEMENTATIONS)
def test_one_step_matches_gnnpe_tpu(implementation):
    src, dst, offs, nbr, x = _inputs()
    got = _port_step(offs, nbr, x, implementation)
    want = _gnnpe_tpu_step(src, dst, offs, nbr, x, implementation)
    assert got.shape == want.shape == (V, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _head_graph():
    """tests/test_torch_ell.py's "head" graph: 42 vertices wider than
    the widest class, so the layout has head levels."""
    from gnnpe_tpu.io.datasets import powerlaw_graph
    g = powerlaw_graph(2000, 12000, 8, seed=0, max_degree=300)
    return g.offsets, g.neighbors


@pytest.mark.parametrize("graph", ["bench", "head"])
def test_slot_list_bit_equal_to_root(graph):
    from gnnpe_tpu.ops.ell import build_binned_ell
    from gnnpe_tpu_torch.ops.ell import build_binned_ell as port_build
    offs, nbr = (_inputs()[2:4] if graph == "bench" else _head_graph())
    v = len(offs) - 1
    lay = build_binned_ell(offs, nbr)
    # bench.py:158-161, as the root bench builds it from its layout.
    parts = [t.reshape(-1) for t in lay.class_tables]
    parts += [t.reshape(-1) for t in lay.head_tables]
    want = np.minimum(np.concatenate(parts), v - 1)
    assert (len(lay.head_tables) > 0) == (graph == "head")
    got = bench.slot_list(port_build(offs, nbr))
    assert got.dtype == want.dtype and np.array_equal(got, want)


# A 4-vertex toy: in-degrees 2, 1, 0, 2 (CSR by destination), D=2.
TOY_OFFS = np.array([0, 2, 3, 3, 5], np.int32)
TOY_NBR = np.array([1, 2, 0, 1, 3], np.int32)
# Index bytes, counted by hand from the toy's layouts:
TOY_INDEX_BYTES = {
    # one width-4 class of 4 rows: 16 int32 slots + 4 f32 pad counts
    "binned": 16 * 4 + 4 * 4,
    # level 1: 4 chunk rows of 8; level 2: 4 rows of 8; int32
    "ell": (4 * 8 + 4 * 8) * 4,
    # local group: vertex 2 in the zero tail, a width-4 class of 3 rows
    # (12 slots + 3 pad counts); empty halo group; the send gather's CSR
    # of one slot (2 offsets, no neighbour)
    "binned_halo": 12 * 4 + 3 * 4 + 2 * 4,
    # offsets [5] and neighbours [5], int32
    "flat": 5 * 4 + 5 * 4,
}


@pytest.mark.parametrize("implementation", bench.IMPLEMENTATIONS)
def test_bound_bytes_match_a_hand_count(implementation):
    x = np.random.RandomState(0).rand(4, 2).astype(np.float32)
    with process_group("cpu"):
        a = bench.build_aggregation(TOY_OFFS, TOY_NBR, x, implementation,
                                    "cpu")
        out = a.to_vertices(a.agg(a.x)).numpy()
    from gnnpe_tpu_torch.ops.spmm import neighbor_sum_np
    np.testing.assert_allclose(out, neighbor_sum_np(TOY_OFFS, TOY_NBR, x),
                               rtol=1e-6)
    index = TOY_INDEX_BYTES[implementation]
    assert a.index_bytes == index
    bound = bench.step_bound(4, 5, 2, a.index_bytes, 1e9, 1e12)
    # x read, the sums written, the * 0.1 read and written: 16 B a
    # vertex and column; one add per arc and column, one multiply per
    # element.
    assert bound["bytes"] == 16 * 4 * 2 + index
    assert bound["ops"] == 5 * 2 + 4 * 2
    assert bound["bound_by"] == "bytes"
    assert bound["bound_s"] == pytest.approx((16 * 4 * 2 + index) / 1e9)
    assert bench.step_bound(4, 5, 2, index, 1e12, 1.0)["bound_by"] == \
        "operations"


def _last_lines(capsys, argv):
    assert bench.main(argv) == 0
    return capsys.readouterr().out.strip().splitlines()


def test_main_prints_the_root_keys_last(capsys, tmp_path):
    metrics = tmp_path / "m.jsonl"
    lines = _last_lines(capsys, SMALL + ["--metrics", str(metrics),
                                         "--trace", str(tmp_path / "tr")])
    last = json.loads(lines[-1])
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == "aggregation_edges_per_sec_chip"
    assert last["unit"] == "edges/s" and last["value"] > 0
    assert np.isfinite(last["vs_baseline"]) and last["vs_baseline"] > 0
    record = json.loads(lines[-2][len("record: "):])
    assert last["vs_baseline"] == record["vs_baseline"]
    assert last["value"] == round(record["edges_per_sec"])
    rows = [json.loads(l[len("bench row: "):]) for l in lines
            if l.startswith("bench row: ")]
    assert [r["implementation"] for r in rows] == ["binned", "binned_halo"]
    assert rows[0]["share_of_bound"] == pytest.approx(
        rows[0]["bound_s"] / rows[0]["step_s"])
    assert rows[0]["num_hubs"] > 0 and rows[0]["graph_s"] is None
    assert "probe_s" in rows[0]["continuity"]
    events = [json.loads(l)["event"] for l in metrics.read_text().splitlines()]
    assert events == ["aggregation", "binned_halo_1shard", "record"]
    assert os.listdir(tmp_path / "tr")


def test_without_test_dir_query_latency_is_not_run(capsys):
    lines = _last_lines(capsys, SMALL + ["--implementation", "flat",
                                         "--skip-halo"])
    record = json.loads(lines[-2][len("record: "):])
    assert record["query_latency"] == "not run (no --test-dir)"
    assert "binned_halo_ratio" not in record
    assert [l for l in lines if l.startswith("bench row: ")][0].count(
        '"implementation": "flat"') == 1


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--num-vertices", str(V), "--num-edges", str(E)])


def test_query_latency_counts_equal_gnnpe_tpu(tmp_path):
    from gnnpe_tpu.config import PEConfig, PGEConfig
    from gnnpe_tpu.engine import PEEngine, PGEEngine
    from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
    g = powerlaw_graph(400, 1400, 8, seed=3, max_degree=40)
    q = sample_query(g, 5, seed=1)
    g.to_graph_file(str(tmp_path / "data_graph.graph"))
    q.to_graph_file(str(tmp_path / "query_graph.graph"))
    want_pe = PEEngine(PEConfig.from_cli(), g).offline().build_index() \
        .online(q).answer_count
    want_pge = PGEEngine(PGEConfig.from_cli(), g).offline() \
        .online(q).answer_count
    assert want_pe > 0 and want_pge > 0
    pe_ms, pge_ms = bench.bench_query_latency(
        str(tmp_path), want_pe=want_pe, want_pge=want_pge, device="cpu")
    assert pe_ms > 0 and pge_ms > 0
    with pytest.raises(RuntimeError, match="PE answered"):
        bench.bench_query_latency(str(tmp_path), want_pe=want_pe + 1,
                                  want_pge=want_pge, device="cpu")


def test_bench_never_imports_jax():
    code = (
        "import json, sys\n"
        "from gnnpe_tpu_torch import bench\n"
        f"bench.main({SMALL!r} + ['--implementation', 'ell'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gnnpe_tpu', 'bench'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
@pytest.mark.parametrize("implementation", bench.IMPLEMENTATIONS)
def test_cuda_step_and_record(implementation):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from gnnpe_tpu_torch.ops.spmm import neighbor_sum_np
    _, _, offs, nbr, x = _inputs()
    with process_group("cuda"):
        a = bench.build_aggregation(offs, nbr, x, implementation, "cuda")
        got = a.to_vertices(a.agg(a.x)).cpu().numpy()
    np.testing.assert_allclose(got, neighbor_sum_np(offs, nbr, x),
                               rtol=1e-5, atol=1e-6)
    rec = {}
    eps, frac, step_s = bench.bench_aggregation(V, E, D, implementation,
                                                "cuda", record=rec)
    assert eps > 0 and np.isfinite(frac) and rec["graph_s"] > 0
    assert sum(rec["launches_per_step"].values()) > 0
