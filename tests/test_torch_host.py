"""The port's own host layer (numpy) against the gnnpe_tpu originals it
was copied from, on numpy-seeded inputs.

Both sides run the same arithmetic in numpy, so every comparison is
bit-equal (tolerance 0).  Each package gets its own ``CSRGraph`` and its
own embeddings, built from the same numpy arrays: no object of one
package is handed to a function of the other.
"""

import dataclasses
import importlib
import os
import pathlib

import numpy as np
import pytest

import gnnpe_tpu_torch
from gnnpe_tpu_torch.kernels import _build

REF = "gnnpe_tpu"
PORT = "gnnpe_tpu_torch"
SIDES = (REF, PORT)


def mod(side, name):
    return importlib.import_module(f"{side}.{name}")


def same(a, b):
    """Bit-equal arrays, scalars, dataclasses, or sequences of them."""
    if dataclasses.is_dataclass(a):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _edges(seed=0, v=400, e=1600, labels=6, hub=90):
    rng = np.random.RandomState(seed)
    pairs = np.concatenate([
        np.stack([np.zeros(hub, np.int64), np.arange(1, hub + 1)], 1),
        rng.randint(1, v - 5, (e, 2))])           # the last 5 stay isolated
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    pairs = np.unique(np.sort(pairs, axis=1), axis=0)
    return v, pairs, rng.randint(0, labels, v)


def graphs(**kw):
    """The same graph as each package's own CSRGraph."""
    v, pairs, labels = _edges(**kw)
    return {s: mod(s, "graph.csr").CSRGraph.from_edges(v, pairs, labels)
            for s in SIDES}


def both(name, fn, call):
    """``call(fn of each side, side)`` for both packages."""
    return [call(getattr(mod(s, name), fn), s) for s in SIDES]


# ---- 1. config ------------------------------------------------------------

def test_config_constants_and_cli_semantics():
    ref, port = mod(REF, "config"), mod(PORT, "config")
    assert (ref.EPSILON, ref.UNLIMITED) == (port.EPSILON, port.UNLIMITED)
    for cls in ("PEConfig", "PGEConfig"):
        for kw in ({}, dict(l=3, e=4, p=2, n=1000)):
            a = getattr(ref, cls).from_cli(**kw)
            b = getattr(port, cls).from_cli(**kw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (a.pde_dim, a.edges_per_path) == (b.pde_dim,
                                                     b.edges_per_path)
    assert gnnpe_tpu_torch.PEConfig is port.PEConfig


# ---- 2. graph ---------------------------------------------------------------

def test_csr_graph_fields_and_queries(tmp_path):
    g = graphs()
    a, b = g[REF], g[PORT]
    for name in ("offsets", "neighbors", "labels", "degrees",
                 "label_frequency", "reverse_index", "reverse_offsets",
                 "nlf"):
        same(getattr(a, name), getattr(b, name))
    for name in ("num_vertices", "num_edges", "labels_count", "max_degree",
                 "max_label_frequency"):
        assert getattr(a, name) == getattr(b, name)
    assert (a.degrees == 0).sum() >= 5
    rng = np.random.RandomState(1)
    u, v = rng.randint(0, a.num_vertices, (2, 500))
    same(a.has_edge(u, v), b.has_edge(u, v))
    same(a.label_adjacency(), b.label_adjacency())
    same(a.neighbors_with_label(0, 2), b.neighbors_with_label(0, 2))
    same(a.coo(), b.coo())
    same(a.vertices_with_label(1), b.vertices_with_label(1))
    # The text format both ways: each package reads the other's file.
    files = {s: str(tmp_path / f"{s}.graph") for s in SIDES}
    for s in SIDES:
        g[s].to_graph_file(files[s])
    assert pathlib.Path(files[REF]).read_bytes() == \
        pathlib.Path(files[PORT]).read_bytes()
    back = mod(PORT, "graph.csr").CSRGraph.from_graph_file(files[REF])
    same(back.neighbors, a.neighbors)
    same(back.labels, a.labels)
    assert not hasattr(b, "device_arrays")


@pytest.mark.parametrize("seed,labels,chunk", [
    (20, 1, None), (21, 6, None), (22, 25, None), (23, 6, 4), (24, 13, 1)],
    ids=["one-label", "six", "twenty-five", "six-chunked", "row-a-chunk"])
def test_label_adjacency_equals_the_lexsort_build(monkeypatch, seed, labels,
                                                  chunk):
    """The port's label runs (one stable sort by row and label, the
    offsets counted a chunk of rows at a time) against gnnpe_tpu's
    three-key ``lexsort`` build, on random graphs with a hub and
    isolated vertices; ``chunk`` shrinks the port's chunks to a few
    rows."""
    if chunk is not None:
        monkeypatch.setattr(mod(PORT, "graph.csr"), "LABEL_RUN_CHUNK",
                            chunk * labels)
    g = graphs(seed=seed, labels=labels)
    same(g[REF].label_adjacency(), g[PORT].label_adjacency())
    neighbors, offsets = g[PORT].label_adjacency()
    assert offsets.shape == (g[PORT].num_vertices,
                             g[PORT].labels_count + 1)
    same(offsets[:, -1], g[PORT].degrees)


@pytest.mark.parametrize("strategy", ["multilevel", "bfs", "round_robin",
                                      "block", "auto"])
def test_partition_graph(strategy):
    g = graphs(seed=2)
    same(*both("graph.partition", "partition_graph",
               lambda f, s: f(g[s], 4, strategy=strategy)))


def test_degree_order_and_membership_file(tmp_path):
    g = graphs(seed=3)
    same(*both("graph.partition", "degree_sorted_nodes",
               lambda f, s: f(g[s])))
    mem = np.random.RandomState(0).randint(0, 3, g[REF].num_vertices)
    for s in SIDES:
        mod(s, "graph.partition").write_membership(
            str(tmp_path / f"{s}.txt"), g[s], mem)
    assert (tmp_path / f"{REF}.txt").read_bytes() == \
        (tmp_path / f"{PORT}.txt").read_bytes()


# ---- 3. features and the host neighbour sum ---------------------------------

@pytest.mark.parametrize("labels_count,dim", [(1, 1), (15, 2), (71, 5)])
def test_label_feature_table(labels_count, dim):
    same(*both("ops.mt19937", "label_feature_table",
               lambda f, s: f(labels_count, dim)))


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_neighbor_sum_np(scale):
    g = graphs(seed=4)
    x = np.random.RandomState(5).rand(g[REF].num_vertices, 3) * scale
    same(*both("ops.spmm", "neighbor_sum_np",
               lambda f, s: f(g[s].offsets, g[s].neighbors, x)))


# ---- 4. VDE -------------------------------------------------------------------

def _vde(g, dim=2):
    return {REF: mod(REF, "embed.vde").gen_vde(g[REF], dim),
            PORT: mod(PORT, "embed.vde").gen_vde_host(g[PORT], dim)}


@pytest.mark.parametrize("dim", [1, 2, 4])
def test_gen_vde_host(dim):
    ve = _vde(graphs(seed=6), dim)
    same(ve[REF], ve[PORT])
    assert ve[PORT].num_vertices == ve[REF].num_vertices
    assert ve[PORT].dim == dim
    assert type(ve[PORT]).__module__ == f"{PORT}.embed.vde"


# ---- 5. paths and PDE ---------------------------------------------------------

def _paths(g, length, dedup):
    return {s: mod(s, "paths.enumerate").enumerate_paths(
        g[s], mod(s, "graph.partition").degree_sorted_nodes(g[s]), length,
        dedup=dedup)[0] for s in SIDES}


@pytest.mark.parametrize("length,dedup", [(2, True), (3, True), (3, False)])
def test_enumerate_paths(length, dedup):
    g = graphs(seed=7, v=200, e=500, hub=30)
    p = _paths(g, length, dedup)
    same(p[REF], p[PORT])
    assert p[PORT].shape[0] > 0


def test_enumerate_with_membership_and_streaming_dedup():
    g = graphs(seed=8, v=200, e=500, hub=30)
    mem = np.random.RandomState(1).randint(0, 3, 200)
    order = mod(REF, "graph.partition").degree_sorted_nodes(g[REF])
    got = both("paths.enumerate", "enumerate_paths",
               lambda f, s: f(g[s], order, 3, dedup=True, membership=mem))
    same(got[0][0], got[1][0])
    same(got[0][1], got[1][1])
    rows = both("paths.enumerate", "enumerate_paths_from",
                lambda f, s: f(g[s], order[:50], 3))
    same(*rows)
    ranks = both("paths.enumerate", "start_ranks",
                 lambda f, s: f(order, 200))
    same(*ranks)
    same(*both("paths.enumerate", "dedup_orientations_streaming",
               lambda f, s: f(rows[0], ranks[0])))


def test_pde_tables_and_path_groups():
    g = graphs(seed=9, v=200, e=500, hub=30)
    ve = _vde(g)
    p = _paths(g, 3, True)[REF]
    same(*both("embed.pde", "gen_pde", lambda f, s: f(ve[s], p)))
    same(*both("embed.pde", "gen_query_pde_table",
               lambda f, s: f(ve[s], p[:40])))
    full = _paths(g, 2, False)[REF]
    got = both("embed.pde", "path_groups",
               lambda f, s: f(ve[s], full[:, 0], full, 4))
    same(*got)
    assert type(mod(PORT, "embed.pde").gen_pde(ve[PORT], p)).__module__ \
        == f"{PORT}.embed.pde"


# ---- 6. plan, refinement, filters ---------------------------------------------

def _query(g, size=6, seed=0):
    return {s: mod(s, "io.datasets").sample_query(g[s], size, seed=seed)
            for s in SIDES}


def test_plan_functions():
    g = graphs(seed=10)
    q = _query(g)
    ve = {REF: mod(REF, "embed.vde").gen_vde(q[REF], 2),
          PORT: mod(PORT, "embed.vde").gen_vde_host(q[PORT], 2)}
    qp = _paths(q, 3, True)[REF]
    weight = mod(REF, "embed.pde").gen_query_pde_table(ve[REF], qp)[1]
    same(*both("match.plan", "greedy_path_cover",
               lambda f, s: f(qp, weight, q[s].num_vertices)))
    counts = np.random.RandomState(2).randint(1, 50, q[REF].num_vertices)
    orders = both("match.plan", "gql_order", lambda f, s: f(q[s], counts))
    same(*orders)
    same(*both("match.plan", "generate_bn",
               lambda f, s: f(q[s], *orders[0])))


@pytest.mark.parametrize("engine", ["native", "python"])
def test_refinement_counts_and_embeddings(engine):
    g = graphs(seed=11)
    q = _query(g, size=5, seed=3)
    cands = [np.nonzero((g[REF].labels == lab)
                        & (g[REF].degrees >= deg))[0]
             for lab, deg in zip(q[REF].labels, q[REF].degrees)]
    got = both("match.refine", "refinement",
               lambda f, s: f(g[s], q[s], cands, engine=engine))
    assert got[0] == got[1] > 0
    emb = both("match.refine", "refinement",
               lambda f, s: f(g[s], q[s], cands, 50, engine=engine,
                              return_embeddings=True))
    assert emb[0][0] == emb[1][0]
    same(np.asarray(emb[0][1], np.int64), np.asarray(emb[1][1], np.int64))


def test_native_refinement_builds_outside_the_packages():
    g = graphs(seed=11)
    tri = mod(PORT, "graph.csr").CSRGraph.from_edges(
        3, np.array([[0, 1], [1, 2], [0, 2]]), np.zeros(3, np.int64))
    assert mod(PORT, "match.refine").refinement(
        tri, tri, [np.arange(3)] * 3, engine="native") == 6
    built = list(_build.BUILD_DIR.glob("libgnnpe_refine_*.so"))
    assert built, f"no native refinement library under {_build.BUILD_DIR}"
    pkg = pathlib.Path(gnnpe_tpu_torch.__file__).parent
    assert not list(pkg.rglob("*.so"))
    with pytest.raises(ValueError):
        mod(PORT, "match.refine").refinement(
            g[PORT], tri, [np.arange(3)] * 3, engine="auto")


def _pe_inputs(seed=12):
    g = graphs(seed=seed, v=200, e=500, hub=30)
    q = _query(g, size=5, seed=1)
    ve = _vde(g)
    qv = {REF: mod(REF, "embed.vde").gen_vde(q[REF], 2),
          PORT: mod(PORT, "embed.vde").gen_vde_host(q[PORT], 2)}
    paths = _paths(g, 3, True)[REF]
    qpaths = _paths(q, 3, True)[REF]
    data = {s: mod(s, "embed.pde").gen_pde(ve[s], paths) for s in SIDES}
    query, weight = {}, None
    for s in SIDES:
        query[s], weight, _ = mod(s, "embed.pde").gen_query_pde_table(
            qv[s], qpaths)
    plan = mod(REF, "match.plan").greedy_path_cover(qpaths, weight,
                                                    q[REF].num_vertices)
    return g, q, ve, qv, paths, data, query, plan


def test_pe_filters():
    g, q, ve, qv, paths, data, query, plan = _pe_inputs()
    nq = q[REF].num_vertices
    same(*both("match.filter", "eps_threshold",
               lambda f, s: f(query[s].pde, 1e-6)))
    flat = both("match.filter", "pe_candidates",
                lambda f, s: f(data[s], query[s], plan, nq))
    same(*flat)
    chunked = both("match.filter", "pe_candidates_chunked",
                   lambda f, s: f(ve[s], paths, query[s], plan, nq,
                                  chunk=97))
    same(*chunked)
    same(flat[1], chunked[1])
    # The threaded oracle (one chunk range a worker) gives the same sets.
    threaded = mod(PORT, "match.filter").pe_candidates_chunked(
        ve[PORT], paths, query[PORT], plan, nq, chunk=97, workers=4)
    same(chunked[0], threaded)
    assert sum(map(len, flat[1])) > 0
    mask = np.random.RandomState(3).rand(len(plan), len(paths)) < 0.01
    same(*both("match.device_filter", "extract_candidates",
               lambda f, s: f(mask, data[s].vids, query[s].vids[plan], nq)))


def _pge_inputs(seed=13):
    g = graphs(seed=seed, v=200, e=500, hub=30)
    q = _query(g, size=5, seed=2)
    ve = _vde(g)
    qv = {REF: mod(REF, "embed.vde").gen_vde(q[REF], 2),
          PORT: mod(PORT, "embed.vde").gen_vde_host(q[PORT], 2)}
    dp = _paths(g, 2, False)[REF]
    qp = _paths(q, 2, False)[REF]
    groups = {s: mod(s, "embed.pde").path_groups(ve[s], dp[:, 0], dp, 4)
              for s in SIDES}
    qgroups = {s: mod(s, "embed.pde").path_groups(qv[s], qp[:, 0], qp, 4)
               for s in SIDES}
    return g, q, ve, qv, groups, qgroups


def test_pge_filters():
    g, q, ve, qv, groups, qgroups = _pge_inputs()
    ids = list(range(q[REF].num_vertices))

    def args(s):
        return (ve[s].labels, ve[s].degrees, *groups[s], qv[s].labels,
                qv[s].degrees, *qgroups[s], ids)

    flat = both("match.filter", "pge_candidates",
                lambda f, s: f(*args(s), epsilon=1e-6))
    same(*flat)
    chunked = both("match.filter", "pge_candidates_chunked",
                   lambda f, s: f(*args(s), epsilon=1e-6, chunk=37))
    same(*chunked)
    same(flat[1], chunked[1])
    assert sum(map(len, flat[1])) > 0


# ---- 7. packed indexes and the sort key ---------------------------------------

def test_packed_pe_index_build_search_and_files(tmp_path):
    g, q, ve, qv, paths, data, query, plan = _pe_inputs(seed=14)
    nq = q[REF].num_vertices
    idx = {s: mod(s, "index.packed").PackedDominanceIndex.build(
        data[s], block_size=64) for s in SIDES}
    same(idx[REF], idx[PORT])
    got = [idx[s].search(query[s], plan, nq) for s in SIDES]
    same(*got)
    same(got[1], mod(PORT, "match.filter").pe_candidates(
        data[PORT], query[PORT], plan, nq))
    # One npz format both ways: each package loads what the other saved.
    stores = {s: mod(s, "io.artifacts").ArtifactStore(str(tmp_path / s))
              for s in SIDES}
    for s, other in ((REF, PORT), (PORT, REF)):
        path = mod(s, "index.packed").save_index(stores[s], "index", "fp",
                                                 idx[s])
        os.replace(path, stores[other]._path("index", "x" + s))
        back = mod(other, "index.packed").load_index(
            stores[other], "index", "x" + s,
            mod(other, "index.packed").PackedDominanceIndex)
        same(back, idx[other])
        assert type(back).__module__ == f"{other}.index.packed"


def test_packed_pge_index_build_and_search():
    g, q, ve, qv, groups, qgroups = _pge_inputs(seed=15)
    idx = {s: mod(s, "index.packed").PGEPackedIndex.build(
        ve[s].labels, ve[s].degrees, *groups[s], block_size=32)
        for s in SIDES}
    same(idx[REF], idx[PORT])
    ids = list(range(q[REF].num_vertices))
    same(*[idx[s].search(qv[s].labels, qv[s].degrees, *qgroups[s], ids,
                         epsilon=1e-6) for s in SIDES])


def test_sort_key_helpers():
    g, q, ve, qv, paths, data, query, plan = _pe_inputs(seed=16)
    name = "index.device_packed"
    x = np.random.RandomState(4).randn(50, 3) * 1e3
    for up in (True, False):
        same(*both(name, "_outward", lambda f, s: f(x, up, pad_rows=2)))
    same(*both(name, "sig_radix_of", lambda f, s: f(ve[s])))
    same(*both(name, "path_sig", lambda f, s: f(data[s].labels, 9)))
    tables = both(name, "key_tables", lambda f, s: f(ve[s]))
    same(*tables)
    same(*both(name, "composite_sort_key", lambda f, s: f(paths, ve[s])))
    same(*both(name, "composite_sort_key",
               lambda f, s: f(paths[:100], ve[s], tables[0])))


# ---- 8. the binned layout -------------------------------------------------------

def _layout_graphs():
    star = graphs(seed=17, v=3000, e=6000, hub=700)     # a 3-level head
    hubs = graphs(seed=18, v=300, e=800, hub=199)       # the hub product
    return {"head_chain": star, "hubs": hubs}


@pytest.mark.parametrize("name", ["head_chain", "hubs"])
@pytest.mark.parametrize("kw", [{}, dict(hub_matmul=False),
                                dict(widths=(2, 8, 32), hub_precision="bf16")],
                         ids=["default", "no_hubs", "widths"])
def test_build_binned_ell(name, kw):
    """conftest pins gnnpe_tpu's hub prices to its table's "cpu" row,
    the row the port's HUB_PRICES copies."""
    g = _layout_graphs()[name]
    lay = both("ops.ell", "build_binned_ell",
               lambda f, s: f(g[s].offsets, g[s].neighbors, **kw))
    for f in dataclasses.fields(lay[1]):
        same(getattr(lay[0], f.name), getattr(lay[1], f.name))
    if name == "head_chain":
        assert len(lay[1].head_tables) >= 3
    elif kw.get("hub_matmul", True):
        assert lay[1].num_hub_arcs > 0


def test_hub_prices_argument(monkeypatch):
    from gnnpe_tpu.utils import device_probe
    ref, port = mod(REF, "ops.ell"), mod(PORT, "ops.ell")
    assert port.HUB_PRICES == device_probe._table_lookup("cpu")
    assert port.DEFAULT_WIDTHS == ref.DEFAULT_WIDTHS
    g = _layout_graphs()["hubs"]
    cheap_gather = (50e9, 1e12, 2e-7)       # gathers 100x dearer: more hubs
    monkeypatch.setattr(ref, "_device_constants", lambda: cheap_gather)
    a = ref.build_binned_ell(g[REF].offsets, g[REF].neighbors)
    b = port.build_binned_ell(g[PORT].offsets, g[PORT].neighbors,
                              hub_prices=cheap_gather)
    base = port.build_binned_ell(g[PORT].offsets, g[PORT].neighbors)
    assert b.num_hub_arcs == a.num_hub_arcs > base.num_hub_arcs
    same(a.hub_counts, b.hub_counts)
    same(a.class_tables, b.class_tables)


# ---- 9. datasets and artifacts --------------------------------------------------

def test_datasets():
    ref, port = mod(REF, "io.datasets"), mod(PORT, "io.datasets")
    kw = dict(alpha=0.8, seed=3, max_degree=60)
    a, b = ref.powerlaw_graph(500, 2000, 7, **kw), \
        port.powerlaw_graph(500, 2000, 7, **kw)
    for name in ("offsets", "neighbors", "labels"):
        same(getattr(a, name), getattr(b, name))
    for tree in (True, False):
        qa = ref.sample_query(a, 7, tree=tree, seed=5)
        qb = port.sample_query(b, 7, tree=tree, seed=5)
        for name in ("offsets", "neighbors", "labels"):
            same(getattr(qa, name), getattr(qb, name))
    ya, yb = ref.load_dataset("yeast", seed=1), \
        port.load_dataset("yeast", seed=1)
    same(ya.neighbors, yb.neighbors)
    same(ya.labels, yb.labels)
    synthetic = {k: v for k, v in ref.LADDER.items() if "path" not in v}
    assert port.LADDER == synthetic


def test_artifact_store(tmp_path):
    data = tmp_path / "data.graph"
    data.write_text("t 0 0\n")
    stores = {s: mod(s, "io.artifacts").ArtifactStore(str(tmp_path / s))
              for s in SIDES}
    cfg = {s: mod(s, "config").PEConfig.from_cli(l=2, e=2) for s in SIDES}
    fps = [stores[s].fingerprint(cfg[s], str(data), extra={"x": 1})
           for s in SIDES]
    assert fps[0] == fps[1]
    arrays = dict(a=np.arange(5), b=np.random.RandomState(0).rand(3, 2))
    for s, other in ((REF, PORT), (PORT, REF)):
        path = stores[s].save("stage", fps[0], **arrays)
        os.replace(path, stores[other]._path("stage", "from" + s))
        assert stores[other].has("stage", "from" + s)
        back = stores[other].load("stage", "from" + s)
        same([back["a"], back["b"]], [arrays["a"], arrays["b"]])
    assert stores[PORT].load("stage", "missing") is None
    paths = np.random.RandomState(1).randint(0, 50, (20, 3)).astype(np.int32)
    for s in SIDES:
        stores[s].write_all_paths(str(tmp_path / f"{s}.paths"), paths)
    assert (tmp_path / f"{REF}.paths").read_bytes() == \
        (tmp_path / f"{PORT}.paths").read_bytes()


# ---- 10. graph algorithms, the dynamic graph, small helpers --------------------

def test_graph_ops_orders_matching_and_components():
    g = graphs(seed=14, v=120, e=260, hub=20)
    for fn in ("bfs_order", "dfs_order"):
        same(*both("graph.ops", fn, lambda f, s: f(g[s], 3)))
    same(*both("graph.ops", "core_order", lambda f, s: f(g[s])))
    same(g[REF].k_core(), g[PORT].k_core())
    same(*both("graph.ops", "connected_components", lambda f, s: f(g[s])))
    rng = np.random.RandomState(4)
    adj = [np.unique(rng.randint(0, 9, rng.randint(0, 4))) for _ in range(12)]
    same(*both("graph.ops", "bipartite_match", lambda f, s: f(adj, 9)))


def test_dynamic_graph_updates_and_snapshot():
    g = graphs(seed=15, v=60, e=120, hub=8)
    snaps, logs = [], []
    for s in SIDES:
        dyn = mod(s, "graph.dynamic")
        dg = dyn.DynamicGraph.from_csr(g[s])
        v = dg.add_vertex(3)
        dg.add_edge(v, 0)
        dg.add_edge(v, 7)
        dg.remove_edge(0, 1)
        dg.remove_vertex(5)
        snap = dg.snapshot()
        snaps.append([snap.offsets, snap.neighbors, snap.labels])
        logs.append([dataclasses.astuple(u) for u in dg.updates])
        assert type(snap).__module__ == f"{s}.graph.csr"
    same(*snaps)
    assert logs[0] == logs[1]


def test_path_group_keys_and_er_graph():
    group = np.random.RandomState(6).rand(9, 2, 4)
    same(*both("embed.pde", "path_group_keys", lambda f, s: f(group)))
    a, b = both("io.datasets", "er_graph", lambda f, s: f(300, 900, 5, seed=2))
    for name in ("offsets", "neighbors", "labels"):
        same(getattr(a, name), getattr(b, name))


# ---- 11. the reference's wire formats, partition quality, graph meta -----------

def test_reference_wire_format_readers_and_writers(tmp_path):
    stores = {s: mod(s, "io.artifacts").ArtifactStore(str(tmp_path / s))
              for s in SIDES}
    rng = np.random.RandomState(2)
    paths = rng.randint(0, 90, (25, 3)).astype(np.int32)
    rows = rng.randint(0, 25, 11)
    files = {}
    for s in SIDES:
        stores[s].write_all_paths(str(tmp_path / f"{s}.paths"), paths)
        stores[s].write_partition_paths(str(tmp_path / f"{s}.part"), rows)
        files[s] = (tmp_path / f"{s}.part").read_bytes()
    assert files[REF] == files[PORT]
    back = [stores[s].read_all_paths(str(tmp_path / f"{o}.paths"))
            for s, o in ((REF, PORT), (PORT, REF))]
    same(*back)
    assert np.array_equal(back[1], paths)
    empty = tmp_path / "empty.paths"
    empty.write_text("0\n")
    same(*[stores[s].read_all_paths(str(empty)) for s in SIDES])

    v, vde_dim, pde_dim = 17, 2, 4
    arrays = dict(labels=rng.randint(0, 5, v), degrees=rng.randint(0, 9, v),
                  keys=rng.rand(v), x=rng.rand(v, vde_dim),
                  nx=rng.rand(v, vde_dim), vde=rng.rand(v, vde_dim),
                  group=rng.rand(v, 2, pde_dim),
                  label_group=rng.rand(v, 2, pde_dim))
    for s in SIDES:
        stores[s].write_data_vertices_bin(str(tmp_path / f"{s}.bin"), vde_dim,
                                          pde_dim, **arrays)
    assert (tmp_path / f"{REF}.bin").read_bytes() == \
        (tmp_path / f"{PORT}.bin").read_bytes()
    got = [stores[s].read_data_vertices_bin(str(tmp_path / f"{s}.bin"),
                                            vde_dim, pde_dim) for s in SIDES]
    assert sorted(got[0]) == sorted(got[1])
    for k in got[0]:
        same(got[0][k], got[1][k])
    same(got[1]["group"], arrays["group"])


def test_edge_cut_and_membership_reader(tmp_path):
    g = graphs(seed=16)
    mem = np.random.RandomState(3).randint(0, 4, g[REF].num_vertices)
    same(*both("graph.partition", "edge_cut", lambda f, s: f(g[s], mem)))
    for s in SIDES:
        mod(s, "graph.partition").write_membership(
            str(tmp_path / f"{s}.txt"), g[s], mem)
    read = both("graph.partition", "read_membership",
                lambda f, s: f(str(tmp_path / f"{s}.txt"),
                               g[s].num_vertices))
    same(*read)
    same(read[1][1], mem.astype(np.int32))


def test_graph_meta_and_networkx_loader(tmp_path):
    g = graphs(seed=17)
    assert g[REF].meta() == g[PORT].meta()
    nx = pytest.importorskip("networkx")
    import gzip
    import pickle
    v, pairs, labels = _edges(seed=17)
    h = nx.Graph()
    h.add_nodes_from((i, {"label": int(labels[i])}) for i in range(v))
    h.add_edges_from(map(tuple, pairs))
    raw, packed = tmp_path / "raw.gpickle.gz", tmp_path / "packed.gpickle"
    raw.write_bytes(pickle.dumps(h))           # a raw pickle, .gz name
    with gzip.open(packed, "wb") as f:
        pickle.dump(h, f)
    for path in (raw, packed):
        a, b = both("graph.csr", "CSRGraph",
                    lambda c, s: c.from_networkx_gpickle(str(path)))
        for name in ("offsets", "neighbors", "labels"):
            same(getattr(a, name), getattr(b, name))
        same(b.neighbors, g[PORT].neighbors)
