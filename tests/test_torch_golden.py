"""The port against the reference's own Test/ outputs (tests/golden/),
on the Test/ data graph rebuilt from those fixtures: no data file is
added and the reference's Test/ directory is not read.

The rebuild (ROADMAP, fault R1): the 3-vertex paths of
``all_paths_l2.txt.gz`` hold 12,481 of the graph's 12,519 edges; the
other 38 are isolated K2 edges between degree-1 vertices, and the ``nx``
column of ``data_vertices_pge.bin`` names each one's partner label
(a degree-1 vertex's nx is its partner's x).  Any pairing inside a
(label, partner label) class gives an isomorphic graph with the same
paths and path groups.  Every fixture is read with the port's own
readers (``ArtifactStore``).
"""

import gzip
import json
import shutil

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.embed.pde import path_groups, path_groups_device
from gnnpe_tpu_torch.embed.vde import gen_vde, gen_vde_host
from gnnpe_tpu_torch.graph.csr import CSRGraph
from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
from gnnpe_tpu_torch.io.artifacts import ArtifactStore
from gnnpe_tpu_torch.ops.mt19937 import label_feature_table, label_seeded_x
from gnnpe_tpu_torch.paths.device_enumerate import enumerate_dedup_device
from gnnpe_tpu_torch.paths.enumerate import enumerate_paths

from .conftest import GOLDEN

VDE_DIM, PDE_DIM = 2, 4


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden")
    plain = tmp / "all_paths_l2.txt"
    with gzip.open(GOLDEN / "all_paths_l2.txt.gz", "rb") as src, \
            open(plain, "wb") as dst:
        shutil.copyfileobj(src, dst)
    store = ArtifactStore(str(tmp / "store"))
    with open(GOLDEN / "GOLDEN.json") as f:
        meta = json.load(f)
    return dict(
        meta=meta, store=store,
        paths=store.read_all_paths(str(plain)),
        vertices=store.read_data_vertices_bin(
            str(GOLDEN / "data_vertices_pge.bin"), VDE_DIM, PDE_DIM))


def _k2_edges(dv, missing):
    """Pair the degree-1 vertices the paths miss: u's partner has the
    label whose x equals nx[u]; within a (label, partner label) class
    the pairing is by ascending id."""
    table = label_feature_table(int(dv["labels"].max()) + 1, VDE_DIM)
    partner = np.array([int(np.nonzero((table == dv["nx"][u]).all(1))[0][0])
                        for u in missing])
    own = dv["labels"][missing]
    edges = []
    for a, b in sorted(set(zip(own.tolist(), partner.tolist()))):
        if a > b:
            continue
        left = missing[(own == a) & (partner == b)]
        right = missing[(own == b) & (partner == a)]
        if a == b:
            left, right = left[0::2], left[1::2]
        assert len(left) == len(right)
        edges += list(zip(left.tolist(), right.tolist()))
    return np.array(edges, dtype=np.int64)


@pytest.fixture(scope="module")
def data_graph(golden):
    dv, paths = golden["vertices"], golden["paths"]
    v = len(dv["labels"])
    pairs = np.concatenate([paths[:, :2], paths[:, 1:]])
    pairs = np.unique(np.sort(pairs, axis=1), axis=0)
    assert len(pairs) == 12_481
    seen = np.bincount(pairs.ravel(), minlength=v)
    missing = np.nonzero(seen < dv["degrees"])[0]
    assert len(missing) == 76 and (dv["degrees"][missing] == 1).all()
    assert (seen[missing] == 0).all()
    edges = np.concatenate([pairs, _k2_edges(dv, missing)])
    return CSRGraph.from_edges(v, edges, dv["labels"])


def test_rebuilt_graph_matches_the_reference_meta(golden, data_graph):
    want = golden["meta"]["data_graph"]
    got = data_graph.meta()
    assert got == {"num_vertices": want["V"], "num_edges": want["E"],
                   "labels_count": want["labels"],
                   "max_degree": want["max_degree"],
                   "max_label_frequency": want["max_label_frequency"]}
    assert np.array_equal(data_graph.degrees, golden["vertices"]["degrees"])


def test_pe_paths_equal_the_reference(golden, data_graph):
    want = golden["paths"]
    assert len(want) == golden["meta"]["pe"]["num_paths_l2"]
    order = degree_sorted_nodes(data_graph)
    host, _ = enumerate_paths(data_graph, order, 3, dedup=True)
    dev = enumerate_dedup_device(data_graph, order, 3, "cpu").numpy()
    rows = lambda a: {tuple(r) for r in np.asarray(a, np.int64).tolist()}
    assert rows(host) == rows(want) == rows(dev)
    # The rows come in the reference's order too.
    assert np.array_equal(host.astype(np.int64), want)
    assert np.array_equal(dev.astype(np.int64), want)


def test_partition_lists_equal_the_reference(data_graph):
    membership = np.arange(data_graph.num_vertices) % 5
    _, parts = enumerate_paths(data_graph, degree_sorted_nodes(data_graph),
                               3, dedup=True, membership=membership)
    for pid in range(5):
        tok = gzip.open(GOLDEN / f"partition_paths_{pid}.txt.gz",
                        "rt").read().split()
        assert int(tok[0]) == len(parts[pid])
        assert np.array_equal(parts[pid], np.array(tok[1:], dtype=np.int64))


def test_vde_equals_the_reference(golden, data_graph):
    rows = 0
    with open(GOLDEN / "vde_x_golden.txt") as f:
        for line in f:
            t = line.split()
            want = np.array([float(v) for v in t[2:]])
            assert np.array_equal(label_seeded_x(int(t[1]), int(t[0])), want)
            rows += 1
    assert rows == 480
    dv = golden["vertices"]
    for ve in (gen_vde_host(data_graph, VDE_DIM),
               gen_vde(data_graph, VDE_DIM, "cpu")):
        for name in ("x", "nx", "vde"):
            assert np.array_equal(getattr(ve, name), dv[name]), name


def test_pge_groups_equal_the_reference(golden, data_graph, tmp_path):
    dv = golden["vertices"]
    ve = gen_vde_host(data_graph, VDE_DIM)
    order = degree_sorted_nodes(data_graph)
    p2, _ = enumerate_paths(data_graph, order, 2, dedup=False)
    group, lgroup = path_groups(ve, p2[:, 0], p2, PDE_DIM)
    assert np.array_equal(group, dv["group"])
    assert np.array_equal(lgroup, dv["label_group"])
    dgroup, dlgroup = path_groups_device(ve, data_graph, order, 2, PDE_DIM,
                                         torch.device("cpu"))
    assert np.array_equal(dgroup, dv["group"])
    assert np.array_equal(dlgroup, dv["label_group"])
    # The port's writer gives the reference's file byte for byte (data
    # vertices carry key 0.0, GNN-PGE/src/main.cpp:179-194).
    path = str(tmp_path / "dv.bin")
    golden["store"].write_data_vertices_bin(
        path, VDE_DIM, PDE_DIM, ve.labels, ve.degrees,
        np.zeros(data_graph.num_vertices), ve.x, ve.nx, ve.vde, group, lgroup)
    with open(path, "rb") as a, open(GOLDEN / "data_vertices_pge.bin",
                                     "rb") as b:
        assert a.read() == b.read()
