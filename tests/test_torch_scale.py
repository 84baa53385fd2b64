"""The port at the ladder's upper rungs, on the CPU at small sizes: the
resident/streamed rule against a fake card that counts the tensors
alive, the l=1 route of the ladder against gnnpe_tpu's, the device
enumeration into one preallocated table on a hub-skewed graph, the
bounded stable sort of the table-mode build, the youtube rungs'
generators against gnnpe_tpu's, and the CSR layer's int32 limit.
Every comparison is exact (paths, orders, CSR arrays, counts,
candidates, spot checks).  gnnpe_tpu is imported inside the tests that
run it."""

import types
import weakref

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from gnnpe_tpu_torch.embed.vde import gen_vde
from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.graph.partition import degree_sorted_nodes
from gnnpe_tpu_torch.index import device_packed
from gnnpe_tpu_torch.index.device_packed import (StreamedPESearch,
                                                 TablePESearch, stable_order,
                                                 table_build_bytes)
from gnnpe_tpu_torch.io.datasets import LADDER, load_dataset, powerlaw_graph
from gnnpe_tpu_torch.ops import spmm
from gnnpe_tpu_torch.paths import device_enumerate, pipeline
from gnnpe_tpu_torch.paths.enumerate import enumerate_paths


class FakeCard(TorchDispatchMode):
    """A card of ``size`` bytes: every tensor an op makes under the mode
    counts (by storage) while a tensor on that storage lives, and an op
    that takes the count past ``size`` raises CUDA's out-of-memory error.
    ``free`` is what the port's ``free_bytes`` would read there."""

    def __init__(self, size: int):
        super().__init__()
        self.size, self.live, self.peak = size, 0, 0
        self._storages = {}

    def free(self, device=None) -> int:
        return self.size - self.live

    def _release(self, key) -> None:
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage.data_ptr()
            if key == 0:
                continue
            if key not in self._storages:
                self._storages[key] = [0, storage.nbytes()]
                self.live += storage.nbytes()
            self._storages[key][0] += 1
            weakref.finalize(t, self._release, key)
        self.peak = max(self.peak, self.live)
        if self.live > self.size:
            raise torch.OutOfMemoryError(
                f"fake card: {self.live} B alive, {self.size} B")
        return out


@pytest.fixture(scope="module")
def small():
    g = powerlaw_graph(1200, 4000, 10, seed=3, max_degree=40)
    return g, degree_sorted_nodes(g), gen_vde(g, 2, "cpu")


def _on_card(monkeypatch, card):
    for mod in (device_packed, device_enumerate, pipeline):
        if hasattr(mod, "free_bytes"):
            monkeypatch.setattr(mod, "free_bytes", card.free)


@pytest.mark.parametrize("budget", ["share", "all"])
def test_rule_never_picks_a_mode_whose_build_fails(small, monkeypatch,
                                                   budget):
    """(a) At card sizes around the boundary the mode chosen before
    enumeration builds; where the table fits the budget but enumeration
    and build do not, the rule says streamed, and a resident build there
    does fail."""
    g, order, vertices = small
    monkeypatch.setattr(device_packed, "KEY_ROWS", 256)
    monkeypatch.setattr(device_packed, "SORT_ROWS", 512)
    monkeypatch.setattr(device_packed, "FOLD_BLOCKS", 4)
    # The streamed index's staging ring is host memory beside a card; the
    # fake card cannot tell it from the device's, so it is kept small.
    monkeypatch.setattr(device_packed, "STAGING_ROWS", 64)
    b, l = 16, 3
    p = device_enumerate.known_path_count(g, l)
    need = table_build_bytes(p, l, b, False, g.num_vertices, 2)
    table = -(-p // b) * b * l * 4
    seen = set()
    for frac in (0.6, 0.9, 0.97, 1.0, 1.03, 2.0):
        size = int(need * frac)
        card = FakeCard(size)
        _on_card(monkeypatch, card)
        budget_bytes = size if budget == "all" else None
        window = table <= device_packed.RESIDENT_SHARE * size or \
            budget == "all"
        with card:
            paths, idx, timings = pipeline.offline_build_pipelined(
                g, order, l, vertices, "cpu", block_size=b,
                budget_bytes=budget_bytes)
        resident = isinstance(idx, TablePESearch)
        assert resident == (window and need <= size), frac
        assert timings["mode"] == ("resident" if resident else "streamed")
        assert timings["rule_need_bytes"] == need
        assert card.peak <= size and idx.num_entries == p
        seen.add((resident, window))
        if window and not resident and frac == 0.97:
            # The table fits the budget; enumeration and build do not.
            card = FakeCard(size)
            _on_card(monkeypatch, card)
            with pytest.raises((MemoryError, torch.OutOfMemoryError)):
                with card:
                    pipeline.offline_build_pipelined(
                        g, order, l, vertices, "cpu", block_size=b,
                        resident=True)
        del paths, idx
    assert (True, True) in seen
    assert (False, True if budget == "all" else False) in seen


def test_resident_build_peak_under_the_model(small, monkeypatch):
    """The fake card's peak over a resident build with the paths already
    enumerated stays within ``table_build_bytes``."""
    g, order, vertices = small
    monkeypatch.setattr(device_packed, "KEY_ROWS", 256)
    monkeypatch.setattr(device_packed, "SORT_ROWS", 512)
    monkeypatch.setattr(device_packed, "FOLD_BLOCKS", 4)
    paths = device_enumerate.enumerate_dedup_device(g, order, 3, "cpu")
    p = len(paths)
    card = FakeCard(1 << 40)
    with card:
        TablePESearch.build_from_paths(paths, vertices, "cpu", block_size=16)
    assert 0 < card.peak <= table_build_bytes(p, 3, 16, True,
                                              g.num_vertices, 2)


@pytest.mark.parametrize("max_rows", [7, 64, 1000, 1 << 20])
def test_stable_order_is_numpys_stable_argsort(max_rows, monkeypatch):
    monkeypatch.setattr(device_packed, "SORT_ROWS", max_rows)
    rng = np.random.RandomState(5)
    key = rng.randint(0, 50, 4000).astype(np.int64) << 32
    key[rng.rand(4000) < 0.4] = 17 << 32          # one value ties heavily
    key[:300] = rng.randint(0, 1 << 62, 300)
    got = stable_order(torch.from_numpy(key))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.argsort(key, kind="stable"))


@pytest.fixture(scope="module")
def hub():
    """youtube_skew's spec (25 labels, alpha 0.85, degree uncapped) at a
    few thousand vertices: one start's paths dwarf the rest."""
    spec = LADDER["youtube_skew"]
    g = powerlaw_graph(3000, 8000, spec["labels"], alpha=spec["alpha"],
                       seed=0)
    return g, degree_sorted_nodes(g)


def test_enumeration_into_one_table_on_a_hub(hub, monkeypatch):
    """(c) The deduplicated rows written chunk by chunk into the table
    of ``known_path_count`` rows equal ``enumerate_paths(dedup=True)`` in
    rows and order, with the cap taken again before every chunk."""
    g, order = hub
    deg = np.diff(g.offsets)
    assert deg.max() > 20 * np.median(deg)
    slots = device_enumerate.last_hop_slots(g, 3)
    assert np.array_equal(slots, np.array(
        [deg[g.vertex_neighbors(v)].sum() for v in range(g.num_vertices)],
        dtype=np.float64))
    cap = int(slots.max()) + 10
    caps = []
    monkeypatch.setattr(device_enumerate, "default_cap",
                        lambda *a: caps.append(1) or cap)
    for l in (2, 3):
        want, _ = enumerate_paths(g, order, l, dedup=True)
        assert len(want) == device_enumerate.known_path_count(g, l)
        caps.clear()
        got = device_enumerate.enumerate_dedup_device(g, order, l, "cpu")
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert len(caps) > 1
    # Every start's directed 3-vertex paths fit its estimate.
    directed, _ = enumerate_paths(g, order, 3, dedup=False)
    per_start = np.bincount(directed[:, 0], minlength=g.num_vertices)
    assert (per_start <= slots).all()


def test_path_groups_through_the_hub(hub, monkeypatch):
    from gnnpe_tpu_torch.embed.pde import path_groups, path_groups_device
    g, order = hub
    vertices = gen_vde(g, 2, "cpu")
    monkeypatch.setattr(device_enumerate, "default_cap", lambda *a: 200_000)
    paths, _ = enumerate_paths(g, order, 3, dedup=False)
    want = path_groups(vertices, paths[:, 0], paths, 6)
    got = path_groups_device(vertices, g, order, 3, 6, "cpu")
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("streamed", [False, True])
def test_l1_route_matches_gnnpe_tpu(streamed):
    """(b) ``run_rung`` at l=1 (``pe_max_paths`` under yeast's 3-vertex
    count): rows and candidates equal to gnnpe_tpu's, resident and
    streamed."""
    from gnnpe_tpu.config import PEConfig as RefPEConfig
    from gnnpe_tpu.engine import PEEngine as RefPEEngine
    from gnnpe_tpu.frontends.ladder import run_rung as jax_run_rung
    from gnnpe_tpu.io.datasets import load_dataset as jax_load
    from gnnpe_tpu.io.datasets import sample_query as jax_sample
    from gnnpe_tpu_torch.frontends import ladder
    kw = dict(queries=4, pe_only=True, pe_max_paths=100_000,
              force_streamed=streamed, prefill_seconds=2)
    (ours,) = ladder.run_rung("yeast", device="cpu", **kw)
    (theirs,) = jax_run_rung("yeast", **kw)
    g = load_dataset("yeast")
    assert ours["l"] == theirs["l"] == 1
    assert ours["paths"] == theirs["paths"] == g.num_edges
    assert ours["mode"] == theirs["mode"] == ("streamed" if streamed
                                             else "resident")
    for k in ("mean_answers", "queries", "spot_verified"):
        assert ours[k] == theirs[k], k
    assert ours["spot_verified"] and ours["spot_verified_p90"]
    assert ours["spot_error"] is None and "error" not in ours["serving"]
    assert ours["peak_device_bytes"] is None and ours["peak_host_rss_bytes"]
    ref = RefPEEngine(RefPEConfig.from_cli(l=1, e=2, p=5, n=100_000),
                      jax_load("yeast", seed=0))
    ref.offline()
    ref.build_index(block_size=512)
    qs = [jax_sample(ref.graph, 8, tree=True, seed=i) for i in range(4)]
    want = [int(sum(len(c) for c in ref.online(q).candidates)) for q in qs]
    assert ours["candidates"] == want and min(want) > 0


@pytest.mark.parametrize("name", ["youtube", "youtube_skew"])
def test_youtube_rungs_equal_gnnpe_tpus(name):
    """(d) The rungs' generators give gnnpe_tpu's CSR; youtube's
    deduplicated 3-vertex path count is gnnpe_tpu's PE row's, and
    youtube_skew's goes past ``pe_max_paths`` (PE at l=1)."""
    from gnnpe_tpu.io.datasets import load_dataset as jax_load
    ours, theirs = load_dataset(name), jax_load(name)
    for k in ("offsets", "neighbors", "labels"):
        assert np.array_equal(getattr(ours, k), getattr(theirs, k)), k
    p3 = device_enumerate.known_path_count(ours, 3)
    if name == "youtube":
        assert p3 == 1_170_203_040
    else:
        assert p3 > 2_000_000_000
        assert device_enumerate.known_path_count(ours, 2) == 2_987_624


def test_csr_past_int32_arcs_raises():
    """A1's row offsets are int32: an offsets array of 2^31 or more arcs
    raises instead of wrapping."""
    big = np.array([0, 2 ** 31], dtype=np.int64)
    fake = types.SimpleNamespace(offsets=big, neighbors=np.zeros(4, np.int32),
                                 labels=np.zeros(1, np.int32),
                                 degrees=np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="2\\^31"):
        to_device(fake, "cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        CSRGraph(big, np.zeros(4, np.int32), np.zeros(1, np.int32))
    # Offsets that were narrowed already (wrapped negative) are refused.
    fake.offsets = big.astype(np.int32)
    with pytest.raises(ValueError, match="row pointers"):
        to_device(fake, "cpu")
    nbr = torch.empty(2 ** 31, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        spmm.neighbor_sum(torch.zeros(2, dtype=torch.int32), nbr,
                          torch.zeros(1, 2, dtype=torch.float64))
