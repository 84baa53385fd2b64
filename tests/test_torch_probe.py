"""The device probe that prices hubs: the CPU gets gnnpe_tpu's "cpu"
row unchanged (so every CPU layout is the one gnnpe_tpu builds without a
probe), a measured value that is not finite and positive raises, and the
layouts take a device's prices where they are built for it."""

import math

import numpy as np
import pytest
import torch

from gnnpe_tpu.ops import ell as jax_ell
from gnnpe_tpu.utils import device_probe as jax_probe
from gnnpe_tpu_torch.io.datasets import powerlaw_graph
from gnnpe_tpu_torch.ops import ell
from gnnpe_tpu_torch.utils import device_probe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cpu_row_is_gnnpe_tpus():
    assert device_probe.device_constants("cpu") == jax_probe._table_lookup(
        "cpu")
    assert device_probe.device_constants(torch.device("cpu")) == \
        device_probe.CPU_ROW == ell.HUB_PRICES
    assert ell._device_constants("cpu") == device_probe.CPU_ROW


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf, 0.0, -1.0])
@pytest.mark.parametrize("slot", [0, 1, 2])
def test_a_bad_probe_value_raises(monkeypatch, bad, slot):
    vals = [2.5e12, 6e14, 4e-10]
    vals[slot] = bad
    with pytest.raises(RuntimeError, match=device_probe.NAMES[slot]):
        device_probe._check(vals)
    # What a CUDA device would get from such a probe (the cache is
    # bypassed; no card is touched).
    monkeypatch.setattr(device_probe, "_probe", lambda dev: tuple(vals))
    with pytest.raises(RuntimeError):
        device_probe._measured.__wrapped__(torch.device("cuda", 0))
    assert device_probe._check([2.5e12, 6e14, 4e-10]) == (2.5e12, 6e14,
                                                          4e-10)


def test_other_devices_raise():
    with pytest.raises(ValueError):
        device_probe.device_constants("meta")


def test_layouts_take_the_devices_prices(monkeypatch):
    """``build_binned_ell`` prices hubs with ``hub_prices``, else the
    device's constants, else the "cpu" row; on the CPU the device's row
    is the "cpu" row, so the layout is gnnpe_tpu's."""
    g = powerlaw_graph(2000, 12000, 5, seed=4, alpha=1.1)
    base = ell.build_binned_ell(g.offsets, g.neighbors)
    on_cpu = ell.build_binned_ell(g.offsets, g.neighbors, device="cpu")
    ref = jax_ell.build_binned_ell(g.offsets, g.neighbors)
    for lay in (base, on_cpu):
        assert lay.num_slots == ref.num_slots
        assert np.array_equal(lay.perm, ref.perm)
        assert (lay.hub_rows is None) == (ref.hub_rows is None)
    # A device whose gathers are dear gets hubs; an explicit price
    # overrides the device's.
    dear = (3e12, 7e14, 1e-7)
    monkeypatch.setattr(ell, "_device_constants", lambda device: dear)
    measured = ell.build_binned_ell(g.offsets, g.neighbors, device="cpu")
    assert measured.hub_rows is not None and len(measured.hub_rows)
    given = ell.build_binned_ell(g.offsets, g.neighbors, device="cpu",
                                 hub_prices=ell.HUB_PRICES)
    assert given.num_slots == base.num_slots
    # fit's layout goes through the same rule.
    from gnnpe_tpu_torch.models import train
    seen = []
    monkeypatch.setattr(ell, "build_binned_ell",
                        lambda *a, **k: seen.append(k) or base)
    train._aggregate(g, "binned", torch.device("cpu"))
    assert seen[-1]["device"] == torch.device("cpu")
    assert "hub_prices" not in seen[-1]


def test_hub_counts_are_charged_the_bytes_they_take():
    """A layout built for a CUDA device keeps B as f32 there, so each
    count costs 4 bytes of memory traffic and of the budget; elsewhere
    gnnpe_tpu's 1 byte is kept.  No card is touched: the builds are on
    the host, the prices are given."""
    from gnnpe_tpu_torch.ops.rect import build_binned_rect
    cuda = torch.device("cuda")
    assert ell.hub_costs(None, "hi_lo") == ell.hub_costs("cpu", "f32") \
        == (1, 0)
    assert ell.hub_costs(cuda, "hi_lo") == (ell.CUDA_HUB_ENTRY_BYTES, 8)
    assert ell.hub_costs(cuda, "f32") == ell.hub_costs(cuda, "bf16") \
        == (4, 4)
    g = powerlaw_graph(2000, 12000, 5, seed=4, alpha=1.1)
    v = g.num_vertices
    occ = np.sort(np.bincount(g.neighbors, minlength=v))[::-1]
    # Memory-bound prices: a column costs entry_bytes·V/bw, so the
    # threshold is entry_bytes·V/(bw·gather) occurrences.
    gather = 1e-9
    prices = (2.0 * v / (gather * occ[8]), math.inf, gather)
    for entry, want in ((1, occ > 0.5 * occ[8]), (4, occ > 2.0 * occ[8])):
        got = ell._select_hubs(v, g.neighbors, 128, 2048, 256 << 20, prices,
                               (entry, 0))
        assert len(got) == int(want.sum()) > 0
    # The budget: 6 columns of 1-byte counts hold 1 column of 4 bytes.
    # With every price but the gather's free, only the budget caps them.
    kw = dict(hub_prices=(math.inf, math.inf, gather), hub_mem_budget=6 * v)
    for build in (lambda d: ell.build_binned_ell(g.offsets, g.neighbors,
                                                 device=d, **kw),
                  lambda d: build_binned_rect(g.offsets, g.neighbors, v,
                                              device=d, **kw)):
        assert [len(build(d).hub_rows) for d in ("cpu", cuda)] == [6, 1]


def test_a_card_charges_any_hub_its_passes_over_the_output(monkeypatch):
    """On a card the hub part costs CUDA_HUB_OUTPUT_PASSES passes over
    the f32 [V, D] output whatever the hub count: the hubs are kept only
    where the gathers they save outweigh that and their columns."""
    g = powerlaw_graph(2000, 12000, 5, seed=4, alpha=1.1)
    v = g.num_vertices
    occ = np.sort(np.bincount(g.neighbors, minlength=v))[::-1]
    gather = 1e-9
    bw = 4.0 * v / (gather * occ[8])    # a 4-byte column: occ[8] gathers
    monkeypatch.setattr(ell, "_device_constants",
                        lambda device: (bw, math.inf, gather))
    cuda = torch.device("cuda")
    n = int((occ > occ[8]).sum())
    saved = gather * (occ[:n].sum() - n * occ[8])
    for dim in (1, 128):
        fixed = 8 * 4.0 * v * dim / bw
        lay = ell.build_binned_ell(g.offsets, g.neighbors, device=cuda,
                                   feature_dim_hint=dim)
        got = 0 if lay.hub_rows is None else len(lay.hub_rows)
        assert got == (n if saved > fixed else 0)
        # The host keeps gnnpe_tpu's model: no fixed cost, 1 byte a count.
        host = ell.build_binned_ell(g.offsets, g.neighbors, device="cpu",
                                    feature_dim_hint=dim)
        assert len(host.hub_rows) == int((occ > occ[8] / 4).sum()) > n
        if dim == 1:
            assert got == n > 0
        else:
            assert got == 0


@pytest.mark.cuda
def test_probe_on_card(cuda_device):
    vals = device_probe.device_constants(cuda_device)
    assert all(math.isfinite(v) and v > 0 for v in vals)
    assert device_probe.device_constants(cuda_device) is vals   # cached
