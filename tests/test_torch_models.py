"""The port's PathGNN, loss, samplers, fit and checkpoints
(gnnpe_tpu_torch/models/) against gnnpe_tpu's, on the CPU, with JAX's
weights carried across by ``params_from_jax``.

Tolerances: forward and loss rtol 1e-5 (f32, another summation order);
gradients rtol 1e-4 / atol 1e-6; fit histories rtol 1e-3 / atol 1e-5,
the tolerance gnnpe_tpu holds its own two aggregations to
(tests/test_models.py::test_fit_binned_aggregation_matches_segment).
The samplers are copies and must return equal arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnnpe_tpu.io.datasets import powerlaw_graph
from gnnpe_tpu.models import gnn as jgnn
from gnnpe_tpu.models import train as jtrain
from gnnpe_tpu.ops.mt19937 import label_feature_table
from gnnpe_tpu_torch.models import gnn, train
from gnnpe_tpu_torch.ops.ell import (BinnedEllDevice, binned_aggregate,
                                     build_binned_ell)
from gnnpe_tpu_torch.ops.spmm import NeighborSum

CFG = dict(dim=4, num_layers=2, labels_count=6, activation="softplus")


@pytest.fixture(scope="module")
def toy():
    from __graft_entry__ import _toy_graph
    return _toy_graph(num_vertices=48, num_labels=6, seed=3)


@pytest.fixture(scope="module")
def jax_pair():
    """gnnpe_tpu's model and random params, and the port's module
    holding the same weights."""
    jm = jgnn.PathGNN(**CFG)
    params = jm.init(jax.random.key(0), labels_count=6)
    leaves = [np.asarray(l) for l in jax.tree.flatten(params)[0]]
    return jm, params, gnn.params_from_jax(
        gnn.PathGNN(**CFG, device="cpu"), leaves)


def _aggregates(g):
    off, nbr = torch.from_numpy(g.offsets), torch.from_numpy(g.neighbors)
    return {
        "segment": lambda h: NeighborSum.apply(off, nbr, h),
        "binned": binned_aggregate(BinnedEllDevice.from_host(
            build_binned_ell(g.offsets, g.neighbors), "cpu")),
    }


def _paths_pairs(g, seed=0):
    rng = np.random.RandomState(seed)
    paths = rng.randint(0, g.num_vertices, (32, 3)).astype(np.int32)
    return paths, rng.randint(0, 32, (64, 2)).astype(np.int32), \
        rng.randint(0, 32, (48, 2)).astype(np.int32)


def _jax_inputs(g):
    src, dst = g.coo()
    return jnp.asarray(g.labels), jnp.asarray(src), jnp.asarray(dst)


@pytest.mark.parametrize("aggregation", ["segment", "binned"])
def test_forward_matches_jax(toy, jax_pair, aggregation):
    jm, params, port = jax_pair
    labels, src, dst = _jax_inputs(toy)
    paths, _, _ = _paths_pairs(toy)
    agg = _aggregates(toy)[aggregation]
    lt = torch.from_numpy(toy.labels).long()
    with torch.no_grad():
        h = port.vertex_embeddings(lt, agg)
        pde = port.path_embeddings(lt, torch.from_numpy(paths).long(), agg)
    np.testing.assert_allclose(
        h.numpy(), np.asarray(jm.vertex_embeddings(
            params, labels, src, dst, toy.num_vertices)), rtol=1e-5)
    np.testing.assert_allclose(
        pde.numpy(), np.asarray(jm.path_embeddings(
            params, labels, src, dst, toy.num_vertices, jnp.asarray(paths))),
        rtol=1e-5)


@pytest.mark.parametrize("aggregation", ["segment", "binned"])
@pytest.mark.parametrize("negatives", [False, True])
def test_loss_and_grads_match_jax(toy, jax_pair, aggregation, negatives):
    jm, params, port = jax_pair
    labels, src, dst = _jax_inputs(toy)
    paths, pairs, neg = _paths_pairs(toy)
    want, jgrads = jax.value_and_grad(lambda p: jgnn.dominance_loss(
        jm, p, labels, src, dst, toy.num_vertices, jnp.asarray(paths),
        jnp.asarray(pairs), negative_pairs=(
            jnp.asarray(neg) if negatives else None)))(params)
    port.zero_grad()
    loss = gnn.dominance_loss(
        port, torch.from_numpy(toy.labels).long(),
        torch.from_numpy(paths).long(), torch.from_numpy(pairs).long(),
        _aggregates(toy)[aggregation],
        negative_pairs=torch.from_numpy(neg).long() if negatives else None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for p, jg in zip(port.leaves(), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-6)


def test_reference_params_match_jax_and_reproduce_vde():
    """reference_params equals gnnpe_tpu's leaves, and one identity layer
    reproduces the fixed VDE (f32 softplus round trip: rtol 1e-3)."""
    from gnnpe_tpu.embed.vde import gen_vde
    g = powerlaw_graph(400, 1600, 5, seed=2, max_degree=40)
    table = label_feature_table(g.labels_count, 2)
    jm = jgnn.PathGNN(dim=2, num_layers=1, labels_count=g.labels_count)
    port = gnn.PathGNN(dim=2, num_layers=1, labels_count=g.labels_count,
                       device="cpu").reference_params(table)
    for p, jl in zip(port.leaves(),
                     jax.tree.leaves(jm.reference_params(table))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jl),
                                   rtol=1e-6)
    off, nbr = torch.from_numpy(g.offsets), torch.from_numpy(g.neighbors)
    with torch.no_grad():
        h = port.vertex_embeddings(torch.from_numpy(g.labels).long(),
                                   lambda x: NeighborSum.apply(off, nbr, x))
    np.testing.assert_allclose(h.numpy(), gen_vde(g, 2).vde, rtol=1e-3,
                               atol=1e-5)


def test_init_is_seeded_and_has_jax_distribution():
    def make(seed, table=None):
        return gnn.PathGNN(**CFG, device="cpu").init(
            torch.Generator().manual_seed(seed), label_table=table)
    a, b, c = make(0), make(0), make(1)
    for pa, pb, pc in zip(a.leaves(), b.leaves(), c.leaves()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.w_self[0], c.w_self[0])
    with torch.no_grad():
        w = gnn.softplus(a.w_self[1])
        noise = w - torch.eye(4)
        assert (noise >= -1e-6).all() and noise.max() < 0.1
        assert torch.allclose(gnn.softplus(a.embed).sum(1), torch.ones(6),
                              atol=1e-5)
        assert torch.allclose(gnn.softplus(a.bias[0]),
                              torch.full((4,), np.log(2.0)))
    table = label_feature_table(6, 4)
    np.testing.assert_allclose(
        gnn.softplus(make(0, table).embed).detach().numpy(), table,
        rtol=1e-5)


def test_samplers_equal_jax(toy):
    from gnnpe_tpu.graph.partition import degree_sorted_nodes
    from gnnpe_tpu.paths.enumerate import enumerate_paths
    paths, _ = enumerate_paths(toy, degree_sorted_nodes(toy), 3, dedup=True)
    for name, seed in (("sample_dominance_pairs", 0),
                       ("sample_negative_pairs", 7)):
        got = getattr(train, name)(toy, paths, 300, seed=seed)
        want = getattr(jtrain, name)(toy, paths, 300, seed=seed)
        assert got.dtype == want.dtype and len(got) > 0
        assert np.array_equal(got, want)


@pytest.mark.parametrize("aggregation,steps", [("segment", 10),
                                               ("binned", 10),
                                               ("binned", 53)])
def test_fit_history_matches_jax(toy, jax_pair, aggregation, steps):
    """Both fits start from the same params (state=) and draw the same
    batches; 53 steps cross a chunk boundary, whose padding steps'
    batches are drawn but not run."""
    jm, params, _ = jax_pair
    paths, _, _ = _paths_pairs(toy, seed=1)
    kw = dict(num_steps=steps, batch_size=64, seed=0, learning_rate=1e-2,
              aggregation=aggregation, negatives=True)
    want = jtrain.fit(jm, toy, paths, state=jtrain.TrainState(
        params=params, opt_state=optax.adam(1e-2).init(params)), **kw)
    port = gnn.params_from_jax(gnn.PathGNN(**CFG, device="cpu"),
                               [np.asarray(l) for l in
                                jax.tree.flatten(params)[0]])
    got = train.fit(port, toy, paths, state=train.TrainState(params=port),
                    device="cpu", **kw)
    assert got.step == want.step == steps
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3,
                               atol=1e-5)
    assert got.history[-1] < got.history[0]


def test_fit_initialises_from_reference_table(toy):
    paths, _, _ = _paths_pairs(toy, seed=1)
    model = gnn.PathGNN(**CFG, device="cpu")
    state = train.fit(model, toy, paths, num_steps=1, batch_size=16,
                      device="cpu")
    assert state.params is model and state.step == 1
    assert np.isfinite(state.history).all() and state.steps_s > 0
    with pytest.raises(ValueError):
        train.fit(model, toy, paths, num_steps=1, aggregation="dense",
                  device="cpu")
    with pytest.raises(ValueError):
        train.fit(gnn.PathGNN(**CFG, device="cpu"), toy, paths,
                  state=state, num_steps=1, device="cpu")


def test_checkpoints(toy, jax_pair, tmp_path):
    """gnnpe_tpu's npz loads into the port; the port's torch checkpoint
    round-trips weights, Adam state, step and history."""
    jm, params, _ = jax_pair
    jtrain.save_checkpoint(str(tmp_path / "ck.npz"), jtrain.TrainState(
        params=params, opt_state=None, step=7))
    port = gnn.load_jax_checkpoint(str(tmp_path / "ck.npz"),
                                   gnn.PathGNN(**CFG, device="cpu"))
    for p, jl in zip(port.leaves(), jax.tree.leaves(params)):
        assert np.array_equal(p.detach().numpy(), np.asarray(jl))

    paths, _, _ = _paths_pairs(toy, seed=1)
    state = train.fit(port, toy, paths, num_steps=3, batch_size=16,
                      state=train.TrainState(params=port), device="cpu")
    train.save_checkpoint(str(tmp_path / "ck.pt"), state)
    back = train.load_checkpoint(str(tmp_path / "ck.pt"),
                                 gnn.PathGNN(**CFG, device="cpu"))
    assert back.step == 3 and back.history == state.history
    for a, b in zip(back.params.leaves(), port.leaves()):
        assert torch.equal(a, b)
    assert back.opt_state.state_dict()["state"][0]["step"] == 3
