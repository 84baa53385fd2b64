"""Training for the PathGNN family on one device (counterpart of
gnnpe_tpu/models/train.py).

Training data: sampled (sub-path, super-path) pairs with a label-
preserving vertex mapping, positives for the dominance hinge, and
optionally provable negatives.  The samplers are gnnpe_tpu's numpy code,
copied unchanged, so they return the same arrays for the same seed.

``fit`` runs one Adam step per iteration (gnnpe_tpu scans chunks of
steps in one dispatch, a workaround for its relay's per-dispatch cost)
but draws its batches exactly as gnnpe_tpu does: per chunk of
``min(50, num_steps)`` steps, padding steps included, so the RNG
stream, the batches and the loss history follow gnnpe_tpu's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from gnnpe_tpu_torch.graph.csr import CSRGraph, to_device
from gnnpe_tpu_torch.models.gnn import PathGNN, dominance_loss
from gnnpe_tpu_torch.ops.gather import GatherRows
from gnnpe_tpu_torch.ops.mt19937 import label_feature_table
from gnnpe_tpu_torch.utils.device import as_device
from gnnpe_tpu_torch.utils.profiling import annotate


def sample_dominance_pairs(graph: CSRGraph, paths: np.ndarray,
                           num_pairs: int, seed: int = 0) -> np.ndarray:
    """int32[B, 2] rows (i, j): path i should be dominated by path j.

    Positive construction: j shares i's label sequence position-wise,
    each of i's vertices has degree ≤ j's (the leaf-filter necessary
    conditions, custom.h:410-434), AND the per-vertex NLF containment
    holds.  The NLF requirement keeps this set disjoint from
    sample_negative_pairs — without it the dominance hinge and the
    discriminative term fight over the same pairs and training goes
    nowhere.  If the strict (NLF-containing) set is empty — tiny or
    adversarial graphs — falls back to degree-only positives."""
    rng = np.random.RandomState(seed)
    degrees = np.take(graph.degrees, paths)
    nlf = graph.nlf
    flat, offs, sizes = _label_signature_buckets(graph, paths)
    if flat is None:
        return np.zeros((0, 2), dtype=np.int32)

    def draw(require_nlf):
        pairs = []
        got = 0
        for _ in range(64):  # vectorized rejection rounds
            i, j = _draw_bucket_pairs(rng, flat, offs, sizes,
                                      max(num_pairs, 4096))
            fwd = (degrees[i] <= degrees[j]).all(axis=1)
            bwd = (degrees[j] <= degrees[i]).all(axis=1)
            if require_nlf:
                fwd &= (nlf[paths[i]] <= nlf[paths[j]]).all(axis=(1, 2))
                bwd &= (nlf[paths[j]] <= nlf[paths[i]]).all(axis=(1, 2))
            bwd &= ~fwd
            ii = np.concatenate([i[fwd], j[bwd]])
            jj = np.concatenate([j[fwd], i[bwd]])
            if len(ii):
                pairs.append(np.stack([ii, jj], axis=1))
                got += len(ii)
            if got >= num_pairs:
                break
        if not pairs:
            return np.zeros((0, 2), dtype=np.int32)
        return np.concatenate(pairs)[:num_pairs].astype(np.int32)

    strict = draw(require_nlf=True)
    return strict if len(strict) else draw(require_nlf=False)


def _label_signature_buckets(graph: CSRGraph, paths: np.ndarray):
    """Rows of ``paths`` grouped by per-position label signature
    (buckets of size ≥ 2), via one argsort — NOT a per-bucket scan,
    which is O(#buckets · P) and hangs at 415k paths.  Returns
    (flat_rows, bucket_offsets, bucket_sizes), or (None, None, None)
    if no bucket has ≥ 2 rows."""
    labels = np.take(graph.labels, paths)
    sig = np.ascontiguousarray(labels).view(
        np.dtype((np.void, labels.dtype.itemsize * labels.shape[1])))
    _, inverse = np.unique(sig.ravel(), return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    sorted_inv = inverse[order]
    cuts = np.nonzero(np.diff(sorted_inv))[0] + 1
    buckets = [b for b in np.split(order, cuts) if len(b) >= 2]
    if not buckets:
        return None, None, None
    sizes = np.array([len(b) for b in buckets], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return np.concatenate(buckets), offs, sizes


def _draw_bucket_pairs(rng, flat, offs, sizes, n):
    """n (i, j) path-row pairs drawn within random buckets, i != j."""
    b = rng.randint(len(sizes), size=n)
    i = flat[offs[b] + (rng.rand(n) * sizes[b]).astype(np.int64)]
    j = flat[offs[b] + (rng.rand(n) * sizes[b]).astype(np.int64)]
    keep = i != j
    return i[keep], j[keep]


def sample_negative_pairs(graph: CSRGraph, paths: np.ndarray,
                          num_pairs: int, seed: int = 0) -> np.ndarray:
    """int32[B, 2] rows (i, j): provably NON-matching candidate pairs.

    Each pair passes the leaf filter's label+degree test position-wise
    (so only the pde dominance test can prune it), but the per-vertex
    NLF containment — for some position k and label ℓ, vertex i_k has
    MORE ℓ-labeled neighbors than j_k — proves no monomorphism maps
    path i into path j (neighbor labels must inject;
    ref BuildNLF graph.cpp:107-123 states the same necessary
    condition).  These are exactly the false candidates the fixed VDE
    fails to prune; the discriminative loss term teaches the model to
    separate them.  Feeding only provable negatives keeps the
    objective consistent with the structural dominance guarantee."""
    rng = np.random.RandomState(seed)
    degrees = np.take(graph.degrees, paths)
    nlf = graph.nlf  # int[V, L] neighbor-label counts
    flat, offs, sizes = _label_signature_buckets(graph, paths)
    if flat is None:
        return np.zeros((0, 2), dtype=np.int32)
    pairs = []
    got = 0
    for _ in range(64):  # vectorized rejection rounds
        i, j = _draw_bucket_pairs(rng, flat, offs, sizes,
                                  max(num_pairs, 4096))
        keep = (degrees[i] <= degrees[j]).all(axis=1)
        i, j = i[keep], j[keep]
        if not len(i):
            continue
        # NLF containment must FAIL at >=1 position to prove i !-> j.
        neg = (nlf[paths[i]] > nlf[paths[j]]).any(axis=(1, 2))
        if neg.any():
            pairs.append(np.stack([i[neg], j[neg]], axis=1))
            got += int(neg.sum())
        if got >= num_pairs:
            break
    if not pairs:
        return np.zeros((0, 2), dtype=np.int32)
    return np.concatenate(pairs)[:num_pairs].astype(np.int32)


@dataclass
class TrainState:
    """``params`` is the trained module itself; ``opt_state`` its
    ``torch.optim.Adam`` (None: ``fit`` makes a fresh one).
    ``steps_s`` is the wall time of the step loops, synchronised with
    the device at both ends."""
    params: PathGNN
    opt_state: Optional[torch.optim.Adam] = None
    step: int = 0
    history: List[float] = field(default_factory=list)
    steps_s: float = 0.0


def _aggregate(graph: CSRGraph, aggregation: str, device):
    """The neighbour sum h ↦ A h for ``fit``: "segment" is the CSR
    kernel A1 (``NeighborSum``), "binned" the degree-binned layout on
    kernel A2 with the permutes at the layer boundary, its hubs priced
    with ``device``'s own prices."""
    if aggregation == "segment":
        from gnnpe_tpu_torch.ops.spmm import NeighborSum
        offsets, neighbors, _, _ = to_device(graph, device)
        return lambda h: NeighborSum.apply(offsets, neighbors, h)
    if aggregation == "binned":
        from gnnpe_tpu_torch.ops.ell import (BinnedEllDevice,
                                             binned_aggregate,
                                             build_binned_ell)
        lay = build_binned_ell(graph.offsets, graph.neighbors,
                               device=device)
        return binned_aggregate(BinnedEllDevice.from_host(lay, device))
    raise ValueError(f"aggregation must be 'segment' or 'binned', got "
                     f"{aggregation!r}")


def readout_plans(model: PathGNN, graph: CSRGraph, paths: np.ndarray
                  ) -> Tuple[GatherRows, GatherRows]:
    """The trainer's two fixed gathers as ``GatherRows`` plans on the
    model's device: the label lookup (``graph.labels`` into the model's
    label table) and the path readout (``paths`` read flat into the
    graph's vertex rows)."""
    return (GatherRows.build(graph.labels, model.labels_count, model.device,
                             name="readout.labels"),
            GatherRows.build(paths, graph.num_vertices, model.device,
                             name="readout.paths"))


def fit(model: PathGNN, graph: CSRGraph, paths: np.ndarray,
        num_steps: int = 100, batch_size: int = 1024,
        learning_rate: float = 1e-3, seed: int = 0,
        init_from_reference: bool = True,
        state: Optional[TrainState] = None,
        aggregation: str = "segment",
        negatives: bool = False,
        neg_margin: float = 0.1, *, device) -> TrainState:
    """Train ``model`` (whose parameters live on ``device``), resumable
    via ``state``.

    Without ``state`` the model is initialised from ``seed`` (a CPU
    ``torch.Generator``), with the label-seeded table when
    ``init_from_reference``.  With ``state``, ``state.params`` (which
    must be ``model``) trains on from its current weights.

    aggregation: "segment" (CSR neighbour sum, kernel A1, forward and
    backward) or "binned" (the degree-binned layout, kernel A2, forward
    and backward; the production choice at scale), its hubs priced with
    ``device``'s prices (ops/ell.py:_device_constants: measured on a
    CUDA device).
    negatives=True adds the discriminative term over NLF-violating
    candidate pairs (sample_negative_pairs).
    The label lookup and the path readout go through ``readout_plans``,
    built once before the step loop, so their backward is kernel A2's
    walk of the transposed index (``launches_per_backward`` each a step
    on a card) and no scatter, on either aggregation."""
    device = as_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, fit asked for "
                         f"{device}")
    if state is None:
        gen = torch.Generator().manual_seed(seed)
        table = (label_feature_table(graph.labels_count, model.dim)
                 if init_from_reference else None)
        model.init(gen, label_table=table)
        state = TrainState(params=model)
    elif state.params is not model:
        raise ValueError("state.params is not the model being fit")
    if state.opt_state is None:
        state.opt_state = torch.optim.Adam(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8)
    opt = state.opt_state
    for group in opt.param_groups:
        group["lr"] = learning_rate

    aggregate = _aggregate(graph, aggregation, device)
    labels = torch.from_numpy(graph.labels).to(device).long()
    paths_t = torch.from_numpy(np.asarray(paths, np.int64)).to(device)
    labels_plan, paths_plan = readout_plans(model, graph, paths)
    pairs_all = sample_dominance_pairs(graph, paths,
                                       num_pairs=batch_size * 8,
                                       seed=seed)
    if not len(pairs_all):
        raise ValueError("no dominance pairs could be sampled")
    neg_all = (sample_negative_pairs(graph, paths,
                                     num_pairs=batch_size * 8,
                                     seed=seed + 7)
               if negatives else np.zeros((0, 2), dtype=np.int32))
    use_neg = len(neg_all) > 0

    rng = np.random.RandomState(seed + 1)
    chunk = min(50, max(1, num_steps))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with annotate("fit.steps", device):
        done = 0
        while done < num_steps:
            k = min(chunk, num_steps - done)
            # Drawn for the whole chunk, as gnnpe_tpu draws for its scan.
            batches = torch.from_numpy(pairs_all[rng.randint(
                len(pairs_all), size=(chunk, batch_size))]).to(device).long()
            negs = (torch.from_numpy(neg_all[rng.randint(
                len(neg_all), size=(chunk, batch_size))]).to(device).long()
                if use_neg else None)
            losses = []
            for s in range(k):
                opt.zero_grad(set_to_none=True)
                loss = dominance_loss(
                    model, labels, paths_t, batches[s], aggregate,
                    negative_pairs=negs[s] if use_neg else None,
                    neg_margin=neg_margin, labels_plan=labels_plan,
                    paths_plan=paths_plan)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            state.history.extend(torch.stack(losses).tolist())
            state.step += k
            done += k
    state.steps_s += time.perf_counter() - t0
    return state


def save_checkpoint(path: str, state: TrainState) -> None:
    """torch checkpoint of the parameters, the Adam state, the step and
    the loss history."""
    torch.save({"step": state.step, "history": list(state.history),
                "params": state.params.state_dict(),
                "opt_state": (None if state.opt_state is None
                              else state.opt_state.state_dict())}, path)


def load_checkpoint(path: str, model: PathGNN) -> TrainState:
    """A ``TrainState`` for ``model`` from ``save_checkpoint``'s file,
    loaded onto the model's device (tensors and plain values only).
    gnnpe_tpu's npz checkpoints load with
    ``models.gnn.load_jax_checkpoint``."""
    ck = torch.load(path, map_location=model.device, weights_only=True)
    model.load_state_dict(ck["params"])
    opt = None
    if ck["opt_state"] is not None:
        opt = torch.optim.Adam(model.parameters())
        opt.load_state_dict(ck["opt_state"])
    return TrainState(params=model, opt_state=opt, step=int(ck["step"]),
                      history=list(ck["history"]))
