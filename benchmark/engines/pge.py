"""GNN-PGE (``variant: "pge"``): how the harness builds the program's
engine for a configuration and reads back what its timed path derived.
A variant is this file and ``benchmark/reference/<variant>.py``.  Every
field of the program that the check reads is read here, and one that
cannot be read raises ``Unreadable``.

The configuration's ``l`` counts a path's edges in both variants, so
that ``check.py``'s ``l + 1`` is its vertex count; GNN-PGE's ``-l``
counts vertices, so the engine is given ``l + 1``."""

from __future__ import annotations

import numpy as np

from benchmark.engines import Unreadable, host


def build(cfg: dict, graph, device):
    """``PGEEngine`` through its public offline path: the groups folded
    on the device, the packed vertex index built and uploaded."""
    from gnnpe_tpu_torch.config import PGEConfig
    from gnnpe_tpu_torch.engine import PGEEngine
    eng = PGEEngine(PGEConfig.from_cli(cfg["l"] + 1, cfg["e"], cfg["p"],
                                       cfg["max_answers"]), graph, device)
    eng.offline(device=True).build_index(block_size=cfg["block_size"])
    return eng.attach_device(device)


def data_vde(eng) -> np.ndarray:
    """The data graph's VDE the groups were folded from."""
    try:
        return host(eng.vertices.vde)
    except (AttributeError, TypeError) as exc:
        raise Unreadable(f"the engine's data VDE: {exc!r}") from exc


def planned(query, lo: int, hi: int):
    """(vids, pde) of the query vertices [lo, hi) of the rows the search
    was handed (``PGEQuery``, one row a query vertex in id order): the
    ids of the rows that carry a label and a degree, and their four box
    ends side by side (group lower, group upper, label group lower,
    label group upper).  Labels and degrees are checked through the
    candidates they select."""
    try:
        rows = min(len(host(query.labels)[lo:hi]),
                   len(host(query.degrees)[lo:hi]))
        group = host(query.group)[lo:hi]
        label_group = host(query.label_group)[lo:hi]
        pde = np.concatenate([group[:, 0], group[:, 1], label_group[:, 0],
                              label_group[:, 1]], 1)
    except (AttributeError, IndexError, TypeError, ValueError) as exc:
        raise Unreadable(f"the search's query rows: {exc!r}") from exc
    return np.arange(rows, dtype=np.int64)[:, None], pde
