"""GNN-PE (``variant: "pe"``): how the harness builds the program's
engine for a configuration and reads back what its timed path derived.
A variant is this file and ``benchmark/reference/<variant>.py``.  Every
field of the program that the check reads is read here, and one that
cannot be read raises ``Unreadable``."""

from __future__ import annotations

import numpy as np

from benchmark.engines import Unreadable, host


def build(cfg: dict, graph, device):
    """``PEEngine`` through its public offline path, with the program's
    own choice of resident or streamed index."""
    from gnnpe_tpu_torch.config import PEConfig
    from gnnpe_tpu_torch.engine import PEEngine
    eng = PEEngine(PEConfig.from_cli(cfg["l"], cfg["e"], cfg["p"],
                                     cfg["max_answers"]), graph, device)
    eng.offline(device=True).build_index(block_size=cfg["block_size"],
                                         table=True)
    return eng


def data_vde(eng) -> np.ndarray:
    """The data graph's VDE the index was built from."""
    try:
        return host(eng.vertices.vde)
    except (AttributeError, TypeError) as exc:
        raise Unreadable(f"the engine's data VDE: {exc!r}") from exc


def planned(query, lo: int, hi: int):
    """(vids - lo, pde) of the planned paths of the query whose vertex
    ids the search's stacked table offsets to [lo, hi): what the search
    was handed (``PEQuery.pde`` and ``plan_rows``)."""
    try:
        t = query.pde
        rows = host(query.plan_rows).astype(np.int64)
        vids, pde = host(t.vids)[rows], host(t.pde)[rows]
    except (AttributeError, IndexError, TypeError) as exc:
        raise Unreadable(f"the search's query table: {exc!r}") from exc
    mine = (vids[:, 0] >= lo) & (vids[:, 0] < hi)
    return vids[mine] - lo, pde[mine]
