"""Configuration for the gnnpe_tpu pipeline.

Replaces the reference's three-tier config (compile-time macros in
configuration/config.h, mutable globals in custom.h:45-50, CLI11 flags in
src/main.cpp:46-56) with a single frozen dataclass.

Reference quirks reproduced here (see SURVEY.md §2/§5):
  * GNN-PE increments the CLI ``-l`` flag by one before use
    (GNN-PE/src/main.cpp:58: ``path_length += 1``), so ``-l 2`` means paths
    of **3 vertices**.  GNN-PGE does not (GNN-PGE/src/main.cpp:58);
    its default is ``path_length = 1 + 1 = 2`` vertices
    (GNN-PGE/include/custom.h:48).
  * ``pde_dim = vde_dim * path_length`` must be derived *after* flag
    parsing (the reference's stale-global pitfall, custom.h:49).
"""

# The port's own copy of gnnpe_tpu/config.py (numpy only; the two
# packages share no code, so the tests can hold one against the other).

from __future__ import annotations

import dataclasses
from typing import Optional

# Dominance comparisons use this slack, matching the reference
# (GNN-PE/include/custom.h:43: ``const double epsilon = 1e-6``).
EPSILON = 1e-6

# Sentinel for "no output limit" (custom.h:45: ``MAX_LIMIT = UINT_MAX``).
UNLIMITED = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Config:
    """Shared configuration for both engine variants.

    Attributes:
      vde_dim: per-vertex dominance-embedding width (ref ``-e``, default 2).
      path_length: number of **vertices** per indexed path.  Use
        :meth:`PEConfig.from_cli` / :meth:`PGEConfig.from_cli` to apply the
        per-variant CLI semantics.
      partition_num: number of graph partitions (ref ``-p``, default 5).
      max_answers: cap on emitted matches (ref ``-n``, default unlimited).
      epsilon: dominance slack (ref custom.h:43).
      seed_mode: "label" reproduces the reference's label-seeded fixed
        embeddings (custom.h:492-511); "trained" plugs in a trained model.
    """

    vde_dim: int = 2
    path_length: int = 2
    partition_num: int = 5
    max_answers: int = UNLIMITED
    epsilon: float = EPSILON
    seed_mode: str = "label"

    @property
    def pde_dim(self) -> int:
        """Path-embedding width (custom.h:49, recomputed post-parse)."""
        return self.vde_dim * self.path_length

    @property
    def edges_per_path(self) -> int:
        return self.path_length - 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PEConfig(Config):
    """GNN-PE variant: one index entry per *path* (point boxes).

    Path dedup keeps a single orientation of each undirected path
    (custom.h:66-92); candidate filtering is position-wise along the path.
    """

    variant: str = "pe"

    @classmethod
    def from_cli(cls, l: int = 2, e: int = 2, p: int = 5,
                 n: Optional[int] = None) -> "PEConfig":
        """Apply GNN-PE CLI semantics: ``-l`` counts edges; the engine adds
        one to get the vertex count (GNN-PE/src/main.cpp:58)."""
        return cls(vde_dim=e, path_length=l + 1, partition_num=p,
                   max_answers=UNLIMITED if n is None else n)


@dataclasses.dataclass(frozen=True)
class PGEConfig(Config):
    """GNN-PGE variant: one index entry per *vertex*, whose box bounds all
    paths leaving it (GNN-PGE/src/main.cpp:91-177).  Exact on Test/."""

    variant: str = "pge"

    @classmethod
    def from_cli(cls, l: int = 2, e: int = 2, p: int = 5,
                 n: Optional[int] = None) -> "PGEConfig":
        """GNN-PGE takes ``-l`` verbatim as the vertex count — no ``+1``
        (GNN-PGE/src/main.cpp:58; default 2 from custom.h:48)."""
        return cls(vde_dim=e, path_length=l, partition_num=p,
                   max_answers=UNLIMITED if n is None else n)
