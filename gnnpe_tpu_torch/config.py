"""Configuration, re-exported from gnnpe_tpu (host-only, no JAX)."""

from gnnpe_tpu.config import EPSILON, Config, PEConfig, PGEConfig

__all__ = ["EPSILON", "Config", "PEConfig", "PGEConfig"]
