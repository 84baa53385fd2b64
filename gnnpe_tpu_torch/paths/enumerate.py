"""Simple-path enumeration with orientation dedup, re-exported from
gnnpe_tpu (host numpy frontier expansion)."""

from gnnpe_tpu.paths.enumerate import enumerate_paths

__all__ = ["enumerate_paths"]
