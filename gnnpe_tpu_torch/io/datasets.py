"""Dataset ladder and query sampling, re-exported from gnnpe_tpu (host
numpy, deterministic from a seed)."""

from gnnpe_tpu.io.datasets import load_dataset, powerlaw_graph, sample_query

__all__ = ["load_dataset", "powerlaw_graph", "sample_query"]
