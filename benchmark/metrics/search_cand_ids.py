"""Mean candidate ids a search call returns, summed over its query
vertices: what refinement is handed (``last_stats["cand_ids"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "cand_ids")
