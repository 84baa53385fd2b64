"""Query planning (the greedy path cover), re-exported from gnnpe_tpu."""

from gnnpe_tpu.match.plan import greedy_path_cover

__all__ = ["greedy_path_cover"]
