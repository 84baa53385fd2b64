"""Mean blocks that pass phase 1's box tests for some row of a search
call, before any prune (``last_stats["phase1"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "phase1")
