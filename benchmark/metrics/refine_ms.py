"""Mean ms of the engine's ``refine`` stage a query (native C++
backtracking; in the batch mix eight threads share a batch)."""

from benchmark import readers


def read(run):
    return readers.mean_stage(run, "refine")
