"""Mean ms of refinement's ``refine.explore`` span a query: the native
explorer's backtracking itself (``timings_ms["refine.explore"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_stage(run, "refine.explore")
