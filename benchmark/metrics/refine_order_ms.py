"""Mean ms of refinement's ``refine.order`` span a query: the matching
order and the backward neighbours (``timings_ms["refine.order"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_stage(run, "refine.order")
