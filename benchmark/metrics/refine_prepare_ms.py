"""Mean ms of refinement's ``refine.prepare`` span a query: the native
explorer's int32 arrays, the candidates' among them
(``timings_ms["refine.prepare"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_stage(run, "refine.prepare")
