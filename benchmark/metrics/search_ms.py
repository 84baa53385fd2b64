"""Mean ms of the engine's ``search`` stage a query: phase 1, phase 2 and
the union."""

from benchmark import readers


def read(run):
    return readers.mean_stage(run, "search")
