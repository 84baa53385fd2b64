"""Mean ms of the engine's ``query_plan`` stage a query: the query's VDE on
kernel A1, its paths and the plan."""

from benchmark import readers


def read(run):
    return readers.mean_stage(run, "query_plan")
