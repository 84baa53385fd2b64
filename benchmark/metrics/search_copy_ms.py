"""Mean ms of the search's ``search.copy`` span a search call, summed
over its chunks: the host union's copies of each chunk's hit mask and
hit rows to the host (``last_stats["copy_ms"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "copy_ms")
