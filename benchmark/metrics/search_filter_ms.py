"""Mean ms of the search's ``search.filter`` span a search call: phase 1
over every block summary, the signature prune and the surviving blocks'
list (``last_stats["filter_ms"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "filter_ms")
