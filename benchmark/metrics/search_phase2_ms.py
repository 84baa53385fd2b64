"""Mean ms of the search's ``search.phase2`` span a search call, summed
over its chunks: the vid rows' gather, the leaf test and the hit columns
(on the device union also the bitmap's scatter;
``last_stats["phase2_ms"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "phase2_ms")
