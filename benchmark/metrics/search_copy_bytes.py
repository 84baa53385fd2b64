"""Mean bytes the search copies to the host a search call: each chunk's
hit mask (Q bool bytes a hit column) and hit rows (8 bytes each)
(``last_stats["copied_bytes"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "copied_bytes")
