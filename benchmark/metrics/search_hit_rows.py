"""Mean hit rows the search copies to the host a search call: the hit
mask's columns, summed over its chunks (``last_stats["hit_rows"]``), the
rows ``search.extract`` works through on the host union."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "hit_rows")
