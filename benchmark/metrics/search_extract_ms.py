"""Mean ms of the search's ``search.extract`` span a search call: the
host union's candidate extraction and union, or the device union's
bitmap copy (``last_stats["extract_ms"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "extract_ms")
