"""Mean blocks that survive phase 1 and the signature prune, a search: a
query in the online mix, a stacked batch in the batch mix."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "survived")
