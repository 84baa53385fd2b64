"""Mean blocks inside the rows' label runs a PGE search call, summed
over its rows: what the label-run prune lets through, read beside
``phase1`` (the box tests alone) and ``survived`` (both)
(``last_stats["label_run_blocks"]``)."""

from benchmark import readers


def read(run):
    return readers.mean_counter(run, "label_run_blocks")
