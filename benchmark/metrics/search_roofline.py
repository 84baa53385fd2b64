"""The search kernels' share of their byte roofline (see
readers.search_roofline_pct)."""

from benchmark import readers


def read(run):
    return readers.search_roofline_pct(run)
