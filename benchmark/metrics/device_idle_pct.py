"""Share of the traced window in which no kernel, copy or set ran on the
card."""

from benchmark import readers


def read(run):
    return readers.device_idle_pct(run)
