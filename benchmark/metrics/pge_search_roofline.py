"""The PGE search's share of its byte roofline: the least time its
bytes (``benchmark/roofline_pge.py``) need at the card's peak rate, as
a share of the device time of the kernels launched inside the engine's
``search`` ranges, over the traced window."""

from benchmark.roofline import PEAK_HBM_BYTES_PER_S
from benchmark.roofline_pge import search_bytes


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace["range_kernel_s"].get("search", 0.0)
    calls = [c for c in run.calls if "survived" in c]
    if kernel_s <= 0 or not calls:
        return None
    need = sum(search_bytes(run.cell.config, c) for c in calls)
    return 100.0 * need / PEAK_HBM_BYTES_PER_S / kernel_s
