"""The yardstick's peaks and the work a search needs, counted by the
benchmark's own arithmetic so that whatever later implements the search
is measured against the same work.

Peaks: NVIDIA's H100 SXM data sheet, at its full power limit of 700 W
(a run prints the card's own limit beside its numbers).
"""

from __future__ import annotations

PEAK_HBM_BYTES_PER_S = 3.35e12

F32, I32 = 4, 4


def search_bytes(config: dict, stats: dict) -> int:
    """Bytes one PE index search has to read from device memory, each
    once: every block's summary (the upper bound of its PDE, the window
    of its label features, the largest degree at each position) and the
    vertex ids of every row of the blocks that survive phase 1.  The
    per-vertex labels, degrees and VDE gathered for those rows are left
    out (the tables fit in L2), so the count is a floor of the work."""
    length = config["l"] + 1                 # vertices in a path
    width = length * config["e"]
    summary = 3 * width * F32 + length * I32
    rows = stats["survived"] * config["block_size"] * length * I32
    return stats["blocks"] * summary + rows
