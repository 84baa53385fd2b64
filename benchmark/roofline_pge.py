"""The work a GNN-PGE index search needs, counted by the benchmark's own
arithmetic, against ``benchmark/roofline.py``'s peak, so that whatever
later implements the search is measured against the same work.  The
widths are those the PGE search keeps on the card (``PGEPackedIndex``
uploaded by ``DevicePackedPGESearch``): f64 boxes, int32 labels,
degrees and vertex ids."""

from __future__ import annotations

F64, I32 = 8, 4


def search_bytes(config: dict, stats: dict) -> int:
    """Bytes one PGE index search has to read from device memory, each
    once: every block's summary (the upper bound of its group boxes, the
    lower and upper ends of its label-group boxes, its largest degree)
    and, of every row of each block that survives phase 1 and the label
    run, its label, degree, group upper end, label-group box and vertex
    id.  ``l + 1`` vertices a path, so a box has (l + 1) * e columns."""
    width = (config["l"] + 1) * config["e"]
    summary = 3 * width * F64 + I32
    row = I32 + I32 + 3 * width * F64 + I32
    return (stats["blocks"] * summary
            + stats["survived"] * config["block_size"] * row)
