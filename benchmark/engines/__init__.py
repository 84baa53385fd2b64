"""One file per variant of the program (``benchmark/engines/<variant>.py``,
found by the configuration's ``variant``): how the harness builds the
engine and reads back what its timed path derived.  What they share is
here."""

from __future__ import annotations

import numpy as np


class Unreadable(RuntimeError):
    """The harness could not read what the program's timed path made.
    The run then ends with no result: a renamed field or a table kept on
    the card says nothing of whether the answers are right."""


def host(x) -> np.ndarray:
    """A host copy of a NumPy array or of a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)
