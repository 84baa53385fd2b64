"""Host packed-index builds, re-exported from gnnpe_tpu: entries sorted
by label signature then -Σpde, one level of block summaries.  Their
numpy fields are what index/device_packed.py uploads."""

from gnnpe_tpu.index.packed import (PackedDominanceIndex, PGEPackedIndex,
                                    load_index, save_index)

__all__ = ["PackedDominanceIndex", "PGEPackedIndex", "load_index",
           "save_index"]
