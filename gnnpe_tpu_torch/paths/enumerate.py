"""Simple-path enumeration with orientation dedup, re-exported from
gnnpe_tpu (host numpy frontier expansion).  ``enumerate_paths_from``,
``start_ranks`` and ``dedup_orientations_streaming`` are the host
forms that paths/device_enumerate.py is held against."""

from gnnpe_tpu.paths.enumerate import (dedup_orientations_streaming,
                                       enumerate_paths,
                                       enumerate_paths_from, start_ranks)

__all__ = ["dedup_orientations_streaming", "enumerate_paths",
           "enumerate_paths_from", "start_ranks"]
