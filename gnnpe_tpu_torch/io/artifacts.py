"""Staged artifact store (checkpoint/resume), re-exported from gnnpe_tpu."""

from gnnpe_tpu.io.artifacts import ArtifactStore

__all__ = ["ArtifactStore"]
