"""Candidate refinement, re-exported from gnnpe_tpu: host C++
(match/native/refine.cpp, built with g++ at first use) behind ctypes.

Pass ``engine="native"``: ``"auto"`` silently falls back to the Python
explorer when the native build fails."""

from gnnpe_tpu.match.refine import refinement

__all__ = ["refinement"]
