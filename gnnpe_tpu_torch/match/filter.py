"""Flat f64 host filters, re-exported from gnnpe_tpu: the shared ε
threshold, and the chunked oracles every candidate search is held
against."""

from gnnpe_tpu.match.filter import (eps_threshold, pe_candidates_chunked,
                                    pge_candidates_chunked)

__all__ = ["eps_threshold", "pe_candidates_chunked",
           "pge_candidates_chunked"]
