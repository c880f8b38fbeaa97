"""Evaluation helpers: attention-alignment diagnostics for validation."""
from .alignment import alignment_diagnostics

__all__ = ["alignment_diagnostics"]
