"""Batched ensemble execution."""

from .ensemble import EnsembleRunner

__all__ = ["EnsembleRunner"]
