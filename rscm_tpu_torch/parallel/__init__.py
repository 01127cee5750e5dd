"""Batched ensemble execution."""

from .ensemble import EnsembleRunner, stack_params

__all__ = ["EnsembleRunner", "stack_params"]
