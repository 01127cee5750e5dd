"""Batched ensemble execution, and its split over a device mesh."""

from .ensemble import EnsembleRunner, Mesh, make_mesh, stack_params

__all__ = ["EnsembleRunner", "Mesh", "make_mesh", "stack_params"]
