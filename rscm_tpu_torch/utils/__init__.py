"""Utilities: small dense/banded linear algebra and the device choice."""

from .linear_algebra import invert_4x4, invert_4x4_traced, thomas_solve, thomas_solve_batched
from .target import resolve_device

__all__ = [
    "invert_4x4",
    "invert_4x4_traced",
    "thomas_solve",
    "thomas_solve_batched",
    "resolve_device",
]
