"""Utilities: small dense/banded linear algebra, TOML encoding and the
device choice."""

from .linear_algebra import (
    invert_4x4,
    invert_4x4_traced,
    thomas_solve,
    thomas_solve_assoc,
    thomas_solve_batched,
)
from .target import mesh_context, mesh_platform, resolve_device
from .toml_writer import dumps_toml

__all__ = [
    "invert_4x4",
    "invert_4x4_traced",
    "thomas_solve",
    "thomas_solve_batched",
    "thomas_solve_assoc",
    "dumps_toml",
    "resolve_device",
    "mesh_platform",
    "mesh_context",
]
