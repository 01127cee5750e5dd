"""Generic component support (the component library itself is not ported yet)."""

from ._builder import make_builder

__all__ = ["make_builder"]
