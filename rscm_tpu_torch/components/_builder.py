"""Builder-pattern shims matching the reference's Python component builders.

The reference exposes ``XBuilder.from_parameters({...}).build()`` for every
native component (``create_component_builder!`` macro,
``crates/rscm-core/src/python/component.rs:19-87``).  Here a builder is a
thin generic wrapper since our components construct directly from kwargs.
"""

from __future__ import annotations

__all__ = ["make_builder"]


def make_builder(component_cls, name: str = None):
    class Builder:
        def __init__(self, parameters: dict):
            self._parameters = dict(parameters)

        @classmethod
        def from_parameters(cls, parameters: dict) -> "Builder":
            return cls(parameters)

        def build(self):
            return component_cls.from_parameters(self._parameters)

        def __repr__(self):
            return f"{type(self).__name__}({self._parameters})"

    Builder.__name__ = name or f"{component_cls.__name__}Builder"
    Builder.__qualname__ = Builder.__name__
    return Builder
