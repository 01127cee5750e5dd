"""Component builder registry (mirror of python/rscm/config/registry.py:31-151)."""

from __future__ import annotations

from .exceptions import ComponentNotFoundError

__all__ = ["ComponentRegistry", "component_registry", "register_component"]


class ComponentRegistry:
    """Maps component names to builder classes for config-driven assembly."""

    def __init__(self):
        self._registry: dict = {}

    def register(self, name: str, builder_class):
        if name in self._registry and self._registry[name] is not builder_class:
            raise ValueError(
                f"Component '{name}' is already registered with a different class"
            )
        self._registry[name] = builder_class

    def get(self, name: str):
        if name not in self._registry:
            raise ComponentNotFoundError(name, self.list())
        return self._registry[name]

    def list(self) -> list:
        return sorted(self._registry)

    def is_registered(self, name: str) -> bool:
        return name in self._registry


component_registry = ComponentRegistry()


def register_component(name: str):
    def decorator(cls):
        component_registry.register(name, cls)
        return cls

    return decorator
