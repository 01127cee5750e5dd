"""Configuration exception hierarchy (mirror of python/rscm/config/exceptions.py)."""

from __future__ import annotations

__all__ = [
    "ConfigError",
    "ValidationError",
    "IncompatibleSchemaError",
    "ComponentNotFoundError",
]


class ConfigError(Exception):
    """Base exception for configuration errors."""


class ValidationError(ConfigError):
    """Type mismatches, missing required fields, out-of-range values."""


class IncompatibleSchemaError(ConfigError):
    def __init__(self, config_version: str, loader_version: str):
        self.config_version = config_version
        self.loader_version = loader_version
        super().__init__(
            f"Incompatible schema version: config has version "
            f"{config_version}, loader supports {loader_version} "
            f"(major versions differ)"
        )


class ComponentNotFoundError(ConfigError):
    def __init__(self, name: str, available: list):
        self.name = name
        self.available = available
        super().__init__(
            f"Component '{name}' not found in registry. "
            f"Available components: {', '.join(available) if available else '(none)'}"
        )
