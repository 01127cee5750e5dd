"""
Layered TOML configuration system.

Mirror of ``python/rscm/config/``: dataclass configs, deep-merged config
layers (defaults -> tuning -> experiment), a component registry keyed by
type string, schema-version compatibility checks, parameter metadata with
validation, and doc generation.  A copy of the JAX package's host-only
``config/``; the models it builds are this package's.
"""

from .base import InputSpec, ModelConfig, TimeConfig
from .builder import build_model, build_two_layer_model
from .docs import (
    export_component_metadata,
    export_parameter_json,
    generate_component_docs,
    generate_parameter_docs,
)
from .exceptions import (
    ComponentNotFoundError,
    ConfigError,
    IncompatibleSchemaError,
    ValidationError,
)
from .loader import deep_merge, load_config, load_config_layers
from .parameters import (
    ParameterMetadata,
    get_parameter_metadata,
    parameter,
    validate_parameters,
)
from .registry import ComponentRegistry, component_registry, register_component
from .validation import check_schema_version, find_unknown_keys, parse_semver

__all__ = [
    "ComponentNotFoundError",
    "ComponentRegistry",
    "ConfigError",
    "IncompatibleSchemaError",
    "InputSpec",
    "ModelConfig",
    "ParameterMetadata",
    "TimeConfig",
    "ValidationError",
    "build_model",
    "build_two_layer_model",
    "check_schema_version",
    "component_registry",
    "deep_merge",
    "export_component_metadata",
    "export_parameter_json",
    "find_unknown_keys",
    "generate_component_docs",
    "generate_parameter_docs",
    "get_parameter_metadata",
    "load_config",
    "load_config_layers",
    "parameter",
    "parse_semver",
    "register_component",
    "validate_parameters",
]
