"""Layered TOML configuration loading
(mirror of python/rscm/config/loader.py:27-128)."""

from __future__ import annotations

import logging
import tomllib
from pathlib import Path

from .validation import check_schema_version, find_unknown_keys

logger = logging.getLogger(__name__)

__all__ = [
    "LOADER_SCHEMA_VERSION",
    "deep_merge",
    "load_config",
    "load_config_layers",
]

#: Schema version this loader implements; configs declaring an
#: incompatible major version are rejected at load time.
LOADER_SCHEMA_VERSION = "1.0.0"

KNOWN_TOP_LEVEL = {
    "schema",
    "time",
    "components",
    "inputs",
    "outputs",
    "model",
    "initial_values",
}


def deep_merge(base: dict, override: dict) -> dict:
    """Recursive dict merge; override wins, lists replaced not concatenated."""
    result = base.copy()
    for key, value in override.items():
        if key in result and isinstance(result[key], dict) and isinstance(value, dict):
            result[key] = deep_merge(result[key], value)
        else:
            result[key] = value
    return result


def load_config(path) -> dict:
    """Load one TOML file, warning on unknown top-level keys.

    A declared schema version (``[schema] version`` or
    ``[model] config_schema``) is checked against
    :data:`LOADER_SCHEMA_VERSION`: an incompatible major raises
    :class:`~rscm_tpu_torch.config.exceptions.IncompatibleSchemaError`.
    """
    path = Path(path)
    with path.open("rb") as f:
        config = tomllib.load(f)
    unknown = find_unknown_keys(config, KNOWN_TOP_LEVEL)
    if unknown:
        logger.warning(
            f"Unknown configuration keys in {path}: {', '.join(unknown)}. "
            "These will be ignored."
        )
    declared = config.get("schema", {}).get("version") or config.get(
        "model", {}
    ).get("config_schema")
    if declared:
        check_schema_version(str(declared), LOADER_SCHEMA_VERSION)
    # remember where the config lives so relative input files resolve;
    # file-bearing input specs get the directory stamped per spec, so a
    # later override layer (whose _base_dir wins the merge) cannot
    # redirect a defaults-layer file to the wrong directory
    config["_base_dir"] = str(path.parent)
    inputs = config.get("inputs")
    if isinstance(inputs, dict):
        for spec in inputs.values():
            if isinstance(spec, dict) and spec.get("file"):
                spec.setdefault("_base_dir", str(path.parent))
    return config


def load_config_layers(*paths) -> dict:
    """Merge configs left-to-right (defaults -> tuning -> experiment)."""
    if not paths:
        return {}
    result = load_config(paths[0])
    for path in paths[1:]:
        result = deep_merge(result, load_config(path))
    return result
