"""Schema-version checks and unknown-key detection
(mirror of python/rscm/config/validation.py)."""

from __future__ import annotations

import logging

from .exceptions import IncompatibleSchemaError

logger = logging.getLogger(__name__)

__all__ = ["parse_semver", "check_schema_version", "find_unknown_keys"]


def parse_semver(version: str):
    parts = version.split(".")
    if len(parts) != 3:
        raise ValueError(
            f"Invalid semver format: '{version}' (expected 'MAJOR.MINOR.PATCH')"
        )
    try:
        return tuple(int(p) for p in parts)
    except ValueError as err:
        raise ValueError(
            f"Invalid semver format: '{version}' (non-integer component)"
        ) from err


def check_schema_version(config_version: str, loader_version: str):
    """Major mismatch -> error; config minor newer -> warn; else silent."""
    config_major, config_minor, _ = parse_semver(config_version)
    loader_major, loader_minor, _ = parse_semver(loader_version)
    if config_major != loader_major:
        raise IncompatibleSchemaError(config_version, loader_version)
    if config_minor > loader_minor:
        logger.warning(
            f"Configuration schema version {config_version} is newer than "
            f"loader version {loader_version}. Some features may not be supported."
        )


def find_unknown_keys(data: dict, known_keys: set) -> list:
    return sorted(set(data) - known_keys)
