"""Bidirectional mapping between MAGICC .CFG format and nested configs.

Covers the reference's ``rscm.config.models.magicc.legacy`` surface
(`python/rscm/config/models/magicc/legacy.py`) with one deliberate
extension: parameters the reference registry tracks as NOT_IMPLEMENTED but
this engine implements (the GHG forcing method and rapid adjustments) are
SUPPORTED here and map through — see ARCHITECTURE.md "Known deviations".

Design: the flat .CFG namespace is case-insensitive and keyed by Fortran
parameter names; the nested side is dot-path addressed into plain dicts so
the result feeds ``build_model``'s TOML-shaped configs directly. Import
triage (supported / known-but-unsupported / unknown) is table-driven off
``MAGICC_PARAMETERS`` statuses.
"""

from __future__ import annotations

import logging
from functools import reduce
from typing import Any, Dict

from .parameters import MAGICC_PARAMETERS, ParameterStatus

logger = logging.getLogger(__name__)

__all__ = ["LEGACY_MAPPING", "from_legacy_dict", "to_legacy_dict"]

LEGACY_MAPPING: Dict[str, str] = {
    p.name.lower(): p.rscm_path
    for p in MAGICC_PARAMETERS.values()
    if p.status == ParameterStatus.SUPPORTED and p.rscm_path
}

_MISSING = object()


def _walk(tree: Any, path: str) -> Any:
    """Dot-path lookup into nested dicts; _MISSING when any hop fails."""
    def hop(node, key):
        if isinstance(node, dict) and key in node:
            return node[key]
        return _MISSING

    return reduce(hop, path.split("."), tree)


def _plant(tree: dict, path: str, value: Any) -> None:
    """Dot-path insert into nested dicts, growing branches as needed."""
    *branch, leaf = path.split(".")
    node = reduce(lambda d, k: d.setdefault(k, {}), branch, tree)
    node[leaf] = value


def _triage_unsupported(key: str) -> None:
    """Log a known-but-unmapped legacy key per its registry status."""
    status = MAGICC_PARAMETERS[key.lower()].status
    if status == ParameterStatus.NOT_IMPLEMENTED:
        logger.info(f"Parameter '{key}' not implemented, ignoring")
    elif status == ParameterStatus.DEPRECATED:
        logger.warning(f"Parameter '{key}' is deprecated, ignoring")
    # NOT_NEEDED and any future passive statuses stay silent


def from_legacy_dict(legacy: Dict[str, Any]) -> Dict[str, Any]:
    """Flat MAGICC .CFG dict -> nested config dict.

    SUPPORTED parameters map through; NOT_IMPLEMENTED log at INFO;
    DEPRECATED warn; NOT_NEEDED are silent; unknown keys warn.
    """
    config: Dict[str, Any] = {}
    for key, value in legacy.items():
        path = LEGACY_MAPPING.get(key.lower())
        if path is not None:
            _plant(config, path, value)
        elif key.lower() in MAGICC_PARAMETERS:
            _triage_unsupported(key)
        else:
            logger.warning(f"Unknown legacy parameter '{key}', ignoring")
    return config


def to_legacy_dict(config: Dict[str, Any]) -> Dict[str, Any]:
    """Nested config dict -> flat MAGICC .CFG dict (supported keys only)."""
    found = (
        (key, _walk(config, path)) for key, path in LEGACY_MAPPING.items()
    )
    # identity checks: `in (...)` would apply == element-wise to numpy
    # array values and raise on truthiness
    return {
        key: value
        for key, value in found
        if value is not _MISSING and value is not None
    }
