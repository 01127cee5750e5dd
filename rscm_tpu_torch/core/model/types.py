"""Shared builder/runtime value types (mirror of ``model/types.rs``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..component import RequirementDefinition, RequirementType
from ..spatial import GridType
from ..units import Unit

__all__ = [
    "VariableDefinition",
    "UnitConversionInfo",
    "TransformDirection",
    "RequiredTransformation",
    "ReadSpec",
    "WriteSpec",
]


@dataclass
class VariableDefinition:
    name: str
    unit: str
    parsed_unit: Optional[Unit]
    grid_type: GridType
    requirement_type: RequirementType

    @staticmethod
    def from_requirement_definition(definition: RequirementDefinition) -> "VariableDefinition":
        try:
            parsed = Unit.parse(definition.unit)
        except Exception:
            parsed = None
        return VariableDefinition(
            definition.name,
            definition.unit,
            parsed,
            definition.grid_type,
            definition.requirement_type,
        )


@dataclass
class UnitConversionInfo:
    variable: str
    component: str
    factor: float
    source_unit: str
    target_unit: str


class TransformDirection:
    Read = "Read"
    Write = "Write"


@dataclass
class RequiredTransformation:
    variable: str
    unit: str
    source_grid: GridType
    target_grid: GridType
    direction: str


@dataclass
class ReadSpec:
    """Static per-(component, input) read plan resolved at build time.

    ``window_grid`` is the grid the component's window presents;
    ``aggregation`` (source-size x window-size constant matrix) implements a
    read-side fine->coarse transform; ``factor`` the unit conversion.
    """

    var_name: str
    window_grid: GridType
    factor: float
    source: str
    aggregation: Optional[np.ndarray]


@dataclass
class WriteSpec:
    """Static per-variable write plan: output grid -> storage grid."""

    var_name: str
    source_grid: GridType
    storage_grid: GridType
    matrix: Optional[np.ndarray]  # (source_size x storage_size) or None
