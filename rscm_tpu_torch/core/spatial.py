"""
Spatial grids: Scalar (global), Hemispheric (N/S), FourBox (MAGICC standard).

Mirrors ``crates/rscm-core/src/spatial/`` and ``grid_transform.rs``:

- FourBox region order: NorthernOcean, NorthernLand, SouthernOcean,
  SouthernLand (``spatial/four_box.rs:8``).
- Aggregation is fine -> coarse only; disaggregation always requires an
  explicit user component (``grid_transform.rs:12-20``).
- Grids carry aggregation weights (area fractions summing to 1).

Every transform is expressed as a constant aggregation matrix
(``transform_matrix``), so a grid transform inside the batched year loop is
one small constant matmul over the region axis.
"""

from __future__ import annotations

from enum import Enum, IntEnum
from typing import Optional, Sequence

import numpy as np

from .errors import UnsupportedGridTransformationError

__all__ = [
    "GridType",
    "ScalarRegion",
    "HemisphericRegion",
    "FourBoxRegion",
    "SpatialGrid",
    "ScalarGrid",
    "HemisphericGrid",
    "FourBoxGrid",
    "grid_for_type",
    "grid_size",
]


class GridType(Enum):
    Scalar = "Scalar"
    FourBox = "FourBox"
    Hemispheric = "Hemispheric"

    @property
    def name_str(self) -> str:
        return self.value

    def is_coarser_than(self, other: "GridType") -> bool:
        """Mirror of ``GridType::is_coarser_than`` (``component.rs:57-64``)."""
        return (self, other) in {
            (GridType.Scalar, GridType.FourBox),
            (GridType.Scalar, GridType.Hemispheric),
            (GridType.Hemispheric, GridType.FourBox),
        }

    def can_aggregate_to(self, target: "GridType") -> bool:
        return self == target or target.is_coarser_than(self)

    @property
    def size(self) -> int:
        return _GRID_SIZES[self]

    def __str__(self) -> str:
        return self.value


_GRID_SIZES = {GridType.Scalar: 1, GridType.FourBox: 4, GridType.Hemispheric: 2}


def grid_size(grid_type: GridType) -> int:
    return _GRID_SIZES[grid_type]


class ScalarRegion(IntEnum):
    Global = 0
    GLOBAL = 0  # reference constant-style alias


class HemisphericRegion(IntEnum):
    Northern = 0
    Southern = 1
    NORTHERN = 0  # reference constant-style aliases
    SOUTHERN = 1


class FourBoxRegion(IntEnum):
    NorthernOcean = 0
    NorthernLand = 1
    SouthernOcean = 2
    SouthernLand = 3
    NORTHERN_OCEAN = 0  # reference constant-style aliases
    NORTHERN_LAND = 1
    SOUTHERN_OCEAN = 2
    SOUTHERN_LAND = 3


class _Weights(np.ndarray):
    """Area-weight vector; also callable, matching the reference's
    ``grid.weights()`` method style while staying a plain ndarray for the
    rest of the engine (``grid.weights`` attribute access)."""

    def __call__(self) -> np.ndarray:
        return np.asarray(self)


def _as_weights(values) -> "_Weights":
    # copy, never view: asarray on a float64 input returns the CALLER'S
    # array, and the read-only flag on a view does not protect a writable
    # base — the caller could silently mutate the grid's weights (and its
    # __hash__/__eq__/aggregation) through their own reference
    w = np.array(values, dtype=np.float64).view(_Weights)
    w.setflags(write=False)
    return w


class SpatialGrid:
    """Base spatial grid: size, region names, weights, aggregation, transform."""

    grid_type: GridType
    weights: np.ndarray

    def grid_name(self) -> str:
        return self.grid_type.value

    def size(self) -> int:
        return self.grid_type.size

    def region_names(self) -> list:
        raise NotImplementedError

    def aggregate_global(self, values) -> float:
        values = np.asarray(values, dtype=np.float64)
        assert values.shape[-1] == self.size(), (
            f"{self.grid_name()}Grid expects exactly {self.size()} regional values"
        )
        return float(np.dot(values, self.weights)) if values.ndim == 1 else values @ self.weights

    def transform_matrix(self, target: "SpatialGrid") -> np.ndarray:
        """Constant matrix M with target_values = values @ M.

        Raises when the transformation is unsupported (disaggregation).
        """
        raise NotImplementedError

    def transform_to(self, values, target: "SpatialGrid"):
        """Transform regional values onto a target grid (fine -> coarse only)."""
        values = np.asarray(values, dtype=np.float64)
        assert values.shape[-1] == self.size(), "Values length must match grid size"
        m = self.transform_matrix(target)
        return list(values @ m)

    def __eq__(self, other):
        return (
            isinstance(other, SpatialGrid)
            and self.grid_type == other.grid_type
            and np.array_equal(self.weights, other.weights)
        )

    def __hash__(self):
        return hash((self.grid_type, self.weights.tobytes()))

    def __repr__(self):
        return f"{type(self).__name__}(weights={self.weights.tolist()})"


class ScalarGrid(SpatialGrid):
    grid_type = GridType.Scalar

    def __init__(self):
        self.weights = _as_weights([1.0])

    def region_names(self) -> list:
        return ["Global"]

    def transform_matrix(self, target: SpatialGrid) -> np.ndarray:
        if target.size() == 1:
            return np.array([[1.0]])
        raise UnsupportedGridTransformationError("<value>", self.grid_name(), target.grid_name())


class HemisphericGrid(SpatialGrid):
    grid_type = GridType.Hemispheric

    def __init__(self, weights: Optional[Sequence[float]] = None):
        if weights is None:
            weights = [0.5, 0.5]
        weights = np.asarray(weights, dtype=np.float64)
        assert weights.shape == (2,)
        assert abs(float(weights.sum()) - 1.0) < 1e-6, (
            f"Weights must sum to 1.0, got {float(weights.sum())}"
        )
        self.weights = _as_weights(weights)
        self.weights.setflags(write=False)

    @staticmethod
    def equal_weights() -> "HemisphericGrid":
        return HemisphericGrid()

    @staticmethod
    def with_weights(weights) -> "HemisphericGrid":
        return HemisphericGrid(weights)

    def region_names(self) -> list:
        return ["Northern Hemisphere", "Southern Hemisphere"]

    def transform_matrix(self, target: SpatialGrid) -> np.ndarray:
        if target.size() == 1:
            return self.weights.reshape(2, 1)
        if target.size() == 2:
            return np.eye(2)
        raise UnsupportedGridTransformationError("<value>", self.grid_name(), target.grid_name())


class FourBoxGrid(SpatialGrid):
    grid_type = GridType.FourBox

    def __init__(self, weights: Optional[Sequence[float]] = None):
        if weights is None:
            weights = [0.25, 0.25, 0.25, 0.25]
        weights = np.asarray(weights, dtype=np.float64)
        assert weights.shape == (4,)
        assert abs(float(weights.sum()) - 1.0) < 1e-6, (
            f"Weights must sum to 1.0, got {float(weights.sum())}"
        )
        northern = weights[FourBoxRegion.NorthernOcean] + weights[FourBoxRegion.NorthernLand]
        southern = weights[FourBoxRegion.SouthernOcean] + weights[FourBoxRegion.SouthernLand]
        assert northern > 1e-10, (
            "Northern hemisphere weights must be non-zero for hemispheric "
            f"transformation, got {northern}"
        )
        assert southern > 1e-10, (
            "Southern hemisphere weights must be non-zero for hemispheric "
            f"transformation, got {southern}"
        )
        self.weights = _as_weights(weights)
        self.weights.setflags(write=False)

    @staticmethod
    def magicc_standard() -> "FourBoxGrid":
        return FourBoxGrid()

    @staticmethod
    def with_weights(weights) -> "FourBoxGrid":
        return FourBoxGrid(weights)

    def region_names(self) -> list:
        return ["Northern Ocean", "Northern Land", "Southern Ocean", "Southern Land"]

    def transform_matrix(self, target: SpatialGrid) -> np.ndarray:
        w = self.weights
        if target.size() == 1:
            return w.reshape(4, 1)
        if target.size() == 2:
            no, nl, so, sl = (
                FourBoxRegion.NorthernOcean,
                FourBoxRegion.NorthernLand,
                FourBoxRegion.SouthernOcean,
                FourBoxRegion.SouthernLand,
            )
            north_sum = w[no] + w[nl]
            south_sum = w[so] + w[sl]
            m = np.zeros((4, 2))
            m[no, 0] = w[no] / north_sum
            m[nl, 0] = w[nl] / north_sum
            m[so, 1] = w[so] / south_sum
            m[sl, 1] = w[sl] / south_sum
            return m
        if target.size() == 4:
            return np.eye(4)
        raise UnsupportedGridTransformationError("<value>", self.grid_name(), target.grid_name())


def grid_for_type(grid_type: GridType, weights=None) -> SpatialGrid:
    """Construct the grid object for a GridType with optional custom weights."""
    if grid_type is GridType.Scalar:
        return ScalarGrid()
    if grid_type is GridType.FourBox:
        return FourBoxGrid(weights)
    if grid_type is GridType.Hemispheric:
        return HemisphericGrid(weights)
    raise ValueError(f"Unknown grid type {grid_type}")
