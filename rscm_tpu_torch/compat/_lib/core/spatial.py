"""``rscm._lib.core.spatial`` — grids and region enums."""

from rscm_tpu_torch.core.spatial import (  # noqa: F401
    FourBoxGrid,
    FourBoxRegion,
    GridType,
    HemisphericGrid,
    HemisphericRegion,
    ScalarGrid,
    ScalarRegion,
    SpatialGrid,
)

__all__ = [
    "FourBoxGrid",
    "FourBoxRegion",
    "GridType",
    "HemisphericGrid",
    "HemisphericRegion",
    "ScalarGrid",
    "ScalarRegion",
    "SpatialGrid",
]
