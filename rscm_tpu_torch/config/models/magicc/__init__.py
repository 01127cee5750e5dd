"""MAGICC model configuration: typed dataclasses + legacy .CFG mapping.

Mirror of ``python/rscm/config/models/magicc/``.
"""

from .config import AggregationConfig, ClimateConfig, ForcingConfig, MAGICCConfig
from .legacy import LEGACY_MAPPING, from_legacy_dict, to_legacy_dict
from .parameters import (
    MAGICC_PARAMETERS,
    ParameterInfo,
    ParameterStatus,
    get_coverage_report,
    get_coverage_stats,
)

__all__ = [
    "AggregationConfig",
    "ClimateConfig",
    "ForcingConfig",
    "LEGACY_MAPPING",
    "MAGICCConfig",
    "MAGICC_PARAMETERS",
    "ParameterInfo",
    "ParameterStatus",
    "from_legacy_dict",
    "get_coverage_report",
    "get_coverage_stats",
    "to_legacy_dict",
]
