"""MAGICC model configuration dataclasses.

Behavioral mirror of ``python/rscm/config/models/magicc/config.py``: typed
containers for climate/forcing/aggregation blocks that the legacy-mapping
layer and ``build_model`` consume.  Field defaults follow MAGICC7's
standard configuration (ECS 3.0 K, 2xCO2 forcing 3.71 W/m^2).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...base import ModelConfig

__all__ = ["ClimateConfig", "ForcingConfig", "AggregationConfig", "MAGICCConfig"]


@dataclass
class ClimateConfig:
    """MAGICC climate model parameters."""

    climate_sensitivity: float = 3.0
    forcing_2xco2: float = 3.71


@dataclass
class ForcingConfig:
    """MAGICC forcing parameters."""

    solar_scale: float = 1.0
    volcanic_scale: float = 1.0


@dataclass
class AggregationConfig:
    """MAGICC forcing aggregation settings."""

    run_modus: str = "ALL"


@dataclass
class MAGICCConfig(ModelConfig):
    """Configuration for a MAGICC model."""

    model_type: str = "magicc"
    climate: ClimateConfig = field(default_factory=ClimateConfig)
    forcing: ForcingConfig = field(default_factory=ForcingConfig)
    aggregation: AggregationConfig = field(default_factory=AggregationConfig)
