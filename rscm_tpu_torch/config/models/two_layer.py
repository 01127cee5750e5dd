"""Two-layer model config integration: registry entry + typed config."""

from __future__ import annotations

from dataclasses import dataclass, field
from rscm_tpu_torch.components import TwoLayerBuilder

from ..base import ModelConfig
from ..parameters import parameter
from ..registry import component_registry

component_registry.register("TwoLayer", TwoLayerBuilder)

__all__ = ["TwoLayerParams", "TwoLayerParameters", "TwoLayerConfig"]


@dataclass
class TwoLayerParams:
    """Held et al. (2010) two-layer EBM parameters with metadata.

    Values are validated against each field's ``range`` metadata on
    construction (reference: python/rscm/config/models/two_layer.py).
    """

    lambda0: float = parameter(
        default=1.0, unit="W/m^2/K", range=(0.0, 10.0), typical_range=(0.8, 1.5),
        description="Climate feedback parameter at zero warming",
        source="Held et al. (2010)",
    )
    a: float = parameter(
        default=0.0, unit="W/m^2/K^2",
        description="Nonlinear feedback coefficient (0 for linear model)",
    )
    efficacy: float = parameter(
        default=1.0, unit="1", typical_range=(1.0, 1.8),
        description="Ocean heat uptake efficacy",
    )
    eta: float = parameter(
        default=0.7, unit="W/m^2/K",
        description="Surface/deep-ocean heat exchange coefficient",
    )
    heat_capacity_surface: float = parameter(
        default=8.0, unit="W yr/m^2/K", range=(0.1, 100.0),
        description="Mixed-layer + atmosphere heat capacity",
    )
    heat_capacity_deep: float = parameter(
        default=100.0, unit="W yr/m^2/K", range=(1.0, 10000.0),
        description="Deep-ocean heat capacity",
    )


    def __post_init__(self):
        from ..parameters import validate_parameters

        violations = validate_parameters(self)
        if violations:
            raise ValueError("; ".join(violations))


@dataclass
class TwoLayerConfig(ModelConfig):
    """Typed two-layer model configuration."""

    climate: TwoLayerParams = field(default_factory=TwoLayerParams)
    model_type: str = "two-layer"


# Reference-name alias (python/rscm/config/models/two_layer.py)
TwoLayerParameters = TwoLayerParams
