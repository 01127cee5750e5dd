"""
Generic component library.

Mirrors ``crates/rscm-two-layer`` and ``crates/rscm-components``: the
two-layer energy-balance model, a one-box carbon cycle, logarithmic CO2
forcing, four-box ocean heat uptake distribution, and the Joos et al. (2001)
ocean-surface partial pressure.
"""

from .two_layer import TwoLayer, TwoLayerBuilder
from .carbon_cycle import GTC_PER_PPM, CarbonCycle, CarbonCycleBuilder
from .co2_erf import CO2ERF, CO2ERFBuilder
from .four_box_ocean_heat_uptake import (
    FourBoxOceanHeatUptake,
    FourBoxOceanHeatUptakeBuilder,
)
from .ocean_surface_partial_pressure import (
    OceanSurfacePartialPressure,
    OceanSurfacePartialPressureBuilder,
)

__all__ = [
    "TwoLayer",
    "TwoLayerBuilder",
    "CarbonCycle",
    "CarbonCycleBuilder",
    "CO2ERF",
    "CO2ERFBuilder",
    "FourBoxOceanHeatUptake",
    "FourBoxOceanHeatUptakeBuilder",
    "OceanSurfacePartialPressure",
    "OceanSurfacePartialPressureBuilder",
    "GTC_PER_PPM",
]
