"""``rscm.components`` — generic component builders, resolved to the port's
implementations (the reference binds these names to its Rust components):
one-box carbon cycle, logarithmic CO2 forcing, and the four-box ocean heat
uptake."""

from rscm_tpu_torch.components import (
    CarbonCycleBuilder,
    CO2ERFBuilder,
    FourBoxOceanHeatUptakeBuilder,
)

__all__ = [
    "CarbonCycleBuilder",
    "CO2ERFBuilder",
    "FourBoxOceanHeatUptakeBuilder",
]
