"""
Four-box ocean heat uptake distribution.

Mirror of ``crates/rscm-components/src/components/four_box_ocean_heat_uptake.rs``:
distributes a scalar aggregated ERF into four regional heat-uptake values by
per-region efficiency ratios (which must average to 1 with equal weights).
"""

from __future__ import annotations

from rscm_tpu_torch.core.component import Component, Input, Output, Parameter
from rscm_tpu_torch.core.state import FourBoxSlice

from ._builder import make_builder

__all__ = ["FourBoxOceanHeatUptake", "FourBoxOceanHeatUptakeBuilder"]


class FourBoxOceanHeatUptake(Component):
    """Distribute scalar ERF into regional (four-box) ocean heat uptake."""

    tags = ("temperature", "ocean", "regional", "four-box", "experimental")
    category = "Ocean"

    erf = Input("Effective Radiative Forcing|Aggregated", unit="W/m^2")
    heat_uptake = Output("Heat Uptake|Ocean", unit="W/m^2", grid="FourBox")

    northern_ocean_ratio = Parameter(default=1.2)
    northern_land_ratio = Parameter(default=0.6)
    southern_ocean_ratio = Parameter(default=1.6)
    southern_land_ratio = Parameter(default=0.6)

    @classmethod
    def from_parameters(cls, parameters: dict):
        instance = cls(**parameters)
        avg = (
            float(instance.northern_ocean_ratio)
            + float(instance.northern_land_ratio)
            + float(instance.southern_ocean_ratio)
            + float(instance.southern_land_ratio)
        ) / 4.0
        assert abs(avg - 1.0) < 0.01, (
            f"Regional ratios must average to 1.0 with equal weights (got {avg})"
        )
        return instance

    def solve_ctx(self, ctx, inputs, internal_state):
        erf = inputs.erf.get()
        uptake = FourBoxSlice(
            erf * self.northern_ocean_ratio,
            erf * self.northern_land_ratio,
            erf * self.southern_ocean_ratio,
            erf * self.southern_land_ratio,
        )
        return (self.Outputs(heat_uptake=uptake), internal_state)


FourBoxOceanHeatUptakeBuilder = make_builder(FourBoxOceanHeatUptake)
