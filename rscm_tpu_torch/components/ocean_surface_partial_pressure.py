"""
Ocean-surface CO2 partial pressure (Joos et al. 2001 polynomial fit).

Mirror of ``crates/rscm-components/src/components/ocean_carbon_cycle/
ocean_surface_partial_pressure.rs``: a quartic polynomial in the dissolved
inorganic carbon anomaly, with temperature-dependent coefficients and an
exponential SST sensitivity.
"""

from __future__ import annotations

from rscm_tpu_torch.core.component import Component, Input, Output, Parameter
from rscm_tpu_torch.core import xmath as xm

from ._builder import make_builder

__all__ = ["OceanSurfacePartialPressure", "OceanSurfacePartialPressureBuilder"]


class OceanSurfacePartialPressure(Component):
    """Ocean-surface pCO2 from SST anomaly + DIC anomaly."""

    tags = ("ocean", "carbon-cycle", "magicc", "experimental")
    category = "Ocean Carbon Cycle"

    sea_surface_temperature = Input("Sea Surface Temperature", unit="K")
    dissolved_inorganic_carbon = Input("Dissolved Inorganic Carbon", unit="micromol / kg")
    ospp_co2 = Output("Ocean Surface Partial Pressure|CO2", unit="ppm")

    ospp_preindustrial = Parameter(unit="ppm")
    sensitivity_ospp_to_temperature = Parameter(unit="1/K")
    sea_surface_temperature_preindustrial = Parameter(default=0.0, unit="K")
    delta_ospp_offsets = Parameter(default=(0.0,) * 5, static=True)
    delta_ospp_coefficients = Parameter(default=(0.0,) * 5, static=True)

    def calculate_ospp(self, delta_dic):
        # Polynomial basis in the DIC anomaly; coefficient scalings match the
        # reference literally (including its 10e-3 = 1e-2 style constants).
        bits = (
            delta_dic,
            delta_dic**2 * 10e-3,
            -(delta_dic**3) * 10e-5,
            delta_dic**4 * 10e-7,
            -(delta_dic**4) * 10e-10,
        )
        total = 0.0
        for offset, coeff, bit in zip(
            self.delta_ospp_offsets, self.delta_ospp_coefficients, bits
        ):
            total = total + (
                offset + coeff * self.sea_surface_temperature_preindustrial
            ) * bit
        return total

    def solve_ctx(self, ctx, inputs, internal_state):
        delta_sst = inputs.sea_surface_temperature.get()
        delta_dic = inputs.dissolved_inorganic_carbon.get()
        delta_ospp = self.calculate_ospp(delta_dic)
        ospp = (self.ospp_preindustrial + delta_ospp) * xm.exp(
            self.sensitivity_ospp_to_temperature * delta_sst
        )
        return (self.Outputs(ospp_co2=ospp), internal_state)


OceanSurfacePartialPressureBuilder = make_builder(OceanSurfacePartialPressure)
