"""
CO2 budget closure: atmospheric concentration from fossil + land-use
emissions minus terrestrial and ocean uptake.

Mirror of ``crates/rscm-magicc/src/carbon/budget.rs:77-168`` +
``src/parameters/co2_budget.rs``.
"""

from __future__ import annotations

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter, State

__all__ = ["CO2Budget", "CO2BudgetBuilder"]


class CO2Budget(Component):
    """Close the atmospheric CO2 budget."""

    tags = ("carbon-cycle", "budget", "magicc")
    category = "Carbon Cycle"

    fossil_emissions = Input("Emissions|CO2|Fossil", unit="GtC/yr")
    landuse_emissions = Input("Emissions|CO2|Land Use", unit="GtC/yr")
    terrestrial_flux = Input("Carbon Flux|Terrestrial", unit="GtC/yr")
    ocean_flux = Input("Carbon Flux|Ocean", unit="GtC/yr")
    co2_concentration = State("Atmospheric Concentration|CO2", unit="ppm")
    net_emissions = Output("Emissions|CO2|Net", unit="GtC/yr")
    airborne_fraction = Output("Airborne Fraction|CO2", unit="1")

    gtc_per_ppm = Parameter(default=2.123, unit="GtC/ppm")
    co2_pi = Parameter(default=278.0, unit="ppm")

    def solve_budget(self, fossil_emissions, landuse_emissions, terrestrial_flux,
                     ocean_flux, co2_current, dt):
        total_emissions = fossil_emissions + landuse_emissions
        total_uptake = terrestrial_flux + ocean_flux
        net_to_atm = total_emissions - total_uptake

        co2_next = co2_current + (net_to_atm * dt) / self.gtc_per_ppm

        safe_emissions = xm.where(total_emissions > 0.0, total_emissions, 1.0)
        airborne_fraction = xm.where(
            total_emissions > 0.0, net_to_atm / safe_emissions, 0.0
        )
        return co2_next, net_to_atm, airborne_fraction

    def solve_ctx(self, ctx, inputs, internal_state):
        dt = ctx.t_next - ctx.t_current
        co2_next, net_emissions, airborne_fraction = self.solve_budget(
            inputs.fossil_emissions.get(),
            inputs.landuse_emissions.get(),
            inputs.terrestrial_flux.get(),
            inputs.ocean_flux.get(),
            inputs.co2_concentration.at_start(),
            dt,
        )
        return (
            self.Outputs(
                co2_concentration=co2_next,
                net_emissions=net_emissions,
                airborne_fraction=airborne_fraction,
            ),
            internal_state,
        )


CO2BudgetBuilder = make_builder(CO2Budget)
