"""
One-box carbon-cycle with temperature-dependent uptake lifetime.

Mirror of ``crates/rscm-components/src/components/carbon_cycle.rs``:

    dC/dt  = E / 2.13 − (C − C0) / (τ·e^{αT})   [ppm/yr]
    dU/dt  = (C − C0) / (τ·e^{αT}) · 2.13        [GtC/yr cumulative uptake]
    dCE/dt = E                                   [GtC/yr cumulative emissions]

RK4 sub-stepped (default 0.1 yr), emissions/temperature constant over the
step via window ``get()``.
"""

from __future__ import annotations

from rscm_tpu_torch.core.component import Component, Input, Parameter, State
from rscm_tpu_torch.core.ivp import solve_ivp_rk4
from rscm_tpu_torch.core import xmath as xm

from ._builder import make_builder

__all__ = ["CarbonCycle", "CarbonCycleBuilder", "GTC_PER_PPM"]

#: Conversion between atmospheric CO2 mass and mixing ratio
#: (``crates/rscm-components/src/constants.rs``)
GTC_PER_PPM = 2.13


class CarbonCycle(Component):
    """Single-box carbon cycle."""

    tags = ("carbon-cycle", "simple", "stable")
    category = "Carbon Cycle"

    emissions = Input("Emissions|CO2|Anthropogenic", unit="GtC / yr")
    temperature = Input("Surface Temperature", unit="K")
    concentration = State("Atmospheric Concentration|CO2", unit="ppm")
    cumulative_emissions = State("Cumulative Emissions|CO2", unit="Gt C")
    cumulative_uptake = State("Cumulative Land Uptake", unit="Gt C")

    tau = Parameter(description="Atmospheric lifetime of CO2 at equilibrium", unit="yr")
    conc_pi = Parameter(description="Pre-industrial CO2 concentration", unit="ppm")
    alpha_temperature = Parameter(
        description="Temperature sensitivity of the uptake lifetime", unit="1/K"
    )
    step_size = Parameter(default=0.1, description="RK4 sub-step", unit="yr", static=True)

    def solve_ctx(self, ctx, inputs, internal_state):
        emissions = inputs.emissions.get()
        temperature = inputs.temperature.get()

        def dy_dt(t, y):
            conc, _uptake, _cum = y
            lifetime = self.tau * xm.exp(self.alpha_temperature * temperature)
            uptake = (conc - self.conc_pi) / lifetime  # ppm / yr
            return (
                emissions / GTC_PER_PPM - uptake,  # ppm / yr
                uptake * GTC_PER_PPM,  # GtC / yr
                emissions,  # GtC / yr
            )

        y0 = (
            inputs.concentration.at_start(),
            inputs.cumulative_uptake.at_start(),
            inputs.cumulative_emissions.at_start(),
        )
        conc, uptake, cum_emissions = solve_ivp_rk4(dy_dt, y0, ctx, self.step_size)
        return (
            self.Outputs(
                concentration=conc,
                cumulative_uptake=uptake,
                cumulative_emissions=cum_emissions,
            ),
            internal_state,
        )


CarbonCycleBuilder = make_builder(CarbonCycle)
