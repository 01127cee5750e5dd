"""
Two-layer energy-balance model (Held et al. 2010).

Mirror of ``crates/rscm-two-layer/src/component.rs``:

    Cs dTs/dt = F − (λ0 − a·Ts)·Ts − ε·η·(Ts − Td)
    Cd dTd/dt = η·(Ts − Td)

with a third ODE dimension accumulating total heat content.  Solved with
RK4 at a 0.1 yr sub-step inside each model step; the forcing window is
constant over the step (``component.rs:159-189, 223-252``).
"""

from __future__ import annotations

from rscm_tpu_torch.core.component import Component, Input, Parameter, State
from rscm_tpu_torch.core.ivp import solve_ivp_rk4

from ._builder import make_builder

__all__ = ["TwoLayer", "TwoLayerBuilder"]


class TwoLayer(Component):
    """Two-layer (surface + deep-ocean) energy balance model."""

    tags = ("temperature", "ocean", "two-layer", "stable")
    category = "Temperature"

    erf = Input("Effective Radiative Forcing", unit="W/m^2")
    surface_temperature = State("Surface Temperature", unit="K")
    deep_temperature = State("Deep Ocean Temperature", unit="K")

    lambda0 = Parameter(
        description="Climate feedback parameter at zero warming", unit="W/m^2/K"
    )
    a = Parameter(description="State dependence of climate feedback", unit="W/m^2/K^2")
    efficacy = Parameter(description="Deep-ocean heat uptake efficacy", unit="1")
    eta = Parameter(description="Surface/deep heat exchange coefficient", unit="W/m^2/K")
    heat_capacity_surface = Parameter(
        description="Heat capacity of the surface mixed layer", unit="W yr/m^2/K"
    )
    heat_capacity_deep = Parameter(
        description="Heat capacity of the deep ocean", unit="W yr/m^2/K"
    )

    def solve_ctx(self, ctx, inputs, internal_state):
        erf = inputs.erf.get()

        def dy_dt(t, y):
            temperature_surface, temperature_deep, _heat = y
            temperature_difference = temperature_surface - temperature_deep
            lambda_eff = self.lambda0 - self.a * temperature_surface
            heat_exchange_surface = self.efficacy * self.eta * temperature_difference
            dts_dt = (
                erf - lambda_eff * temperature_surface - heat_exchange_surface
            ) / self.heat_capacity_surface
            heat_exchange_deep = self.eta * temperature_difference
            dtd_dt = heat_exchange_deep / self.heat_capacity_deep
            dheat_dt = (
                self.heat_capacity_surface * dts_dt + self.heat_capacity_deep * dtd_dt
            )
            return (dts_dt, dtd_dt, dheat_dt)

        y0 = (
            inputs.surface_temperature.at_start(),
            inputs.deep_temperature.at_start(),
            0.0,
        )
        ts, td, _heat = solve_ivp_rk4(dy_dt, y0, ctx, step_size=0.1)
        return (
            self.Outputs(surface_temperature=ts, deep_temperature=td),
            internal_state,
        )


TwoLayerBuilder = make_builder(TwoLayer)
