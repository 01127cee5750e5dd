"""
Terrestrial carbon: 4-pool box model (plant / detritus / soil / humus) with
CO2 fertilization of NPP, temperature-dependent respiration/turnover, and
land-use emissions.

Mirror of ``crates/rscm-magicc/src/carbon/terrestrial.rs:87-340`` +
``src/parameters/terrestrial_carbon.rs`` (pool sizes and flux fractions
calibrated to MAGICC7 pre-industrial steady state).  Pool updates use the
reference's semi-implicit trapezoidal step.
"""

from __future__ import annotations

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter, State

__all__ = ["TerrestrialCarbon", "TerrestrialCarbonBuilder"]


class TerrestrialCarbon(Component):
    """Four-pool terrestrial carbon cycle."""

    tags = ("carbon-cycle", "terrestrial", "magicc")
    category = "Carbon Cycle"

    co2_concentration = Input("Atmospheric Concentration|CO2", unit="ppm")
    temperature = Input("Surface Temperature", unit="K")
    landuse_emissions = Input("Emissions|CO2|Land Use", unit="GtC/yr")
    plant_pool = State("Carbon Pool|Plant", unit="GtC")
    detritus_pool = State("Carbon Pool|Detritus", unit="GtC")
    soil_pool = State("Carbon Pool|Soil", unit="GtC")
    humus_pool = State("Carbon Pool|Humus", unit="GtC")
    net_flux = Output("Carbon Flux|Terrestrial", unit="GtC/yr")

    npp_pi = Parameter(default=66.27, unit="GtC/yr")
    co2_pi = Parameter(default=278.0, unit="ppm")
    beta = Parameter(default=0.6486, description="CO2 fertilization strength")
    npp_temp_sensitivity = Parameter(default=0.0107, unit="1/K")
    resp_temp_sensitivity = Parameter(default=0.0685, unit="1/K")
    detritus_temp_sensitivity = Parameter(default=0.1358, unit="1/K")
    soil_temp_sensitivity = Parameter(default=0.1541, unit="1/K")
    humus_temp_sensitivity = Parameter(default=0.05, unit="1/K")
    plant_pool_pi = Parameter(default=884.86, unit="GtC")
    detritus_pool_pi = Parameter(default=92.77, unit="GtC")
    soil_pool_pi = Parameter(default=1681.53, unit="GtC")
    humus_pool_pi = Parameter(default=836.0, unit="GtC")
    respiration_pi = Parameter(default=12.26, unit="GtC/yr")
    frac_npp_to_plant = Parameter(default=0.4483)
    frac_npp_to_detritus = Parameter(default=0.3998)
    frac_plant_to_detritus = Parameter(default=0.9989)
    frac_detritus_to_soil = Parameter(default=0.3)
    frac_soil_to_humus = Parameter(default=0.1)
    enable_fertilization = Parameter(default=True, static=True)
    enable_temp_feedback = Parameter(default=True, static=True)

    # -- derived pre-industrial turnover times (terrestrial_carbon.rs) ------

    def frac_npp_to_soil(self):
        return xm.maximum(1.0 - self.frac_npp_to_plant - self.frac_npp_to_detritus, 0.0)

    def net_flux_to_plant_pi(self):
        return self.frac_npp_to_plant * self.npp_pi - self.respiration_pi

    def tau_plant_pi(self):
        net_flux = self.net_flux_to_plant_pi()
        return xm.where(net_flux > 1e-10, self.plant_pool_pi / xm.maximum(net_flux, 1e-10), 100.0)

    def tau_detritus_pi(self):
        flux_in = (
            self.frac_npp_to_detritus * self.npp_pi
            + self.frac_plant_to_detritus * self.net_flux_to_plant_pi()
        )
        return xm.where(flux_in > 1e-10, self.detritus_pool_pi / xm.maximum(flux_in, 1e-10), 3.0)

    def tau_soil_pi(self):
        flux_detritus_out = self.detritus_pool_pi / self.tau_detritus_pi()
        flux_in = (
            self.frac_npp_to_soil() * self.npp_pi
            + (1.0 - self.frac_plant_to_detritus) * self.net_flux_to_plant_pi()
            + self.frac_detritus_to_soil * flux_detritus_out
        )
        return xm.where(flux_in > 1e-10, self.soil_pool_pi / xm.maximum(flux_in, 1e-10), 50.0)

    def tau_humus_pi(self):
        flux_soil_out = self.soil_pool_pi / self.tau_soil_pi()
        flux_in = self.frac_soil_to_humus * flux_soil_out
        return xm.where(flux_in > 1e-10, self.humus_pool_pi / xm.maximum(flux_in, 1e-10), 1000.0)

    # -- factors (terrestrial.rs:41-68) --------------------------------------

    def fertilization_factor(self, co2):
        if not self.enable_fertilization:
            return 1.0
        safe_co2 = xm.maximum(co2, 1e-30)
        factor = xm.maximum(1.0 + self.beta * xm.log(safe_co2 / self.co2_pi), 0.1)
        return xm.where(co2 <= 0.0, 1.0, factor)

    def temperature_factor(self, temperature, sensitivity):
        if not self.enable_temp_feedback:
            return 1.0
        return xm.exp(sensitivity * temperature)

    def calculate_npp(self, co2, temperature):
        return (
            self.npp_pi
            * self.fertilization_factor(co2)
            * self.temperature_factor(temperature, self.npp_temp_sensitivity)
        )

    def calculate_respiration(self, co2, temperature):
        return (
            self.respiration_pi
            * self.fertilization_factor(co2)
            * self.temperature_factor(temperature, self.resp_temp_sensitivity)
        )

    @staticmethod
    def _implicit_pool_step(pool_current, tau, flux_in, temp_factor, dt):
        """Semi-implicit trapezoidal pool update (terrestrial.rs:70-88)."""
        k_eff = temp_factor / tau
        half_k = 0.5 * k_eff * dt
        new_pool = ((1.0 - half_k) * pool_current + flux_in * dt) / (1.0 + half_k)
        new_pool = xm.maximum(new_pool, 0.0)
        turnover = 0.5 * k_eff * (pool_current + new_pool)
        return new_pool, turnover

    # -- main step (terrestrial.rs:90-160) ------------------------------------

    def solve_pools(self, co2, temperature, landuse_emissions, pools, dt):
        plant, detritus, soil, humus = pools

        npp = self.calculate_npp(co2, temperature)
        respiration = self.calculate_respiration(co2, temperature)

        tf_detritus = self.temperature_factor(temperature, self.detritus_temp_sensitivity)
        tf_soil = self.temperature_factor(temperature, self.soil_temp_sensitivity)
        tf_humus = self.temperature_factor(temperature, self.humus_temp_sensitivity)

        flux_in_plant = npp * self.frac_npp_to_plant - respiration - landuse_emissions
        new_plant, turnover_plant = self._implicit_pool_step(
            plant, self.tau_plant_pi(), flux_in_plant, 1.0, dt
        )

        flux_in_detritus = (
            npp * self.frac_npp_to_detritus
            + self.frac_plant_to_detritus * turnover_plant
        )
        new_detritus, turnover_detritus = self._implicit_pool_step(
            detritus, self.tau_detritus_pi(), flux_in_detritus, tf_detritus, dt
        )

        flux_in_soil = (
            npp * self.frac_npp_to_soil()
            + (1.0 - self.frac_plant_to_detritus) * turnover_plant
            + self.frac_detritus_to_soil * turnover_detritus
        )
        new_soil, turnover_soil = self._implicit_pool_step(
            soil, self.tau_soil_pi(), flux_in_soil, tf_soil, dt
        )

        flux_in_humus = self.frac_soil_to_humus * turnover_soil
        new_humus, turnover_humus = self._implicit_pool_step(
            humus, self.tau_humus_pi(), flux_in_humus, tf_humus, dt
        )

        detritus_to_atm = (1.0 - self.frac_detritus_to_soil) * turnover_detritus
        soil_to_atm = (1.0 - self.frac_soil_to_humus) * turnover_soil
        total_respiration = respiration + detritus_to_atm + soil_to_atm + turnover_humus
        net_flux = npp - total_respiration - landuse_emissions

        return (new_plant, new_detritus, new_soil, new_humus), net_flux

    def solve_ctx(self, ctx, inputs, internal_state):
        dt = ctx.t_next - ctx.t_current
        pools = (
            inputs.plant_pool.at_start(),
            inputs.detritus_pool.at_start(),
            inputs.soil_pool.at_start(),
            inputs.humus_pool.at_start(),
        )
        (new_plant, new_detritus, new_soil, new_humus), net_flux = self.solve_pools(
            inputs.co2_concentration.get(),
            inputs.temperature.get(),
            inputs.landuse_emissions.get(),
            pools,
            dt,
        )
        return (
            self.Outputs(
                plant_pool=new_plant,
                detritus_pool=new_detritus,
                soil_pool=new_soil,
                humus_pool=new_humus,
                net_flux=net_flux,
            ),
            internal_state,
        )


TerrestrialCarbonBuilder = make_builder(TerrestrialCarbon)
