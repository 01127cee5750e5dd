"""
CH4 concentration chemistry with OH lifetime feedbacks.

Mirror of ``crates/rscm-magicc/src/chemistry/ch4.rs:75-307`` +
``src/parameters/ch4_chemistry.rs`` (MAGICC7 defaults): Prather-style
iterative burden update (4 iterations) with CH4 self-feedback on OH,
NOx/CO/NMVOC emission feedbacks, temperature feedback, and fixed
soil/stratospheric/tropospheric-Cl sinks.

Beyond the reference (which documents these as simplifications —
``ch4.rs`` module doc "Differences from MAGICC7 Module 01"), this
implementation optionally supports the full MAGICC7 semantics from
the reference's ``docs/modules/module_01_ch4_chemistry.md``:

- ``scheme="magicc7"``: the METHANE-subroutine iteration layout (base
  burden = current concentration, iteration 1 uses the start-of-step
  burden rather than the two-step mean);
- wetland temperature feedback on natural emissions
  (``CH4_WETLAND_SLOPE``, MAGICC7.f90:4006-4015);
- budget-closure natural emissions (:func:`natural_emissions_budget`,
  mirroring ``methane_calc_budget``);
- prescribed concentrations until a switch year
  (``CH4_SWITCHFROMCONC2EMIS_YEAR``), with the Prather update taking
  over afterwards.

Measured against the MAGICC7 SSP245 golden pathway
(``tests/regression/data/ghg_forcing/03_emissions_driven.csv``) the
:meth:`CH4Chemistry.magicc7` configuration tracks concentrations to
~2% max where the plain reference-parity defaults diverge by ~16-18%
(the reference's own recorded parity: max 16.09%, in its
``tests/regression/parity_results.csv``).
"""

from __future__ import annotations

import numpy as np

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter, State

__all__ = [
    "CH4Chemistry",
    "CH4ChemistryBuilder",
    "natural_emissions_budget",
]

PRATHER_ITERATIONS = 4

#: MAGICC7 MAGCFG_DEFAULTALL.CFG values (module_01 doc §4): total initial
#: lifetime, self-feedback S, OH sensitivity scale, feedback coefficients,
#: ppb->Tg conversion (CH4_PPB2TGCH4 x CH4_MIXBOXSIZE), wetland slope.
MAGICC7_CH4 = {
    "tau_tot_init": 9.9474,
    "ch4_self_feedback": -0.53775,
    "oh_sensitivity_scale": 0.72448,
    "oh_nox_sensitivity": 0.0093376,
    "oh_co_sensitivity": -0.000113,
    "oh_nmvoc_sensitivity": -0.0003142,
    "temp_sensitivity": 0.07,
    "ppb_to_tg": 2.824 * 0.973,
    "wetland_slope": 22.4,
    "feedback_year": 1927.0,
    "switch_year": 2015.0,
}


def natural_emissions_budget(
    concentrations,
    anthro_emissions,
    tau_oh,
    tau_other,
    ppb_to_tg,
    n_years: int = 10,
    start_index: int = 0,
):
    """Infer natural emissions by closing the CH4 budget over a window.

    Mirror of MAGICC7's ``methane_calc_budget`` (module_01 doc §7.1):

    ``E_nat = ppb2tg * (sum dC + sum Cbar/tau_OH + sum Cbar/tau_other)/N
    - mean(anthro)`` over ``n_years`` starting at ``start_index`` of the
    prescribed concentration series.  Closing over the earliest decade
    (near pre-industrial equilibrium) reproduces the MAGICC7 SSP245
    pathway best in this framework (measured in
    ``tests/regression/test_emissions_driven.py``).
    """
    c = np.asarray(concentrations, dtype=np.float64)
    e = np.asarray(anthro_emissions, dtype=np.float64)
    i0, i1 = start_index, start_index + n_years
    dcdt = c[i0 + 1 : i1 + 1] - c[i0:i1]
    cbar = (c[i0 + 1 : i1 + 1] + c[i0:i1]) / 2.0
    return float(
        ppb_to_tg
        * (dcdt.sum() + cbar.sum() / tau_oh + cbar.sum() / tau_other)
        / n_years
        - e[i0:i1].mean()
    )


class CH4Chemistry(Component):
    """CH4 concentration with interactive OH lifetime."""

    tags = ("chemistry", "ch4", "magicc")
    category = "Atmospheric Chemistry"

    ch4_emissions = Input("Emissions|CH4", unit="Mt CH4/yr")
    temperature = Input("Surface Temperature", unit="K")
    nox_emissions = Input("Emissions|NOx", unit="Mt N/yr")
    co_emissions = Input("Emissions|CO", unit="Mt CO/yr")
    nmvoc_emissions = Input("Emissions|NMVOC", unit="Mt NMVOC/yr")
    ch4_concentration = State("Atmospheric Concentration|CH4", unit="ppb")
    ch4_lifetime = Output("Lifetime|CH4", unit="yr")

    ch4_pi = Parameter(default=722.0, unit="ppb")
    natural_emissions = Parameter(default=209.0, unit="Mt CH4/yr")
    tau_oh = Parameter(default=9.3, unit="yr")
    tau_soil = Parameter(default=150.0, unit="yr")
    tau_strat = Parameter(default=120.0, unit="yr")
    tau_trop_cl = Parameter(default=200.0, unit="yr")
    ch4_self_feedback = Parameter(default=-0.32)
    oh_sensitivity_scale = Parameter(default=0.72)
    oh_nox_sensitivity = Parameter(default=0.0042)
    oh_co_sensitivity = Parameter(default=-0.000105)
    oh_nmvoc_sensitivity = Parameter(default=-0.000315)
    temp_sensitivity = Parameter(default=0.0316)
    include_temp_feedback = Parameter(default=True, static=True)
    include_emissions_feedback = Parameter(default=True, static=True)
    ppb_to_tg = Parameter(default=2.75, unit="Tg/ppb")
    nox_reference = Parameter(default=0.0)
    co_reference = Parameter(default=0.0)
    nmvoc_reference = Parameter(default=0.0)
    #: MAGICC7 extensions (defaults preserve exact reference-parity output)
    wetland_slope = Parameter(
        default=0.0, unit="Mt CH4/yr/K",
        description="Wetland natural-emission temperature feedback "
        "(CH4_WETLAND_SLOPE; MAGICC7.f90:4006-4015)",
    )
    temp_reference = Parameter(
        default=0.0, unit="K",
        description="Temperature at the feedback reference year "
        "(CH4_YRSTART_TEMP); feedbacks use max(T - temp_reference, 0)",
    )
    scheme = Parameter(
        default="reference", static=True,
        description="'reference' = rscm ch4.rs iteration layout; "
        "'magicc7' = METHANE subroutine layout (module_01 doc §7.2)",
    )
    prescribed_concentrations = Parameter(
        default=None, static=True,
        description="Optional (n_steps,) concentration series on the model "
        "time axis; written verbatim while t_next <= prescribed_until",
    )
    prescribed_until = Parameter(
        default=None, static=True,
        description="Last year (inclusive) whose concentration comes from "
        "prescribed_concentrations (CH4_SWITCHFROMCONC2EMIS_YEAR)",
    )

    # -- lifetime pieces (ch4.rs:49-122) ------------------------------------

    def tau_other(self):
        return 1.0 / (1.0 / self.tau_soil + 1.0 / self.tau_strat + 1.0 / self.tau_trop_cl)

    def _base_lifetime_factor(self, delta_nox, delta_co, delta_nmvoc):
        if not self.include_emissions_feedback:
            return self.tau_oh
        gamma = self.oh_sensitivity_scale
        exponent = -gamma * (
            self.oh_nox_sensitivity * delta_nox
            + self.oh_co_sensitivity * delta_co
            + self.oh_nmvoc_sensitivity * delta_nmvoc
        )
        return self.tau_oh * xm.exp(exponent)

    def _oh_lifetime(self, burden_mean, burden_reference, base_lifetime_factor):
        x = -self.oh_sensitivity_scale * self.ch4_self_feedback
        ratio = xm.maximum(burden_mean / burden_reference, 1.0)
        return base_lifetime_factor * ratio**x

    def _apply_temperature_feedback(self, tau_oh, temperature):
        if not self.include_temp_feedback:
            return tau_oh
        delta_t = xm.maximum(temperature, 0.0)
        adjusted = self.tau_oh / (
            self.tau_oh / tau_oh + self.temp_sensitivity * delta_t
        )
        return xm.where(xm.abs(temperature) < 1e-10, tau_oh, adjusted)

    def _iteration_correction(self, tau_oh, delta_burden_prev, burden_current):
        x = -self.oh_sensitivity_scale * self.ch4_self_feedback
        # safe denominator: a plain where() still differentiates through
        # the divide-by-zero branch (NaN gradients), so mask the input too
        near_zero = xm.abs(burden_current) < 1e-10
        safe_burden = xm.where(near_zero, 1.0, burden_current)
        corrected = tau_oh * (1.0 - 0.5 * x * delta_burden_prev / safe_burden)
        return xm.where(near_zero, tau_oh, corrected)

    def calculate_total_lifetime(self, tau_oh):
        return 1.0 / (1.0 / tau_oh + 1.0 / self.tau_other())

    # -- solve (ch4.rs:126-205) ----------------------------------------------

    def _wetland_emissions(self, temperature):
        """Wetland feedback term; exactly zero (and NaN-free) when unused."""
        if isinstance(self.wetland_slope, float) and self.wetland_slope == 0.0:
            return 0.0
        return self.wetland_slope * xm.maximum(
            temperature - self.temp_reference, 0.0
        )

    def _solve_concentration_magicc7(
        self, ch4_current, anthropogenic_emissions, temperature,
        nox_emissions, co_emissions, nmvoc_emissions,
    ):
        """METHANE-subroutine iteration layout (module_01 doc §7.2).

        Differences from the reference layout: the base burden is the
        current concentration (no two-step window), iteration 1 uses the
        start-of-step burden rather than a mean, and the temperature /
        wetland feedbacks reference ``temp_reference`` (the feedback start
        year) instead of raw anomaly zero.
        """
        total_emissions = (
            anthropogenic_emissions
            + self.natural_emissions
            + self._wetland_emissions(temperature)
        )
        burden = ch4_current * self.ppb_to_tg
        burden_reference = self.ch4_pi * self.ppb_to_tg
        delta_t = xm.maximum(temperature - self.temp_reference, 0.0)

        base_lifetime_factor = self._base_lifetime_factor(
            nox_emissions - self.nox_reference,
            co_emissions - self.co_reference,
            nmvoc_emissions - self.nmvoc_reference,
        )
        x = -self.oh_sensitivity_scale * self.ch4_self_feedback
        tau_other = self.tau_other()

        burden_k = burden
        delta_burden = None
        tau_oh = self.tau_oh
        for iteration in range(PRATHER_ITERATIONS):
            burden_mean = (
                burden if iteration == 0 else (burden + burden_k) / 2.0
            )
            ratio = xm.maximum(burden_mean / burden_reference, 1.0)
            tau_oh = base_lifetime_factor * ratio**x
            if delta_burden is not None:
                # same zero-burden guard as _iteration_correction: a zero
                # start-of-step burden must not poison tau_oh (or its
                # gradient) with inf/NaN
                near_zero = xm.abs(burden) < 1e-10
                safe_burden = xm.where(near_zero, 1.0, burden)
                corrected = tau_oh * (
                    1.0 - 0.5 * x * delta_burden / safe_burden
                )
                tau_oh = xm.where(near_zero, tau_oh, corrected)
            if self.include_temp_feedback:
                tau_oh = self.tau_oh / (
                    self.tau_oh / tau_oh + self.temp_sensitivity * delta_t
                )
            delta_burden = (
                total_emissions - burden_mean / tau_oh - burden_mean / tau_other
            )
            burden_k = burden + delta_burden

        return burden_k / self.ppb_to_tg, self.calculate_total_lifetime(tau_oh)

    def solve_concentration(
        self, ch4_prev, ch4_current, anthropogenic_emissions, temperature,
        nox_emissions, co_emissions, nmvoc_emissions,
    ):
        if self.scheme == "magicc7":
            return self._solve_concentration_magicc7(
                ch4_current, anthropogenic_emissions, temperature,
                nox_emissions, co_emissions, nmvoc_emissions,
            )
        total_emissions = (
            anthropogenic_emissions
            + self.natural_emissions
            + self._wetland_emissions(temperature)
        )
        burden_prev = ch4_prev * self.ppb_to_tg
        burden_reference = self.ch4_pi * self.ppb_to_tg

        base_lifetime_factor = self._base_lifetime_factor(
            nox_emissions - self.nox_reference,
            co_emissions - self.co_reference,
            nmvoc_emissions - self.nmvoc_reference,
        )

        burden = ch4_current * self.ppb_to_tg
        delta_burden = None
        tau_oh = self.tau_oh
        tau_other = self.tau_other()

        for _ in range(PRATHER_ITERATIONS):
            burden_mean = (burden + burden_prev) / 2.0
            tau_oh = self._oh_lifetime(burden_mean, burden_reference, base_lifetime_factor)
            if delta_burden is not None:
                tau_oh = self._iteration_correction(tau_oh, delta_burden, burden_prev)
            tau_oh = self._apply_temperature_feedback(tau_oh, temperature)
            delta_burden = (
                total_emissions - burden_mean / tau_oh - burden_mean / tau_other
            )
            burden = burden_prev + delta_burden

        new_concentration = burden / self.ppb_to_tg
        total_lifetime = self.calculate_total_lifetime(tau_oh)
        return new_concentration, total_lifetime

    def solve_ctx(self, ctx, inputs, internal_state):
        ch4_current = inputs.ch4_concentration.at_start()
        ch4_prev = inputs.ch4_concentration.previous()
        if ch4_prev is None:
            ch4_prev = ch4_current

        new_concentration, lifetime = self.solve_concentration(
            ch4_prev,
            ch4_current,
            inputs.ch4_emissions.get(),
            inputs.temperature.get(),
            inputs.nox_emissions.get(),
            inputs.co_emissions.get(),
            inputs.nmvoc_emissions.get(),
        )
        new_concentration = self._apply_prescribed(ctx, new_concentration)
        return (
            self.Outputs(ch4_concentration=new_concentration, ch4_lifetime=lifetime),
            internal_state,
        )

    def _apply_prescribed(self, ctx, computed):
        """Concentration-prescribed mode until the switch year (shared
        MAGICC7 ``SWITCHFROMCONC2EMIS_YEAR`` semantics — see
        :mod:`rscm_tpu_torch.magicc.chemistry.prescribed`)."""
        from .prescribed import apply_prescribed_concentration

        return apply_prescribed_concentration(
            ctx, computed, self.prescribed_concentrations, self.prescribed_until
        )

    @classmethod
    def magicc7(
        cls,
        years,
        concentrations,
        anthro_emissions,
        nox_emissions,
        co_emissions,
        nmvoc_emissions,
        temperatures=None,
        budget_years: int = 10,
        budget_start_index: int = 0,
        **overrides,
    ):
        """Full MAGICC7 module-01 configuration from a prescribed pathway.

        ``years``/``concentrations``/emission arrays are on the model time
        axis.  Derives: tau_OH from ``CH4_TAUTOT_INIT`` (9.9474 yr),
        budget-closure natural emissions (:func:`natural_emissions_budget`),
        feedback references (burden, emissions, temperature) at the
        feedback start year (1927), the wetland feedback slope, and
        concentration prescription until the switch year (2015).  Any
        keyword override wins over the derived value.
        """
        m = MAGICC7_CH4
        years = np.asarray(years, dtype=np.float64)
        conc = np.asarray(concentrations, dtype=np.float64)

        decls = cls._component_parameters
        tau_soil = overrides.get("tau_soil", decls["tau_soil"].default)
        tau_strat = overrides.get("tau_strat", decls["tau_strat"].default)
        tau_cl = overrides.get("tau_trop_cl", decls["tau_trop_cl"].default)
        tau_other = 1.0 / (1.0 / tau_soil + 1.0 / tau_strat + 1.0 / tau_cl)
        tau_oh = 1.0 / (1.0 / m["tau_tot_init"] - 1.0 / tau_other)

        feedback_year = overrides.pop("feedback_year", m["feedback_year"])
        fidx = int(np.searchsorted(years, feedback_year))
        fidx = min(max(fidx, 0), len(years) - 1)

        e_nat = natural_emissions_budget(
            conc,
            anthro_emissions,
            tau_oh,
            tau_other,
            m["ppb_to_tg"],
            n_years=budget_years,
            start_index=budget_start_index,
        )
        kwargs = dict(
            scheme="magicc7",
            tau_oh=tau_oh,
            ch4_self_feedback=m["ch4_self_feedback"],
            oh_sensitivity_scale=m["oh_sensitivity_scale"],
            oh_nox_sensitivity=m["oh_nox_sensitivity"],
            oh_co_sensitivity=m["oh_co_sensitivity"],
            oh_nmvoc_sensitivity=m["oh_nmvoc_sensitivity"],
            temp_sensitivity=m["temp_sensitivity"],
            ppb_to_tg=m["ppb_to_tg"],
            wetland_slope=m["wetland_slope"],
            ch4_pi=float(conc[fidx]),
            natural_emissions=e_nat,
            nox_reference=float(np.asarray(nox_emissions)[fidx]),
            co_reference=float(np.asarray(co_emissions)[fidx]),
            nmvoc_reference=float(np.asarray(nmvoc_emissions)[fidx]),
            temp_reference=(
                float(np.asarray(temperatures)[fidx])
                if temperatures is not None
                else 0.0
            ),
            prescribed_concentrations=conc,
            prescribed_until=overrides.pop("switch_year", m["switch_year"]),
        )
        kwargs.update(overrides)
        return cls(**kwargs)


CH4ChemistryBuilder = make_builder(CH4Chemistry)
