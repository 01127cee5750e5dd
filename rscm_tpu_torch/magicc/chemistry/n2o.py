"""
N2O concentration chemistry with concentration-dependent stratospheric
lifetime and a lagged-burden sink.

Mirror of ``crates/rscm-magicc/src/chemistry/n2o.rs:78-219`` +
``src/parameters/n2o_chemistry.rs``.

Beyond the reference, ``scheme="magicc7"`` implements the NITROUS
subroutine layout from
the reference's ``docs/modules/module_02_n2o_chemistry.md`` (base burden
= current concentration, iteration 1 from the start-of-step burden),
plus budget-closure natural emissions
(:func:`n2o_natural_emissions_budget`, mirror of the module's init
phase) and concentration prescription until the MAGICC7 switch year
(``N2O_SWITCHFROMCONC2EMIS_YEAR`` = 2015).  On the MAGICC7 SSP245
golden pathway the :meth:`N2OChemistry.magicc7` configuration tracks
concentrations to ~0.4% max vs ~7% for the reference-parity defaults.
"""

from __future__ import annotations

import numpy as np

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter, State

__all__ = [
    "N2OChemistry",
    "N2OChemistryBuilder",
    "n2o_natural_emissions_budget",
]

PRATHER_ITERATIONS = 4

#: MAGICC7 module-02 defaults (doc §4): feedback reference year, budget
#: window end (N2O_LASTBUDGETYEAR), conc->emis switch year.
MAGICC7_N2O = {
    "feedback_year": 1925.0,
    "last_budget_year": 1991.0,
    "budget_years": 10,
    "switch_year": 2015.0,
}


def n2o_natural_emissions_budget(
    concentrations,
    anthro_emissions,
    tau_n2o,
    ppb_to_tg,
    strat_delay: int = 1,
    n_years: int = 10,
    start_index: int = 0,
):
    """Infer natural N2O emissions by budget closure over a window.

    Mirror of MAGICC7's init phase (module_02 doc §7.1):
    ``E_nat = ppb2tg * (sum dC + sum Cbar_lagged/tau)/N - mean(anthro)``
    with the lagged mean burden ``(C[i-d] + C[i-d-1])/2`` matching the
    NITROUS sink term.  (The module doc's pseudocode halves the anthro
    term; closing with the full anthropogenic mean reproduces the MAGICC7
    SSP245 pathway to ~0.4% here, vs ~11% with the halved term —
    measured in ``tests/regression/test_emissions_driven.py``.)
    """
    c = np.asarray(concentrations, dtype=np.float64)
    e = np.asarray(anthro_emissions, dtype=np.float64)
    i0, i1 = start_index, start_index + n_years
    dcdt = c[i0 + 1 : i1 + 1] - c[i0:i1]
    d = max(int(strat_delay), 1)
    cbar_lagged = np.array(
        [(c[max(0, i - d)] + c[max(0, i - d - 1)]) / 2.0 for i in range(i0, i1)]
    )
    return float(
        ppb_to_tg * (dcdt.sum() + cbar_lagged.sum() / tau_n2o) / n_years
        - e[i0:i1].mean()
    )


class N2OChemistry(Component):
    """N2O concentration with lifetime feedback."""

    tags = ("chemistry", "n2o", "magicc")
    category = "Atmospheric Chemistry"

    n2o_emissions = Input("Emissions|N2O", unit="Mt N/yr")
    n2o_concentration = State("Atmospheric Concentration|N2O", unit="ppb")
    n2o_lifetime = Output("Lifetime|N2O", unit="yr")

    n2o_pi = Parameter(default=270.0, unit="ppb")
    natural_emissions = Parameter(default=11.0, unit="Mt N/yr")
    tau_n2o = Parameter(default=139.275, unit="yr")
    lifetime_feedback = Parameter(default=-0.04)
    strat_delay = Parameter(default=1, static=True)
    ppb_to_tg = Parameter(default=4.79, unit="Tg/ppb")
    #: MAGICC7 extensions (defaults preserve exact reference-parity output)
    scheme = Parameter(
        default="reference", static=True,
        description="'reference' = rscm n2o.rs iteration layout; "
        "'magicc7' = NITROUS subroutine layout (module_02 doc §7.3)",
    )
    prescribed_concentrations = Parameter(
        default=None, static=True,
        description="Optional (n_steps,) concentration series on the model "
        "time axis; written verbatim while t_next <= prescribed_until",
    )
    prescribed_until = Parameter(
        default=None, static=True,
        description="Last year (inclusive) prescribed from "
        "prescribed_concentrations (N2O_SWITCHFROMCONC2EMIS_YEAR)",
    )

    def input_lookback(self, var_name: str) -> int:
        # the lagged-burden sink reads at_offset(-(strat_delay + 1))
        if var_name == "Atmospheric Concentration|N2O":
            return max(int(self.strat_delay), 1) + 1
        return super().input_lookback(var_name)

    def calculate_effective_lifetime(self, burden_mid, burden_reference):
        ratio = xm.maximum(burden_mid / burden_reference, 1.0)
        return self.tau_n2o * ratio**self.lifetime_feedback

    def _solve_concentration_magicc7(self, n2o_current, n2o_lagged, emissions, dt):
        """NITROUS subroutine layout (module_02 doc §7.3): base burden is
        the current concentration; iteration 1 uses the start-of-step
        burden, later iterations the (start, iterate) mean."""
        total_emissions = emissions + self.natural_emissions
        burden = n2o_current * self.ppb_to_tg
        burden_lagged = n2o_lagged * self.ppb_to_tg
        burden_reference = self.n2o_pi * self.ppb_to_tg

        burden_k = burden
        tau_eff = self.tau_n2o
        for iteration in range(PRATHER_ITERATIONS):
            burden_mid = (
                burden if iteration == 0 else (burden + burden_k) / 2.0
            )
            tau_eff = self.calculate_effective_lifetime(burden_mid, burden_reference)
            delta_burden = (total_emissions - burden_lagged / tau_eff) * dt
            burden_k = burden + delta_burden

        return burden_k / self.ppb_to_tg, tau_eff

    def solve_concentration(self, n2o_prev, n2o_current, n2o_lagged, emissions, dt):
        if self.scheme == "magicc7":
            return self._solve_concentration_magicc7(
                n2o_current, n2o_lagged, emissions, dt
            )
        total_emissions = emissions + self.natural_emissions
        burden_prev = n2o_prev * self.ppb_to_tg
        burden_lagged = n2o_lagged * self.ppb_to_tg
        burden_reference = self.n2o_pi * self.ppb_to_tg

        burden = n2o_current * self.ppb_to_tg
        tau_eff = self.tau_n2o
        for _ in range(PRATHER_ITERATIONS):
            burden_mid = (burden_prev + burden) / 2.0
            tau_eff = self.calculate_effective_lifetime(burden_mid, burden_reference)
            delta_burden = (total_emissions - burden_lagged / tau_eff) * dt
            burden = burden_prev + delta_burden

        return burden / self.ppb_to_tg, tau_eff

    def solve_ctx(self, ctx, inputs, internal_state):
        dt = ctx.t_next - ctx.t_current

        n2o_current = inputs.n2o_concentration.at_start()
        n2o_prev = inputs.n2o_concentration.previous()
        if n2o_prev is None:
            n2o_prev = n2o_current

        delay = max(int(self.strat_delay), 1)
        t_delay = inputs.n2o_concentration.at_offset(-delay)
        if t_delay is None:
            t_delay = n2o_prev
        t_delay_minus1 = inputs.n2o_concentration.at_offset(-(delay + 1))
        if t_delay_minus1 is None:
            t_delay_minus1 = t_delay
        n2o_lagged = (t_delay + t_delay_minus1) / 2.0

        new_concentration, lifetime = self.solve_concentration(
            n2o_prev, n2o_current, n2o_lagged, inputs.n2o_emissions.get(), dt
        )
        new_concentration = self._apply_prescribed(ctx, new_concentration)
        return (
            self.Outputs(n2o_concentration=new_concentration, n2o_lifetime=lifetime),
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
        budget_years: int = None,
        budget_start_index: int = None,
        **overrides,
    ):
        """Full MAGICC7 module-02 configuration from a prescribed pathway.

        Derives budget-closure natural emissions over the decade ending at
        ``N2O_LASTBUDGETYEAR`` (1991), sets the feedback reference burden
        at the feedback start year (1925), and prescribes concentrations
        until the switch year (2015).  Keyword overrides win.
        """
        m = MAGICC7_N2O
        years = np.asarray(years, dtype=np.float64)
        conc = np.asarray(concentrations, dtype=np.float64)
        decls = cls._component_parameters

        tau = overrides.get("tau_n2o", decls["tau_n2o"].default)
        ppb_to_tg = overrides.get("ppb_to_tg", decls["ppb_to_tg"].default)
        delay = overrides.get("strat_delay", decls["strat_delay"].default)

        if budget_years is None:
            budget_years = m["budget_years"]
        if budget_start_index is None:
            last = overrides.pop("last_budget_year", m["last_budget_year"])
            budget_start_index = int(np.searchsorted(years, last)) - budget_years
            budget_start_index = min(
                max(budget_start_index, 0), len(years) - 1 - budget_years
            )
        e_nat = n2o_natural_emissions_budget(
            conc,
            anthro_emissions,
            tau,
            ppb_to_tg,
            strat_delay=delay,
            n_years=budget_years,
            start_index=budget_start_index,
        )

        feedback_year = overrides.pop("feedback_year", m["feedback_year"])
        fidx = int(np.searchsorted(years, feedback_year))
        fidx = min(max(fidx, 0), len(years) - 1)

        kwargs = dict(
            scheme="magicc7",
            natural_emissions=e_nat,
            n2o_pi=float(conc[fidx]),
            prescribed_concentrations=conc,
            prescribed_until=overrides.pop("switch_year", m["switch_year"]),
        )
        kwargs.update(overrides)
        return cls(**kwargs)


N2OChemistryBuilder = make_builder(N2OChemistry)
