"""
Permafrost carbon feedback: zonal-band thaw releasing CO2 and CH4.

Port of ``rscm_tpu/magicc/carbon/permafrost.py``.

**Beyond the reference.** The reference documents MAGICC7's permafrost
module in full (its ``docs/modules/module_12_permafrost.md``, mapping
``permafrost.f90:1-931``) but never implements it (the module is marked
EXPERIMENTAL upstream).  This component implements that documented
equation set with the zonal-band dimension (default 50 bands) and the
12-month seasonal cycle as dense array axes: one year of the Fortran's
600-iteration band x month loop is a handful of elementwise ops on one
flat month-major ``(..., 12 * n_bands)`` axis (see ``_monthly_climate``).

In the batched year loop a per-member value (the temperature, a swept
parameter) is a ``(B,)`` tensor and the band state ``(B, n_bands)``;
:func:`_col` turns such a value into a ``(B, 1)`` column before it meets
a band or month axis, while shared values (host floats, the static band
geometry) broadcast as they are.

Physics (module_12 doc sections in parentheses):

- Arctic amplification scales the global anomaly; each band thaws past a
  linearly spaced melting threshold (§2.2).
- Thaw/refreeze rate ``sign(T) |T|^a R_base`` per soil type (§2.3).
- Sinusoidal seasonal soil-temperature cycle — a quarter sine wave, the
  Fortran's ``PI = ACOS(0) = pi/2`` convention (§2.4, §9.11).
- Soil moisture as a bounded linear function of soil temperature with an
  exponential moisture modifier (§2.5).
- Q10-style decomposition response ``exp(a (1/T1 - 1/(T+T2)))`` (§2.6),
  four pathways: {mineral soil, peat} x {aerobic -> CO2, anaerobic -> CH4}
  (§2.7), annual-mean rates from the 12 monthly values.
- Carbon transfer frozen -> thawed at frozen-pool density on thaw, thawed
  -> frozen at thawed-pool density on refreeze, aerobic/anaerobic
  partition with optional moisture sensitivity (§2.8-2.9).
- Trapezoidal (semi-implicit) pool decay, the doc's central differencing
  (§8.1), with emissions bounded by the available pool so carbon is
  conserved exactly — a deliberate improvement over the Fortran's
  ``MAX(0,...)`` clipping, which the doc flags as a conservation leak
  (§9.9).  The conservation identity
  ``total pool + cumulative emissions == initial pool`` holds to
  round-off and is exported as a diagnostic.
- CH4 oxidation split: methanogenesis yields half CO2 / half CH4-carbon;
  the in-soil oxidised fraction of the CH4 half re-routes to CO2 (§2.10).

Emissions feed the CO2 budget and CH4 chemistry through the
``CO2BudgetWithPermafrost`` / ``CH4ChemistryWithPermafrost`` subclasses
below (the Fortran adds ``DAT_CO2PF_EMIS`` / ``DAT_CH4PF_EMIS`` into the
same budgets, ``MAGICC7.f90:4022-4024, 7513-7517``); zonal pools and
areas are internal component state (checkpointed like the ocean flux
history), scalar totals are timeseries outputs.
"""

from __future__ import annotations

import numpy as np

import torch

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter

from .budget import CO2Budget
from ..chemistry.ch4 import CH4Chemistry

__all__ = [
    "Permafrost",
    "PermafrostBuilder",
    "CO2BudgetWithPermafrost",
    "CH4ChemistryWithPermafrost",
]

#: 1 GtC emitted as CH4 = 16/12 * 1000 Mt CH4 (module_12 §2.10).
MT_CH4_PER_GTC = 16000.0 / 12.0

_SOILS = ("ms", "peat")


def _col(x):
    """A per-member value (a ``(B,)`` tensor) as a ``(B, 1)`` column, so it
    broadcasts against the band and month axes; host values and 0-d
    tensors are returned as they are."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.dim() >= 1 else x


class Permafrost(Component):
    """Zonal-band permafrost carbon release (module_12, beyond-reference)."""

    tags = ("carbon-cycle", "permafrost", "magicc", "beyond-reference")
    category = "Carbon Cycle"

    temperature = Input("Surface Temperature", unit="K")
    co2_emissions = Output("Emissions|CO2|Permafrost", unit="GtC/yr")
    ch4_emissions = Output("Emissions|CH4|Permafrost", unit="Mt CH4/yr")
    thawed_fraction = Output("Permafrost|Thawed Area Fraction", unit="1")
    total_pool_out = Output("Permafrost|Total Pool", unit="GtC")

    # -- structure (PF_NBANDS; shape-determining, so static) -----------------
    n_bands = Parameter(default=50, static=True)

    # -- temperature and thawing (module_12 §4.2) ----------------------------
    melting_temp_min = Parameter(default=1.0, unit="K")
    melting_temp_max = Parameter(default=12.5, unit="K")
    arctic_amplification = Parameter(default=1.7)
    seasonal_amplitude = Parameter(default=5.0, unit="K")
    thaw_rate_ms = Parameter(default=0.1, unit="1/K/yr")
    thaw_rate_peat = Parameter(default=0.05, unit="1/K/yr")
    thaw_exp_ms = Parameter(default=1.0)
    thaw_exp_peat = Parameter(default=1.0)

    # -- carbon pool and distribution (§4.3) ---------------------------------
    # Static: these shape the host-built initial frozen pools
    # (create_initial_state), so an ensemble sweep over them would leave
    # the initial state stale — declare them untraceable instead.
    total_pool = Parameter(default=800.0, unit="GtC", static=True)
    minsoil_southern_fraction = Parameter(default=0.8, static=True)
    minsoil_northern_fraction = Parameter(default=0.8, static=True)
    zonal_pool_distribution = Parameter(default=0.0, static=True)

    # -- decomposition (§4.4-4.5) --------------------------------------------
    turnover_ms_aerob = Parameter(default=20.0, unit="yr")
    decomp_peat_over_ms = Parameter(default=0.5)
    decomp_anaerob_over_aerob = Parameter(default=0.1)
    q10_alpha_ms_aerob = Parameter(default=308.56, unit="K")
    q10_alpha_ms_anaerob = Parameter(default=308.56, unit="K")
    q10_alpha_peat_aerob = Parameter(default=308.56, unit="K")
    q10_alpha_peat_anaerob = Parameter(default=308.56, unit="K")
    q10_temp1 = Parameter(default=56.02, unit="K")
    q10_temp2 = Parameter(default=46.02, unit="K")

    # -- soil moisture (§4.6) ------------------------------------------------
    soilwater_m = Parameter(default=0.02, unit="1/K")
    soilwater_offset = Parameter(default=0.2)
    soilwater_min = Parameter(default=0.2)

    # -- aerobic/anaerobic partition (§4.7) ----------------------------------
    anaerob_initial_ms = Parameter(default=0.05)
    anaerob_max_ms = Parameter(default=0.3)
    anaerob_moistsens_ms = Parameter(default=0.0)
    anaerob_initial_peat = Parameter(default=0.8)
    anaerob_max_peat = Parameter(default=0.9)
    anaerob_moistsens_peat = Parameter(default=0.0)

    # -- methane oxidation (§4.8) --------------------------------------------
    ch4_oxidation_ms = Parameter(default=0.25)
    ch4_oxidation_peat = Parameter(default=0.6)
    #: Fraction of escaped CH4 later oxidised to CO2 in the atmosphere.
    #: Accounting only — that CO2 arises downstream of CH4 chemistry, not
    #: here (the doc's STEP 12 emission split likewise omits it).
    co2_from_ch4_ox_atm = Parameter(default=1.0)

    # -- static band geometry (pure numpy; parameters are build-time) --------

    def _band_fractions(self) -> np.ndarray:
        """Zonal carbon distribution ``f_pool(i)`` (§2.11); sums to 1."""
        n = int(self.n_bands)
        d = float(self.zonal_pool_distribution)
        i = np.arange(1, n + 1, dtype=np.float64)
        f = ((1.0 + d) / n - d * i / n**2) / (1.0 + d / 2.0 - d / (2.0 * n))
        return f / f.sum()  # exact normalisation against round-off

    def _band_positions(self) -> np.ndarray:
        """Static south→north band coordinate in [0, 1]."""
        n = int(self.n_bands)
        return np.linspace(0.0, 1.0, n) if n > 1 else np.zeros(1)

    def _melting_temps(self, like=None):
        """Per-band melting thresholds (§2.2); dual-mode so the bounds
        stay ensemble-sweepable."""
        frac = xm.asarray(self._band_positions(), like=like)
        lo, hi = _col(self.melting_temp_min), _col(self.melting_temp_max)
        return lo + frac * (hi - lo)

    def _potential_pools(self) -> dict:
        """Per-band initial frozen pools, split mineral-soil vs peat."""
        n = int(self.n_bands)
        frac = np.linspace(0.0, 1.0, n) if n > 1 else np.zeros(1)
        ms_frac = float(self.minsoil_southern_fraction) + frac * (
            float(self.minsoil_northern_fraction)
            - float(self.minsoil_southern_fraction)
        )
        band_pool = float(self.total_pool) * self._band_fractions()
        return {"ms": ms_frac * band_pool, "peat": (1.0 - ms_frac) * band_pool}

    #: Static quarter-sine month shape (§2.4, Fortran ``PI/2`` phase
    #: convention §9.11): 0 at the summer-max month, -1 at the coldest.
    _MONTH_SHAPE = np.sin(
        (np.pi / 2.0) * np.arange(12, dtype=np.float64) / 11.0
    ) - 1.0

    def _seasonal_offsets(self, like=None):
        """Monthly offsets below the summer maximum; dual-mode so the
        amplitude stays ensemble-sweepable."""
        return 0.5 * _col(self.seasonal_amplitude) * xm.asarray(
            self._MONTH_SHAPE, like=like
        )

    # -- internal state -------------------------------------------------------

    def create_initial_state(self):
        n = int(self.n_bands)
        pot = self._potential_pools()
        state = {"cumulative_emissions": np.float64(0.0)}
        for s in _SOILS:
            state[f"{s}_frozen_area"] = np.ones(n)
            state[f"{s}_frozen_pool"] = pot[s].copy()
            for kind in ("aerob", "anaerob"):
                state[f"{s}_{kind}_area"] = np.zeros(n)
                state[f"{s}_{kind}_pool"] = np.zeros(n)
        return state

    # -- per-soil physics (vectorised over the band axis) ---------------------

    def _soil_params(self, soil: str) -> dict:
        if soil == "ms":
            return dict(
                thaw_rate=self.thaw_rate_ms,
                thaw_exp=self.thaw_exp_ms,
                rate_scale=1.0,
                q10_alpha_aerob=self.q10_alpha_ms_aerob,
                q10_alpha_anaerob=self.q10_alpha_ms_anaerob,
                anaerob_init=self.anaerob_initial_ms,
                anaerob_max=self.anaerob_max_ms,
                anaerob_sens=self.anaerob_moistsens_ms,
                ch4_ox=self.ch4_oxidation_ms,
            )
        return dict(
            thaw_rate=self.thaw_rate_peat,
            thaw_exp=self.thaw_exp_peat,
            rate_scale=self.decomp_peat_over_ms,
            q10_alpha_aerob=self.q10_alpha_peat_aerob,
            q10_alpha_anaerob=self.q10_alpha_peat_anaerob,
            anaerob_init=self.anaerob_initial_peat,
            anaerob_max=self.anaerob_max_peat,
            anaerob_sens=self.anaerob_moistsens_peat,
            ch4_ox=self.ch4_oxidation_peat,
        )

    def _monthly_climate(self, t_summer_max):
        """Moisture modifier and soil temperature per (month, band).

        Layout: ONE flat month-major axis of ``12 * n_bands`` (month m,
        band b at index ``m*n + b``) after the member axis, as in the TPU
        package, so the month mean is 12 contiguous band slices
        (:meth:`_month_mean`).
        """
        n = int(self.n_bands)
        t_soil = xm.tile(t_summer_max, 12) + xm.repeat(
            self._seasonal_offsets(like=t_summer_max), n
        )
        w = xm.clip(
            _col(self.soilwater_m) * t_soil + _col(self.soilwater_offset),
            _col(self.soilwater_min),
            1.0,
        )
        f_moist = (1.0 - xm.exp_fast(-w)) / (1.0 - np.exp(-1.0))
        return t_soil, f_moist

    def _month_mean(self, flat):
        """Annual mean over the flat month-major axis: 12 static band
        slices summed."""
        n = int(self.n_bands)
        out = flat[..., 0:n]
        for m in range(1, 12):
            out = out + flat[..., m * n : (m + 1) * n]
        return out / 12.0

    def _q10(self, t_soil, alpha):
        """LPJ-style decomposition response (§2.6), guarded so the
        denominator stays positive for any anomaly."""
        denom = xm.maximum(t_soil + _col(self.q10_temp2), 1.0)
        return xm.exp_fast(_col(alpha) * (1.0 / _col(self.q10_temp1) - 1.0 / denom))

    @staticmethod
    def _memo_key(alpha):
        """Dedup key for per-alpha (band, month) reductions: concrete
        parameter values share work (all four q10 alphas default to the
        same constant: one exp grid instead of four); swept (tensor)
        alphas stay distinct."""
        v = xm.static_value(alpha)
        return v if v is not None else id(alpha)

    def _q10_means(self, t_soil, f_moist, alpha, cache):
        """Annual means ``(mean(q10), mean(q10 * f_moist))`` for one
        alpha, memoised across soils/pathways within a step."""
        key = self._memo_key(alpha)
        if key not in cache:
            q10 = self._q10(t_soil, alpha)
            cache[key] = (
                self._month_mean(q10),
                self._month_mean(q10 * f_moist),
            )
        return cache[key]

    @staticmethod
    def _density(pool, area):
        """Carbon density with the zero-area guard of §8.3 (tolerance,
        not exact equality)."""
        return xm.where(area > 1e-12, pool / xm.maximum(area, 1e-12), 0.0)

    @staticmethod
    def _decay_pool(pool, rate, inflow, dt):
        """Trapezoidal decay + inflow (§8.1); returns (new_pool, emitted).

        Emission is exactly the pool decrement attributable to decay, so
        pool + emitted == old pool + inflow and nothing is clipped away.
        """
        half_k = 0.5 * rate * dt
        new_pool = ((1.0 - half_k) * pool + inflow) / (1.0 + half_k)
        new_pool = xm.maximum(new_pool, 0.0)
        emitted = xm.maximum(pool + inflow - new_pool, 0.0)
        return new_pool, emitted

    def _solve_soil(self, soil, state, t_summer_max, t_soil, f_moist, dt, q10_cache):
        """One annual update for one soil type over all bands.

        Returns (new_state_fields, co2_amount_gtc, ch4_carbon_amount_gtc)
        with emission *amounts* over the step, summed over bands.
        """
        p = self._soil_params(soil)
        frozen_area = state[f"{soil}_frozen_area"]
        frozen_pool = state[f"{soil}_frozen_pool"]
        aerob_area = state[f"{soil}_aerob_area"]
        anaerob_area = state[f"{soil}_anaerob_area"]
        aerob_pool = state[f"{soil}_aerob_pool"]
        anaerob_pool = state[f"{soil}_anaerob_pool"]

        # annual-mean anaerobic fraction (§2.8); with the default moisture
        # sensitivity of 0 (when concrete) it is the constant initial
        # fraction — no (band, month) grid to reduce
        init, amax = _col(p["anaerob_init"]), _col(p["anaerob_max"])
        if xm.static_value(p["anaerob_sens"]) == 0.0:
            f_anaerob = xm.clip(init, 0.0, amax)
        else:
            f_anaerob_monthly = xm.clip(
                init + (amax - init) * f_moist * _col(p["anaerob_sens"]),
                0.0,
                amax,
            )
            f_anaerob = self._month_mean(f_anaerob_monthly)
        f_aerob = 1.0 - f_anaerob

        # thaw / refreeze (§2.3, §7.2 STEP 7): signed area transfer,
        # bounded by what each side holds
        # the default exponent 1.0 (when concrete, i.e. not being swept) is
        # exact |T|, with no power
        thaw_exp = p["thaw_exp"]
        if xm.static_value(thaw_exp) == 1.0:
            thaw_mag = xm.abs(t_summer_max)
        else:
            thaw_mag = xm.power(xm.abs(t_summer_max), _col(thaw_exp))
        rate = xm.sign(t_summer_max) * thaw_mag * _col(p["thaw_rate"])
        d_area = rate * frozen_area * dt
        thawed_area = aerob_area + anaerob_area
        d_area = xm.clip(d_area, -thawed_area, frozen_area)

        thawing = d_area > 0.0
        # thaw: carbon leaves the frozen pool at frozen density, split by
        # the aerobic fraction; refreeze: area returns proportionally from
        # both thawed pools, carbon at each pool's own density
        frozen_density = self._density(frozen_pool, frozen_area)
        thaw_c = xm.where(thawing, frozen_density * d_area, 0.0)
        d_aerob_area_thaw = xm.where(thawing, f_aerob * d_area, 0.0)
        d_anaerob_area_thaw = xm.where(thawing, (1.0 - f_aerob) * d_area, 0.0)

        refreeze_area = xm.where(thawing, 0.0, -d_area)
        share_aerob = xm.where(
            thawed_area > 1e-12, aerob_area / xm.maximum(thawed_area, 1e-12), 0.0
        )
        rf_aerob_area = refreeze_area * share_aerob
        rf_anaerob_area = refreeze_area * (1.0 - share_aerob)
        rf_aerob_c = self._density(aerob_pool, aerob_area) * rf_aerob_area
        rf_anaerob_c = self._density(anaerob_pool, anaerob_area) * rf_anaerob_area

        frozen_area = frozen_area - d_area
        frozen_pool = frozen_pool - thaw_c + rf_aerob_c + rf_anaerob_c
        aerob_area = aerob_area + d_aerob_area_thaw - rf_aerob_area
        anaerob_area = anaerob_area + d_anaerob_area_thaw - rf_anaerob_area
        # thaw_c is zero while refreezing and rf_*_c zero while thawing,
        # so the two regimes compose additively
        aerob_inflow = f_aerob * thaw_c - rf_aerob_c
        anaerob_inflow = (1.0 - f_aerob) * thaw_c - rf_anaerob_c

        # re-partition existing thawed area when the aerobic fraction
        # moved (§7.2 STEP 6) — identically zero with the default
        # moisture sensitivity of 0
        thawed_area = aerob_area + anaerob_area
        shift = f_aerob * thawed_area - aerob_area
        to_aerob = shift > 0.0
        shift_c = xm.where(
            to_aerob,
            self._density(anaerob_pool + anaerob_inflow, anaerob_area) * shift,
            self._density(aerob_pool + aerob_inflow, aerob_area) * shift,
        )
        aerob_area = aerob_area + shift
        anaerob_area = anaerob_area - shift
        aerob_inflow = aerob_inflow + shift_c
        anaerob_inflow = anaerob_inflow - shift_c

        # decomposition (§2.7): annual means of the monthly rates.  The
        # per-soil scalars factor out of the month mean (the mean is
        # linear), so the (band, month) q10 grids are shared across
        # soils/pathways via the memo — one exp grid per distinct alpha
        # instead of four
        base = _col(p["rate_scale"] / self.turnover_ms_aerob)
        mean_q10_aerob = self._q10_means(
            t_soil, f_moist, p["q10_alpha_aerob"], q10_cache
        )[1]
        mean_q10_anaerob = self._q10_means(
            t_soil, f_moist, p["q10_alpha_anaerob"], q10_cache
        )[0]
        d_aerob = base * mean_q10_aerob
        d_anaerob = base * _col(self.decomp_anaerob_over_aerob) * mean_q10_anaerob

        aerob_pool, e_aerob = self._decay_pool(aerob_pool, d_aerob, aerob_inflow, dt)
        anaerob_pool, e_anaerob = self._decay_pool(
            anaerob_pool, d_anaerob, anaerob_inflow, dt
        )

        e_aerob_tot = xm.sum(e_aerob, axis=-1)
        e_anaerob_tot = xm.sum(e_anaerob, axis=-1)

        # emission split (§2.10 / STEP 12): aerobic -> CO2; anaerobic ->
        # half CO2 + half CH4-carbon, of which the in-soil oxidised
        # fraction also becomes CO2
        co2_c = e_aerob_tot + e_anaerob_tot * (1.0 + p["ch4_ox"]) / 2.0
        ch4_c = e_anaerob_tot * (1.0 - p["ch4_ox"]) / 2.0

        new_fields = {
            f"{soil}_frozen_area": frozen_area,
            f"{soil}_frozen_pool": frozen_pool,
            f"{soil}_aerob_area": aerob_area,
            f"{soil}_anaerob_area": anaerob_area,
            f"{soil}_aerob_pool": aerob_pool,
            f"{soil}_anaerob_pool": anaerob_pool,
        }
        return new_fields, co2_c, ch4_c

    # -- component step -------------------------------------------------------

    def solve_permafrost(self, state, temperature, dt):
        if isinstance(temperature, torch.Tensor):
            # host-layout (numpy) state meeting tensor inputs, as in the
            # step-by-step executor: one mode for the whole step
            state = {k: xm.asarray(v, like=temperature) for k, v in state.items()}
        t_arctic = _col(self.arctic_amplification * temperature)
        melt = self._melting_temps(like=temperature)
        t_summer_max = t_arctic - melt  # (..., n_bands)
        t_soil, f_moist = self._monthly_climate(t_summer_max)

        new_state = {}
        co2_c = 0.0  # GtC emitted over this step
        ch4_c = 0.0  # GtC (as carbon) emitted as CH4 over this step
        q10_cache = {}
        for soil in _SOILS:
            fields, soil_co2, soil_ch4 = self._solve_soil(
                soil, state, t_summer_max, t_soil, f_moist, dt, q10_cache
            )
            new_state.update(fields)
            co2_c = co2_c + soil_co2
            ch4_c = ch4_c + soil_ch4

        new_state["cumulative_emissions"] = (
            state["cumulative_emissions"] + co2_c + ch4_c
        )

        total = 0.0
        frozen_weighted = 0.0
        pot = self._potential_pools()
        for soil in _SOILS:
            total = (
                total
                + xm.sum(new_state[f"{soil}_frozen_pool"], axis=-1)
                + xm.sum(new_state[f"{soil}_aerob_pool"], axis=-1)
                + xm.sum(new_state[f"{soil}_anaerob_pool"], axis=-1)
            )
            frozen_weighted = frozen_weighted + xm.sum(
                new_state[f"{soil}_frozen_area"]
                * xm.asarray(pot[soil], like=new_state[f"{soil}_frozen_area"]),
                axis=-1,
            )
        # carbon-weighted thawed fraction (§7.2 STEP 14)
        thawed_fraction = 1.0 - frozen_weighted / float(self.total_pool)

        outputs = {  # emission outputs are rates (per year)
            "co2": co2_c / dt,
            "ch4_mt": ch4_c * MT_CH4_PER_GTC / dt,
            "thawed_fraction": thawed_fraction,
            "total_pool": total,
        }
        return new_state, outputs

    def solve_ctx(self, ctx, inputs, internal_state):
        dt = ctx.t_next - ctx.t_current
        new_state, out = self.solve_permafrost(
            internal_state, inputs.temperature.get(), dt
        )
        return (
            self.Outputs(
                co2_emissions=out["co2"],
                ch4_emissions=out["ch4_mt"],
                thawed_fraction=out["thawed_fraction"],
                total_pool_out=out["total_pool"],
            ),
            new_state,
        )


class CO2BudgetWithPermafrost(CO2Budget):
    """CO2 budget closure including permafrost release (MAGICC7 adds
    ``DAT_CO2PF_EMIS`` into the same budget, ``MAGICC7.f90:7513-7517``)."""

    permafrost_emissions = Input("Emissions|CO2|Permafrost", unit="GtC/yr")

    def solve_ctx(self, ctx, inputs, internal_state):
        dt = ctx.t_next - ctx.t_current
        co2_next, net_emissions, airborne_fraction = self.solve_budget(
            inputs.fossil_emissions.get() + inputs.permafrost_emissions.get(),
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


class CH4ChemistryWithPermafrost(CH4Chemistry):
    """CH4 chemistry fed by anthropogenic plus permafrost emissions
    (MAGICC7 adds ``DAT_CH4PF_EMIS``, ``MAGICC7.f90:4022-4024``)."""

    permafrost_emissions = Input("Emissions|CH4|Permafrost", unit="Mt CH4/yr")

    def solve_ctx(self, ctx, inputs, internal_state):
        ch4_current = inputs.ch4_concentration.at_start()
        ch4_prev = inputs.ch4_concentration.previous()
        if ch4_prev is None:
            ch4_prev = ch4_current

        new_concentration, lifetime = self.solve_concentration(
            ch4_prev,
            ch4_current,
            inputs.ch4_emissions.get() + inputs.permafrost_emissions.get(),
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


PermafrostBuilder = make_builder(Permafrost)
