"""
Sea level rise: thermal expansion, glaciers, ice sheets, land water.

Port of ``rscm_tpu/magicc/slr.py``.

**Beyond the reference.** The reference documents MAGICC7's sea-level
module in full (its ``docs/modules/module_14_sea_level_rise.md``, mapping
the ``sealevel_*`` routines of ``MAGICC7.f90``) but never implements it
(upstream marks it EXPERIMENTAL).  This component implements the
documented equation set:

- **Thermal expansion** (§3.1) — the Fortran integrates an empirical
  expansion-coefficient polynomial over its ocean layers.  Those layer
  temperatures are climate-module internals that a cleanly separated
  component should not reach into, so this implementation uses the
  thermodynamically equivalent proportionality to ocean heat content:
  for an effective expansion coefficient ``alpha_eff``,
  ``dh = alpha_eff / (rho c_p) * OHC`` — the same quantity the layer sum
  computes with a temperature/pressure-dependent alpha.  ``alpha_eff``
  (default 1.55e-4 1/K, upper-ocean mean) and the CMIP5 scaling
  (``expansion_scaling``, the Fortran's SLR_EXPANSION_SCALING) are
  calibration parameters.  Documented deviation (docs/magicc_modules.md).
- **Glaciers and ice caps** (§3.2) — Wigley & Raper (2005) rate equation
  against a Marzeion-style equilibrium table.  The Fortran's 104-point
  table ships in a CFG the reference does not carry; the default here is
  a saturating-exponential fit through the documented anchor values
  (81.2 mm at 0 K, 96.6 mm at 0.1 K, 410.2 mm at 10.3 K), overridable
  via ``gl_equi_temp`` / ``gl_equi_slr``.
- **Greenland SMB** (§3.3) — DEFAULT and FETTWEIS parameterisations.
- **Greenland SID** (§3.4) — Nick et al. (2013) LOW/HIGH reservoir
  depletion with case interpolation and the AR5 upscaling factor.
- **Antarctic SMB** (§3.5) — snowfall increase (typically negative SLR).
- **Antarctic SID** (§3.6) — both methods: DECONTO (threshold fast rate
  for ice-cliff instability) and LEVERMANN (default; per-region impulse
  response convolution over the temperature history, carried in the
  internal state; each year writes one history slot and takes one product
  of the history against the four regions' kernel rows).
- **Land water storage** (§3.7) — prescribed series with post-switch
  depletion; off by default, as in the Fortran.
- **Semi-empirical** (§3.8) — Rahmstorf rate integration with in-run
  base-period accumulation.

Everything is a recurrence in the carried state over ``(B,)`` members
(the Levermann history ``(B, max_history_steps)``).  In the year loop the
step's time and index are host numbers, so the history slot is chosen on
the host.  Opt-in: ``build_magicc_model(include_slr=True)``.
"""

from __future__ import annotations

import numpy as np

import torch

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import Component, Input, Output, Parameter

__all__ = ["SeaLevelRise", "SeaLevelRiseBuilder"]

#: Volumetric heat capacity of seawater (J/m^3/K) — matches the UDEB
#: constants so expansion and OHC use one ocean.
RHO_CP_SEAWATER = 1026.0 * 3990.0

_AIS_REGIONS = ("amundsen", "eastantarctica", "ross", "weddell")

#: Levermann regional IRF polynomial coefficients (x^4 .. x^0), time
#: delays (years) and temperature scalings (module_14 §5.8).
_AIS_IRF = {
    "amundsen": ([3.8e-15, -1.2e-11, 5.3e-9, -1.1e-7, 2.7e-5], 0, 0.17),
    "eastantarctica": ([-4.8e-15, 4.7e-12, -1.3e-9, 1.6e-7, 1.1e-5], 30, 0.35),
    "ross": ([-6.1e-14, 5.2e-11, -1.4e-8, 1.8e-6, -2.2e-5], 20, 0.26),
    "weddell": ([1.5e-14, -1.5e-11, 5.2e-9, -5.1e-7, 3.5e-5], 35, 0.14),
}


#: Saturating-exponential fit ``S(T) = a - b exp(-c T)`` through the
#: documented anchor values (81.2 mm at 0 K, 96.6 mm at 0.1 K, 410.2 mm
#: at 10.3 K) — the generator of the default equilibrium table AND the
#: closed form the solver evaluates directly when no custom table is
#: supplied (see :meth:`SeaLevelRise._solve_glaciers`).
_GL_FIT_C = 0.473
_GL_FIT_B = 15.4 / (1.0 - np.exp(-0.1 * _GL_FIT_C))
_GL_FIT_A = _GL_FIT_B + 81.2
_GL_FIT_TMAX = 10.3


def _default_glacier_table():
    """104-point equilibrium table (0..10.3 K in 0.1 steps) from the
    saturating-exponential fit."""
    temps = np.arange(104, dtype=np.float64) * 0.1
    return temps, _GL_FIT_A - _GL_FIT_B * np.exp(-_GL_FIT_C * temps)


class SeaLevelRise(Component):
    """Global mean sea level rise from all MAGICC7 contributors."""

    tags = ("sea-level", "magicc", "beyond-reference")
    category = "Sea Level"

    temperature = Input("Surface Temperature", unit="K")
    ocean_heat_content = Input("Ocean Heat Content", unit="J/m^2")

    total = Output("Sea Level Rise", unit="mm")
    expansion = Output("Sea Level Rise|Thermal Expansion", unit="mm")
    glaciers = Output("Sea Level Rise|Glaciers", unit="mm")
    gis_smb = Output("Sea Level Rise|Greenland|SMB", unit="mm")
    gis_sid = Output("Sea Level Rise|Greenland|SID", unit="mm")
    ais_smb = Output("Sea Level Rise|Antarctica|SMB", unit="mm")
    ais_sid = Output("Sea Level Rise|Antarctica|SID", unit="mm")
    landwater = Output("Sea Level Rise|Land Water", unit="mm")
    semiempirical = Output("Sea Level Rise|Semi-Empirical", unit="mm")

    # -- thermal expansion (§5.1; OHC-proportional form, see module doc) -----
    expansion_alpha_eff = Parameter(default=1.55e-4, unit="1/K")
    expansion_scaling = Parameter(default=0.8824)
    expansion_startyear = Parameter(default=1850.0, static=True)

    # -- glaciers (§5.2) ------------------------------------------------------
    gl_sens_mm_per_yr_k = Parameter(default=0.625, unit="mm/yr/K")
    gl_temp_exponent = Parameter(default=0.82)
    gl_norm_vol = Parameter(default=1.0)
    gl_norm_temp = Parameter(default=1.0)
    gl_startyear = Parameter(default=1850.0, static=True)
    #: Equilibrium lookup tables (static arrays; default = documented fit)
    gl_equi_temp = Parameter(default=None, static=True)
    gl_equi_slr = Parameter(default=None, static=True)

    # -- Greenland SMB (§5.3) -------------------------------------------------
    gis_smb_parameterisation = Parameter(default="default", static=True)
    gis_smb_coef1 = Parameter(default=0.015, unit="mm/yr")
    gis_smb_coef2 = Parameter(default=0.9)
    gis_smb_sens_exponent = Parameter(default=2.3)
    gis_smb_initial_volume_mm = Parameter(default=7360.0, unit="mm")
    gis_smb_volume_exponent = Parameter(default=0.5)
    gis_smb_coef_fw1 = Parameter(default=-10.0)
    gis_smb_coef_fw2 = Parameter(default=2.0)
    gis_smb_coef_fw3 = Parameter(default=1.0)
    gis_smb_startyear = Parameter(default=1965.0, static=True)

    # -- Greenland SID (§5.4) -------------------------------------------------
    gis_sid_case = Parameter(default=0.5)
    gis_sid_scaling = Parameter(default=5.0)
    gis_sid_totalvol_low = Parameter(default=35.98, unit="mm")
    gis_sid_totalvol_high = Parameter(default=53.63, unit="mm")
    gis_sid_dschrg_sens_low = Parameter(default=0.000906, unit="1/yr")
    gis_sid_dschrg_sens_high = Parameter(default=0.000793, unit="1/yr")
    gis_sid_tempsens_low = Parameter(default=0.389, unit="1/K")
    gis_sid_tempsens_high = Parameter(default=0.472, unit="1/K")
    gis_sid_startyear = Parameter(default=2000.0, static=True)

    # -- Antarctic SMB (§5.5) -------------------------------------------------
    ais_smb_coef1 = Parameter(default=0.128, unit="mm/yr")
    ais_smb_coef2 = Parameter(default=-0.424)
    ais_smb_sens_exponent = Parameter(default=0.782)
    ais_smb_startyear = Parameter(default=1980.0, static=True)

    # -- Antarctic SID (§5.6-5.8) ---------------------------------------------
    ais_sid_parameterisation = Parameter(default="levermann", static=True)
    ais_sid_scaling = Parameter(default=1.0)
    ais_sid_startyear = Parameter(default=1850.0, static=True)
    ais_discharge_startyear = Parameter(default=1950.0, static=True)
    # DeConto
    ais_sid_totalvol = Parameter(default=17560.0, unit="mm")
    ais_sid_dschrg_sens = Parameter(default=5.28e-5, unit="1/yr")
    ais_sid_tempsens_exponent = Parameter(default=2.0)
    ais_sid_thresholdtemp = Parameter(default=1.023, unit="K")
    ais_sid_zerotemp = Parameter(default=0.0, unit="K")
    ais_sid_fastrate = Parameter(default=13.83, unit="mm/yr")
    # Levermann
    ais_sid_basalmelt = Parameter(default=11.5, unit="m/yr/K")
    ais_sid_irf_yrspan = Parameter(default=500, static=True)
    #: Length of the carried temperature history (steps after the SID
    #: start year); size it to the run length like the ocean flux window.
    max_history_steps = Parameter(default=600, static=True)

    # -- land water (§5.9; off by default, as in the Fortran) -----------------
    landwater_enabled = Parameter(default=False, static=True)
    #: Prescribed mm/yr series aligned to the model time axis.
    landwater_mm_per_year = Parameter(default=None, static=True)
    landwater_startyear = Parameter(default=1900.0, static=True)
    landwater_switchyear = Parameter(default=2100.0, static=True)
    landwater_maxvolume_mm = Parameter(default=1000.0, unit="mm")
    landwater_volume_exponent = Parameter(default=0.5)

    # -- semi-empirical (§5.10) -----------------------------------------------
    semiempi_zeroratetemp = Parameter(default=-0.5, unit="K")
    semiempi_rate_sens = Parameter(default=0.3353, unit="mm/yr/K")
    semiempi_base_start = Parameter(default=1980.0, static=True)
    semiempi_base_end = Parameter(default=1999.0, static=True)
    semiempi_switchyear = Parameter(default=2000.0, static=True)

    # -- static tables --------------------------------------------------------

    def _glacier_table(self):
        if getattr(self, "_gl_table_cache", None) is None:
            if self.gl_equi_temp is not None and self.gl_equi_slr is not None:
                t = np.asarray(self.gl_equi_temp, dtype=np.float64)
                s = np.asarray(self.gl_equi_slr, dtype=np.float64)
            else:
                t, s = _default_glacier_table()
            if len(t) != len(s) or len(t) < 2:
                raise ValueError(
                    "gl_equi_temp / gl_equi_slr must be equal-length tables "
                    f"with >= 2 points, got {len(t)} / {len(s)}"
                )
            self._gl_table_cache = (t, s)
        return self._gl_table_cache

    def axis_dt(self) -> float:
        """Time-axis step in years; 1.0 (annual) until a builder sets it."""
        return float(getattr(self, "_axis_dt", 1.0))

    def validate_time_axis(self, time_axis):
        """Builder hook: the IRF history is indexed by step, so the axis
        must be uniform; its step size is baked into the static kernels
        (ages evaluated at ``step * dt`` years)."""
        values = np.asarray(time_axis.values(), dtype=np.float64)
        if len(values) < 2:
            return
        diffs = np.diff(values)
        dt = float(diffs[0])
        if np.max(np.abs(diffs - dt)) > 1e-9 * max(abs(dt), 1.0):
            raise ValueError(
                "SeaLevelRise requires a uniform time axis: the AIS "
                "discharge IRF history is indexed by time step, so "
                "variable step sizes would corrupt the convolution "
                f"(got steps from {diffs.min():g} to {diffs.max():g} yr)"
            )
        if dt != self.axis_dt():
            self._axis_dt = dt
            self._lev_cache = None  # kernels depend on the step size

    def _levermann_kernels(self):
        """Static per-region convolution machinery (§3.6, §8.1-8.2).

        ``R[i] = max(0, poly(i * dt))`` for ages within the IRF span,
        where ``dt`` is the (uniform) axis step in years — annual axes
        reproduce the spec exactly; finer/coarser axes evaluate the same
        polynomial response at the true age.  The per-step middle sum
        ``sum_{i} F(t-i) R(i)`` becomes one dot of the carried history
        (slot j holds the anomaly written at relative step j) against row
        ``idx`` of the static matrix ``W[idx, j] = R(idx - j) for
        2 <= j <= idx-1`` — the spec's exact index window (the two-slot
        exclusion is 2*dt years off-spec on non-annual axes).
        ``F(start) = 0`` kills the far corner term.
        """
        if getattr(self, "_lev_cache", None) is None:
            n = int(self.max_history_steps)
            span = float(self.ais_sid_irf_yrspan)
            dt = self.axis_dt()
            ages = np.arange(n, dtype=np.float64) * dt
            kernels = {}
            for name, (coefs, delay, scaling) in _AIS_IRF.items():
                r = np.maximum(0.0, np.polyval(coefs, ages))
                r[ages >= span] = 0.0
                # the spec's annual sum is a Riemann sum of the IRF
                # integral with dt = 1 yr; finer/coarser steps weight
                # each term by their dt so the discharge converges to
                # the same integral (exactly the spec value at dt = 1)
                r = r * dt
                w = np.zeros((n, n))
                for idx in range(n):
                    j = np.arange(2, max(idx, 2))  # 2 .. idx-1
                    j = j[j < n]
                    w[idx, j] = r[idx - j]
                kernels[name] = (r, w, delay, scaling)
            self._lev_cache = kernels
            self._lev_device = {}
        return self._lev_cache

    def _levermann_rows(self, like):
        """The four regions' ``W`` matrices as one ``(n, n, 4)`` tensor on
        ``like``'s device and dtype, copied there once (not once a year):
        row ``[idx, :, r]`` is region r's kernel row for history slot
        ``idx``."""
        kernels = self._levermann_kernels()
        key = (like.dtype, like.device)
        if key not in self._lev_device:
            w = np.stack([w for (_, w, _, _) in kernels.values()], axis=-1)
            self._lev_device[key] = torch.as_tensor(w, dtype=like.dtype, device=like.device)
        return self._lev_device[key]

    # -- internal state -------------------------------------------------------

    def create_initial_state(self):
        state = {
            "gl": np.float64(0.0),
            "gis_smb": np.float64(0.0),
            "ais_smb": np.float64(0.0),
            "landwater": np.float64(0.0),
            "semiempi": np.float64(0.0),
            "base_sum": np.float64(0.0),
            "base_count": np.float64(0.0),
            "gis_vol_low": np.float64(float(self.gis_sid_totalvol_low)),
            "gis_vol_high": np.float64(float(self.gis_sid_totalvol_high)),
        }
        if str(self.ais_sid_parameterisation).lower() == "deconto":
            state["ais_vol"] = np.float64(float(self.ais_sid_totalvol))
        else:
            state["t_hist"] = np.zeros(int(self.max_history_steps))
            state["t_at_start"] = np.float64(0.0)
            state["started"] = np.float64(0.0)
        return state

    # -- sub-component physics -------------------------------------------------

    def _solve_glaciers(self, gl, t_global, active, dt):
        """Wigley-Raper rate vs the equilibrium tables (§3.2).  The
        Fortran's ``SIGN(|T - E|^exp, E)`` takes the *equilibrium
        temperature's* sign — reproduced verbatim.

        With the default table the two lookups use the table's own
        closed form ``S(T) = a - b exp(-c T)`` (and its log inverse),
        clamped to the table range like ``np.interp`` would be: a handful
        of elementwise ops instead of a binary search per member per
        year, and the exact function the default table discretises.
        Custom ``gl_equi_temp``/``gl_equi_slr`` tables keep the interp
        path.
        """
        if self.gl_equi_temp is None or self.gl_equi_slr is None:
            a, b, c = _GL_FIT_A, _GL_FIT_B, _GL_FIT_C
            t_clamped = xm.clip(t_global, 0.0, _GL_FIT_TMAX)
            equi_slr = a - b * xm.exp_fast(-c * t_clamped)
            # inverse: T(S) = -ln((a - S)/b)/c; S below S(0) maps to 0
            # and S above S(Tmax) to Tmax, matching interp's clamping
            arg = xm.maximum((a - gl) / b, 1e-30)
            equi_temp = xm.clip(-xm.log(arg) / c, 0.0, _GL_FIT_TMAX)
        else:
            tab_t, tab_s = self._glacier_table()
            tab_t_x = xm.asarray(tab_t, like=t_global)
            tab_s_x = xm.asarray(tab_s, like=t_global)
            equi_slr = xm.interp(t_global, tab_t_x, tab_s_x)
            equi_temp = xm.interp(gl, tab_s_x, tab_t_x)
        volume_factor = (equi_slr - gl) / self.gl_norm_vol
        # Fortran SIGN(A, 0.0) is +|A| (sign of +0); numpy sign(0) is 0,
        # which would freeze the glaciers at the table edge where the
        # clamped equilibrium temperature is exactly 0
        sgn = xm.where(equi_temp < 0.0, -1.0, 1.0)
        temp_factor = (
            sgn
            * xm.power(xm.abs(t_global - equi_temp), self.gl_temp_exponent)
            / self.gl_norm_temp
        )
        rate = self.gl_sens_mm_per_yr_k * volume_factor * temp_factor
        return gl + xm.where(active, rate * dt, 0.0)

    def _solve_gis_smb(self, smb, t_global, active, dt):
        if str(self.gis_smb_parameterisation).lower() == "fettweis":
            rate = (
                self.gis_smb_coef_fw1 * t_global
                - self.gis_smb_coef_fw2 * t_global**2
                - self.gis_smb_coef_fw3 * t_global**3
            ) / (-361.0)
        else:
            t_term = self.gis_smb_coef2 * t_global + (
                1.0 - self.gis_smb_coef2
            ) * xm.power(
                xm.maximum(t_global, 0.0), self.gis_smb_sens_exponent
            )
            volume_term = xm.power(
                xm.maximum(1.0 - smb / self.gis_smb_initial_volume_mm, 0.0),
                self.gis_smb_volume_exponent,
            )
            rate = self.gis_smb_coef1 * t_term * volume_term
        return smb + xm.where(active, rate * dt, 0.0)

    def _solve_gis_sid_case(self, vol, t_global, sens, tempsens, active, dt):
        """Nick et al. reservoir depletion for one LOW/HIGH case (§3.4)."""
        discharge = xm.minimum(
            0.0, -sens * vol * xm.exp(tempsens * t_global) * dt
        )
        discharge = xm.maximum(discharge, -vol)
        return xm.where(active, xm.maximum(vol + discharge, 0.0), vol)

    def _solve_ais_smb(self, smb, t_global, active, dt):
        t_term = self.ais_smb_coef2 * t_global + (
            1.0 - self.ais_smb_coef2
        ) * xm.power(xm.maximum(t_global, 0.0), self.ais_smb_sens_exponent)
        return smb + xm.where(active, self.ais_smb_coef1 * t_term * dt, 0.0)

    def _solve_ais_sid_deconto(self, vol, t_global, t, dt):
        """Threshold fast-rate reservoir (§3.6 DECONTO)."""
        anomaly = t_global - self.ais_sid_zerotemp
        temp_term = xm.sign(anomaly) * xm.power(
            xm.abs(anomaly), self.ais_sid_tempsens_exponent
        )
        discharge = self.ais_sid_dschrg_sens * vol * temp_term
        discharge = discharge + xm.where(
            t_global >= self.ais_sid_thresholdtemp, self.ais_sid_fastrate, 0.0
        )
        discharge = xm.minimum(discharge * dt, vol)
        active = t > float(self.ais_discharge_startyear)
        vol_next = xm.where(active, vol - discharge, vol)
        contribution = (self.ais_sid_totalvol - vol_next) * self.ais_sid_scaling
        return vol_next, contribution

    def _solve_ais_sid_levermann(self, state, t_global, t, step_like):
        """Regional IRF convolution (§3.6 LEVERMANN).  History slot
        ``idx`` (steps past the SID start year) holds the temperature
        anomaly vs the start-year temperature; each region contributes
        ``c_R * basalmelt * (dT(t) R(0) + dot(hist, W_R[idx]))``."""
        start = float(self.ais_sid_startyear)
        n = int(self.max_history_steps)
        dt_axis = self.axis_dt()
        started = state["started"]
        # latch the start-year temperature the first time t reaches it
        crossing = (t >= start) & (started == 0.0)
        t_at_start = xm.where(crossing, t_global, state["t_at_start"])
        started = xm.where(crossing, 1.0, started)

        # slot index counts *steps* past the start year (not years): on a
        # non-annual uniform axis every step still gets its own slot, and
        # the kernels are evaluated at the true age step*dt (see
        # _levermann_kernels)
        idx_f = (t - start) / dt_axis
        # +1e-6 so a 2.9999999996 from the division truncates to 3, not 2
        idx = xm.clip(idx_f + 1e-6, 0.0, float(n - 1))
        anomaly = t_global - t_at_start

        hist = state["t_hist"]
        idx_i = int(idx)
        kernels = self._levermann_kernels()
        if xm._is_tensor(t_global, hist):
            # one new history, written out of place (autograd may hold the
            # old one): the slot copied in between the two unchanged parts
            ref = t_global if isinstance(t_global, torch.Tensor) else hist
            hist = xm.asarray(hist, like=ref)
            anomaly = xm.asarray(anomaly, like=ref)
            lead = torch.broadcast_shapes(hist.shape[:-1], anomaly.shape)
            hist = hist.expand(lead + (n,))
            hist = torch.cat(
                [hist[..., :idx_i], anomaly.expand(lead)[..., None], hist[..., idx_i + 1:]],
                dim=-1,
            )
            # W[idx, j] is zero outside 2 <= j <= idx - 1, so only the
            # slots before idx enter the product
            middles = torch.matmul(
                hist[..., :idx_i], self._levermann_rows(hist)[idx_i, :idx_i]
            ).unbind(-1)
        else:
            hist = np.asarray(hist, dtype=np.float64).copy()
            hist[idx_i] = anomaly
            middles = [xm.dot(hist, w[idx_i]) for (_, w, _, _) in kernels.values()]

        conv_mm = 0.0
        for middle, (r, _, delay, scaling) in zip(middles, kernels.values()):
            region = (anomaly * float(r[0]) + middle) * scaling * self.ais_sid_basalmelt
            # per-region delay is in years; idx_f counts steps
            active = idx_f * dt_axis >= float(delay)
            conv_mm = conv_mm + xm.where(active, region * 1000.0, 0.0)

        gated = xm.where(t > start, conv_mm * self.ais_sid_scaling, 0.0)
        new_state = {
            "t_hist": hist,
            "t_at_start": t_at_start,
            "started": started,
        }
        return new_state, gated

    def _solve_landwater(self, lw, t, step_index, dt):
        """Prescribed series with post-switch depletion (§3.7)."""
        if not self.landwater_enabled or self.landwater_mm_per_year is None:
            return lw
        series = np.asarray(self.landwater_mm_per_year, dtype=np.float64)
        # the step index is a host number in both of the port's executors
        rate = float(series[min(max(int(step_index), 0), len(series) - 1)])
        switch = float(self.landwater_switchyear)
        max_vol = self.landwater_maxvolume_mm
        depletion = xm.power(
            xm.maximum(1.0 - lw / max_vol, 0.0), self.landwater_volume_exponent
        )
        factor = xm.where(t > switch, depletion, 1.0)
        active = t > float(self.landwater_startyear)
        return lw + xm.where(active, rate * factor * dt, 0.0)

    def _solve_semiempirical(self, state, t_global, t, dt):
        """Rahmstorf rate integration (§3.8) with in-run base-period
        accumulation."""
        in_base = (t >= float(self.semiempi_base_start)) & (
            t <= float(self.semiempi_base_end)
        )
        base_sum = state["base_sum"] + xm.where(in_base, t_global, 0.0)
        base_count = state["base_count"] + xm.where(in_base, 1.0, 0.0)
        basetemp = base_sum / xm.maximum(base_count, 1.0)
        rate = self.semiempi_rate_sens * (
            t_global - basetemp - self.semiempi_zeroratetemp
        )
        active = t >= float(self.semiempi_switchyear)
        semiempi = state["semiempi"] + xm.where(active, rate * dt, 0.0)
        return {
            "semiempi": semiempi,
            "base_sum": base_sum,
            "base_count": base_count,
        }

    # -- component step -------------------------------------------------------

    def solve_slr(self, state, t_global, ohc, t, step_index, dt):
        new_state = dict(state)

        # thermal expansion: proportional to OHC (see module docstring)
        active = t > float(self.expansion_startyear)
        expansion = xm.where(
            active,
            self.expansion_scaling
            * self.expansion_alpha_eff
            / RHO_CP_SEAWATER
            * ohc
            * 1000.0,
            0.0,
        )

        new_state["gl"] = self._solve_glaciers(
            state["gl"], t_global, t > float(self.gl_startyear), dt
        )
        new_state["gis_smb"] = self._solve_gis_smb(
            state["gis_smb"], t_global, t > float(self.gis_smb_startyear), dt
        )

        sid_active = t > float(self.gis_sid_startyear)
        new_state["gis_vol_low"] = self._solve_gis_sid_case(
            state["gis_vol_low"], t_global, self.gis_sid_dschrg_sens_low,
            self.gis_sid_tempsens_low, sid_active, dt,
        )
        new_state["gis_vol_high"] = self._solve_gis_sid_case(
            state["gis_vol_high"], t_global, self.gis_sid_dschrg_sens_high,
            self.gis_sid_tempsens_high, sid_active, dt,
        )
        sid_low = self.gis_sid_totalvol_low - new_state["gis_vol_low"]
        sid_high = self.gis_sid_totalvol_high - new_state["gis_vol_high"]
        gis_sid = (
            (sid_high - sid_low) * self.gis_sid_case + sid_low
        ) * self.gis_sid_scaling

        new_state["ais_smb"] = self._solve_ais_smb(
            state["ais_smb"], t_global, t > float(self.ais_smb_startyear), dt
        )

        if str(self.ais_sid_parameterisation).lower() == "deconto":
            sid_gate = t > float(self.ais_sid_startyear)
            vol, contribution = self._solve_ais_sid_deconto(
                state["ais_vol"], t_global, t, dt
            )
            new_state["ais_vol"] = xm.where(sid_gate, vol, state["ais_vol"])
            # the Fortran subtracts SMB so SID is pure discharge (§8.2)
            ais_sid = xm.where(
                sid_gate, contribution - new_state["ais_smb"], 0.0
            )
        else:
            lev_state, ais_sid = self._solve_ais_sid_levermann(
                state, t_global, t, step_index
            )
            new_state.update(lev_state)

        new_state["landwater"] = self._solve_landwater(
            state["landwater"], t, step_index, dt
        )
        new_state.update(self._solve_semiempirical(state, t_global, t, dt))

        total = (
            expansion
            + new_state["gl"]
            + new_state["gis_smb"]
            + gis_sid
            + new_state["ais_smb"]
            + ais_sid
            + new_state["landwater"]
        )
        outputs = {
            "total": total,
            "expansion": expansion,
            "glaciers": new_state["gl"],
            "gis_smb": new_state["gis_smb"],
            "gis_sid": gis_sid,
            "ais_smb": new_state["ais_smb"],
            "ais_sid": ais_sid,
            "landwater": new_state["landwater"],
            "semiempirical": new_state["semiempi"],
        }
        return new_state, outputs

    def solve_ctx(self, ctx, inputs, internal_state):
        dt = ctx.t_next - ctx.t_current
        new_state, out = self.solve_slr(
            internal_state,
            inputs.temperature.get(),
            inputs.ocean_heat_content.get(),
            ctx.t_current,
            ctx.step_index,
            dt,
        )
        return self.Outputs(**out), new_state


SeaLevelRiseBuilder = make_builder(SeaLevelRise)
