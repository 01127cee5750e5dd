"""
ClimateUDEB: 4-box atmosphere + 2 x N-layer upwelling-diffusion ocean.

Mirror of ``crates/rscm-magicc/src/climate/udeb/`` (+ ``state.rs``,
``parameters/climate_udeb.rs``): monthly sub-steps solving an implicit
tridiagonal diffusion/upwelling system per hemisphere (Thomas solve),
LAMCALC-derived ocean/land feedbacks with time-varying ECS (cumulative-T
and forcing feedbacks), depth-dependent ocean area factors, SST->air
temperature adjustment, ground-heat damping, and variable upwelling.

The port runs the yearly update batched over ensemble members inside the
model program's year loop (the TPU package's traced path): tensors carry a
leading member axis, the twelve monthly sub-steps of a year and the
time-varying-ECS LAMCALC go through two hand-written CUDA kernels
(:mod:`rscm_tpu_torch.ops.udeb_month`, :mod:`rscm_tpu_torch.ops.lamcalc_kernel`)
or their plain PyTorch versions, and the cumulative-temperature history is a
fixed ring buffer.  The step-by-step executor runs the same batched solve
at one member (:meth:`ClimateUDEB._solve_step`), where the TPU package runs
a separate numpy host path (``_solve_host``).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import torch

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import (
    Component, Input, Output, Parameter, SolveContext, State, state_to_host, state_to_tensors,
)
from rscm_tpu_torch.core.spatial import FourBoxRegion
from rscm_tpu_torch.core.state import FourBoxSlice

from .lamcalc import LamcalcParams, compute_qfrac, lamcalc

__all__ = ["ClimateUDEB", "ClimateUDEBBuilder", "CMIP5_PROFILE_NH", "CMIP5_PROFILE_SH"]

DIFFUSIVITY_CM2S_TO_M2YR = 3155.76
RHO_SEAWATER = 1026.0
CP_SEAWATER = 3985.0
SECONDS_PER_YEAR = 31557600.0
#: the JAX package's month engines, with the port's engine for each
_ENGINE_ALIASES = {"pallas": "cuda", "xla": "torch"}

# CMIP5-derived initial ocean temperature profiles (climate_udeb.rs tables)
CMIP5_PROFILE_NH = (
    1.89503822e01, 1.58484640e01, 1.27692938e01, 1.11237631e01, 9.93378544e00,
    8.89700890e00, 8.01173782e00, 7.24060631e00, 6.58022213e00, 5.99888515e00,
    5.47700644e00, 5.02416515e00, 4.62269211e00, 4.27446032e00, 3.95875454e00,
    3.70120311e00, 3.47130036e00, 3.26678157e00, 3.08187413e00, 2.93045211e00,
    2.79141068e00, 2.66952801e00, 2.55478907e00, 2.44816899e00, 2.35198379e00,
    2.26331019e00, 2.18005610e00, 2.10292435e00, 2.02744699e00, 1.95637441e00,
    1.89118743e00, 1.82867718e00, 1.76954043e00, 1.71074319e00, 1.65469503e00,
    1.60236323e00, 1.55269921e00, 1.50864816e00, 1.47147048e00, 1.44045138e00,
    1.41173756e00, 1.38347185e00, 1.35783422e00, 1.33539736e00, 1.31498563e00,
    1.29516900e00, 1.27472460e00, 1.25263810e00, 1.22954643e00, 1.20586693e00,
)
CMIP5_PROFILE_SH = (
    1.62849369e01, 1.35041571e01, 1.10637445e01, 9.45342350e00, 8.30402851e00,
    7.37928152e00, 6.60113478e00, 5.90550613e00, 5.29829597e00, 4.77080584e00,
    4.31242418e00, 3.93976259e00, 3.62348270e00, 3.35576391e00, 3.11617875e00,
    2.93644977e00, 2.77795982e00, 2.63738632e00, 2.50925493e00, 2.40222931e00,
    2.30221725e00, 2.21322107e00, 2.12794638e00, 2.04543614e00, 1.96889246e00,
    1.89580762e00, 1.82651293e00, 1.75886285e00, 1.69188118e00, 1.62586987e00,
    1.56049752e00, 1.49373257e00, 1.42720032e00, 1.35796928e00, 1.28947854e00,
    1.22542751e00, 1.16357803e00, 1.10515058e00, 1.05139232e00, 1.00322735e00,
    9.58882809e-01, 9.15422320e-01, 8.75476420e-01, 8.43416333e-01, 8.16016912e-01,
    7.90101945e-01, 7.68699825e-01, 7.51805604e-01, 7.36583769e-01, 7.25481987e-01,
)

_HYPSOMETRY_DEPTH = (0.0, 200.0, 500.0, 1000.0, 1500.0, 2000.0, 2500.0, 3000.0,
                     3500.0, 4000.0, 4500.0, 5000.0)
_HYPSOMETRY_AREA = (1.0, 0.975, 0.95, 0.92, 0.91, 0.87, 0.81, 0.72, 0.55, 0.38,
                    0.18, 0.05)


def heat_capacity_per_unit_area(depth_m: float) -> float:
    return RHO_SEAWATER * CP_SEAWATER * depth_m / SECONDS_PER_YEAR


class ClimateUDEB(Component):
    """Upwelling-diffusion energy-balance climate model."""

    tags = ("climate", "udeb", "magicc")
    category = "Climate"

    #: common alternate parameter spelling used in MAGICC configs
    parameter_aliases = {"forcing_2xco2": "rf_2xco2"}

    total_erf = Input("Effective Radiative Forcing", unit="W/m^2")
    surface_temperature = State("Surface Temperature", unit="K", grid="FourBox")
    heat_uptake = Output("Heat Uptake", unit="W/m^2")
    ocean_heat_content = Output("Ocean Heat Content", unit="J/m^2")
    sst = Output("Sea Surface Temperature", unit="K")

    n_layers = Parameter(default=50, static=True)
    mixed_layer_depth = Parameter(default=60.0, unit="m", static=True)
    layer_thickness = Parameter(default=100.0, unit="m", static=True)
    kappa = Parameter(default=0.75, unit="cm^2/s")
    kappa_min = Parameter(default=0.1, unit="cm^2/s")
    kappa_dkdt = Parameter(default=-0.191)
    w_initial = Parameter(default=3.5, unit="m/yr")
    w_variable_fraction = Parameter(default=0.7)
    w_threshold_temp_nh = Parameter(default=8.0, unit="K")
    w_threshold_temp_sh = Parameter(default=8.0, unit="K")
    ecs = Parameter(default=3.0, unit="K")
    rf_2xco2 = Parameter(default=3.71, unit="W/m^2")
    rlo = Parameter(default=1.317)
    feedback_q_sensitivity = Parameter(default=7.84e-9)
    feedback_cumt_sensitivity = Parameter(default=0.08)
    feedback_cumt_period = Parameter(default=300.0, unit="yr", static=True)
    k_lo = Parameter(default=1.44, unit="W/m^2/K")
    k_ns = Parameter(default=0.31, unit="W/m^2/K")
    amplify_ocean_to_land = Parameter(default=1.02)
    nh_land_fraction = Parameter(default=0.42, static=True)
    sh_land_fraction = Parameter(default=0.21, static=True)
    depth_dependent_area = Parameter(default=1.0, static=True)
    temp_adjust_alpha = Parameter(default=1.04)
    temp_adjust_gamma = Parameter(default=-0.002)
    polar_sinking_ratio = Parameter(default=0.2)
    land_heat_capacity_enabled = Parameter(default=True, static=True)
    k_lg = Parameter(default=0.1, unit="W/m^2/K")
    land_hc_eff_thickness = Parameter(default=300.0, unit="m")
    rf_regions_co2 = Parameter(default=(1.4089, 1.37045, 1.43333, 1.33257), static=True)
    efficacy_apply = Parameter(default=0, static=True)
    prescribed_efficacy_co2 = Parameter(default=1.0)
    ocean_temp_profile = Parameter(default="CMIP5", static=True)  # "CMIP5" | "Analytical"
    steps_per_year = Parameter(default=12, static=True)
    max_temperature = Parameter(default=25.0, unit="K")
    #: engine for the yearly monthly sub-steps and LAMCALC: "cuda" (the
    #: hand-written kernels, ops/udeb_month.py and ops/lamcalc_kernel.py),
    #: "torch" (their plain PyTorch versions) or "auto" (default: "cuda"
    #: when the run's tensors are on a CUDA device, "torch" on the CPU);
    #: the JAX package's names "pallas" and "xla" are aliases of "cuda" and
    #: "torch"
    month_engine = Parameter(default="auto", static=True)
    #: tridiagonal solver of the torch engine's column update: "sequential"
    #: (the Thomas sweep the kernel runs) or "assoc" (associative scans,
    #: utils/linear_algebra.py::thomas_solve_assoc); the cuda engine runs
    #: its sweep either way, as the JAX package's Pallas engine does
    tridiag_solver = Parameter(default="sequential", static=True)
    #: gate for the per-year LAMCALC; with False the program reuses the
    #: build-time lambdas (exact when the ECS feedback sensitivities are
    #: zero; an approximation otherwise that trades ECS time-variation for
    #: less work)
    time_varying_ecs = Parameter(default=True, static=True)

    def __init__(self, **params):
        super().__init__(**params)
        if self.n_layers < 2:
            raise ValueError(f"invalid n_layers: must be >= 2, got {self.n_layers}")
        if not np.isfinite(self.prescribed_efficacy_co2) or self.prescribed_efficacy_co2 <= 0:
            raise ValueError(
                "invalid prescribed_efficacy_co2: must be finite and positive, "
                f"got {self.prescribed_efficacy_co2}"
            )
        result = self._run_lamcalc(self.ecs)
        if result is None:
            raise ValueError(
                f"LAMCALC iteration failed to converge for ECS={self.ecs}, RLO={self.rlo}"
            )
        self.lambda_ocean = result.lambda_ocean
        self.lambda_land = result.lambda_land
        self.matrix_inverse = result.matrix_inverse
        self.co2_internal_efficacy = result.co2_internal_efficacy
        area = np.asarray(self.global_box_fractions())
        self.co2_qfrac = compute_qfrac(self.rf_regions_co2, area)
        self.af_top, self.af_bottom, self.af_diff = self.compute_area_factors()

    # Note: the LAMCALC products (lambda_ocean/lambda_land/matrix_inverse/
    # co2_internal_efficacy) are derived instance attributes, not declared
    # Parameters, so they stay out of the traced pytree; the traced path
    # re-derives them in-graph from the (possibly batched) ecs/rlo/... .

    # -- parameter helpers (climate_udeb.rs impl block) ----------------------

    def _run_lamcalc(self, ecs):
        fgno, fgnl, fgso, fgsl = self.global_box_fractions()
        return lamcalc(
            LamcalcParams(
                q_2xco2=self.rf_2xco2,
                k_lo=self.k_lo,
                k_ns=self.k_ns,
                ecs=ecs,
                rlo=self.rlo,
                amplify_ocean_to_land=self.amplify_ocean_to_land,
                fgno=fgno,
                fgnl=fgnl,
                fgso=fgso,
                fgsl=fgsl,
                rf_regions_co2=tuple(self.rf_regions_co2),
            )
        )

    def kappa_m2_per_yr(self):
        return self.kappa * DIFFUSIVITY_CM2S_TO_M2YR

    def kappa_min_m2_per_yr(self):
        return self.kappa_min * DIFFUSIVITY_CM2S_TO_M2YR

    def lambda_global(self):
        return self.rf_2xco2 / self.ecs

    def global_box_fractions(self):
        fgnl = self.nh_land_fraction / 2.0
        fgno = 0.5 - fgnl
        fgsl = self.sh_land_fraction / 2.0
        fgso = 0.5 - fgsl
        return (fgno, fgnl, fgso, fgsl)

    def ocean_area_at_depth(self, depth_m: float) -> float:
        hydro = float(
            np.interp(depth_m, _HYPSOMETRY_DEPTH, _HYPSOMETRY_AREA)
        )
        return 1.0 + self.depth_dependent_area * (hydro - 1.0)

    def compute_area_factors(self):
        n = self.n_layers
        af_top, af_bottom, af_diff = [], [], []
        for layer in range(n):
            if layer == 0:
                z_top, z_bottom = 0.0, self.mixed_layer_depth
            else:
                z_top = self.mixed_layer_depth + (layer - 1) * self.layer_thickness
                z_bottom = z_top + self.layer_thickness
            a_top = self.ocean_area_at_depth(z_top)
            a_bottom = self.ocean_area_at_depth(z_bottom)
            a_avg = (a_top + a_bottom) / 2.0
            af_top.append(a_top / a_avg)
            af_bottom.append(a_bottom / a_avg)
            af_diff.append((a_top - a_bottom) / a_avg)
        return np.asarray(af_top), np.asarray(af_bottom), np.asarray(af_diff)

    def mixed_layer_heat_capacity(self):
        return heat_capacity_per_unit_area(self.mixed_layer_depth)

    def ground_heat_capacity(self):
        return heat_capacity_per_unit_area(self.land_hc_eff_thickness)

    def initial_ocean_profile(self, hemi: int) -> np.ndarray:
        assert hemi in (0, 1)
        if self.ocean_temp_profile == "CMIP5":
            cmip5 = CMIP5_PROFILE_NH if hemi == 0 else CMIP5_PROFILE_SH
            profile = np.empty(self.n_layers)
            for i in range(self.n_layers):
                profile[i] = cmip5[i] if i < len(cmip5) else cmip5[-1]
            return profile
        # analytical exponential profile
        t_mix, t_polar = 17.2, 1.0
        kappa = self.kappa_m2_per_yr()
        profile = np.empty(self.n_layers)
        profile[0] = t_mix
        for layer in range(1, self.n_layers):
            depth = (layer - 1.0) * self.layer_thickness + 0.5 * self.layer_thickness
            profile[layer] = t_polar + (t_mix - t_polar) * math.exp(
                -self.w_initial * depth / kappa
            )
        return profile

    # -- internal state (climate/state.rs) ------------------------------------

    #: capacity of the cumulative-temperature ring buffer; must cover
    #: feedback_cumt_period / dt steps (512 >= 300 annual steps + margin)
    history_capacity = Parameter(default=512, static=True)

    def create_initial_state(self):
        profiles = [self.initial_ocean_profile(0), self.initial_ocean_profile(1)]
        return {
            "ocean_temps": np.zeros((2, self.n_layers)),
            "upwelling_rates": np.array([self.w_initial, self.w_initial]),
            # newest-first ring buffers replacing the reference's unbounded
            # Vec history (state.rs temperature_history/dt_history): entry k
            # holds (global_temp * dt, dt) of the step k steps ago
            "th_values": np.zeros(self.history_capacity),
            "th_dts": np.zeros(self.history_capacity),
            "land_temps": np.zeros(2),
            "ground_temps": np.zeros(2),
            "alpha_eff": np.array([self.temp_adjust_alpha, self.temp_adjust_alpha]),
            "hemi_heat_exchange": np.zeros(2),
            "initial_ocean_profile": np.stack(profiles),
            "polar_sinking_temp": 1.0,
            "mixed_layer_initial_temp": float(profiles[0][0]),
        }

    # -- loop-layout hooks -----------------------------------------------------
    #
    # Inside the year loop the cumulative-temperature ring is CIRCULAR
    # (slot p holds the entry of the latest year ≡ p mod capacity), so a
    # year writes one slot instead of shifting the whole (B, capacity)
    # buffer.  The host-visible contract stays newest-first; the program
    # converts once at entry/exit via these hooks.

    def _cumt_window(self, dt_year: float):
        """Static feedback window: (n_eff, frac, newest-first weights).

        ``n_eff`` whole entries get weight 1 and the entry aged ``n_eff``
        gets the fractional remainder (zero when the window is clamped to
        the ring capacity) — the discretisation of the cumulative-
        temperature feedback period under a uniform ``dt``.
        """
        cap = int(self.history_capacity)
        period = self.feedback_cumt_period
        n_full = int(period // dt_year)
        frac = (period - n_full * dt_year) / dt_year
        n_eff = min(n_full, cap)
        if n_full >= cap:
            frac = 0.0
        weights = np.zeros(cap)
        weights[:n_eff] = 1.0
        if frac > 0:
            weights[n_eff] = frac
        return n_eff, frac, weights

    def pack_scan_state(self, state, start_idx: int, dt=None):
        cap = int(self.history_capacity)
        slots = (int(start_idx) - 1 - np.arange(cap)) % cap
        out = {**state, "th_values": state["th_values"][..., slots]}
        if dt is not None:
            # seed the running boxcar sum: inside the loop the windowed
            # part of cum_t is a recursion (add the new entry, subtract
            # the entry aging out — two ring slots) instead of a
            # (B, capacity) dot every year, with a Kahan compensation
            # term so the running sum does not drift in float32.  Only
            # valid under a uniform axis (the absence of this key makes
            # the solve raise).
            n_eff, _, _ = self._cumt_window(float(dt))
            th = state["th_values"]
            boxcar = np.ones(cap)
            boxcar[n_eff:] = 0.0
            s0 = xm.dot(th, boxcar)
            out["th_cumsum"] = s0
            out["th_cumsum_c"] = s0 * 0.0
        return out

    def unpack_scan_state(self, state, end_idx: int, dt=None):
        cap = int(self.history_capacity)
        ages = (int(end_idx) - 1 - np.arange(cap)) % cap
        out = {**state, "th_values": state["th_values"][..., ages]}
        out.pop("th_cumsum", None)
        out.pop("th_cumsum_c", None)
        return out

    def cumulative_temperature(self, values, dts):
        """The cumulative temperature over the feedback period from the
        newest-first host history: whole entries while they fit, the last
        one weighted by the part of its step inside the period (the TPU
        package's ``adjusted_ecs`` walk, ``udeb/mod.rs:302-350``)."""
        cum_t = 0.0
        years_remaining = self.feedback_cumt_period
        for value, dt in zip(np.asarray(values, dtype=np.float64),
                             np.asarray(dts, dtype=np.float64)):
            if years_remaining <= 0.0:
                break
            if dt <= 0.0:
                continue
            if dt <= years_remaining:
                cum_t += value
                years_remaining -= dt
            else:
                cum_t += value * (years_remaining / dt)
                years_remaining = 0.0
        return cum_t

    # -- the batched yearly solve (the TPU package's ``_solve_traced``) --------

    def solve_ctx(self, ctx, inputs, internal_state):
        if not getattr(ctx, "scan_mode", False):
            return self._solve_step(ctx, inputs, internal_state)
        return self._solve_batched(ctx, inputs, internal_state)

    def _solve_step(self, ctx, inputs, internal_state):
        """One year of the step-by-step executor: the batched solve at one
        member, its loop state packed from the host layout (newest-first
        cumulative-temperature history) before the year and unpacked after
        it, so ``model.component_states`` keeps the host layout between
        steps.  The cumulative temperature walks the recorded step widths,
        as the TPU package's host path does, so a non-uniform axis steps
        as it does there."""
        like = inputs.surface_temperature.at_start(FourBoxRegion.NorthernOcean)
        dt = float(ctx.t_next) - float(ctx.t_current)
        idx = int(ctx.step_index)
        state = self.pack_scan_state(
            state_to_tensors(internal_state, like.dtype, like.device), idx, dt=dt
        )
        state["cum_t"] = self.cumulative_temperature(
            internal_state["th_values"], internal_state["th_dts"]
        )
        year = SolveContext(ctx.t_current, ctx.t_next, idx, spans=np.asarray([dt]),
                            scan_mode=True)
        outputs, state = self._solve_batched(year, inputs, state)
        return outputs, state_to_host(self.unpack_scan_state(state, idx + 1), internal_state)

    def _solve_batched(self, ctx, inputs, internal_state):
        """One year for every member: tensors carry a leading member axis.

        Parameters are host floats (shared by every member) or ``(B,)``
        tensors (swept); internal-state leaves are unbatched on the first
        year and ``(B, ...)`` afterwards.  The cumulative-temperature ring
        is updated in place (one slot a year) once it is batched.
        """
        from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc_scalars
        from rscm_tpu_torch.ops.udeb_month import static_from_component, udeb_year, udeb_year_plain

        state = internal_state
        n = self.n_layers
        regions = (
            FourBoxRegion.NorthernOcean,
            FourBoxRegion.NorthernLand,
            FourBoxRegion.SouthernOcean,
            FourBoxRegion.SouthernLand,
        )
        prev_temp = torch.stack(
            [inputs.surface_temperature.at_start(r) for r in regions], dim=-1
        )  # (B, 4)
        b = prev_temp.shape[0]
        like = dict(dtype=prev_temp.dtype, device=prev_temp.device)

        def C(x):
            return torch.as_tensor(x, **like)

        def M(x):
            """Per-member value: ``(B,)``."""
            return C(x).expand(b)

        def batched(x, shape):
            """A state leaf broadcast to ``(B,) + shape`` (a fresh copy)."""
            return C(x).expand((b,) + shape).clone()

        spans = np.asarray(ctx.spans, dtype=np.float64)
        dt_year = float(spans[0])
        if not np.allclose(spans, dt_year, rtol=0, atol=0.0):
            raise ValueError("ClimateUDEB requires a uniform time axis")
        if "th_cumsum" not in state:
            raise ValueError("ClimateUDEB: the program did not pack the loop state")

        erf_start = inputs.total_erf.at_start()
        erf_end_raw = inputs.total_erf.at_end()
        erf_end = torch.where(torch.isnan(erf_end_raw), erf_start, erf_end_raw)
        erf_start = torch.where(torch.isnan(erf_start), erf_end, erf_start)

        ocean_temps = batched(state["ocean_temps"], (2, n))
        land_temps = batched(state["land_temps"], (2,))
        ground_temps = batched(state["ground_temps"], (2,))

        # branch-free resume seeding (mirror of the host path's guard)
        seed = (
            (ocean_temps[:, 0, 0] == 0.0)
            & (prev_temp[:, 0] != 0.0)
            & ~torch.isnan(prev_temp).any(-1)
        )
        ocean_temps[:, 0, 0] = torch.where(seed, prev_temp[:, 0], ocean_temps[:, 0, 0])
        ocean_temps[:, 1, 0] = torch.where(seed, prev_temp[:, 2], ocean_temps[:, 1, 0])
        land_temps = torch.where(seed[:, None], prev_temp[:, [1, 3]], land_temps)
        ground_temps = torch.where(seed[:, None], land_temps, ground_temps)

        # adjusted ECS: the running boxcar sum carried across years (seeded
        # by pack_scan_state); only the fractional-age entry reads the ring
        capacity = int(self.history_capacity)
        n_eff, frac, _ = self._cumt_window(dt_year)
        idx = int(ctx.step_index)
        th_values = C(state["th_values"])
        if "cum_t" in state:  # the step-by-step executor's walk (_solve_step)
            cum_t = C(state["cum_t"])
        else:
            cum_t = C(state["th_cumsum"])
            if frac > 0:
                cum_t = cum_t + C(frac) * th_values[..., (idx - 1 - n_eff) % capacity]

        period = self.feedback_cumt_period
        cumt_2x = M(self.ecs * period)
        erf_mid = (erf_start + erf_end) / 2.0
        cumt_factor = torch.where(
            cumt_2x.abs() > 1e-15,
            1.0 + self.feedback_cumt_sensitivity * (cum_t - cumt_2x) / cumt_2x,
            C(1.0),
        )
        q_factor = 1.0 + self.feedback_q_sensitivity * (
            torch.clamp(erf_mid, min=0.0) - self.rf_2xco2
        )
        adjusted_ecs = M(self.ecs * cumt_factor * q_factor)

        fgno, fgnl, fgso, fgsl = self.global_box_fractions()
        engine = _ENGINE_ALIASES.get(self.month_engine, self.month_engine)
        if engine == "auto":
            engine = "cuda" if prev_temp.device.type == "cuda" else "torch"
        if engine not in ("cuda", "torch"):
            raise ValueError(
                "ClimateUDEB.month_engine must be auto, cuda, torch, pallas or xla, "
                f"not {engine!r}"
            )

        if self.time_varying_ecs:
            lamcalc_params = LamcalcParams(
                q_2xco2=self.rf_2xco2, k_lo=self.k_lo, k_ns=self.k_ns,
                ecs=adjusted_ecs, rlo=self.rlo,
                amplify_ocean_to_land=self.amplify_ocean_to_land,
                fgno=fgno, fgnl=fgnl, fgso=fgso, fgsl=fgsl,
                rf_regions_co2=tuple(self.rf_regions_co2),
            )
            fallback = (
                self.lambda_ocean, self.lambda_land, self.matrix_inverse,
                self.co2_internal_efficacy,
            )
            lam_o, lam_l, co2_eff = lamcalc_scalars(lamcalc_params, adjusted_ecs, fallback, engine)
        else:
            lam_o = M(self.lambda_ocean)
            lam_l = M(self.lambda_land)
            co2_eff = M(self.co2_internal_efficacy)

        c_ground = self.ground_heat_capacity() if self.land_heat_capacity_enabled else 0.0
        qfrac = C(self.co2_qfrac)

        # the efficacy factor, folded into the erf inputs of the month loop
        if self.efficacy_apply == 1:
            eff_factor = M(self.prescribed_efficacy_co2)
        elif self.efficacy_apply == 2:
            ok = torch.isfinite(co2_eff) & (co2_eff > 0)
            eff_factor = torch.where(
                ok, self.prescribed_efficacy_co2 / torch.where(ok, co2_eff, C(1.0)), C(1.0)
            )
        else:
            eff_factor = M(1.0)

        def sst_to_air(sst):
            alpha, gamma = M(self.temp_adjust_alpha), M(self.temp_adjust_gamma)
            nonzero = gamma.abs() > 1e-15
            gamma_safe = torch.where(nonzero, gamma, C(1.0))
            t_star = -(alpha - 1.0) / (2.0 * gamma_safe)
            delta_max = alpha * t_star + gamma * t_star * t_star - t_star
            quad = torch.where(sst < t_star, alpha * sst + gamma * sst * sst, sst + delta_max)
            return torch.where(nonzero, quad, alpha * sst)

        # -- one year of monthly sub-steps (member-minor kernel layout) --------
        scal = torch.stack([
            M(v) for v in (
                lam_o, lam_l, self.kappa, self.kappa_dkdt, self.kappa_min_m2_per_yr(),
                self.w_initial, self.w_variable_fraction, self.k_lo, self.k_ns, self.k_lg,
                self.amplify_ocean_to_land, self.polar_sinking_ratio,
                self.temp_adjust_alpha, self.temp_adjust_gamma, self.max_temperature,
                c_ground, erf_start * eff_factor, erf_end * eff_factor,
                state["polar_sinking_temp"],
                self.w_threshold_temp_nh, self.w_threshold_temp_sh,
            )
        ])  # (S + 2, B)
        hemi_exchange = batched(state["hemi_heat_exchange"], (2,))
        upwelling = batched(state["upwelling_rates"], (2,))
        alpha_eff = batched(state["alpha_eff"], (2,))
        vec = torch.cat(
            [land_temps, ground_temps, hemi_exchange, upwelling, alpha_eff], dim=1
        ).T.contiguous()  # (10, B)
        init_prof = C(state["initial_ocean_profile"])
        if init_prof.dim() == 2:  # shared by every member: a stride-0 view
            init_prof = init_prof.reshape(2 * n, 1).expand(2 * n, b)
        else:
            init_prof = init_prof.reshape(b, 2 * n).T
        year = (
            udeb_year if engine == "cuda"
            else functools.partial(udeb_year_plain, tridiag=self.tridiag_solver)
        )
        ocean_out, vec_out = year(
            static_from_component(self, dt_year),
            scal.contiguous(),
            ocean_temps.reshape(b, 2 * n).T.contiguous(),
            init_prof,
            vec,
        )
        ocean_temps = ocean_out.T.reshape(b, 2, n)
        land_temps, ground_temps, hemi_exchange, upwelling = (
            vec_out[k : k + 2].T for k in range(0, 8, 2)
        )

        sst_nh = ocean_temps[:, 0, 0]
        sst_sh = ocean_temps[:, 1, 0]
        alpha = M(self.temp_adjust_alpha)

        def air_ratio(sst):
            tiny = sst.abs() < 1e-15
            return torch.where(tiny, alpha, sst_to_air(sst) / torch.where(tiny, C(1.0), sst))

        new_alpha_eff = torch.stack([air_ratio(sst_nh), air_ratio(sst_sh)], dim=-1)
        t_air_nho = sst_to_air(sst_nh)
        t_air_sho = sst_to_air(sst_sh)
        surface_temperature = torch.stack(
            [t_air_nho, land_temps[:, 0], t_air_sho, land_temps[:, 1]], dim=-1
        )  # (B, 4)
        area = C([fgno, fgnl, fgso, fgsl])
        global_temp = (surface_temperature * area).sum(-1)

        # circular ring: one slot a year (in place once batched); the
        # running boxcar sum retires the entry aging out of the window,
        # read from the PRE-update ring (a copy: when the window spans the
        # whole ring it is the slot written next), Kahan-compensated
        new_entry = global_temp * dt_year
        retiring = th_values[..., (idx - n_eff) % capacity].clone() if n_eff > 0 else None
        if th_values.dim() == 1:
            th_values = th_values.expand(b, capacity).clone()
        th_values[:, idx % capacity] = new_entry
        s_prev = C(state["th_cumsum"])
        c_prev = C(state["th_cumsum_c"])
        if n_eff > 0:
            d = (new_entry - retiring) - c_prev
            s_next = s_prev + d
            c_next = (s_next - s_prev) - d
        else:
            s_next, c_next = s_prev, c_prev

        new_state = {
            "ocean_temps": ocean_temps,
            "upwelling_rates": upwelling,
            "th_values": th_values,
            "th_dts": xm.push_front(C(state["th_dts"]), dt_year),
            "land_temps": land_temps,
            "ground_temps": ground_temps,
            "alpha_eff": new_alpha_eff,
            "hemi_heat_exchange": hemi_exchange,
            "initial_ocean_profile": state["initial_ocean_profile"],
            "polar_sinking_temp": state["polar_sinking_temp"],
            "mixed_layer_initial_temp": state["mixed_layer_initial_temp"],
            "th_cumsum": s_next,
            "th_cumsum_c": c_next,
        }

        if self.efficacy_apply == 1:
            erf_adjusted = M(erf_end * self.prescribed_efficacy_co2)
        elif self.efficacy_apply == 2:
            erf_adjusted = torch.where(
                ok, erf_end * self.prescribed_efficacy_co2 / torch.where(ok, co2_eff, C(1.0)),
                erf_end,
            )
        else:
            erf_adjusted = M(erf_end)
        forcing_end = erf_adjusted[:, None] * qfrac  # (B, 4)
        lambdas = C([1.0, 0.0, 1.0, 0.0]) * lam_o[:, None] + C([0.0, 1.0, 0.0, 1.0]) * lam_l[:, None]
        heat_uptake = (forcing_end * area).sum(-1) - (lambdas * surface_temperature * area).sum(-1)
        rho_c = RHO_SEAWATER * CP_SEAWATER
        dz = self.layer_thickness
        dz_mix = self.mixed_layer_depth
        ocean_heat_content = (
            rho_c * dz_mix * (ocean_temps[:, 0, 0] + ocean_temps[:, 1, 0])
            + rho_c * dz * (ocean_temps[:, 0, 1:].sum(-1) + ocean_temps[:, 1, 1:].sum(-1))
        ) / 2.0
        sst = (sst_nh + sst_sh) / 2.0

        return (
            self.Outputs(
                surface_temperature=FourBoxSlice.from_array(surface_temperature.unbind(-1)),
                heat_uptake=heat_uptake,
                ocean_heat_content=ocean_heat_content,
                sst=sst,
            ),
            new_state,
        )


ClimateUDEBBuilder = make_builder(ClimateUDEB)
