"""
Ocean carbon uptake: IRF-convolution mixed-layer model with Joos-style
carbonate chemistry and monthly sub-stepping.

Mirror of ``crates/rscm-magicc/src/carbon/ocean.rs:58-307`` +
``src/parameters/ocean_carbon.rs`` (3D-GFDL / 2D-BERN / HILDA impulse
response kernels), ported from ``rscm_tpu/magicc/carbon/ocean.py``.

The reference's unbounded flux-history ``VecDeque`` becomes one of two
fixed-size engines (:meth:`OceanCarbon.resolved_engine`):

- ``"ring"``: the whole ``max_history_months`` window, kept circular inside
  the year loop (one slot written a month, no shift) and convolved with the
  IRF table rotated by the step index — one ``(B, N) @ (N, 12)`` product a
  year; stored in ``history_dtype``;
- ``"expsum"``: the young window convolved exactly plus ``EXPSUM_TAIL_K``
  recursive exponential accumulators for everything older (a least-squares
  fit of the scaled IRF tail on the host).

The twelve monthly sub-steps are a Python loop over ``(B,)`` tensors.  The
step-by-step executor runs the same yearly update at one member
(:meth:`OceanCarbon._solve_step`), where the TPU package runs separate
newest-first host engines (``solve_ocean``, ``_solve_ocean_expsum``).
Checkpoint migration between engines is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rscm_tpu_torch.components._builder import make_builder
from rscm_tpu_torch.core import xmath as xm
from rscm_tpu_torch.core.component import (
    Component, Input, Output, Parameter, State, state_to_host, state_to_tensors,
)

__all__ = ["IrfForm", "OceanCarbon", "OceanCarbonBuilder", "OCEAN_CARBON_PRESETS"]

PPM_TO_GTC = 2.124
OCEAN_MICROMOL_PER_PPM_M3_PER_KG = 1.72e17

# Exponential-sum tail engine geometry (see OceanCarbon.engine): the last
# `expsum_young_months()` months of flux history are convolved exactly;
# all older history is folded into EXPSUM_TAIL_K recursive accumulators,
# one per fitted decay timescale.  The young window must reach past the
# kernel's early/late switch time (the piecewise kink is not representable
# by a smooth exponential sum), plus two years of margin.
EXPSUM_TAIL_K = 32
EXPSUM_YOUNG_MIN_MONTHS = 24
#: "auto" uses the exp-sum engine only when the configured window is at
#: least this long — short windows are a deliberate truncation request
#: that the (never-forgetting) recursive tail cannot honour.
EXPSUM_AUTO_MIN_MONTHS = 1440

DELTA_OSPP_OFFSETS = (1.5568, 7.4706, 1.2748, 2.4491, 1.5468)
DELTA_OSPP_COEFFICIENTS = (-0.013993, -0.20207, -0.12015, -0.12639, -0.15326)


@dataclass(frozen=True)
class IrfForm:
    """Polynomial or exponential-sum impulse response form."""

    kind: str  # "polynomial" | "exponential_sum"
    coefficients: tuple
    timescales: tuple = ()

    def evaluate(self, t: float) -> float:
        if self.kind == "polynomial":
            result = 0.0
            for c in reversed(self.coefficients):
                result = result * t + c
            return result
        return float(
            sum(
                a * np.exp(-t / tau)
                for a, tau in zip(self.coefficients, self.timescales)
            )
        )


def _poly(*coefficients):
    return IrfForm("polynomial", tuple(coefficients))


def _exp_sum(coefficients, timescales):
    return IrfForm("exponential_sum", tuple(coefficients), tuple(timescales))


# Preset IRF kernels + physical constants (ocean_carbon.rs:108-220)
OCEAN_CARBON_PRESETS = {
    "3D-GFDL": dict(
        gas_exchange_tau=7.66,
        irf_switch_time=1.0,
        irf_early=_poly(1.0, -2.2617, 14.002, -48.770, 82.986, -67.527, 21.037),
        irf_late=_exp_sum(
            [0.01481, 0.019439, 0.038344, 0.066485, 0.24966, 0.70367],
            [1.0e10, 347.55, 65.359, 15.281, 2.3488, 0.70177],
        ),
        mixed_layer_depth=50.9,
        ocean_surface_area=3.55e14,
        sst_pi=17.7,
    ),
    "2D-BERN": dict(
        gas_exchange_tau=7.46,
        irf_switch_time=9.9,
        irf_early=_exp_sum(
            [0.058648, 0.07515, 0.079338, 0.41413, 0.24845, 0.12429],
            [1.0e10, 9.6218, 9.2364, 0.7603, 0.16294, 0.0032825],
        ),
        irf_late=_exp_sum(
            [0.01369, 0.012456, 0.026933, 0.026994, 0.036608, 0.06738],
            [1.0e10, 331.54, 107.57, 38.946, 11.677, 10.515],
        ),
        mixed_layer_depth=50.0,
        ocean_surface_area=3.5375e14,
        sst_pi=18.2997,
    ),
    "HILDA": dict(
        gas_exchange_tau=9.06,
        irf_switch_time=2.0,
        irf_early=_exp_sum(
            [0.12935, 0.24093, 0.24071, 0.17003, 0.21898],
            [1.0e10, 4.9792, 0.96083, 0.26936, 0.034569],
        ),
        irf_late=_exp_sum(
            [0.022936, 0.035549, 0.037820, 0.089318, 0.13963, 0.24278],
            [1.0e10, 232.30, 68.736, 18.601, 5.2528, 1.2679],
        ),
        mixed_layer_depth=75.0,
        ocean_surface_area=3.62e14,
        sst_pi=18.1716,
    ),
}

_STORAGE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class OceanCarbon(Component):
    """IRF-convolution ocean carbon uptake."""

    tags = ("carbon-cycle", "ocean", "magicc")
    category = "Carbon Cycle"

    co2_concentration = Input("Atmospheric Concentration|CO2", unit="ppm")
    sst = Input("Sea Surface Temperature", unit="K")
    ocean_pco2 = State("Ocean Surface pCO2", unit="ppm")
    cumulative_uptake = State("Cumulative Ocean Uptake", unit="GtC")
    air_sea_flux = Output("Carbon Flux|Ocean", unit="GtC/yr")

    model = Parameter(default="3D-GFDL", static=True)
    co2_pi = Parameter(default=278.0, unit="ppm")
    pco2_pi = Parameter(default=278.0, unit="ppm")
    gas_exchange_scale = Parameter(default=1.833492)
    gas_exchange_tau = Parameter(default=7.66, unit="yr")
    temp_sensitivity = Parameter(default=0.03717879, unit="1/K")
    irf_scale = Parameter(default=0.9492864, static=True)
    mixed_layer_depth = Parameter(default=50.9, unit="m")
    ocean_surface_area = Parameter(default=3.55e14, unit="m^2")
    sst_pi = Parameter(default=17.7, unit="degC")
    steps_per_year = Parameter(default=12, static=True)
    max_history_months = Parameter(default=6000, static=True)
    irf_switch_time = Parameter(default=1.0, static=True)
    irf_early = Parameter(default=OCEAN_CARBON_PRESETS["3D-GFDL"]["irf_early"], static=True)
    irf_late = Parameter(default=OCEAN_CARBON_PRESETS["3D-GFDL"]["irf_late"], static=True)
    delta_ospp_offsets = Parameter(default=DELTA_OSPP_OFFSETS, static=True)
    delta_ospp_coefficients = Parameter(default=DELTA_OSPP_COEFFICIENTS, static=True)
    enable_temp_feedback = Parameter(default=True, static=True)
    #: storage dtype of the ring engine's flux history ("float32" |
    #: "bfloat16"), as in the TPU package: "bfloat16" stores the history
    #: and the rotated weights in bfloat16 and forms their product in
    #: float32; "float32" keeps the run's dtype.  The exp-sum engine
    #: ignores it.
    history_dtype = Parameter(default="float32", static=True)
    #: Convolution engine: "ring", "expsum" or "auto" (expsum for windows
    #: of at least EXPSUM_AUTO_MIN_MONTHS, ring for shorter ones).
    engine = Parameter(default="auto", static=True)

    def __init__(self, **params):
        super().__init__(**params)
        # an impulse-response form read back from a serialised model: a dict
        # of its fields (``Model.to_full_dict``) or another package's form
        for name in ("irf_early", "irf_late"):
            form = getattr(self, name)
            if isinstance(form, dict):
                form = IrfForm(form["kind"], tuple(form["coefficients"]),
                               tuple(form.get("timescales", ())))
            elif not isinstance(form, IrfForm):
                form = IrfForm(form.kind, tuple(form.coefficients), tuple(form.timescales))
            setattr(self, name, form)
        if self.history_dtype not in _STORAGE_DTYPES:
            raise ValueError(
                f"OceanCarbon.history_dtype must be one of {sorted(_STORAGE_DTYPES)}, "
                f"got {self.history_dtype!r}"
            )
        # static tables (host arrays and their device copies); one dict
        # shared by the per-run parameter clones (``with_params``)
        self._tables = {}

    @classmethod
    def from_parameters(cls, parameters: dict):
        parameters = dict(parameters)
        model = parameters.get("model", "3D-GFDL")
        preset = OCEAN_CARBON_PRESETS.get(model, {})
        merged = {**preset, "model": model}
        merged.update(parameters)
        return cls(**merged)

    # -- kernel helpers (ocean_carbon.rs:222-272) -----------------------------

    def gas_exchange_rate(self):
        return self.gas_exchange_scale / (self.gas_exchange_tau * 12.0)

    def _scale_irf(self, irf):
        f = self.irf_scale
        return (irf * f) / (irf * f + 1.0 - irf)

    def irf(self, t: float) -> float:
        raw = (
            self.irf_early.evaluate(t)
            if t < self.irf_switch_time
            else self.irf_late.evaluate(t)
        )
        return self._scale_irf(raw)

    def _cached(self, key, make):
        if key not in self._tables:
            self._tables[key] = make()
        return self._tables[key]

    def _device_table(self, name, array, dtype, device):
        """A host table as a tensor, moved to the device once."""
        return self._cached(
            (name, dtype, str(device)),
            lambda: torch.as_tensor(np.ascontiguousarray(array)).to(dtype=dtype, device=device),
        )

    def irf_table(self) -> np.ndarray:
        """Static monthly IRF table: irf(k/12) for k = 0..max_history-1."""
        return self._cached(
            "irf",
            lambda: np.asarray([self.irf(k / 12.0) for k in range(self.max_history_months)]),
        )

    def delta_pco2_from_dic(self, delta_dic):
        dic_powers = (
            delta_dic,
            delta_dic**2 * 1e-3,
            -(delta_dic**3) * 1e-5,
            delta_dic**4 * 1e-7,
            -(delta_dic**5) * 1e-10,
        )
        delta_pco2 = 0.0
        for i, dic_power in enumerate(dic_powers):
            coeff = (
                self.delta_ospp_offsets[i]
                + self.delta_ospp_coefficients[i] * self.sst_pi
            )
            delta_pco2 = delta_pco2 + coeff * dic_power
        return delta_pco2

    def ocean_pco2_value(self, delta_pco2_dic, delta_sst):
        if self.enable_temp_feedback:
            temp_factor = xm.exp(self.temp_sensitivity * delta_sst)
        else:
            temp_factor = 1.0
        return (self.pco2_pi + delta_pco2_dic) * temp_factor

    def dic_conversion_factor(self):
        return OCEAN_MICROMOL_PER_PPM_M3_PER_KG / (
            self.mixed_layer_depth * self.ocean_surface_area
        )

    def calculate_flux(self, pco2_atm, pco2_ocn):
        return self.gas_exchange_rate() * (pco2_atm - pco2_ocn)

    # -- engine selection ------------------------------------------------------

    def resolved_engine(self) -> str:
        """The convolution engine actually in use (resolves ``"auto"``)."""
        if self.engine == "auto":
            return (
                "expsum"
                if int(self.max_history_months) >= EXPSUM_AUTO_MIN_MONTHS
                else "ring"
            )
        if self.engine not in ("ring", "expsum"):
            raise ValueError(
                f"OceanCarbon.engine must be 'auto', 'ring' or 'expsum', "
                f"got {self.engine!r}"
            )
        return self.engine

    def expsum_young_months(self) -> int:
        """Length of the exactly-convolved young window (exp-sum engine):
        the IRF's early/late switch age plus two years, in whole years."""
        steps = int(self.steps_per_year)
        switch_months = int(np.ceil(float(self.irf_switch_time) * 12.0))
        switch_steps = int(np.ceil(switch_months / steps)) * steps
        return max(EXPSUM_YOUNG_MIN_MONTHS, switch_steps + 2 * steps)

    def _expsum_tables(self) -> dict:
        """Static exp-sum engine tables, fitted once per component.

        The *scaled* monthly IRF over ages >= the young window is fitted by
        least squares onto ``EXPSUM_TAIL_K`` fixed log-spaced decay
        timescales; ``fit_rel_error`` records the fit's max relative error.
        Tables are oldest-first (the year loop's layout, see
        :meth:`pack_scan_state`).
        """

        def fit():
            young = self.expsum_young_months()
            steps = int(self.steps_per_year)
            g = self.irf_table()
            if len(g) < young + steps:
                raise ValueError(
                    "expsum engine needs max_history_months >= "
                    f"{young + steps} (young window + one year of table)"
                )
            t_years = np.arange(young, len(g)) / 12.0
            taus = np.concatenate([np.geomspace(0.3, 800.0, EXPSUM_TAIL_K - 1), [1e10]])
            basis = np.exp(-t_years[:, None] / taus[None, :])
            coef, *_ = np.linalg.lstsq(basis, g[young:], rcond=None)
            fit_rel = float(np.max(np.abs(basis @ coef - g[young:]) / np.abs(g[young:])))
            q = np.exp(-1.0 / (12.0 * taus))  # per-month decay factors
            months = np.arange(1, steps + 1)
            slots = np.arange(steps)
            return dict(
                coef=coef,
                q=q,
                young=young,
                # S decays by a full year between updates
                q_steps=q**steps,
                # tail contribution at month m: (S · tail_eval)[m-1]
                tail_eval=coef[:, None] * q[:, None] ** months[None, :],
                # oldest-first young window: slot p holds the entry aged
                # young - 1 - p at year start (rows reversed)
                young_w_of=self._old_history_weights()[:young][::-1],
                # fold weight of the entry exiting from oldest-first slot j
                exit_w_of=q[:, None] ** (young + steps - 1 - slots[None, :]),
                fit_rel_error=fit_rel,
            )

        return self._cached("expsum", fit)

    def _old_history_weights(self) -> np.ndarray:
        """Static ``(N, steps)`` weights of the newest-first history: slot
        ``p`` is ``p+m`` months old at this year's month ``m`` (1-based), so
        ``W[p, m-1] = irf((p+m)/12)``; ages beyond the window hit a zero pad."""

        def weights():
            steps = int(self.steps_per_year)
            gpad = np.concatenate([self.irf_table(), np.zeros(steps)])
            p = np.arange(self.max_history_months)
            m = np.arange(1, steps + 1)
            return gpad[p[:, None] + m[None, :]]

        return self._cached("w_newest", weights)

    # -- internal state --------------------------------------------------------

    def create_initial_state(self):
        if self.resolved_engine() == "expsum":
            return {
                "flux_history": np.zeros(self.expsum_young_months()),
                "tail_accum": np.zeros(EXPSUM_TAIL_K),
            }
        return {"flux_history": np.zeros(self.max_history_months)}

    def migrate_internal_state(self, saved: dict) -> dict:
        """Convert a checkpoint saved under a different engine/window.

        Called by :meth:`Model.restore` when the saved state's schema does
        not match :meth:`create_initial_state` (the engine auto-resolution
        or ``max_history_months`` changed between save and restore).

        - ring -> expsum is exact up to the tail fit (~1e-9): the young
          window is the first ``Y`` ring slots, and every older entry
          folds into the tail accumulators with its age-in-months decay,
          ``S_k = sum_p f_p q_k^p``, the identity the engine's year-end
          fold maintains.
        - ring -> ring with a different window truncates or zero-pads
          (the semantic of changing the window).
        - expsum -> anything else raises: the aggregated tail cannot be
          expanded back into a per-month flux history.
        """
        if set(saved) != {"flux_history"}:
            raise ValueError(
                "OceanCarbon: cannot migrate a checkpoint saved under the "
                "exp-sum engine to a different configuration (the tail "
                "accumulator cannot be expanded back into a flux history); "
                "restore with the original engine/window parameters."
            )
        ring = np.asarray(saved["flux_history"], dtype=np.float64)
        if self.resolved_engine() == "ring":
            n = int(self.max_history_months)
            out = np.zeros(ring.shape[:-1] + (n,))
            m = min(n, ring.shape[-1])
            out[..., :m] = ring[..., :m]
            return {"flux_history": out}
        tabs = self._expsum_tables()
        young = tabs["young"]
        q = tabs["q"]
        fh = ring[..., :young]
        if fh.shape[-1] < young:
            pad = [(0, 0)] * (fh.ndim - 1) + [(0, young - fh.shape[-1])]
            fh = np.pad(fh, pad)
        ages = np.arange(young, ring.shape[-1])
        if len(ages):
            tail = ring[..., young:] @ (q[None, :] ** ages[:, None])
        else:
            tail = np.zeros(ring.shape[:-1] + (EXPSUM_TAIL_K,))
        return {"flux_history": np.ascontiguousarray(fh), "tail_accum": tail}

    # -- loop-layout hooks ------------------------------------------------------
    #
    # The host-visible flux history is newest-first.  Inside the year loop
    # the ring engine keeps it CIRCULAR (slot p holds the flux of absolute
    # month u with u ≡ p mod N), so a year writes its 12 new entries and
    # never shifts the (B, N) buffer; the exp-sum engine keeps its young
    # window oldest-first, so a year is one shift-append.  The program
    # converts once at entry and exit.

    def pack_scan_state(self, state, start_idx: int, dt=None):
        """Host (newest-first) -> loop layout, entering at ``start_idx``;
        the program hands the state over as tensors.

        Ring: slot ``p`` holds the month aged ``(c0 - 1 - p) mod n``
        relative to entry, ``c0 = start_idx * steps_per_year``, stored in
        ``history_dtype``.  Exp-sum: the young window flips to oldest-first
        (``"flux_hist_of"``).
        """
        out = self._to_loop_layout(state, start_idx)
        storage = _STORAGE_DTYPES[self.history_dtype]
        if self.resolved_engine() == "ring" and storage is not None:
            out["flux_history"] = out["flux_history"].to(storage)
        return out

    def unpack_scan_state(self, state, end_idx: int, dt=None):
        """Loop layout -> host (newest-first) after a run ending at
        ``end_idx``; a bfloat16 ring history comes back as float32, as in
        the TPU package."""
        out = self._to_host_layout(state, end_idx)
        if self.resolved_engine() == "ring" and _STORAGE_DTYPES[self.history_dtype] is not None:
            out["flux_history"] = out["flux_history"].to(torch.float32)
        return out

    def _to_loop_layout(self, state, start_idx: int):
        if self.resolved_engine() == "expsum":
            out = {k: v for k, v in state.items() if k != "flux_history"}
            out["flux_hist_of"] = state["flux_history"].flip(-1)
            return out
        n = int(self.max_history_months)
        c0 = int(start_idx) * int(self.steps_per_year)
        return {**state, "flux_history": _gather(state["flux_history"], (c0 - 1 - np.arange(n)) % n)}

    def _to_host_layout(self, state, end_idx: int):
        if self.resolved_engine() == "expsum":
            out = {k: v for k, v in state.items() if k != "flux_hist_of"}
            out["flux_history"] = state["flux_hist_of"].flip(-1)
            return out
        n = int(self.max_history_months)
        c_end = int(end_idx) * int(self.steps_per_year)
        return {**state, "flux_history": _gather(state["flux_history"], (c_end - 1 - np.arange(n)) % n)}

    # -- the batched yearly update ---------------------------------------------

    def _monthly_substeps(self, old_contrib, co2_atm, delta_sst,
                          pco2_initial, cumulative_initial, dt):
        """The twelve sequential monthly sub-steps for every member.

        ``old_contrib`` is ``(..., steps)``: the old history's contribution
        to each month's DIC.  This year's own fluxes enter through the
        lower-triangular ``G[m, j] = irf((m - j)/12)``, as in the TPU
        package's ``_monthly_substeps_scan``.  Returns ``(fluxes (B,
        steps), pco2, cumulative, total_flux)``, fluxes in month order.
        """
        steps = int(self.steps_per_year)
        like = pco2_initial
        b = like.shape[0]
        dtype = like.dtype
        g_new = self.irf_table()[:steps]
        gnp = np.zeros((steps, steps))
        for m in range(steps):
            gnp[m, : m + 1] = g_new[m::-1]
        G = self._device_table("G", gnp, dtype, like.device)
        oc = old_contrib.to(dtype)
        dt_month = dt / steps
        dic_factor = self.dic_conversion_factor()

        pco2 = pco2_initial
        cum = cumulative_initial
        tot = torch.zeros_like(like)
        fbuf = torch.zeros((b, steps), dtype=dtype, device=like.device)
        for m in range(steps):
            flux = self.calculate_flux(co2_atm, pco2)
            fbuf[:, m] = flux
            flux_gtc_yr = flux * 12.0 * PPM_TO_GTC
            tot = tot + flux_gtc_yr / steps
            cum = cum + flux_gtc_yr * dt_month
            new_part = fbuf @ G[m]
            delta_dic = (new_part + oc[..., m]) * dic_factor
            pco2 = self.ocean_pco2_value(self.delta_pco2_from_dic(delta_dic), delta_sst)
        return fbuf, pco2, cum, tot

    def _solve_ocean_circular(self, flux_history, co2_atm, delta_sst,
                              pco2_initial, cumulative_initial, dt, step_index):
        """Ring engine, one year on the circular buffer (no shift).

        The old-history product uses the newest-first weights rotated by
        the step index (member-independent); a bfloat16 history is read
        with bfloat16 weights and multiplied in float32.  The year's 12
        fluxes are written into their slots in place.
        """
        steps = int(self.steps_per_year)
        n = int(self.max_history_months)
        b = pco2_initial.shape[0]
        storage = flux_history.dtype
        compute = torch.float32 if storage == torch.bfloat16 else storage
        w_circ = self._cached(
            "w_circ", lambda: self._old_history_weights()[(-np.arange(n)) % n]
        )
        w_base = self._device_table("w_circ", w_circ, storage, flux_history.device)

        c = int(step_index) * steps
        weights = torch.roll(w_base, (c - 1) % n, dims=0)
        old_contrib = flux_history.to(compute) @ weights.to(compute)  # (..., steps)

        fluxes, pco2_ocn, cumulative, total_flux_gtc = self._monthly_substeps(
            old_contrib, co2_atm, delta_sst, pco2_initial, cumulative_initial, dt,
        )
        if flux_history.dim() == 1:  # first year: the shared history gains the member axis
            flux_history = flux_history.expand(b, n).clone()
        slots = torch.as_tensor((c + np.arange(steps)) % n, device=flux_history.device)
        flux_history[:, slots] = fluxes.to(storage)
        return flux_history, pco2_ocn, cumulative, total_flux_gtc

    def _solve_ocean_expsum_scan(self, fh_of, tail_accum, co2_atm, delta_sst,
                                 pco2_initial, cumulative_initial, dt):
        """Exp-sum engine, one year on the oldest-first young window: the
        young window convolved exactly, the tail from the accumulators, then
        the oldest ``steps`` entries fold into the tail and the year's
        fluxes are appended."""
        steps = int(self.steps_per_year)
        tabs = self._expsum_tables()
        dtype, device = pco2_initial.dtype, pco2_initial.device
        b = pco2_initial.shape[0]
        young_w_of = self._device_table("young_w_of", tabs["young_w_of"], dtype, device)
        tail_eval = self._device_table("tail_eval", tabs["tail_eval"], dtype, device)
        exit_w_of = self._device_table("exit_w_of", tabs["exit_w_of"], dtype, device)
        q_steps = self._device_table("q_steps", tabs["q_steps"], dtype, device)
        fh_of = torch.as_tensor(fh_of, dtype=dtype, device=device)
        tail_accum = torch.as_tensor(tail_accum, dtype=dtype, device=device)

        old_contrib = fh_of @ young_w_of + tail_accum @ tail_eval

        fluxes, pco2_ocn, cumulative, total_flux_gtc = self._monthly_substeps(
            old_contrib, co2_atm, delta_sst, pco2_initial, cumulative_initial, dt,
        )

        exiting = fh_of[..., :steps]  # the oldest entries leave the window
        tail_accum = tail_accum * q_steps + exiting @ exit_w_of.T
        kept = fh_of[..., steps:].expand(b, fh_of.shape[-1] - steps)
        fh_of = torch.cat([kept, fluxes], dim=-1)
        return fh_of, tail_accum.expand(b, -1), pco2_ocn, cumulative, total_flux_gtc

    def _solve_step(self, ctx, inputs, internal_state):
        """One year of the step-by-step executor: the year loop's update at
        one member, the host-layout state (newest-first history) turned
        into the loop layout before the year and back after it.  The
        history keeps the run's dtype, as the TPU package's host engines
        keep float64 whatever ``history_dtype`` says."""
        like = inputs.ocean_pco2.at_start()
        idx = int(ctx.step_index)
        state = self._to_loop_layout(
            state_to_tensors(internal_state, like.dtype, like.device), idx
        )
        outputs, state = self._solve_year(ctx, inputs, state)
        return outputs, state_to_host(self._to_host_layout(state, idx + 1), internal_state)

    def solve_ctx(self, ctx, inputs, internal_state):
        if not getattr(ctx, "scan_mode", False):
            return self._solve_step(ctx, inputs, internal_state)
        return self._solve_year(ctx, inputs, internal_state)

    def _solve_year(self, ctx, inputs, internal_state):
        """The yearly update on the loop-layout state."""
        dt = ctx.t_next - ctx.t_current
        co2 = inputs.co2_concentration.get()
        sst = inputs.sst.get()
        pco2_0 = inputs.ocean_pco2.at_start()
        cum_0 = inputs.cumulative_uptake.at_start()
        if self.resolved_engine() == "expsum":
            fh_of, tail, new_pco2, new_cumulative, flux = self._solve_ocean_expsum_scan(
                internal_state["flux_hist_of"], internal_state["tail_accum"],
                co2, sst, pco2_0, cum_0, dt,
            )
            new_state = {"flux_hist_of": fh_of, "tail_accum": tail}
        else:
            history, new_pco2, new_cumulative, flux = self._solve_ocean_circular(
                internal_state["flux_history"], co2, sst, pco2_0, cum_0, dt,
                ctx.step_index,
            )
            new_state = {"flux_history": history}
        return (
            self.Outputs(
                ocean_pco2=new_pco2,
                cumulative_uptake=new_cumulative,
                air_sea_flux=flux,
            ),
            new_state,
        )


def _gather(x, index):
    """``x[..., index]`` for a tensor and a host index array (a copy)."""
    return x[..., torch.as_tensor(index, device=x.device)]


OceanCarbonBuilder = make_builder(OceanCarbon)
