"""
Calibration setup for the full MAGICC coupled model.

Port of ``rscm_tpu/magicc/calibration.py``: the complete ten-component
MAGICC graph runs inside the posterior, its physical parameters swept per
walker, so the 1024-walker ensemble sampler and the gradient-based samplers
evaluate (and differentiate, through both CUDA kernels) the whole
chemistry -> forcing -> UDEB-climate -> carbon-cycle stack on the card.

:func:`magicc_calibration` wires a synthetic-truth experiment:

1. build the coupled model (:func:`rscm_tpu_torch.magicc.coupled.build_magicc_model`),
2. expose the requested physical parameters through a
   :class:`~rscm_tpu_torch.calibrate.CompiledModelRunner`,
3. run the model once at the known true parameter vector,
4. observe global-mean surface temperature, CO2 and CH4 concentrations and
   ocean heat content at regular intervals with Gaussian noise (numpy,
   the same draws as the JAX package from the same seed),
5. return everything a sampler needs (runner, priors, target, truth).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rscm_tpu_torch.calibrate import (
    CompiledModelRunner,
    GaussianLikelihood,
    ParameterSet,
    Target,
    Uniform,
)

__all__ = ["MAGICC_PARAM_SPECS", "MagiccCalibration", "magicc_calibration"]


# name -> (model target "Component.param", prior (lo, hi), synthetic truth).
# Eight physical parameters spanning every major subsystem: climate response
# (ECS, ocean diffusivity, land/ocean warming ratio), the terrestrial carbon
# cycle (CO2 fertilization, respiration temperature sensitivity), ocean
# carbon uptake, CH4 chemistry, and aerosol forcing.
MAGICC_PARAM_SPECS: Dict[str, Tuple[str, Tuple[float, float], float]] = {
    "ecs": ("ClimateUDEB.ecs", (1.5, 6.0), 3.4),
    "kappa": ("ClimateUDEB.kappa", (0.3, 2.0), 0.7),
    "rlo": ("ClimateUDEB.rlo", (1.0, 1.6), 1.25),
    "beta": ("TerrestrialCarbon.beta", (0.2, 1.2), 0.45),
    "resp_temp_sensitivity": (
        "TerrestrialCarbon.resp_temp_sensitivity",
        (0.0, 0.15),
        0.095,
    ),
    "gas_exchange_scale": ("OceanCarbon.gas_exchange_scale", (0.8, 3.0), 2.3),
    "tau_oh": ("CH4Chemistry.tau_oh", (7.0, 12.0), 10.2),
    "cloud_albedo": (
        "AerosolIndirect.cloud_albedo_coefficient",
        (-2.0, 0.0),
        -0.55,
    ),
}

# observed variables and their observation noise.  Ocean Heat Content breaks
# the ECS / ocean-diffusivity (kappa) degeneracy that surface temperature
# alone leaves (the JAX package's measurement: an 8-parameter MAP without
# OHC lands at ecs 4.25 / kappa 1.93 for truth 3.4 / 0.7).
_OBSERVABLES = {
    "Surface Temperature": 0.05,  # K, global mean of the FourBox output
    "Atmospheric Concentration|CO2": 1.0,  # ppm
    "Atmospheric Concentration|CH4": 10.0,  # ppb
    "Ocean Heat Content": 5.0e7,  # J/m^2 (~2% of the 1950 signal)
}


@dataclass
class MagiccCalibration:
    """Everything a sampler needs for the synthetic-truth experiment."""

    runner: CompiledModelRunner
    params: ParameterSet
    target: Target
    likelihood: GaussianLikelihood
    theta_true: np.ndarray
    param_names: List[str]
    truth_trajectories: Dict[str, np.ndarray] = field(repr=False, default=None)


def magicc_calibration(
    years: Optional[np.ndarray] = None,
    param_names: Optional[List[str]] = None,
    obs_interval: int = 10,
    seed: int = 1234,
    model_kwargs: Optional[dict] = None,
    observe: Optional[Dict[str, float]] = None,
    device=None,
    dtype=torch.float64,
) -> MagiccCalibration:
    """Build the synthetic-truth MAGICC calibration problem, on the CUDA
    card unless ``device`` says otherwise.

    ``param_names`` selects a subset of :data:`MAGICC_PARAM_SPECS` (default:
    all eight).  Observations are drawn every ``obs_interval`` years from
    the model run at the true parameter vector, with per-variable Gaussian
    noise; temperature targets the area-weighted global mean of the FourBox
    output (the Target.compile grid-weights path).  The ocean carbon flux
    history is kept in bfloat16 unless ``model_kwargs`` says otherwise.
    """
    from rscm_tpu_torch.magicc.coupled import build_magicc_model

    if param_names is None:
        param_names = list(MAGICC_PARAM_SPECS)
    unknown = [n for n in param_names if n not in MAGICC_PARAM_SPECS]
    if unknown:
        raise KeyError(f"unknown MAGICC calibration parameters: {unknown}")
    if years is None:
        years = np.arange(1850.0, 2101.0)
    years = np.asarray(years, dtype=np.float64)
    observe = dict(_OBSERVABLES if observe is None else observe)

    kwargs = dict(model_kwargs or {})
    # production memory mode unless the caller overrides
    kwargs.setdefault("ocean_params", {"history_dtype": "bfloat16"})
    model = build_magicc_model(years=years, **kwargs)

    runner = CompiledModelRunner(
        model,
        param_map={n: MAGICC_PARAM_SPECS[n][0] for n in param_names},
        output_variables=list(observe),
        dtype=dtype,
        device=device,
    )

    params = ParameterSet()
    theta_true = []
    for name in param_names:
        _, (lo, hi), truth = MAGICC_PARAM_SPECS[name]
        params.add(name, Uniform(lo, hi))
        theta_true.append(truth)
    theta_true = np.asarray(theta_true, dtype=np.float64)

    # synthetic truth: one forward run at theta_true
    with torch.no_grad():
        truth_trajs = {
            k: v.to(torch.float64).cpu().numpy()
            for k, v in runner.trajectories_fn()(theta_true).items()
        }

    rng = np.random.default_rng(seed)
    target = Target()
    # first observation after one interval (index 0 is the initial-value
    # slot; early spin-up years carry little signal anyway)
    obs_idx = np.arange(obs_interval, len(years), obs_interval)
    for var, sigma in observe.items():
        traj = truth_trajs[var]
        if traj.ndim == 2 and traj.shape[1] > 1:
            weights = np.asarray(
                model.collection.get_data(var).grid.weights, dtype=np.float64
            )
            series = traj @ weights
        else:
            series = traj[:, 0] if traj.ndim == 2 else traj
        vt = target.add_variable(var)
        for i in obs_idx:
            vt.add(
                float(years[i]),
                float(series[i] + rng.normal(0.0, sigma)),
                sigma,
            )

    return MagiccCalibration(
        runner=runner,
        params=params,
        target=target,
        likelihood=GaussianLikelihood(),
        theta_true=theta_true,
        param_names=list(param_names),
        truth_trajectories=truth_trajs,
    )
