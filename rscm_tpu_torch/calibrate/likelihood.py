"""
Likelihood functions over model outputs.

Port of ``rscm_tpu/calibrate/likelihood.py`` (Gaussian ln-likelihood,
optional normalisation) with two evaluation paths:

- host: ``ln_likelihood(ModelOutput, Target)`` — dict-based, API parity;
- device: ``ln_likelihood_traced(trajectories, CompiledTarget)`` — a masked
  reduction over trajectory tensors that autograd differentiates, for one
  member or a leading batch of walkers.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .target import CompiledTarget, Observation, Target, VariableTarget

__all__ = ["VariableOutput", "ModelOutput", "LikelihoodFn", "GaussianLikelihood"]

_LN_2PI = math.log(2.0 * math.pi)


def _time_key(time: float) -> str:
    return f"{time:.6f}"


class VariableOutput:
    """Named variable output: time -> value map (host path)."""

    def __init__(self, name: str):
        self.name = name
        self.values: Dict[str, float] = {}

    def add(self, time: float, value: float) -> "VariableOutput":
        self.values[_time_key(time)] = value
        return self

    def get(self, time: float):
        return self.values.get(_time_key(time))


class ModelOutput:
    def __init__(self):
        self.variables: Dict[str, VariableOutput] = {}

    def add_variable(self, var: VariableOutput) -> "ModelOutput":
        self.variables[var.name] = var
        return self

    def get_variable(self, name: str):
        return self.variables.get(name)


class LikelihoodFn:
    def ln_likelihood(self, output: ModelOutput, target: Target) -> float:
        raise NotImplementedError


class GaussianLikelihood(LikelihoodFn):
    def __init__(self, normalize: bool = False):
        self.normalize = normalize

    @staticmethod
    def with_normalization() -> "GaussianLikelihood":
        return GaussianLikelihood(normalize=True)

    # -- host path ------------------------------------------------------------

    def _observation_ln_likelihood(self, obs: Observation, model_value: float) -> float:
        residual = obs.value - model_value
        ln_l = -0.5 * residual * residual / (obs.uncertainty * obs.uncertainty)
        if self.normalize:
            ln_l -= 0.5 * _LN_2PI + math.log(obs.uncertainty)
        return ln_l

    def _variable_ln_likelihood(self, var_output: VariableOutput, vt: VariableTarget):
        # Anomaly targets: subtract the model's reference-period mean so the
        # comparison is relative to the period (as the device path does)
        offset = 0.0
        if vt.reference_period is not None:
            start, end = vt.reference_period
            ref_vals = [
                v
                for k, v in var_output.values.items()
                if start - 1e-9 <= float(k) <= end + 1e-9
            ]
            if ref_vals:
                offset = float(np.mean(ref_vals))

        ln_l = 0.0
        for obs in vt.observations:
            model_value = var_output.get(obs.time)
            if model_value is None:
                raise ValueError(
                    f"Model output missing time {obs.time} for variable {vt.name}"
                )
            if not np.isfinite(model_value):
                raise ValueError(
                    f"Model output contains non-finite value for {vt.name} "
                    f"at time {obs.time}"
                )
            ln_l += self._observation_ln_likelihood(obs, model_value - offset)
        return ln_l

    def ln_likelihood(self, output: ModelOutput, target: Target) -> float:
        ln_l = 0.0
        for name, vt in target.variables.items():
            var_output = output.get_variable(name)
            if var_output is None:
                raise ValueError(f"Model output missing variable: {name}")
            ln_l += self._variable_ln_likelihood(var_output, vt)
        return ln_l

    # -- device path ----------------------------------------------------------

    def ln_likelihood_traced(self, trajectories: dict, compiled: CompiledTarget):
        """Likelihood from ``{var: (..., n_steps, n_regions)}`` tensors.

        A leading batch of walkers gives one value per walker; a single
        ``(n_steps, n_regions)`` (or ``(n_steps,)``) trajectory gives a 0-d
        tensor.  Non-finite model values yield ``-inf`` (failed runs are
        ``-inf`` posterior, ``ensemble.rs:163-167``).  Reference periods
        subtract the period mean (anomaly targets).
        """
        total = 0.0
        for name, spec in compiled.per_variable.items():
            traj = trajectories[name]
            like = dict(dtype=traj.dtype, device=traj.device)
            weights = spec.get("grid_weights")
            if traj.dim() == 1:
                series = traj
            elif weights is not None and traj.shape[-1] > 1:
                # grid variable: compare the area-weighted global aggregate
                # (SpatialGrid.aggregate_global semantics)
                series = traj @ torch.tensor(weights, **like)
            else:
                series = traj[..., 0]
            model_vals = series[..., torch.as_tensor(spec["indices"], device=traj.device)]
            if spec["reference_indices"] is not None:
                ref = torch.as_tensor(spec["reference_indices"], device=traj.device)
                model_vals = model_vals - series[..., ref].mean(-1, keepdim=True)
            sigmas = torch.as_tensor(spec["sigmas"], **like)
            resid = torch.as_tensor(spec["values"], **like) - model_vals
            ln_l = -0.5 * ((resid / sigmas) ** 2).sum(-1)
            if self.normalize:
                ln_l = ln_l - (0.5 * _LN_2PI + torch.log(sigmas)).sum()
            ln_l = torch.where(
                torch.isfinite(model_vals).all(-1), ln_l, torch.full_like(ln_l, -math.inf)
            )
            total = total + ln_l
        return total
