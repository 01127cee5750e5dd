"""
Ordered name -> prior map with random and Latin Hypercube sampling.

Port of ``rscm_tpu/calibrate/parameter_set.py``.  The joint ``log_prior``
is vectorisable (works on (D,) and (B, D) arrays or tensors), so it slots
directly into the posterior of a batch of walkers on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .distribution import Distribution

__all__ = ["ParameterSet"]


class ParameterSet:
    def __init__(self, parameters: Optional[Dict[str, Distribution]] = None):
        self.parameters: Dict[str, Distribution] = dict(parameters or {})

    @staticmethod
    def from_map(parameters: Dict[str, Distribution]) -> "ParameterSet":
        return ParameterSet(parameters)

    def add(self, name: str, distribution: Distribution) -> "ParameterSet":
        self.parameters[name] = distribution
        return self

    class _CallableList(list):
        """List that is also callable — the reference exposes
        ``param_names`` as an attribute; this engine's internals call it."""

        def __call__(self):
            return list(self)

    @property
    def param_names(self) -> "ParameterSet._CallableList":
        return ParameterSet._CallableList(self.parameters)

    def __len__(self) -> int:
        return len(self.parameters)

    def is_empty(self) -> bool:
        return not self.parameters

    # -- sampling ------------------------------------------------------------

    def sample_random(self, n: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng if rng is not None else np.random.default_rng()
        out = np.empty((n, len(self)))
        # per-parameter draws in order, as the JAX package makes them, so a
        # seed gives the same walkers in both packages
        for j, dist in enumerate(self.parameters.values()):
            out[:, j] = dist.sample_n(n, rng)
        return out

    def sample_lhs(self, n: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Latin Hypercube: stratified quantiles, shuffled per parameter."""
        rng = rng if rng is not None else np.random.default_rng()
        out = np.empty((n, len(self)))
        for j, dist in enumerate(self.parameters.values()):
            stratified = (np.arange(n) + rng.random(n)) / n
            rng.shuffle(stratified)
            out[:, j] = [dist.ppf(float(u)) for u in stratified]
        return out

    def sample_torch(self, generator: torch.Generator, n: int, dtype=torch.float64):
        """Device prior sampling: ``(n, D)`` on the generator's device, one
        parameter's column after another from the same generator."""
        cols = [dist.sample_torch(generator, (n,), dtype) for dist in self.parameters.values()]
        return torch.stack(cols, dim=-1)

    # -- density / bounds -----------------------------------------------------

    def log_prior(self, params):
        """Joint log-prior of a (D,) vector or (..., D) batch (a tensor
        gives a tensor, anything else numpy)."""
        if not isinstance(params, torch.Tensor):
            params = np.asarray(params)
        if params.shape[-1] != len(self):
            raise ValueError(
                f"Parameter vector length {params.shape[-1]} does not match "
                f"parameter set size {len(self)}"
            )
        total = 0.0
        for j, dist in enumerate(self.parameters.values()):
            total = total + dist.ln_pdf(params[..., j])
        return total

    def bounds(self):
        lower, upper = [], []
        for dist in self.parameters.values():
            b = dist.bounds()
            if b is None:
                lower.append(-np.inf)
                upper.append(np.inf)
            else:
                lower.append(b[0])
                upper.append(b[1])
        return (lower, upper)

    # -- serialisation --------------------------------------------------------

    def to_dict(self) -> dict:
        return {name: dist.to_dict() for name, dist in self.parameters.items()}

    @staticmethod
    def from_dict(d: dict) -> "ParameterSet":
        return ParameterSet(
            {name: Distribution.from_dict(spec) for name, spec in d.items()}
        )

    def __repr__(self):
        return f"ParameterSet({self.parameters})"
