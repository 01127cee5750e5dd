"""
Point estimation (MAP / maximum-likelihood) with pluggable optimizers.

Port of ``rscm_tpu/calibrate/point_estimator.py``: :class:`PointEstimator`
evaluates log-posteriors and tracks the evaluation history;
:class:`RandomSearch` matches the reference's only optimizer (same numpy
draws from the same seed); :class:`AdamOptimizer` and
:class:`LBFGSOptimizer` optimise through the model with gradients that
flow through the year loop and both CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

import numpy as np
import torch

from .gradients import value_and_grad
from .likelihood import GaussianLikelihood, LikelihoodFn
from .model_runner import CompiledModelRunner, ModelRunner
from .parameter_set import ParameterSet
from .target import Target

__all__ = [
    "EstimateKind",
    "PointEstimate",
    "PointEstimator",
    "Optimizer",
    "RandomSearch",
    "AdamOptimizer",
    "LBFGSOptimizer",
]


class EstimateKind(Enum):
    MAP = "MAP"  # maximise prior + likelihood
    ML = "ML"  # maximise likelihood only


@dataclass
class PointEstimate:
    best_params: List[float]
    best_log_likelihood: float
    best_log_posterior: float
    n_evaluations: int
    converged: bool


def _check_dispatch_chunk(dispatch_chunk):
    """The JAX package's validation of ``dispatch_chunk`` (an integer >= 1)."""
    if dispatch_chunk is None:
        return None
    if isinstance(dispatch_chunk, bool) or not (
        isinstance(dispatch_chunk, (int, np.integer))
        or (isinstance(dispatch_chunk, float) and dispatch_chunk == int(dispatch_chunk))
    ):
        raise TypeError(f"dispatch_chunk must be an integer, got {dispatch_chunk!r}")
    if dispatch_chunk < 1:
        raise ValueError(f"dispatch_chunk must be >= 1, got {dispatch_chunk}")
    return int(dispatch_chunk)


def _midpoint(lower, upper):
    return [
        (lo + hi) / 2.0 if np.isfinite(lo) and np.isfinite(hi) else 0.0
        for lo, hi in zip(lower, upper)
    ]


class PointEstimator:
    def __init__(
        self,
        params: ParameterSet,
        runner: ModelRunner,
        likelihood: LikelihoodFn,
        target: Target,
    ):
        self.params = params
        self.runner = runner
        self.likelihood = likelihood
        self.target = target
        self._evaluated_params: List[List[float]] = []
        self._evaluated_log_likelihoods: List[float] = []

    # reference API: counts/names are attributes, history via methods
    @property
    def n_params(self) -> int:
        return len(self.params)

    @property
    def param_names(self) -> list:
        return self.params.param_names()

    @property
    def n_evaluations(self) -> int:
        return len(self._evaluated_params)

    def evaluated_params(self) -> list:
        return list(self._evaluated_params)

    def evaluated_log_likelihoods(self) -> list:
        return list(self._evaluated_log_likelihoods)

    def clear_history(self) -> None:
        self._evaluated_params.clear()
        self._evaluated_log_likelihoods.clear()

    def best(self):
        """(params, log_likelihood) of the best finite evaluation, or None."""
        if not self._evaluated_params:
            return None
        lls = np.asarray(self._evaluated_log_likelihoods, dtype=float)
        if not np.any(np.isfinite(lls)):
            return None
        i = int(np.nanargmax(np.where(np.isfinite(lls), lls, -np.inf)))
        return list(self._evaluated_params[i]), float(lls[i])

    def bounds(self):
        return self.params.bounds()

    def evaluate(self, theta) -> float:
        theta = list(np.asarray(theta, dtype=np.float64))

        def record(ll):
            self._evaluated_params.append(theta)
            self._evaluated_log_likelihoods.append(ll)

        try:
            log_prior = float(self.params.log_prior(np.asarray(theta)))
        except Exception:
            record(-np.inf)
            return -np.inf
        if not np.isfinite(log_prior):
            record(-np.inf)
            return -np.inf
        try:
            output = self.runner.run(theta)
            log_likelihood = float(self.likelihood.ln_likelihood(output, self.target))
        except Exception:
            record(-np.inf)
            return -np.inf
        record(log_likelihood)
        return log_prior + log_likelihood

    # -- the objective on tensors (gradient path) --------------------------------

    def _traced_objective(self, kind: EstimateKind):
        """Negative log posterior (or likelihood) of a ``(D,)`` vector or a
        ``(B, D)`` batch, on tensors; None without a CompiledModelRunner and
        a GaussianLikelihood."""
        if not isinstance(self.runner, CompiledModelRunner):
            return None
        if not isinstance(self.likelihood, GaussianLikelihood):
            return None
        compiled_target = self.target.compile(
            self.runner.model.time_axis, self.runner.model.collection
        )
        traj_fn = self.runner.trajectories_fn()
        likelihood = self.likelihood
        params = self.params

        def negative_log_prob(theta):
            ll = likelihood.ln_likelihood_traced(traj_fn(theta), compiled_target)
            if kind is EstimateKind.MAP:
                ll = ll + params.log_prior(theta)
            return -ll

        return negative_log_prob

    def laplace_covariance(self, theta, rel_step: float = 1e-4):
        """Laplace-approximation covariance ``H(theta)^-1`` at a MAP point.

        The Hessian of the negative log posterior is built from central
        finite differences of the forward-mode gradient, as in the JAX
        package: the ``2 D`` perturbed points run as one batched gradient
        evaluation.

        Degenerate directions are handled for the init use case: the
        Hessian is symmetrized, eigenvalues are floored at a curvature
        corresponding to a std of 1/4 of the prior span (flat posterior
        directions otherwise invert to near-infinite variance), and the
        per-dimension std is capped at 1/4 span.  Use with
        :meth:`WalkerInit.gaussian <rscm_tpu_torch.calibrate.sampler.WalkerInit.gaussian>`.
        """
        objective = self._traced_objective(EstimateKind.MAP)
        if objective is None:
            raise ValueError("laplace_covariance requires a CompiledModelRunner")
        theta = np.asarray(theta, dtype=np.float64)
        d = theta.shape[0]

        lower, upper = map(np.asarray, self.bounds())
        span = np.where(np.isfinite(upper - lower), upper - lower, 1.0)
        h = rel_step * span
        # Copied from the JAX package with its fault (ADVICE.md, "Finite
        # differences outside the prior"): theta +- h is not clipped to the
        # prior's support, so a MAP point within h of a bound evaluates a
        # point outside it.
        steps = np.diag(h)
        points = np.concatenate([theta + steps, theta - steps])  # (2D, D)
        _, grads = value_and_grad(objective, self.runner.as_theta(points), "fwd")
        grads = grads.to(torch.float64).cpu().numpy()
        hess = (grads[:d] - grads[d:]) / (2.0 * h[:, None])
        hess = 0.5 * (hess + hess.T)

        # scale-free eigen-floor: work in span units so one badly-scaled
        # parameter cannot dominate the spectrum
        scale = np.diag(span)
        hess_u = scale @ hess @ scale  # curvature per unit span
        eigval, eigvec = np.linalg.eigh(hess_u)
        floor = 1.0 / (0.25**2)  # std of 1/4 span in span units
        eigval = np.maximum(eigval, floor)
        cov_u = (eigvec / eigval) @ eigvec.T
        cov = scale @ cov_u @ scale
        # cap per-dimension std at 1/4 of the prior span
        std = np.sqrt(np.diag(cov))
        shrink = np.minimum(1.0, (0.25 * span) / np.maximum(std, 1e-300))
        return cov * np.outer(shrink, shrink)

    def optimize(self, optimizer: "Optimizer", n_samples=None, **kwargs) -> PointEstimate:
        """Run an optimizer; accepts the reference's positional
        ``optimize(Optimizer.RandomSearch, n_samples)`` calling style."""
        if isinstance(optimizer, type):
            optimizer = optimizer()
        if n_samples is not None:
            kwargs["n_samples"] = n_samples
        return optimizer.optimize(self, **kwargs)


class Optimizer:
    @staticmethod
    def random_search(seed=None) -> "RandomSearch":
        """Reference-style factory: ``Optimizer.random_search()``."""
        return RandomSearch(seed)

    def optimize(self, estimator: PointEstimator, **kwargs) -> PointEstimate:
        raise NotImplementedError


class RandomSearch(Optimizer):
    """Uniform sampling within the prior bounds (reference parity)."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = seed

    def optimize(self, estimator: PointEstimator, n_samples: int = 100) -> PointEstimate:
        rng = np.random.default_rng(self.seed)
        lower, upper = estimator.bounds()
        lower = np.asarray(lower)
        upper = np.asarray(upper)
        finite = np.isfinite(lower) & np.isfinite(upper)
        span_low = np.where(finite, lower, -10.0)
        span_high = np.where(finite, upper, 10.0)

        best_params = None
        best_log_posterior = -np.inf
        best_log_likelihood = -np.inf
        for _ in range(n_samples):
            theta = span_low + rng.random(len(lower)) * (span_high - span_low)
            log_posterior = estimator.evaluate(theta)
            if log_posterior > best_log_posterior:
                best_log_posterior = log_posterior
                best_log_likelihood = estimator._evaluated_log_likelihoods[-1]
                best_params = list(theta)
        if best_params is None:
            raise RuntimeError("Random search found no valid samples")
        return PointEstimate(
            best_params, best_log_likelihood, best_log_posterior, n_samples, True
        )


class AdamOptimizer(Optimizer):
    """Gradient descent on the negative log posterior with Adam (optax's
    update: b1 0.9, b2 0.999, eps 1e-8), a step loop on the device.

    Gradients use batched forward mode up to ``fwd_threshold`` parameters
    (the D tangent directions ride as D members of one run) and reverse
    mode above it, as in the JAX package.  Non-finite gradient entries are
    zeroed; iterates are clipped just inside the prior bounds so a step
    cannot leave the support (-inf walls make gradients vanish); the best
    iterate so far is kept, and the final iterate is checked against it.

    ``dispatch_chunk`` is validated as in the JAX package, where it caps
    the gradient steps in one device program to fence a TPU-worker fault;
    the port runs one step at a time and the argument changes nothing.
    """

    def __init__(self, learning_rate: float = 0.05, n_steps: int = 200,
                 kind: EstimateKind = EstimateKind.MAP,
                 fwd_threshold: int = 32,
                 dispatch_chunk: Optional[int] = None):
        self.learning_rate = learning_rate
        self.n_steps = n_steps
        self.kind = kind
        self.fwd_threshold = int(fwd_threshold)
        self.dispatch_chunk = _check_dispatch_chunk(dispatch_chunk)

    def optimize(self, estimator: PointEstimator, x0=None) -> PointEstimate:
        objective = estimator._traced_objective(self.kind)
        if objective is None:
            raise ValueError("Gradient optimisation requires a CompiledModelRunner")
        runner = estimator.runner

        lower, upper = estimator.bounds()
        lower = np.asarray(lower, dtype=np.float64)
        upper = np.asarray(upper, dtype=np.float64)
        if x0 is None:
            x0 = _midpoint(lower, upper)
        theta = runner.as_theta(np.asarray(x0, dtype=np.float64))
        d = theta.shape[0]
        # clip just inside the support: the prior is -inf outside, and ON
        # a bound a one-sided density can still be degenerate
        span = np.where(np.isfinite(upper - lower), upper - lower, 1.0)
        lo_clip = runner.as_theta(np.where(np.isfinite(lower), lower + 1e-9 * span, -np.inf))
        hi_clip = runner.as_theta(np.where(np.isfinite(upper), upper - 1e-9 * span, np.inf))
        mode = "fwd" if d <= self.fwd_threshold else "rev"

        b1, b2, eps = 0.9, 0.999, 1e-8
        mu = torch.zeros_like(theta)
        nu = torch.zeros_like(theta)
        best_theta = theta
        best_value = torch.full((), np.inf, dtype=theta.dtype, device=theta.device)
        for count in range(1, self.n_steps + 1):
            value, grads = value_and_grad(objective, theta[None], mode)
            value, grads = value[0], grads[0]
            grads = torch.where(torch.isfinite(grads), grads, torch.zeros_like(grads))
            better = value < best_value
            best_theta = torch.where(better, theta, best_theta)
            best_value = torch.where(better, value, best_value)
            mu = (1 - b1) * grads + b1 * mu
            nu = (1 - b2) * grads**2 + b2 * nu
            mu_hat = mu / (1 - b1**count)
            nu_hat = nu / (1 - b2**count)
            theta = theta + -self.learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps))
            theta = torch.minimum(torch.maximum(theta, lo_clip), hi_clip)

        # the final iterate may beat every recorded best
        with torch.no_grad():
            final_value = objective(theta)
        better = final_value < best_value
        best_theta = torch.where(better, theta, best_theta)
        best_value = float(torch.where(better, final_value, best_value))

        best_theta = best_theta.to(torch.float64).cpu().numpy()
        final = estimator.evaluate(best_theta)
        return PointEstimate(
            list(best_theta),
            estimator._evaluated_log_likelihoods[-1],
            final,
            self.n_steps,
            bool(np.isfinite(best_value)),
        )


class LBFGSOptimizer(Optimizer):
    """Quasi-Newton optimisation through the model:
    ``scipy.optimize.minimize(method="BFGS")`` with reverse-mode gradients
    (the JAX package runs ``jax.scipy.optimize.minimize``, BFGS)."""

    def __init__(self, n_steps: int = 100, kind: EstimateKind = EstimateKind.MAP):
        self.n_steps = n_steps
        self.kind = kind

    def optimize(self, estimator: PointEstimator, x0=None) -> PointEstimate:
        from scipy.optimize import minimize

        objective = estimator._traced_objective(self.kind)
        if objective is None:
            raise ValueError("Gradient optimisation requires a CompiledModelRunner")
        runner = estimator.runner
        if x0 is None:
            x0 = _midpoint(*estimator.bounds())

        def fun(x):
            value, grad = value_and_grad(objective, runner.as_theta(x[None]), "rev")
            return float(value[0]), grad[0].to(torch.float64).cpu().numpy()

        result = minimize(fun, np.asarray(x0, dtype=np.float64), jac=True, method="BFGS",
                          options={"maxiter": self.n_steps})
        theta = np.asarray(result.x, dtype=np.float64)
        final = estimator.evaluate(theta)
        return PointEstimate(
            list(theta),
            estimator._evaluated_log_likelihoods[-1],
            final,
            int(result.nit) if hasattr(result, "nit") else self.n_steps,
            bool(result.success),
        )
