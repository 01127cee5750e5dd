"""
Prior distributions: Uniform, Normal, LogNormal, Bound.

Port of ``rscm_tpu/calibrate/distribution.py``.  Each distribution supports
host sampling (numpy Generator, the same draws as the JAX package from the
same seed), device sampling from a ``torch.Generator`` (where the JAX
package draws from a ``jax.random`` key), and a vectorisable ``ln_pdf``
that works on floats, numpy arrays and tensors alike.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Distribution", "Uniform", "Normal", "LogNormal", "Bound"]

_LN_2PI = math.log(2.0 * math.pi)


def _where(pred, on_true, on_false, x):
    """``where`` in the mode of ``x``: a tensor of ``x``'s dtype and device,
    or a numpy value."""
    if isinstance(x, torch.Tensor):
        like = dict(dtype=x.dtype, device=x.device)
        return torch.where(pred, torch.as_tensor(on_true, **like), torch.as_tensor(on_false, **like))
    out = np.where(pred, on_true, on_false)
    return out[()] if out.ndim == 0 else out


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


def _uniform(generator, shape, dtype, device):
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


class Distribution:
    """Base prior distribution."""

    def sample(self, rng: Optional[np.random.Generator] = None) -> float:
        rng = rng if rng is not None else np.random.default_rng()
        return float(self.sample_n(1, rng)[0])

    def sample_n(self, n: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def sample_torch(self, generator: torch.Generator, shape=(), dtype=torch.float64):
        """Device sampling from a ``torch.Generator`` (on the generator's
        device)."""
        raise NotImplementedError

    def ln_pdf(self, x):
        raise NotImplementedError

    def bounds(self) -> Optional[Tuple[float, float]]:
        return None

    def ppf(self, u: float) -> float:
        """Quantile function (used by Latin Hypercube sampling)."""
        raise NotImplementedError

    # serialisation
    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Distribution":
        kind = d["type"]
        if kind == "Uniform":
            return Uniform(d["low"], d["high"])
        if kind == "Normal":
            return Normal(d["mean"], d["std_dev"])
        if kind == "LogNormal":
            return LogNormal(d["mu"], d["sigma"])
        if kind == "Bound":
            return Bound(Distribution.from_dict(d["distribution"]), d["low"], d["high"])
        raise ValueError(f"Unknown distribution type {kind}")


class Uniform(Distribution):
    def __init__(self, low: float, high: float):
        if low >= high:
            raise ValueError(f"Uniform: low ({low}) must be less than high ({high})")
        self.low = float(low)
        self.high = float(high)

    def sample_n(self, n, rng):
        return self.low + rng.random(n) * (self.high - self.low)

    def sample_torch(self, generator, shape=(), dtype=torch.float64):
        u = _uniform(generator, shape, dtype, generator.device)
        return self.low + u * (self.high - self.low)

    def ln_pdf(self, x):
        inside = -math.log(self.high - self.low)
        return _where((x < self.low) | (x > self.high), -np.inf, inside, x)

    def bounds(self):
        return (self.low, self.high)

    def ppf(self, u):
        return self.low + u * (self.high - self.low)

    def to_dict(self):
        return {"type": "Uniform", "low": self.low, "high": self.high}

    def __repr__(self):
        return f"Uniform({self.low}, {self.high})"


class Normal(Distribution):
    def __init__(self, mean: float, std_dev: float):
        if std_dev <= 0.0:
            raise ValueError(f"Normal: std_dev ({std_dev}) must be positive")
        self.mean = float(mean)
        self.std_dev = float(std_dev)

    def sample_n(self, n, rng):
        return rng.normal(self.mean, self.std_dev, n)

    def sample_torch(self, generator, shape=(), dtype=torch.float64):
        return self.mean + self.std_dev * _normal(generator, shape, dtype, generator.device)

    def ln_pdf(self, x):
        z = (x - self.mean) / self.std_dev
        return -0.5 * z * z - math.log(self.std_dev) - 0.5 * _LN_2PI

    def ppf(self, u):
        return self.mean + self.std_dev * _ndtri(u)

    def to_dict(self):
        return {"type": "Normal", "mean": self.mean, "std_dev": self.std_dev}

    def __repr__(self):
        return f"Normal({self.mean}, {self.std_dev})"


class LogNormal(Distribution):
    def __init__(self, mu: float = None, sigma: float = None, *, mean=None, std=None):
        if mean is not None or std is not None:
            # reference keyword style: LogNormal(mean=..., std=...)
            if mu is not None or sigma is not None:
                raise ValueError("pass either (mu, sigma) or (mean=, std=)")
            other = LogNormal.from_mean_std(mean, std)
            mu, sigma = other.mu, other.sigma
        if sigma <= 0.0:
            raise ValueError(f"LogNormal: sigma ({sigma}) must be positive")
        self.mu = float(mu)
        self.sigma = float(sigma)

    @staticmethod
    def from_mean_std(mean: float, std_dev: float) -> "LogNormal":
        if mean <= 0.0:
            raise ValueError(f"LogNormal: mean ({mean}) must be positive")
        if std_dev <= 0.0:
            raise ValueError(f"LogNormal: std_dev ({std_dev}) must be positive")
        sigma_sq = math.log(std_dev**2 / mean**2 + 1.0)
        mu = math.log(mean) - 0.5 * sigma_sq
        return LogNormal(mu, math.sqrt(sigma_sq))

    def sample_n(self, n, rng):
        return rng.lognormal(self.mu, self.sigma, n)

    def sample_torch(self, generator, shape=(), dtype=torch.float64):
        return torch.exp(self.mu + self.sigma * _normal(generator, shape, dtype, generator.device))

    def ln_pdf(self, x):
        safe_x = _where(x > 0.0, x, 1.0, x)
        ln_x = _log(safe_x)
        z = (ln_x - self.mu) / self.sigma
        val = -0.5 * z * z - ln_x - math.log(self.sigma) - 0.5 * _LN_2PI
        return _where(x <= 0.0, -np.inf, val, x)

    def ppf(self, u):
        return math.exp(self.mu + self.sigma * _ndtri(u))

    def to_dict(self):
        return {"type": "LogNormal", "mu": self.mu, "sigma": self.sigma}

    def __repr__(self):
        return f"LogNormal(mu={self.mu}, sigma={self.sigma})"


class Bound(Distribution):
    """Truncate another distribution to [low, high].

    The log-pdf is unnormalised inside the bounds (mirror of the
    reference's comment: normalisation doesn't affect MCMC).
    """

    def __init__(self, distribution: Distribution, low: float, high: float):
        if low >= high:
            raise ValueError(f"Bound: low ({low}) must be less than high ({high})")
        self.distribution = distribution
        self.low = float(low)
        self.high = float(high)

    def sample_n(self, n, rng):
        out = np.empty(n)
        filled = 0
        while filled < n:
            draw = self.distribution.sample_n(n, rng)
            ok = draw[(draw >= self.low) & (draw <= self.high)]
            take = min(len(ok), n - filled)
            out[filled : filled + take] = ok[:take]
            filled += take
        return out

    def sample_torch(self, generator, shape=(), dtype=torch.float64):
        # clipped draw, as the JAX package's traced sampler: used only for
        # walker initialisation, not for posterior maths
        return torch.clamp(self.distribution.sample_torch(generator, shape, dtype),
                           self.low, self.high)

    def ln_pdf(self, x):
        inner = self.distribution.ln_pdf(x)
        return _where((x < self.low) | (x > self.high), -np.inf, inner, x)

    def bounds(self):
        return (self.low, self.high)

    def ppf(self, u):
        # approximate: clip the inner quantile
        return min(max(self.distribution.ppf(u), self.low), self.high)

    def to_dict(self):
        return {
            "type": "Bound",
            "distribution": self.distribution.to_dict(),
            "low": self.low,
            "high": self.high,
        }

    def __repr__(self):
        return f"Bound({self.distribution!r}, {self.low}, {self.high})"


def _ndtri(u: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation)."""
    if not 0.0 < u < 1.0:
        raise ValueError("u must be in (0, 1)")
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    p_low = 0.02425
    if u < p_low:
        q = math.sqrt(-2.0 * math.log(u))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        )
    if u > 1.0 - p_low:
        q = math.sqrt(-2.0 * math.log(1.0 - u))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        )
    q = u - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
        ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    )
