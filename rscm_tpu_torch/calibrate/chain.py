"""
MCMC chain storage, thinning, persistence, merging, and diagnostics.

Port of ``rscm_tpu/calibrate/chain.py`` (host numpy, copied as it is, so a
chain file of either package loads in the other).  Mirror of
``crates/rscm-calibrate/src/sampler/chain.rs`` (storage/thinning,
save/load, merge) and ``diagnostics.rs`` (split-chain Gelman-Rubin R-hat,
autocorrelation-based ESS, integrated autocorrelation time).  Persistence
uses ``.npz`` instead of postcard, with the same 1 GiB cap.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

__all__ = ["Chain"]

MAX_CHAIN_BYTES = 1 << 30  # 1 GiB cap (chain.rs:218-230)


class Chain:
    def __init__(self, param_names: List[str], thin: int = 1):
        self.samples: List[np.ndarray] = []  # each (n_walkers, n_params)
        self.log_probs: List[np.ndarray] = []  # each (n_walkers,)
        self.param_names = list(param_names)
        self.thin = max(int(thin), 1)
        self.total_iterations = 0

    def push(self, positions: np.ndarray, log_probs: np.ndarray) -> bool:
        self.total_iterations += 1
        if self.total_iterations % self.thin == 0:
            self.samples.append(np.asarray(positions, dtype=np.float64).copy())
            self.log_probs.append(np.asarray(log_probs, dtype=np.float64).copy())
            return True
        return False

    def push_stacked(self, positions: np.ndarray, log_probs: np.ndarray):
        """Push a whole (n_iter, n_walkers, n_params) block (device sampler)."""
        for pos, lp in zip(positions, log_probs):
            self.push(pos, lp)

    def __len__(self) -> int:
        return len(self.samples)

    def is_empty(self) -> bool:
        return not self.samples

    @property
    def n_walkers(self) -> int:
        return self.samples[0].shape[0] if self.samples else 0

    # -- access ----------------------------------------------------------------

    def flat_samples(self, discard: int = 0) -> np.ndarray:
        if self.is_empty() or discard >= len(self):
            return np.zeros((0, len(self.param_names)))
        kept = self.samples[discard:]
        return np.concatenate(kept, axis=0).reshape(-1, len(self.param_names))

    def flat_log_probs(self, discard: int = 0) -> np.ndarray:
        if self.is_empty() or discard >= len(self):
            return np.zeros(0)
        return np.concatenate(self.log_probs[discard:], axis=0)

    def to_param_map(self, discard: int = 0) -> Dict[str, np.ndarray]:
        flat = self.flat_samples(discard)
        return {name: flat[:, i] for i, name in enumerate(self.param_names)}

    # -- persistence -------------------------------------------------------------

    def save(self, path: str):
        samples = np.asarray(self.samples)
        log_probs = np.asarray(self.log_probs)
        nbytes = samples.nbytes + log_probs.nbytes
        if nbytes > MAX_CHAIN_BYTES:
            raise ValueError(
                f"Chain too large to save ({nbytes / 2**30:.2f} GiB > 1 GiB cap); "
                f"increase thinning"
            )
        # atomic: a crash mid-write must not destroy the previous save
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # exact filename (np would append .npz)
            np.savez_compressed(
                f,
                samples=samples,
                log_probs=log_probs,
                param_names=np.asarray(self.param_names, dtype=object),
                thin=self.thin,
                total_iterations=self.total_iterations,
            )
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Chain":
        with np.load(path, allow_pickle=True) as data:
            chain = Chain(
                [str(s) for s in data["param_names"]], int(data["thin"])
            )
            chain.samples = [s for s in data["samples"]]
            chain.log_probs = [lp for lp in data["log_probs"]]
            chain.total_iterations = int(data["total_iterations"])
        return chain

    def merge(self, other: "Chain") -> "Chain":
        """Concatenate a resumed run onto this chain, in place
        (chain.rs:256; the reference mutates the receiver). Returns self."""
        assert self.param_names == other.param_names, "param names must match"
        self.samples = self.samples + other.samples
        self.log_probs = self.log_probs + other.log_probs
        self.total_iterations = self.total_iterations + other.total_iterations
        return self

    # -- diagnostics -------------------------------------------------------------

    def to_param_dict(self, discard: int = 0) -> Dict[str, np.ndarray]:
        """Reference-name alias of :meth:`to_param_map`."""
        return self.to_param_map(discard=discard)

    def r_hat(self, discard: int = 0) -> Dict[str, float]:
        """Split-chain Gelman-Rubin (mirror of ``diagnostics.rs:39-110``)."""
        result: Dict[str, float] = {}
        if self.is_empty() or discard >= len(self):
            return result
        n_keep = len(self) - discard
        if n_keep < 4:
            return result
        n_split = n_keep // 2
        stacked = np.asarray(self.samples[discard:])  # (n_keep, W, D)
        first = stacked[:n_split]
        second = stacked[n_split : 2 * n_split]
        # chains: (2W, n_split, D)
        chains = np.concatenate(
            [first.transpose(1, 0, 2), second.transpose(1, 0, 2)], axis=0
        )
        n_chains = chains.shape[0]
        means = chains.mean(axis=1)  # (2W, D)
        variances = chains.var(axis=1, ddof=1)  # (2W, D)
        w = variances.mean(axis=0)
        overall = means.mean(axis=0)
        b = n_split * ((means - overall) ** 2).sum(axis=0) / (n_chains - 1)
        var_plus = ((n_split - 1) * w + b) / n_split
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.sqrt(var_plus / w)
        for i, name in enumerate(self.param_names):
            result[name] = float(r[i])
        return result

    def is_converged(self, discard: int = 0, threshold: float = 1.1) -> bool:
        r_hat = self.r_hat(discard)
        if not r_hat:
            return False
        return all(np.isfinite(v) and v < threshold for v in r_hat.values())

    def _walker_chains(self, discard: int):
        stacked = np.asarray(self.samples[discard:])  # (n_keep, W, D)
        return stacked.transpose(1, 0, 2)  # (W, n_keep, D)

    def ess(self, discard: int = 0) -> Dict[str, float]:
        """Effective sample size via initial-positive-sequence autocorr."""
        result: Dict[str, float] = {}
        if self.is_empty() or discard >= len(self):
            return result
        n_keep = len(self) - discard
        if n_keep < 10:
            return result
        chains = self._walker_chains(discard)  # (W, n, D)
        n_walkers = chains.shape[0]
        max_lag = min(n_keep // 2, 100)
        for i, name in enumerate(self.param_names):
            avg_autocorr = np.zeros(max_lag)
            for w in range(n_walkers):
                avg_autocorr += _autocorrelation(chains[w, :, i], max_lag) / n_walkers
            total = 0.0
            for ac in avg_autocorr:
                if ac <= 0.0:
                    break
                total += ac
            n_total = n_keep * n_walkers
            result[name] = n_total / (1.0 + 2.0 * total)
        return result

    def autocorr_time(self, discard: int = 0) -> Dict[str, float]:
        """Integrated autocorrelation time tau = 1 + 2 sum(rho)."""
        result: Dict[str, float] = {}
        if self.is_empty() or discard >= len(self):
            return result
        n_keep = len(self) - discard
        if n_keep < 10:
            return result
        chains = self._walker_chains(discard)
        n_walkers = chains.shape[0]
        max_lag = min(n_keep // 2, 100)
        for i, name in enumerate(self.param_names):
            avg_autocorr = np.zeros(max_lag)
            for w in range(n_walkers):
                avg_autocorr += _autocorrelation(chains[w, :, i], max_lag) / n_walkers
            total = 0.0
            for ac in avg_autocorr:
                if ac <= 0.0:
                    break
                total += ac
            result[name] = 1.0 + 2.0 * total
        return result

    def __repr__(self):
        return (
            f"Chain(n={len(self)}, walkers={self.n_walkers}, "
            f"params={self.param_names}, thin={self.thin})"
        )


def _autocorrelation(x: np.ndarray, max_lag: int) -> np.ndarray:
    """Normalised autocorrelation rho(1..max_lag)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    mean = x.mean()
    var = ((x - mean) ** 2).sum() / n
    out = np.zeros(max_lag)
    if var == 0.0:
        return out
    centered = x - mean
    for lag in range(1, max_lag + 1):
        out[lag - 1] = (centered[: n - lag] * centered[lag:]).sum() / (n * var)
    return out
