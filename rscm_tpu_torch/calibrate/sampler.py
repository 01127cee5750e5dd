"""
Affine-invariant ensemble MCMC (Goodman & Weare 2010 stretch move).

Port of ``rscm_tpu/calibrate/sampler.py``.  Mirror of
``crates/rscm-calibrate/src/sampler/`` — walkers split into two
halves updated alternately, z ~ g(z; a) stretch proposals against a random
complement walker, acceptance ``min(1, z^(D-1) * p_new/p_old)``, default
walkers ``max(2*n_params, 32)``, checkpoint/resume, progress callbacks.

Two engines:

- **device** (default for :class:`CompiledModelRunner`): a loop over
  iterations whose half-steps are batched tensor operations on the run's
  device — proposals from a ``torch.Generator``, one batched model run for
  the half's posteriors, accept/reject — with no host round trip until a
  checkpoint or progress segment ends (the JAX package runs the same loop
  as one ``lax.scan``).  Its random stream is not the JAX package's, so
  the two engines agree statistically, not draw for draw.
- **host**: reference-faithful Python loop for arbitrary ``ModelRunner``
  implementations, with the JAX package's numpy draws: the same seed gives
  the same chain.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from .chain import Chain
from .likelihood import GaussianLikelihood, LikelihoodFn
from .model_runner import CompiledModelRunner, ModelRunner
from .parameter_set import ParameterSet
from .target import Target

__all__ = [
    "StretchMove",
    "DEMove",
    "WalkerInit",
    "SamplerState",
    "ProgressInfo",
    "EnsembleSampler",
]


@dataclass
class ProgressInfo:
    iteration: int
    total: int
    acceptance_rate: float
    mean_log_prob: float


class StretchMove:
    def __init__(self, a: float = 2.0):
        if a <= 1.0:
            raise ValueError(
                f"Stretch move scale parameter must be > 1.0, got {a}"
            )
        self.a = float(a)

    def sample_z(self, rng: np.random.Generator) -> float:
        u = rng.random()
        return ((self.a - 1.0) * u + 1.0) ** 2 / self.a

    def acceptance_probability(self, z, n_params, log_prob_old, log_prob_new):
        if not np.isfinite(log_prob_new):
            return 0.0
        log_ratio = (n_params - 1.0) * np.log(z) + (log_prob_new - log_prob_old)
        return min(np.exp(log_ratio), 1.0)

    def signature(self):
        """Hashable device-engine cache key component."""
        return ("stretch", self.a)


class DEMove:
    """Differential-evolution proposal (ter Braak 2006; emcee's ``DEMove``).

    Proposal ``x' = x + gamma (x_a - x_b) + sigma N(0, I)`` with ``x_a``,
    ``x_b`` two DISTINCT walkers drawn from the complementary half.  The
    difference vector is distributed like the walker cloud itself, so
    proposals are automatically scaled and oriented along the posterior's
    correlated and flat directions — where the stretch move's 1-d line
    proposals mix diffusively (on the 8-d MAGICC posterior, whose
    gas-exchange direction is nearly flat across its prior, stretch
    stalls near R-hat 1.8 at ~0.09 acceptance; DE converges — measured
    ladder in docs/performance.md).  ``gamma`` defaults to the
    ``2.38 / sqrt(2 D)`` random-walk optimum at run time; with
    probability ``gamma1_prob`` a full ``gamma = 1`` proposal is made
    instead (ter Braak's mode-jumping trick).  The proposal is symmetric,
    so acceptance is plain Metropolis — no stretch Jacobian term.

    Beyond the reference (``sampler/moves.rs`` implements only the
    stretch move); the ensemble-splitting schedule, state, checkpointing
    and diagnostics are shared with :class:`StretchMove` runs.
    """

    def __init__(self, gamma: Optional[float] = None,
                 gamma1_prob: float = 0.1, sigma: float = 1e-5):
        if not 0.0 <= gamma1_prob <= 1.0:
            raise ValueError(f"gamma1_prob must be in [0, 1], got {gamma1_prob}")
        if sigma < 0.0:
            raise ValueError(f"sigma must be >= 0, got {sigma}")
        self.gamma = None if gamma is None else float(gamma)
        self.gamma1_prob = float(gamma1_prob)
        self.sigma = float(sigma)

    def resolve_gamma(self, n_params: int) -> float:
        if self.gamma is not None:
            return self.gamma
        return 2.38 / np.sqrt(2.0 * n_params)

    def signature(self):
        """Hashable device-engine cache key component."""
        return ("de", self.gamma, self.gamma1_prob, self.sigma)


class WalkerInit:
    """FromPrior / Ball / Gaussian / Explicit initial walker positions."""

    def __init__(self, kind: str, center=None, radius=None, positions=None):
        self.kind = kind
        self.center = center
        self.radius = radius
        self.positions = positions

    @staticmethod
    def from_prior() -> "WalkerInit":
        return WalkerInit("FromPrior")

    @staticmethod
    def ball(center, radius) -> "WalkerInit":
        """Walkers in a uniform box around ``center``.

        ``radius`` is a scalar (the reference's ``Ball`` semantics,
        ``sampler/init.rs:12-60``) or a per-parameter array — calibration
        parameters rarely share a scale, so a per-dimension radius (e.g.
        a fraction of each prior's span around a MAP estimate) is the
        form that actually initialises every dimension sensibly.
        """
        radius = np.asarray(radius, dtype=np.float64)
        if radius.ndim == 0:
            radius = float(radius)
        return WalkerInit("Ball", center=list(center), radius=radius)

    @staticmethod
    def gaussian(center, cov) -> "WalkerInit":
        """Walkers drawn from ``N(center, cov)``, clipped just inside the
        prior support.

        The natural companion of a Laplace approximation: draw the
        ensemble from ``N(theta_MAP, H^-1)`` (see
        :meth:`PointEstimator.laplace_covariance <rscm_tpu_torch.calibrate.point_estimator.PointEstimator.laplace_covariance>`)
        and the walker cloud starts with the posterior's own scales AND
        correlations — an isotropic ball must first diffuse into shape
        along every flat/correlated direction before it can mix.
        """
        cov = np.atleast_2d(np.asarray(cov, dtype=np.float64))
        center = np.asarray(center, dtype=np.float64)
        if cov.shape != (center.shape[0], center.shape[0]):
            raise ValueError(
                f"gaussian init cov shape {cov.shape} does not match "
                f"center length {center.shape[0]}"
            )
        return WalkerInit("Gaussian", center=list(center), radius=cov)

    @staticmethod
    def explicit(positions) -> "WalkerInit":
        return WalkerInit("Explicit", positions=np.asarray(positions, dtype=np.float64))

    def initialize(self, n_walkers: int, params: ParameterSet, rng) -> np.ndarray:
        if self.kind == "FromPrior":
            return params.sample_random(n_walkers, rng)
        if self.kind == "Ball":
            if len(self.center) != len(params):
                raise ValueError(
                    f"Ball center length {len(self.center)} does not match "
                    f"parameter count {len(params)}"
                )
            radius = np.asarray(self.radius)
            if radius.ndim == 1 and radius.shape[0] != len(params):
                raise ValueError(
                    f"Ball radius length {radius.shape[0]} does not match "
                    f"parameter count {len(params)}"
                )
            offsets = rng.random((n_walkers, len(params))) - 0.5
            return np.asarray(self.center) + offsets * radius
        if self.kind == "Gaussian":
            if len(self.center) != len(params):
                raise ValueError(
                    f"Gaussian init center length {len(self.center)} does "
                    f"not match parameter count {len(params)}"
                )
            draws = rng.multivariate_normal(
                np.asarray(self.center), self.radius, size=n_walkers,
                method="svd",
            )
            # clip just inside the support: a draw outside a bounded prior
            # would start at -inf posterior
            lower, upper = map(np.asarray, params.bounds())
            span = np.where(np.isfinite(upper - lower), upper - lower, 1.0)
            lo = np.where(np.isfinite(lower), lower + 1e-9 * span, -np.inf)
            hi = np.where(np.isfinite(upper), upper - 1e-9 * span, np.inf)
            return np.clip(draws, lo, hi)
        if self.kind == "Explicit":
            pos = self.positions
            if pos.shape[0] != n_walkers:
                raise ValueError(
                    f"Explicit positions have {pos.shape[0]} walkers, "
                    f"expected {n_walkers}"
                )
            if pos.shape[1] != len(params):
                raise ValueError(
                    f"Explicit positions have {pos.shape[1]} parameters, "
                    f"expected {len(params)}"
                )
            return pos.copy()
        raise ValueError(f"Unknown WalkerInit kind {self.kind}")


class SamplerState:
    """Walker positions + log-probs + acceptance counts (checkpointable)."""

    def __init__(self, positions: np.ndarray, param_names: List[str]):
        self.positions = np.asarray(positions, dtype=np.float64)
        self.param_names = list(param_names)
        n_walkers = self.positions.shape[0]
        self.log_probs = np.full(n_walkers, -np.inf)
        self.n_accepted = np.zeros(n_walkers, dtype=np.int64)
        self.n_proposed = np.zeros(n_walkers, dtype=np.int64)
        self.iteration = 0

    def n_params(self) -> int:
        return self.positions.shape[1]

    def mean_acceptance_rate(self) -> float:
        total = self.n_proposed.sum()
        return float(self.n_accepted.sum() / total) if total else 0.0

    def save_checkpoint(self, path: str):
        # atomic: a crash mid-write must not destroy the previous
        # checkpoint (the exact failure checkpoints exist to survive)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # exact filename (np would append .npz)
            np.savez_compressed(
                f,
                positions=self.positions,
                log_probs=self.log_probs,
                n_accepted=self.n_accepted,
                n_proposed=self.n_proposed,
                iteration=self.iteration,
                param_names=np.asarray(self.param_names, dtype=object),
            )
        os.replace(tmp, path)

    @staticmethod
    def load_checkpoint(path: str) -> "SamplerState":
        real = path if os.path.exists(path) else path + ".npz"
        with np.load(real, allow_pickle=True) as data:
            state = SamplerState(
                data["positions"], [str(s) for s in data["param_names"]]
            )
            state.log_probs = data["log_probs"]
            state.n_accepted = data["n_accepted"]
            state.n_proposed = data["n_proposed"]
            state.iteration = int(data["iteration"])
        return state


class EnsembleSampler:
    def __init__(
        self,
        params: ParameterSet,
        runner: ModelRunner,
        likelihood: LikelihoodFn,
        target: Target,
        move=None,
    ):
        self.params = params
        self.runner = runner
        self.likelihood = likelihood
        self.target = target
        if move is not None and not isinstance(move, (StretchMove, DEMove)):
            raise TypeError(
                f"move must be a StretchMove or DEMove, got {type(move).__name__}"
            )
        self.move = move if move is not None else StretchMove()
        self.default_n_walkers = max(2 * len(params), 32)
        self._device_log_prob = None

    @property
    def stretch(self) -> StretchMove:
        """The stretch move when active (reference-API compat accessor)."""
        if not isinstance(self.move, StretchMove):
            raise AttributeError(
                "sampler is configured with a non-stretch move; use .move"
            )
        return self.move

    def with_stretch_param(self, a: float) -> "EnsembleSampler":
        self.move = StretchMove(a)
        return self

    def with_move(self, move) -> "EnsembleSampler":
        """Set the proposal move (:class:`StretchMove` or :class:`DEMove`)."""
        if not isinstance(move, (StretchMove, DEMove)):
            raise TypeError(
                f"move must be a StretchMove or DEMove, got {type(move).__name__}"
            )
        self.move = move
        return self

    # -- posterior -------------------------------------------------------------

    def log_posterior_batch(self, param_sets) -> np.ndarray:
        outputs = self.runner.run_batch(param_sets)
        out = np.empty(len(param_sets))
        for i, (theta, output) in enumerate(zip(param_sets, outputs)):
            try:
                log_prior = float(self.params.log_prior(np.asarray(theta)))
            except Exception:
                out[i] = -np.inf
                continue
            if not np.isfinite(log_prior):
                out[i] = -np.inf
                continue
            if isinstance(output, Exception):
                out[i] = -np.inf
                continue
            try:
                ll = self.likelihood.ln_likelihood(output, self.target)
            except Exception:
                out[i] = -np.inf
                continue
            out[i] = log_prior + ll
        return out

    def _build_device_log_prob(self):
        """Log posterior of a ``(B, D)`` batch of walkers (or a ``(D,)``
        vector) on tensors, through one batched model run; autograd
        differentiates it."""
        if self._device_log_prob is not None:
            return self._device_log_prob
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

        def log_prob(theta):
            lp = params.log_prior(theta)
            trajectories = traj_fn(theta)
            ll = likelihood.ln_likelihood_traced(trajectories, compiled_target)
            total = lp + ll
            return torch.where(torch.isfinite(total), total, torch.full_like(total, -np.inf))

        self._device_log_prob = log_prob
        return log_prob

    # -- public API --------------------------------------------------------------

    def run(
        self,
        n_iterations: int,
        init: WalkerInit,
        thin: int = 1,
        n_walkers: Optional[int] = None,
        progress_callback: Optional[Callable] = None,
        seed: Optional[int] = None,
        engine: Optional[str] = None,
        mesh=None,
    ) -> Chain:
        """Sample; ``engine`` in {None (auto), "device", "host"}.

        ``mesh`` is kept for API parity: the JAX package shards the walker
        axis over a device mesh with it.  The port runs on one card, and a
        mesh raises.
        """
        n_walkers = n_walkers or self.default_n_walkers
        rng = np.random.default_rng(seed)
        positions = init.initialize(n_walkers, self.params, rng)
        state = SamplerState(positions, self.params.param_names())
        chain = Chain(self.params.param_names(), thin)
        return self._run_from_state(
            state, chain, n_iterations, rng, progress_callback, engine, mesh=mesh
        )

    run_with_walkers = run
    run_with_progress = run

    def run_with_checkpoint(
        self,
        n_iterations: int,
        init: WalkerInit,
        thin: int,
        checkpoint_every: int,
        checkpoint_path: str,
        progress_callback=None,
        n_walkers: Optional[int] = None,
        seed: Optional[int] = None,
        engine: Optional[str] = None,
        mesh=None,
    ) -> Chain:
        n_walkers = n_walkers or self.default_n_walkers
        rng = np.random.default_rng(seed)
        positions = init.initialize(n_walkers, self.params, rng)
        state = SamplerState(positions, self.params.param_names())
        chain = Chain(self.params.param_names(), thin)
        return self._run_from_state(
            state,
            chain,
            n_iterations,
            rng,
            progress_callback,
            engine,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path,
            mesh=mesh,
        )

    def resume_from_checkpoint(
        self,
        n_iterations: int,
        thin: int,
        checkpoint_every: int,
        checkpoint_path: str,
        progress_callback=None,
        seed: Optional[int] = None,
        engine: Optional[str] = None,
        mesh=None,
    ) -> Chain:
        state = SamplerState.load_checkpoint(checkpoint_path + ".state")
        chain = Chain.load(checkpoint_path + ".chain")
        rng = np.random.default_rng(seed)
        # n_iterations is the TOTAL target, not additional iterations
        # (sampler/ensemble.rs resume semantics)
        remaining = max(0, int(n_iterations) - int(state.iteration))
        return self._run_from_state(
            state,
            chain,
            remaining,
            rng,
            progress_callback,
            engine,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path,
            mesh=mesh,
        )

    # -- engines ----------------------------------------------------------------

    def _run_from_state(
        self,
        state: SamplerState,
        chain: Chain,
        n_iterations: int,
        rng,
        progress_callback,
        engine,
        checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        mesh=None,
    ) -> Chain:
        # Validate here so every entry point — run, run_with_checkpoint and
        # resume_from_checkpoint — rejects walker counts the half-split
        # engines cannot handle (an odd count would silently freeze the last
        # walker in the device engine's fixed-size half slices).
        n_walkers = state.positions.shape[0]
        if n_walkers < 2:
            raise ValueError("Must have at least 2 walkers")
        if n_walkers % 2 != 0:
            raise ValueError("Number of walkers must be even")

        device_log_prob = self._build_device_log_prob() if engine != "host" else None
        if engine == "device" and device_log_prob is None:
            raise ValueError(
                "device engine requires a CompiledModelRunner + GaussianLikelihood"
            )
        if device_log_prob is not None:
            return self._run_device(
                device_log_prob,
                state,
                chain,
                n_iterations,
                rng,
                progress_callback,
                checkpoint_every,
                checkpoint_path,
                mesh=mesh,
            )
        return self._run_host(
            state,
            chain,
            n_iterations,
            rng,
            progress_callback,
            checkpoint_every,
            checkpoint_path,
        )

    def _maybe_checkpoint(self, state, chain, iteration, every, path, base=0):
        """``iteration`` counts within the current run; ``base`` is the
        absolute iteration the run resumed from, so checkpoints written
        during a resumed run record total progress (otherwise a second
        resume would redo completed iterations and duplicate samples)."""
        if every and path and (iteration + 1) % every == 0:
            state.iteration = base + iteration + 1
            # chain first: a crash between the two writes must leave
            # state.iteration <= the iterations the saved chain covers
            # (the reverse order loses samples on resume)
            chain.save(path + ".chain")
            state.save_checkpoint(path + ".state")

    # .. host engine (reference-faithful loop) ...................................

    def _run_host(
        self, state, chain, n_iterations, rng, progress_callback,
        checkpoint_every=None, checkpoint_path=None,
    ):
        n_walkers = state.positions.shape[0]
        half = n_walkers // 2
        base_iteration = int(state.iteration)
        if not np.all(np.isfinite(state.log_probs)) and state.iteration == 0:
            state.log_probs = self.log_posterior_batch(list(state.positions))

        for iteration in range(n_iterations):
            self._update_group_host(state, range(0, half), range(half, n_walkers), rng)
            self._update_group_host(state, range(half, n_walkers), range(0, half), rng)
            chain.push(state.positions, state.log_probs)
            if progress_callback is not None:
                progress_callback(
                    ProgressInfo(
                        iteration,
                        n_iterations,
                        state.mean_acceptance_rate(),
                        float(np.mean(state.log_probs)),
                    )
                )
            self._maybe_checkpoint(
                state, chain, iteration, checkpoint_every, checkpoint_path,
                base=base_iteration,
            )
        return chain

    def _update_group_host(self, state, active, complement, rng):
        comp_positions = state.positions[list(complement)]
        n_comp = len(comp_positions)
        proposals, zs = [], []
        if isinstance(self.move, DEMove):
            gamma0 = self.move.resolve_gamma(state.n_params())
            for i in active:
                ia = rng.integers(n_comp)
                ib = (ia + 1 + rng.integers(n_comp - 1)) % n_comp
                gamma = 1.0 if rng.random() < self.move.gamma1_prob else gamma0
                step = gamma * (comp_positions[ia] - comp_positions[ib])
                noise = self.move.sigma * rng.standard_normal(state.n_params())
                proposals.append(state.positions[i] + step + noise)
                zs.append(None)  # symmetric proposal: no Jacobian term
        else:
            for i in active:
                z = self.stretch.sample_z(rng)
                comp = comp_positions[rng.integers(n_comp)]
                proposals.append(comp + z * (state.positions[i] - comp))
                zs.append(z)
        log_probs_new = self.log_posterior_batch(proposals)
        for i, proposal, z, lp_new in zip(active, proposals, zs, log_probs_new):
            if z is None:
                accept_prob = (
                    min(np.exp(min(lp_new - state.log_probs[i], 0.0)), 1.0)
                    if np.isfinite(lp_new)
                    else 0.0
                )
            else:
                accept_prob = self.stretch.acceptance_probability(
                    z, state.n_params(), state.log_probs[i], lp_new
                )
            state.n_proposed[i] += 1
            if rng.random() < accept_prob:
                state.positions[i] = proposal
                state.log_probs[i] = lp_new
                state.n_accepted[i] += 1

    # .. device engine (a loop of batched half-steps on the device) ..............

    def _run_device(
        self, log_prob, state, chain, n_iterations, rng, progress_callback,
        checkpoint_every=None, checkpoint_path=None, mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "EnsembleSampler: the port runs on one card; splitting the walkers "
                "across cards is not ported yet"
            )
        runner = self.runner
        dtype, device = runner.program.dtype, runner.device
        n_walkers, n_params = state.positions.shape
        half = n_walkers // 2
        move = self.move
        is_de = isinstance(move, DEMove)
        if is_de:
            gamma0 = move.resolve_gamma(n_params)
        like = dict(dtype=dtype, device=device)

        # one generator per run, seeded from the numpy stream as the JAX
        # package seeds its key
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(0, 2**63 - 1)))

        def uniform(shape):
            return torch.rand(shape, generator=gen, **like)

        def randint(high, shape):
            # an empty range gives zeros, as jax.random.randint does
            if high <= 0:
                return torch.zeros(shape, dtype=torch.long, device=device)
            return torch.randint(0, high, shape, generator=gen, device=device)

        def half_step(positions, log_probs, n_accepted, active_slice, comp_slice):
            act = slice(active_slice, active_slice + half)
            active = positions[act]
            comp = positions[comp_slice : comp_slice + half]
            lp_old = log_probs[act]
            if is_de:
                gamma_draw = uniform(half)
                ia = randint(half, (half,))
                # distinct second index: uniform over the other half-1.  With
                # two walkers (half = 1) the range is empty and ib = ia, so the
                # proposal has no difference vector — the JAX package's fault,
                # copied for parity (ADVICE.md, "DEMove with two walkers").
                ib = (ia + 1 + randint(half - 1, (half,))) % half
                gamma = torch.where(
                    gamma_draw < move.gamma1_prob,
                    torch.ones((), **like),
                    torch.full((), gamma0, **like),
                )
                noise = torch.randn(active.shape, generator=gen, **like)
                proposals = active + gamma[:, None] * (comp[ia] - comp[ib]) + move.sigma * noise
                lp_new = log_prob(proposals)
                # symmetric proposal: plain Metropolis ratio
                log_ratio = lp_new - lp_old
            else:
                a = move.a
                z = ((a - 1.0) * uniform(half) + 1.0) ** 2 / a
                chosen = comp[randint(half, (half,))]
                proposals = chosen + z[:, None] * (active - chosen)
                lp_new = log_prob(proposals)
                log_ratio = (n_params - 1.0) * torch.log(z) + (lp_new - lp_old)
            accept = (torch.log(uniform(half)) < log_ratio) & torch.isfinite(lp_new)
            positions = positions.clone()
            log_probs = log_probs.clone()
            n_accepted = n_accepted.clone()
            positions[act] = torch.where(accept[:, None], proposals, active)
            log_probs[act] = torch.where(accept, lp_new, lp_old)
            n_accepted[act] += accept.to(n_accepted.dtype)
            return positions, log_probs, n_accepted

        with torch.no_grad():
            positions = torch.as_tensor(state.positions, **like)
            if state.iteration == 0 or not np.all(np.isfinite(state.log_probs)):
                log_probs = log_prob(positions)
            else:
                log_probs = torch.as_tensor(state.log_probs, **like)
            n_accepted = torch.as_tensor(state.n_accepted, device=device)

            # segments fire checkpoints/progress at the requested cadence; a
            # progress callback without checkpointing still gets ~20 updates
            if checkpoint_every:
                segment = checkpoint_every
            elif progress_callback is not None:
                segment = max(1, n_iterations // 20)
            else:
                segment = n_iterations
            base_iteration = int(state.iteration)

            done = 0
            while done < n_iterations:
                seg_todo = min(segment, n_iterations - done)
                seg_pos, seg_lp = [], []
                for _ in range(seg_todo):
                    positions, log_probs, n_accepted = half_step(
                        positions, log_probs, n_accepted, 0, half)
                    positions, log_probs, n_accepted = half_step(
                        positions, log_probs, n_accepted, half, 0)
                    seg_pos.append(positions)
                    seg_lp.append(log_probs)
                chain.push_stacked(
                    torch.stack(seg_pos).to(torch.float64).cpu().numpy(),
                    torch.stack(seg_lp).to(torch.float64).cpu().numpy(),
                )
                done += seg_todo
                state.positions = positions.to(torch.float64).cpu().numpy()
                state.log_probs = log_probs.to(torch.float64).cpu().numpy()
                state.n_accepted = n_accepted.cpu().numpy()
                state.n_proposed += seg_todo  # one proposal per walker per iteration
                if progress_callback is not None:
                    progress_callback(
                        ProgressInfo(
                            done - 1,
                            n_iterations,
                            float(np.sum(state.n_accepted) / max(np.sum(state.n_proposed), 1)),
                            float(np.mean(state.log_probs)),
                        )
                    )
                self._maybe_checkpoint(
                    state, chain, done - 1, checkpoint_every, checkpoint_path,
                    base=base_iteration,
                )
        return chain
