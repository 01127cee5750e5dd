"""
NUTS: gradient-based MCMC through the model.

Port of ``rscm_tpu/calibrate/nuts.py``: multinomial NUTS (Betancourt 2017,
Stan-style) whose log-posterior gradient flows through the year loop and
both CUDA kernels.

- **Uniform-schedule tree building.**  Stage d integrates exactly 2^d
  leapfrog steps for ALL chains at once — the chains are the member axis
  of one batched model run, ``(C, D)`` tensors — and chains whose tree has
  already terminated ride along masked.  The trajectory is stored in
  visitation order, so every buffer write is at a chain-uniform row and
  every balanced-subtree U-turn check is a reshape-sum over the stage's
  rows (a subtree is contiguous in visitation order whatever its
  direction).  With ``stage_skip`` the loop leaves a transition once every
  chain has stopped (one host read per stage, against a model evaluation
  per leapfrog step).  All random numbers of a transition are drawn before
  its first stage, so skipping stages changes no draw.
- **Forward-mode gradients** for small parameter vectors
  (``grad_mode="auto"``, as in the JAX package): D tangent directions ride
  as D members of one forward-mode run; ``"rev"`` takes the reverse-mode
  gradient of the batch.
- **Progressive multinomial sampling** within/across subtrees (biased to
  the new subtree, as in Stan), Gumbel-max over masked log weights.
- **Per-chain dual averaging** (Hoffman & Gelman 2014 defaults) adapts the
  step size during warmup; the diagonal mass matrix starts at the prior
  scale and is refined from a Welford window mid-warmup.
- Divergences (energy error > 1000) and non-finite gradients terminate the
  doubling; gradients are sanitised to zero where non-finite and diverged
  integrators freeze, so a trajectory that grazes a bound rejects instead
  of poisoning positions with NaN.

The JAX package runs the whole run as one ``lax.scan``; here the iteration
and leapfrog loops are Python loops over batched tensor operations, with
the chains' random draws from one ``torch.Generator`` on the run's device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .chain import Chain
from .gradients import value_and_grad
from .likelihood import GaussianLikelihood, LikelihoodFn
from .model_runner import CompiledModelRunner
from .parameter_set import ParameterSet
from .point_estimator import _check_dispatch_chunk
from .sampler import EnsembleSampler
from .target import Target

__all__ = ["NUTSSampler"]

_DIVERGENCE_THRESHOLD = 1000.0


class NUTSSampler:
    """No-U-Turn sampling of the model posterior.

    Same construction surface as :class:`EnsembleSampler`, restricted to
    the compiled path (NUTS needs gradients, so the runner must be a
    :class:`CompiledModelRunner` and the likelihood a GaussianLikelihood).
    """

    def __init__(
        self,
        params: ParameterSet,
        runner: CompiledModelRunner,
        likelihood: LikelihoodFn,
        target: Target,
        max_tree_depth: int = 8,
        target_accept: float = 0.8,
        grad_mode: str = "auto",
        stage_skip: bool = True,
    ):
        if not isinstance(runner, CompiledModelRunner):
            raise TypeError(
                "NUTSSampler requires a CompiledModelRunner (gradients flow "
                "only through the model program); use EnsembleSampler for "
                "host/black-box runners"
            )
        if not isinstance(likelihood, GaussianLikelihood):
            raise TypeError("NUTSSampler requires a GaussianLikelihood")
        self.params = params
        self.runner = runner
        self.likelihood = likelihood
        self.target = target
        self.max_tree_depth = int(max_tree_depth)
        self.target_accept = float(target_accept)
        if grad_mode not in ("auto", "fwd", "rev"):
            raise ValueError(
                f"grad_mode must be 'auto', 'fwd' or 'rev', got {grad_mode!r}"
            )
        self.grad_mode = grad_mode
        self.stage_skip = bool(stage_skip)
        # reuse the ensemble sampler's theta -> log-posterior builder
        self._log_prob = EnsembleSampler(
            params, runner, likelihood, target
        )._build_device_log_prob()
        if self._log_prob is None:
            raise TypeError("could not build a log-posterior on tensors")
        self.last_diagnostics: dict = {}

    # -- unconstrained reparameterisation ------------------------------------
    #
    # NUTS samples in an unconstrained space x (Stan-style): bounded priors
    # create hard -inf walls in theta-space where trajectories diverge and
    # dual averaging collapses the step size; logit/exp transforms remove
    # the walls entirely, with the log-Jacobian folded into the density.

    def _build_transforms(self):
        like = dict(dtype=self.runner.program.dtype, device=self.runner.device)
        lower, upper = self.params.bounds()
        lower = np.asarray(lower, dtype=np.float64)
        upper = np.asarray(upper, dtype=np.float64)
        finite_lo = np.isfinite(lower)
        finite_hi = np.isfinite(upper)
        interval = finite_lo & finite_hi
        lo_safe = torch.as_tensor(np.where(finite_lo, lower, 0.0), **like)
        hi_safe = torch.as_tensor(np.where(finite_hi, upper, 1.0), **like)
        width_safe = torch.as_tensor(np.where(interval, upper - lower, 1.0), **like)
        interval = torch.as_tensor(interval, device=like["device"])
        finite_lo = torch.as_tensor(finite_lo, device=like["device"])
        finite_hi = torch.as_tensor(finite_hi, device=like["device"])
        logsig = torch.nn.functional.logsigmoid

        def to_theta(x):
            """x (unconstrained) -> (theta, sum log|dtheta/dx| over the last axis)."""
            s = torch.sigmoid(x)
            theta = torch.where(
                interval,
                lo_safe + width_safe * s,
                torch.where(
                    finite_lo,
                    lo_safe + torch.exp(x),
                    torch.where(finite_hi, hi_safe - torch.exp(x), x),
                ),
            )
            logj = torch.where(
                interval,
                torch.log(width_safe) + logsig(x) + logsig(-x),
                torch.where(finite_lo | finite_hi, x, torch.zeros_like(x)),
            )
            return theta, logj.sum(-1)

        def to_x(theta):
            z = torch.clamp((theta - lo_safe) / width_safe, 1e-12, 1.0 - 1e-12)
            pos_lo = torch.clamp(theta - lo_safe, min=1e-300)
            pos_hi = torch.clamp(hi_safe - theta, min=1e-300)
            return torch.where(
                interval,
                torch.log(z) - torch.log1p(-z),
                torch.where(
                    finite_lo,
                    torch.log(pos_lo),
                    torch.where(finite_hi, torch.log(pos_hi), theta),
                ),
            )

        return to_theta, to_x

    # -- gradient engine -------------------------------------------------------

    def _make_value_and_grad(self, logp_fn, n_params: int):
        """``(C, D)`` positions -> ``((C,) logp, (C, D) grad)``, by the engine
        ``grad_mode`` picks: ``"fwd"`` (``"auto"`` up to 32 parameters, as in
        the JAX package) runs D forward-mode tangents per chain as members of
        one run; ``"rev"`` takes the reverse-mode gradient."""
        mode = self.grad_mode
        if mode == "auto":
            mode = "fwd" if n_params <= 32 else "rev"

        def vag(q):
            return value_and_grad(logp_fn, q, mode)

        return vag

    # -- one NUTS transition (batched over chains) -----------------------------

    def _build_step(self, n_params, logp_fn, n_chains, gen):
        batched_vag = self._make_value_and_grad(logp_fn, n_params)
        max_depth = self.max_tree_depth
        n_rows = 1 << max_depth  # row 0 = start state; stage d -> [2^d, 2^(d+1))
        D = int(n_params)
        C = int(n_chains)
        like = dict(dtype=self.runner.program.dtype, device=self.runner.device)
        counts = {"steps": 0}

        def safe_grad(q):
            logp, grad = batched_vag(q)
            counts["steps"] += 1
            return logp, torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))

        def uniform(shape):
            return torch.rand(shape, generator=gen, **like)

        # q0 (C,D), logp0 (C,), grad0 (C,D), eps (C,), inv_mass (C,D)
        def step(q0, logp0, grad0, eps, inv_mass):
            def kinetic(p):  # (C, D) -> (C,)
                return 0.5 * torch.sum(p * p * inv_mass, dim=-1)

            # every draw of the transition, before its first stage
            p0 = torch.randn((C, D), generator=gen, **like) / torch.sqrt(inv_mass)
            draws = [
                (uniform(C) < 0.5, uniform(C), uniform((C, 1 << depth)))
                for depth in range(max_depth)
            ]
            h0 = logp0 - kinetic(p0)  # (C,) log joint at the start

            qs = torch.zeros((C, n_rows, D), **like)
            ps = torch.zeros((C, n_rows, D), **like)
            grads = torch.zeros((C, n_rows, D), **like)
            logws = torch.full((C, n_rows), -math.inf, **like)
            qs[:, 0], ps[:, 0], grads[:, 0], logws[:, 0] = q0, p0, grad0, 0.0

            c = dict(
                # position-space edges of the merged tree (start = both)
                q_left=q0, p_left=p0, grad_left=grad0,
                q_right=q0, p_right=p0, grad_right=grad0,
                p_sum=p0,  # total momentum over all merged states
                prop_q=q0, prop_logp=logp0, prop_grad=grad0,
                logw_total=torch.zeros(C, **like),
                stop=torch.zeros(C, dtype=torch.bool, device=like["device"]),
                diverged=torch.zeros(C, dtype=torch.bool, device=like["device"]),
                sum_accept=torch.zeros(C, **like),
                n_leapfrog=torch.zeros(C, dtype=torch.int64, device=like["device"]),
            )

            for depth in range(max_depth):
                if self.stage_skip and bool(c["stop"].all()):
                    break  # every chain's tree has terminated
                base = 1 << depth  # first visitation row of the stage
                length = base  # leapfrog steps in this stage
                go_right, u_prop, u_leaf = draws[depth]
                active = ~c["stop"]
                v = torch.where(go_right, 1.0, -1.0).to(like["dtype"])
                vc = v[:, None]
                fwd = vc > 0

                # integrate from the edge in direction v
                q = torch.where(fwd, c["q_right"], c["q_left"])
                p = torch.where(fwd, c["p_right"], c["p_left"])
                grad = torch.where(fwd, c["grad_right"], c["grad_left"])
                bad = torch.zeros(C, dtype=torch.bool, device=like["device"])
                for i in range(length):
                    p_half = p + 0.5 * eps[:, None] * vc * grad
                    q_new = q + eps[:, None] * vc * p_half * inv_mass
                    logp_new, grad_new = safe_grad(q_new)
                    p_new = p_half + 0.5 * eps[:, None] * vc * grad_new
                    logw = logp_new - kinetic(p_new) - h0
                    bad_new = ~torch.isfinite(logw) | (logw < -_DIVERGENCE_THRESHOLD)
                    bad = bad | bad_new
                    # freeze diverged integrators: no NaN may propagate
                    badc = bad[:, None]
                    q = torch.where(badc, q, q_new)
                    p = torch.where(badc, p, p_new)
                    grad = torch.where(badc, grad, grad_new)
                    logw = torch.where(bad, torch.full_like(logw, -math.inf), logw)
                    row = base + i  # uniform across chains
                    qs[:, row], ps[:, row], grads[:, row], logws[:, row] = q, p, grad, logw
                    use = active & ~bad
                    c["sum_accept"] = c["sum_accept"] + torch.where(
                        use, torch.clamp(torch.exp(logw), max=1.0), torch.zeros_like(logw))
                    c["n_leapfrog"] = c["n_leapfrog"] + use.to(torch.int64)
                diverged = bad

                # the stage's rows: the new subtree in visitation order —
                # contiguous whatever the direction
                ps_sub = ps[:, base : base + length]
                logws_sub = logws[:, base : base + length]

                # balanced-block U-turns inside the subtree: blocks of size
                # 2^m aligned to the subtree start; a reversed block is the
                # same set and the check is end-symmetric
                sub_turning = torch.zeros(C, dtype=torch.bool, device=like["device"])
                for m in range(1, depth + 1):
                    size = 1 << m
                    blocks = ps_sub.reshape(C, length // size, size, D)
                    rsum = blocks.sum(2)  # (C, nb, D)
                    im = inv_mass[:, None, :]
                    u = ((blocks[:, :, 0] * rsum * im).sum(-1) < 0) | (
                        (blocks[:, :, -1] * rsum * im).sum(-1) < 0)
                    sub_turning = sub_turning | u.any(-1)

                # multinomial leaf draw within the subtree (Gumbel-max)
                logw_sub = torch.logsumexp(logws_sub, dim=-1)
                gumbel = -torch.log(-torch.log(u_leaf))
                leaf = torch.argmax(logws_sub + gumbel, dim=-1)  # (C,)
                rows = leaf[:, None, None].expand(C, 1, D)
                take_q = torch.gather(qs[:, base : base + length], 1, rows)[:, 0]
                take_grad = torch.gather(grads[:, base : base + length], 1, rows)[:, 0]
                take_p = torch.gather(ps_sub, 1, rows)[:, 0]
                leaf_logw = torch.gather(logws_sub, 1, leaf[:, None])[:, 0]

                # biased progressive sampling (Stan): favour the fresh subtree
                p_new_tree = torch.exp(torch.clamp(logw_sub - c["logw_total"], max=0.0))
                ok = active & ~diverged & ~sub_turning
                take = (u_prop < p_new_tree) & ok
                takec = take[:, None]
                c["prop_q"] = torch.where(takec, take_q, c["prop_q"])
                c["prop_grad"] = torch.where(takec, take_grad, c["prop_grad"])
                c["prop_logp"] = torch.where(
                    take, leaf_logw + h0 + kinetic(take_p), c["prop_logp"])
                c["logw_total"] = torch.where(
                    ok, torch.logaddexp(c["logw_total"], logw_sub), c["logw_total"])

                # merge edges + total momentum (only where the subtree was
                # accepted into the tree)
                okc = ok[:, None]
                for side, mask in (("right", okc & fwd), ("left", okc & ~fwd)):
                    c[f"q_{side}"] = torch.where(mask, q, c[f"q_{side}"])
                    c[f"p_{side}"] = torch.where(mask, p, c[f"p_{side}"])
                    c[f"grad_{side}"] = torch.where(mask, grad, c[f"grad_{side}"])
                c["p_sum"] = c["p_sum"] + torch.where(okc, ps_sub.sum(1), torch.zeros_like(p))

                # full-tree U-turn across the merged span
                full_turning = ((c["p_left"] * c["p_sum"] * inv_mass).sum(-1) < 0) | (
                    (c["p_right"] * c["p_sum"] * inv_mass).sum(-1) < 0)
                c["stop"] = c["stop"] | diverged | sub_turning | full_turning
                c["diverged"] = c["diverged"] | (diverged & active)

            accept_stat = torch.where(
                c["n_leapfrog"] > 0,
                c["sum_accept"] / torch.clamp(c["n_leapfrog"], min=1).to(like["dtype"]),
                torch.zeros_like(c["sum_accept"]),
            )
            return (c["prop_q"], c["prop_logp"], c["prop_grad"], accept_stat,
                    c["n_leapfrog"], c["diverged"])

        return step, safe_grad, counts

    # -- public API -----------------------------------------------------------

    def mass_from_covariance(self, theta, cov) -> np.ndarray:
        """Diagonal x-space inverse mass from a theta-space covariance.

        NUTS samples in the unconstrained space; a posterior covariance
        estimated in theta space (e.g.
        :meth:`PointEstimator.laplace_covariance
        <rscm_tpu_torch.calibrate.point_estimator.PointEstimator.laplace_covariance>`
        at a MAP point) maps through the squared Jacobian of the
        bounded->unconstrained transform at ``theta``.  Pass the result as
        ``run(inv_mass=...)``.
        """
        _, to_x = self._build_transforms()
        theta = self.runner.as_theta(np.asarray(theta, dtype=np.float64))
        cov = np.asarray(cov, dtype=np.float64)
        var_theta = np.diag(cov) if cov.ndim == 2 else cov
        # to_x acts elementwise, so its Jacobian is diagonal: one tangent
        jac = torch.func.jvp(to_x, (theta,), (torch.ones_like(theta),))[1]
        jac = jac.to(torch.float64).cpu().numpy()
        var_x = np.maximum(jac**2 * var_theta, 1e-12)
        # Copied from the JAX package with its fault (ADVICE.md, "Inverse
        # mass matrix inverted"): the inverse mass should be var_x.
        return 1.0 / var_x

    def run(
        self,
        n_iterations: int,
        n_chains: int = 4,
        warmup: int = 200,
        thin: int = 1,
        seed: Optional[int] = None,
        init_positions: Optional[np.ndarray] = None,
        step_size: float = 0.1,
        mesh=None,
        dispatch_chunk: Optional[int] = None,
        inv_mass: Optional[np.ndarray] = None,
    ) -> Chain:
        """Sample ``n_iterations`` post-warmup draws per chain.

        Warmup adapts the step size per chain by dual averaging toward
        ``target_accept``; warmup draws are not pushed to the chain.
        Diagnostics (divergences, model-evaluation counts, final step
        sizes) land in :attr:`last_diagnostics`: ``n_model_evals`` counts
        the leapfrog steps each chain took while its tree was growing,
        ``n_leapfrog_steps`` the batched steps run for all chains together,
        and ``n_gradient_evals`` the batched value-and-gradient evaluations
        (the leapfrog steps and one at the start).

        ``mesh`` is kept for API parity (the JAX package shards the chains
        over a device mesh with it); the port runs on one card, and a mesh
        raises.  ``dispatch_chunk`` is validated as in the JAX package,
        where it caps the iterations in one device program to fence a
        TPU-worker fault; the port runs one transition at a time, and the
        argument changes nothing.
        """
        if mesh is not None:
            raise NotImplementedError(
                "NUTSSampler: the port runs on one card; sharding the chains "
                "across cards is not ported yet"
            )
        _check_dispatch_chunk(dispatch_chunk)
        like = dict(dtype=self.runner.program.dtype, device=self.runner.device)
        rng = np.random.default_rng(seed)
        names = self.params.param_names()
        D = len(names)

        to_theta, to_x = self._build_transforms()

        if init_positions is None:
            init_positions = self.params.sample_random(n_chains, rng)
        init_positions = np.asarray(init_positions, dtype=np.float64)
        if init_positions.shape != (n_chains, D):
            raise ValueError(
                f"init_positions must be ({n_chains}, {D}), got {init_positions.shape}"
            )
        init_x = to_x(torch.as_tensor(init_positions, **like))

        # sampling runs in the unconstrained space; density incl. Jacobian
        base_logp = self._log_prob

        def logp_x(x):
            theta, logj = to_theta(x)
            return base_logp(theta) + logj

        # initial diagonal mass matrix: caller-provided (x-space posterior
        # variances, e.g. from mass_from_covariance on a Laplace fit) or the
        # prior scale in x-space; refined mid-warmup from the chains' own
        # samples (Welford window)
        if inv_mass is not None:
            inv_mass = np.asarray(inv_mass, dtype=np.float64)
            if inv_mass.shape != (D,):
                raise ValueError(f"inv_mass must have shape ({D},), got {inv_mass.shape}")
            if not np.all(np.isfinite(inv_mass)) or np.any(inv_mass <= 0.0):
                raise ValueError("inv_mass entries must be finite and > 0")
            inv_mass0 = torch.as_tensor(inv_mass, **like)
        else:
            prior_draws = self.params.sample_random(256, rng)
            x_draws = to_x(torch.as_tensor(prior_draws, **like)).to(torch.float64).cpu().numpy()
            prior_mass = np.maximum(np.var(x_draws, axis=0), 1e-12)
            # Copied from the JAX package with its fault (ADVICE.md, "Inverse
            # mass matrix inverted"): the inverse mass should be the variance.
            inv_mass0 = torch.as_tensor(1.0 / prior_mass, **like)

        gen = torch.Generator(device=like["device"])
        gen.manual_seed(int(rng.integers(2**31)))
        step, safe_grad, counts = self._build_step(D, logp_x, n_chains, gen)

        # dual averaging constants (Hoffman & Gelman 2014)
        gamma, t0, kappa = 0.05, 10.0, 0.75
        target = self.target_accept
        # Welford window for mass adaptation: [25%, 75%) of warmup, with
        # the mass switched (and dual averaging restarted) at 75%
        w_lo = int(warmup * 0.25)
        w_hi = int(warmup * 0.75)
        adapt_mass = (w_hi - w_lo) >= max(10, 2 * D)

        total_iters = warmup + n_iterations
        C = n_chains
        dev = like["device"]
        with torch.no_grad():
            q = init_x
            logp, grad = safe_grad(q)
            log_eps = torch.full((C,), math.log(step_size), **like)
            log_eps_bar = log_eps.clone()
            h_bar = torch.zeros(C, **like)
            mu = torch.full((C,), math.log(10.0 * step_size), **like)
            da_m = torch.zeros(C, dtype=torch.int64, device=dev)
            inv_mass_c = inv_mass0.expand(C, D).clone()
            w_count = torch.zeros(C, dtype=torch.int64, device=dev)
            w_mean = torch.zeros((C, D), **like)
            w_m2 = torch.zeros((C, D), **like)
            n_lf = torch.zeros(C, dtype=torch.int64, device=dev)
            n_div = torch.zeros(C, dtype=torch.int64, device=dev)
            xs, logps = [], []

            for it in range(total_iters):
                eps = torch.exp(log_eps)
                q, logp, grad, accept_stat, lf, diverged = step(q, logp, grad, eps, inv_mass_c)

                # Welford accumulation of x-space samples inside the window
                if adapt_mass:
                    if w_lo <= it < w_hi:
                        w_count = w_count + 1
                        delta = q - w_mean
                        w_mean = w_mean + delta / torch.clamp(w_count, min=1)[:, None]
                        w_m2 = w_m2 + delta * (q - w_mean)
                    if it == w_hi:
                        # switch: mass <- regularised sample variance
                        # (Stan-style shrinkage toward the prior mass); dual
                        # averaging restarts
                        n = torch.clamp(w_count - 1, min=1).to(w_m2.dtype)[:, None]
                        var = w_m2 / n
                        shrink = n / (n + 5.0)
                        var_reg = shrink * var + (1.0 - shrink) * (1.0 / inv_mass_c)
                        # Copied from the JAX package with its fault (ADVICE.md,
                        # "Inverse mass matrix inverted"): the inverse mass
                        # should be var_reg.
                        inv_mass_c = 1.0 / torch.clamp(var_reg, min=1e-12)
                        mu = math.log(10.0) + log_eps
                        h_bar = torch.zeros_like(h_bar)
                        da_m = torch.zeros_like(da_m)

                # dual averaging (active during warmup only)
                da_m = da_m + 1
                m = da_m.to(log_eps.dtype)
                eta = 1.0 / (m + t0)
                h_new = (1.0 - eta) * h_bar + eta * (target - accept_stat)
                log_eps_da = mu - torch.sqrt(m) / gamma * h_new
                w = m ** (-kappa)
                log_eps_bar_da = w * log_eps_da + (1.0 - w) * log_eps_bar

                if it < warmup:
                    # the last warmup iteration hands over the *averaged* step
                    # size, so the first recorded draw never steps with the raw
                    # dual-averaging iterate
                    log_eps = log_eps_bar_da if it == warmup - 1 else log_eps_da
                    log_eps_bar = log_eps_bar_da
                    h_bar = h_new
                else:
                    log_eps = log_eps_bar
                    n_div = n_div + diverged.to(torch.int64)
                n_lf = n_lf + lf
                xs.append(q)
                logps.append(logp)

            # back to theta-space; recorded log probs exclude the Jacobian
            xs = torch.stack(xs)  # (T, C, D)
            thetas, logjs = to_theta(xs)
            logps = torch.stack(logps) - logjs

        self.last_diagnostics = {
            "n_model_evals": int(n_lf.sum()),
            "n_divergences": int(n_div.sum()),
            "n_leapfrog_steps": counts["steps"] - 1,
            "n_gradient_evals": counts["steps"],
            "step_sizes": torch.exp(log_eps).tolist(),
            "inv_mass": inv_mass_c.tolist(),
            "mass_adapted": bool(adapt_mass),
            "warmup": warmup,
            "n_chains": n_chains,
        }
        chain = Chain(self.params.param_names(), thin)
        chain.push_stacked(
            thetas[warmup:].to(torch.float64).cpu().numpy(),
            logps[warmup:].to(torch.float64).cpu().numpy(),
        )
        return chain
