"""The device samplers recover the TwoLayer toy's posterior.

A ``torch.Generator`` on the run's device and ``jax.random`` keys never
give the same draws, so the port's device engines are held statistically,
on the one-parameter TwoLayer toy of ``tests/test_nuts.py`` (lambda0 on
U(0.5, 2.5), truth 1.2):

- the device ``EnsembleSampler`` (32 walkers, 100 iterations) and
  ``NUTSSampler`` (4 chains, tree depth 2, 15 warmup + 25 draws,
  reverse-mode gradients) recover lambda0 as the JAX package's
  ``test_recovers_parameter`` does (mean within 0.05 of the truth, std
  below 0.05);
- their posterior means agree with the JAX package's NUTS posterior (the
  reference test's run: 4 chains, 100 warmup + 200 draws, depth 6) within
  3 Monte Carlo standard errors (std / sqrt(ESS) of each, combined).

The port's runs are shorter than the reference's (CPU gradients through
the toy's 51-year RK4 loop cost about 0.5 s each on a CPU).
"""

import numpy as np
import pytest

import rscm_tpu.calibrate as jc
import rscm_tpu_torch.calibrate as pc
from test_torch_support import TOY_LAMBDA, toy_problem


def mean_and_mcse(chain, discard=0):
    flat = chain.flat_samples(discard=discard)[:, 0]
    ess = chain.ess(discard=discard)["lambda0"]
    return flat.mean(), flat.std() / np.sqrt(ess), flat.std()


@pytest.fixture(scope="module")
def jax_posterior():
    params, runner, likelihood, target = toy_problem("rscm_tpu")
    nuts = jc.NUTSSampler(params, runner, likelihood, target, max_tree_depth=6)
    return mean_and_mcse(nuts.run(n_iterations=200, n_chains=4, warmup=100, seed=3))


@pytest.fixture(scope="module")
def port_toy():
    return toy_problem("rscm_tpu_torch")


def assert_recovers(port, ref):
    mean, mcse, std = port
    ref_mean, ref_mcse, _ = ref
    assert mean == pytest.approx(TOY_LAMBDA, abs=0.05)
    assert std < 0.05
    assert abs(mean - ref_mean) < 3.0 * np.hypot(mcse, ref_mcse), (mean, ref_mean, mcse, ref_mcse)


def test_device_ensemble_sampler_recovers_lambda0(port_toy, jax_posterior):
    sampler = pc.EnsembleSampler(*port_toy)
    chain = sampler.run(n_iterations=100, init=pc.WalkerInit.from_prior(), n_walkers=32,
                        seed=7, engine="device")
    assert chain.flat_samples().shape == (3200, 1)
    assert_recovers(mean_and_mcse(chain, discard=50), jax_posterior)


def test_nuts_recovers_lambda0(port_toy, jax_posterior):
    nuts = pc.NUTSSampler(*port_toy, max_tree_depth=2, grad_mode="rev")
    chain = nuts.run(n_iterations=25, n_chains=4, warmup=15, seed=3)
    assert chain.flat_samples().shape == (100, 1)
    assert chain.r_hat()["lambda0"] < 1.1
    assert nuts.last_diagnostics["n_divergences"] == 0
    assert_recovers(mean_and_mcse(chain), jax_posterior)
