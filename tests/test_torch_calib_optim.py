"""Gradient-based point estimation: the port against ``rscm_tpu.calibrate``.

- ``AdamOptimizer``, 20 steps on the three-parameter MAGICC problem of the
  JAX package's ``test_map_recovers_truth_three_params`` (ECS, tau_OH,
  beta; learning rate 0.08; x0 drawn with seed 7), cut to 1850-1857 with
  the flux history in the working dtype, reaches the JAX package's best
  iterate within 1e-6 relative (the port takes reverse-mode gradients, the
  JAX package forward-mode ones: in float64 they agree to rounding);
- ``LBFGSOptimizer`` (scipy's BFGS with the port's gradients) reaches the
  JAX package's optimum (``jax.scipy.optimize.minimize``, BFGS) within
  1e-4 relative on the two-parameter TwoLayer toy of ``tests/test_nuts.py``
  (maximum likelihood from inside the support: both BFGS are
  unconstrained, and the JAX package's steps out of the prior's support
  from the midpoint);
- ``laplace_covariance`` there agrees within 1e-6 relative.
"""

import numpy as np
import pytest

import rscm_tpu.calibrate as jc
import rscm_tpu_torch.calibrate as pc
from rscm_tpu.magicc.calibration import magicc_calibration as jax_magicc_calibration
from rscm_tpu_torch.magicc.calibration import magicc_calibration
from test_torch_support import toy_problem


def test_adam_tracks_the_jax_iterates_on_magicc():
    kwargs = dict(years=np.arange(1850.0, 1858.0), param_names=["ecs", "tau_oh", "beta"],
                  obs_interval=2, model_kwargs={"ocean_params": {"history_dtype": "float32"}})
    ref, port = jax_magicc_calibration(**kwargs), magicc_calibration(device="cpu", **kwargs)
    lower, upper = map(np.asarray, ref.params.bounds())
    x0 = list(lower + np.random.default_rng(7).random(len(lower)) * (upper - lower))
    want = jc.PointEstimator(ref.params, ref.runner, ref.likelihood, ref.target).optimize(
        jc.AdamOptimizer(learning_rate=0.08, n_steps=20), x0=x0)
    got = pc.PointEstimator(port.params, port.runner, port.likelihood, port.target).optimize(
        pc.AdamOptimizer(learning_rate=0.08, n_steps=20, fwd_threshold=0), x0=x0)
    np.testing.assert_allclose(got.best_params, want.best_params, rtol=1e-6)
    np.testing.assert_allclose(got.best_log_posterior, want.best_log_posterior, rtol=1e-6)
    assert got.converged and got.n_evaluations == want.n_evaluations == 20
    # the iterate moved from x0 and stayed inside the support
    assert np.all(np.asarray(got.best_params) != x0)
    assert np.all((lower < got.best_params) & (np.asarray(got.best_params) < upper))


@pytest.fixture(scope="module")
def toys():
    return (toy_problem("rscm_tpu", ("lambda0", "eta")),
            toy_problem("rscm_tpu_torch", ("lambda0", "eta")))


def test_lbfgs_reaches_the_jax_optimum_and_laplace_covariance_matches(toys):
    (jp, jr, jl, jt), (pp, pr, pl, pt) = toys
    ref = jc.PointEstimator(jp, jr, jl, jt)
    port = pc.PointEstimator(pp, pr, pl, pt)
    x0 = [1.0, 0.9]
    want = ref.optimize(jc.LBFGSOptimizer(n_steps=100, kind=jc.EstimateKind.ML), x0=x0)
    got = port.optimize(pc.LBFGSOptimizer(n_steps=100, kind=pc.EstimateKind.ML), x0=x0)
    assert got.converged
    np.testing.assert_allclose(got.best_params, want.best_params, rtol=1e-4)
    np.testing.assert_allclose(got.best_params, [1.2, 0.7], rtol=0.1)

    theta = np.asarray(want.best_params)
    want_cov = ref.laplace_covariance(theta)
    np.testing.assert_allclose(port.laplace_covariance(theta), want_cov, rtol=1e-6)
