"""The MAGICC calibration problem: the port against the JAX package.

``magicc_calibration`` builds the same synthetic-truth problem in both
packages (the same truth run, and the same numpy noise from the same
seed); the MAP objective — the negative log posterior through the whole
ten-component graph — and its gradient are held against the JAX
package's ``jax.value_and_grad`` at the same point:

- with the ocean carbon flux history in the working dtype (float64 here),
  the objective agrees within 1e-9 and the gradient within 1e-7 of its
  largest component;
- with the production bfloat16 history, the two packages round the
  history's tangents at different places, so the gradient is held at the
  JAX package's own bar for its two modes under bfloat16 (rtol 2e-2,
  atol 1e-6 x max, cosine > 0.999999;
  ``tests/test_calibration_magicc.py:136-167``);
- (``tests/test_torch_calib_sensitivity.py`` holds the sensitivities.)

The time axis is cut to 1850-1870 (the JAX package's own CPU tests cut
the 1850-2100 problem to 81-101 years; the port's CPU gradient costs about
0.4 s a model year).
"""

import jax
import numpy as np
import pytest
import torch

from rscm_tpu.calibrate import EstimateKind as JaxEstimateKind
from rscm_tpu.calibrate import PointEstimator as JaxPointEstimator
from rscm_tpu.magicc.calibration import magicc_calibration as jax_magicc_calibration
from rscm_tpu_torch.calibrate import EstimateKind, PointEstimator
from rscm_tpu_torch.calibrate.gradients import value_and_grad
from rscm_tpu_torch.magicc.calibration import MAGICC_PARAM_SPECS, magicc_calibration

YEARS = np.arange(1850.0, 1871.0)
FLOAT_HISTORY = {"ocean_params": {"history_dtype": "float32"}}  # the working dtype


def pair(**kwargs):
    return (magicc_calibration(device="cpu", **kwargs), jax_magicc_calibration(**kwargs))


@pytest.fixture(scope="module")
def float_history():
    return pair(years=YEARS, obs_interval=4, model_kwargs=FLOAT_HISTORY)


@pytest.fixture(scope="module")
def bf16_history():
    return pair(years=YEARS, obs_interval=4)


def objective_and_gradient(port, ref, theta):
    """The MAP objective and its reverse-mode gradient in both packages."""
    est = PointEstimator(port.params, port.runner, port.likelihood, port.target)
    value, grad = value_and_grad(est._traced_objective(EstimateKind.MAP),
                                 port.runner.as_theta(theta[None]), "rev")
    jax_est = JaxPointEstimator(ref.params, ref.runner, ref.likelihood, ref.target)
    want_value, want_grad = jax.jit(jax.value_and_grad(
        jax_est._traced_objective(JaxEstimateKind.MAP)))(theta)
    return (float(value[0]), grad[0].numpy()), (float(want_value), np.asarray(want_grad))


def test_the_problem_is_the_jax_packages(float_history):
    port, ref = float_history
    assert port.param_names == list(MAGICC_PARAM_SPECS) == ref.param_names
    np.testing.assert_array_equal(port.theta_true, ref.theta_true)
    for name, vt in ref.target.variables.items():
        got = port.target.variables[name].observations
        assert [o.time for o in got] == [o.time for o in vt.observations]
        np.testing.assert_allclose([o.value for o in got], [o.value for o in vt.observations],
                                   rtol=1e-9)


def test_map_objective_and_gradient_match_jax_float_history(float_history):
    port, ref = float_history
    rng = np.random.default_rng(0)
    lower, upper = map(np.asarray, ref.params.bounds())
    theta = ref.theta_true + 0.05 * (upper - lower) * rng.uniform(-1.0, 1.0, len(lower))
    (value, grad), (want_value, want_grad) = objective_and_gradient(port, ref, theta)
    np.testing.assert_allclose(value, want_value, rtol=1e-9)
    assert np.all(np.abs(grad) > 0.0)  # the gradient reaches every subsystem
    np.testing.assert_allclose(grad, want_grad, rtol=0.0, atol=1e-7 * np.max(np.abs(want_grad)))


def test_map_gradient_matches_jax_at_the_bf16_bar(bf16_history):
    port, ref = bf16_history
    (value, grad), (want_value, want_grad) = objective_and_gradient(port, ref, ref.theta_true)
    np.testing.assert_allclose(value, want_value, rtol=1e-9)
    scale = np.max(np.abs(want_grad))
    np.testing.assert_allclose(grad, want_grad, rtol=2e-2, atol=1e-6 * scale)
    cos = np.dot(grad, want_grad) / (np.linalg.norm(grad) * np.linalg.norm(want_grad))
    assert cos > 0.999999, cos
