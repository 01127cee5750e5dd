"""NUTS in forward and reverse mode give the same chains.

On a clean float64 model the two gradient engines agree to rounding, so
NUTS chains started from the same seed (the same generator state, hence
the same momenta and tree draws) agree within 1e-10 — the bar
``tests/test_nuts.py:285-301`` holds the JAX package's two engines to.
Also here: the transition is the same with and without ``stage_skip``,
and the step's bookkeeping is consistent.  The toy is the TwoLayer model
of ``tests/test_nuts.py`` on 2000-2020 (forward mode runs the gradient's
tangent directions as members of one run, at several times the cost of a
reverse-mode gradient on the CPU).
"""

import numpy as np
import pytest

import rscm_tpu_torch.calibrate as pc
from test_torch_support import toy_problem


@pytest.fixture(scope="module")
def toy():
    return toy_problem("rscm_tpu_torch", ("lambda0", "eta"), years=np.arange(2000.0, 2021.0))


def run(toy, **kwargs):
    nuts = pc.NUTSSampler(*toy, max_tree_depth=2, **kwargs)
    chain = nuts.run(n_iterations=2, n_chains=2, warmup=2, seed=5)
    return chain, nuts.last_diagnostics


def test_forward_and_reverse_mode_chains_agree(toy):
    rev, rev_diag = run(toy, grad_mode="rev")
    fwd, fwd_diag = run(toy, grad_mode="fwd")
    np.testing.assert_allclose(fwd.flat_samples(), rev.flat_samples(), rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(fwd.flat_log_probs(), rev.flat_log_probs(), rtol=1e-10)
    assert fwd_diag["n_model_evals"] == rev_diag["n_model_evals"] > 0
    np.testing.assert_allclose(fwd_diag["step_sizes"], rev_diag["step_sizes"], rtol=1e-10)


def test_stage_skip_samples_identically(toy):
    skip, skip_diag = run(toy, grad_mode="rev", stage_skip=True)
    full, full_diag = run(toy, grad_mode="rev", stage_skip=False)
    np.testing.assert_array_equal(skip.flat_samples(), full.flat_samples())
    assert skip_diag["n_model_evals"] == full_diag["n_model_evals"]
    # without the skip every stage runs: 1 + 2 leapfrog steps a transition
    assert full_diag["n_leapfrog_steps"] == 4 * 3
    assert skip_diag["n_leapfrog_steps"] <= full_diag["n_leapfrog_steps"]
    assert skip_diag["n_model_evals"] <= 2 * skip_diag["n_leapfrog_steps"]
    assert skip_diag["n_gradient_evals"] == skip_diag["n_leapfrog_steps"] + 1
