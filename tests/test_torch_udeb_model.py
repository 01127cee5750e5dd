"""ClimateUDEB through the port against the JAX package's XLA engine.

The same model (ClimateUDEB driven by an exogenous ERF step) is built with
both packages' ``ModelBuilder`` and run to the end: the JAX package's
compiled program with ``month_engine="xla"``, the port's year loop on the
CPU with its plain engine.  The parameter sets and the 1e-9 bar are those
of ``tests/test_udeb_pallas.py``, which holds the Pallas engine to the XLA
one the same way.
"""

import numpy as np
import pytest
import torch

from test_torch_support import UDEB_OUTPUTS, build_udeb, step_erf, values

YEARS = np.arange(1850.0, 1900.0)
PARAM_SETS = [
    {},  # defaults: time-varying ECS, land heat, variable upwelling
    {"efficacy_apply": 2},
    {"land_heat_capacity_enabled": False},
    {"w_variable_fraction": 0.0, "feedback_cumt_sensitivity": 0.0,
     "feedback_q_sensitivity": 0.0},
    {"n_layers": 17},
]
#: a feedback window as long as the cumulative-temperature ring, so every
#: year retires the slot it is about to overwrite
FULL_RING = {"feedback_cumt_period": 20.0, "history_capacity": 20}


@pytest.mark.parametrize("params", PARAM_SETS)
def test_torch_engine_matches_xla(params):
    erf = step_erf(YEARS)
    xla = build_udeb("rscm_tpu", YEARS, erf, month_engine="xla", **params)
    xla.run(compiled=True)
    port = build_udeb("rscm_tpu_torch", YEARS, erf, month_engine="torch", **params)
    port.run(device="cpu")
    for name in UDEB_OUTPUTS:
        np.testing.assert_allclose(
            values(port, name), values(xla, name), rtol=1e-9, atol=1e-9, err_msg=name
        )


def test_engines_agree_on_cpu():
    """On CPU tensors the kernels' wrappers take the plain versions, so the
    "cuda" and "auto" engines give the "torch" engine's numbers exactly."""
    years = YEARS[:12]
    erf = step_erf(years)
    runs = {}
    for engine in ("torch", "cuda", "auto"):
        model = build_udeb("rscm_tpu_torch", years, erf, month_engine=engine)
        model.run(device="cpu")
        runs[engine] = values(model, "Surface Temperature")
    np.testing.assert_array_equal(runs["cuda"], runs["torch"])
    np.testing.assert_array_equal(runs["auto"], runs["torch"])


def test_unknown_engine_raises():
    model = build_udeb("rscm_tpu_torch", YEARS[:3], step_erf(YEARS[:3]), month_engine="mosaic")
    with pytest.raises(ValueError, match="month_engine"):
        model.run(device="cpu")


def test_float32_run_tracks_float64():
    """The working dtype follows the runner: a float32 run of the plain
    engine stays within float32 rounding of the float64 run."""
    from rscm_tpu_torch.parallel import EnsembleRunner

    erf = step_erf(YEARS)
    out = {}
    for dtype in (torch.float64, torch.float32):
        runner = EnsembleRunner(build_udeb("rscm_tpu_torch", YEARS, erf), dtype=dtype,
                                device="cpu")
        params = runner.batched_params({"ClimateUDEB.ecs": np.array([2.5, 4.0])})
        out[dtype] = runner.run(params, out_vars=["Surface Temperature"])["Surface Temperature"]
    assert out[torch.float32].dtype == torch.float32
    np.testing.assert_allclose(out[torch.float32].double().numpy(),
                               out[torch.float64].numpy(), rtol=1e-4, atol=1e-4)


def test_full_ring_model_matches_xla():
    erf = step_erf(YEARS)
    xla = build_udeb("rscm_tpu", YEARS, erf, month_engine="xla", **FULL_RING)
    xla.run(compiled=True)
    port = build_udeb("rscm_tpu_torch", YEARS, erf, month_engine="torch", **FULL_RING)
    port.run(device="cpu")
    for name in UDEB_OUTPUTS:
        np.testing.assert_allclose(
            values(port, name), values(xla, name), rtol=1e-9, atol=1e-9, err_msg=name
        )


def test_full_ring_ensemble_matches_jax_runner():
    """Four members: from the second year on the ring is batched and
    written in place."""
    from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
    from rscm_tpu_torch.parallel import EnsembleRunner

    erf = step_erf(YEARS)
    sweep = {"ClimateUDEB.ecs": np.array([2.0, 3.0, 4.0, 5.0])}
    jax_runner = JaxEnsembleRunner(
        build_udeb("rscm_tpu", YEARS, erf, month_engine="xla", **FULL_RING)
    )
    want = jax_runner.run(params=jax_runner.batched_params(sweep), out_vars=UDEB_OUTPUTS)
    runner = EnsembleRunner(
        build_udeb("rscm_tpu_torch", YEARS, erf, month_engine="torch", **FULL_RING), device="cpu"
    )
    got = runner.run(runner.batched_params(sweep), out_vars=UDEB_OUTPUTS)
    for name in UDEB_OUTPUTS:
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), rtol=1e-9, atol=1e-9, err_msg=name
        )


def udeb_state(model):
    """ClimateUDEB's entry of ``model.component_states``."""
    (state,) = [s for s in model.component_states.values() if s and "ocean_temps" in s]
    return state


def test_run_writes_final_component_states_back():
    years = YEARS[:20]
    erf = step_erf(years)
    xla = build_udeb("rscm_tpu", years, erf, month_engine="xla")
    xla.run(compiled=True)
    port = build_udeb("rscm_tpu_torch", years, erf, month_engine="torch")
    port.run(device="cpu")
    want, got = udeb_state(xla), udeb_state(port)
    for key in ("ocean_temps", "th_values"):
        assert isinstance(got[key], np.ndarray)
        assert got[key].shape == np.shape(want[key]), key
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-9, atol=1e-9,
                                   err_msg=key)
    assert np.abs(got["ocean_temps"]).max() > 0.1  # the run moved the columns
