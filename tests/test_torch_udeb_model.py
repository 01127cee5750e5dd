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
]


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
    model = build_udeb("rscm_tpu_torch", YEARS[:3], step_erf(YEARS[:3]), month_engine="pallas")
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
