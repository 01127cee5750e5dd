"""Builder errors, device choice and linear algebra of the port.

- Build-time errors are part of the product: the port raises the same
  error types with the same messages as ``rscm_tpu``.
- Entry points run on the CUDA card unless asked for another device; with
  no card a request for the default device raises and nothing runs on the
  CPU instead.
- ``utils.linear_algebra`` host and tensor forms agree with ``rscm_tpu``'s.
"""

import numpy as np
import pytest
import torch

import rscm_tpu.core as jax_core
import rscm_tpu.core.errors as jax_errors
import rscm_tpu.utils.linear_algebra as jax_la
import rscm_tpu_torch.core as core
import rscm_tpu_torch.core.errors as errors
import rscm_tpu_torch.utils.linear_algebra as la
from rscm_tpu_torch.utils.target import resolve_device
from test_torch_support import build_udeb, step_erf

YEARS = np.arange(1850.0, 1856.0)


def _raise(pkg_core, pkg_errors, builder_fn, error_name):
    with pytest.raises(getattr(pkg_errors, error_name)) as info:
        builder_fn(pkg_core).build()
    return str(info.value)


def missing_initial_value(pkg_core):
    import importlib

    magicc = importlib.import_module(pkg_core.__name__.replace(".core", ".magicc"))
    axis = pkg_core.TimeAxis.from_values(YEARS)
    return (
        pkg_core.ModelBuilder()
        .with_time_axis(axis)
        .with_component(magicc.ClimateUDEB())
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            pkg_core.Timeseries(step_erf(YEARS)[:, None], axis,
                                pkg_core.ScalarGrid(), "W/m^2"),
        )
    )


def incompatible_units(pkg_core):
    schema = missing_initial_value(pkg_core)
    schema_ = pkg_core.VariableSchema()
    schema_.add_variable("Effective Radiative Forcing", "GtC/yr")
    schema_.add_variable("Surface Temperature", "K", pkg_core.GridType.FourBox)
    schema_.add_variable("Heat Uptake", "W/m^2")
    schema_.add_variable("Ocean Heat Content", "J/m^2")
    schema_.add_variable("Sea Surface Temperature", "K")
    return schema.with_schema(schema_).with_initial_values({"Surface Temperature": 0.0})


def undefined_output(pkg_core):
    schema_ = pkg_core.VariableSchema()
    schema_.add_variable("Effective Radiative Forcing", "W/m^2")
    schema_.add_variable("Surface Temperature", "K", pkg_core.GridType.FourBox)
    return (
        missing_initial_value(pkg_core)
        .with_schema(schema_)
        .with_initial_values({"Surface Temperature": 0.0})
    )


@pytest.mark.parametrize(
    "builder_fn, error_name",
    [
        (missing_initial_value, "MissingInitialValueError"),
        (incompatible_units, "IncompatibleUnitsError"),
        (undefined_output, "SchemaUndefinedOutputError"),
    ],
)
def test_builder_errors_match_rscm_tpu(builder_fn, error_name):
    want = _raise(jax_core, jax_errors, builder_fn, error_name)
    got = _raise(core, errors, builder_fn, error_name)
    assert got == want


def test_converted_units_read_the_same():
    """A component input in other (compatible) units than the schema's is
    read through the same conversion factor in both packages."""
    from rscm_tpu.core.units import Unit as JaxUnit
    from rscm_tpu_torch.core.units import Unit

    for a, b in [("W/m^2", "mW/m^2"), ("GtC/yr", "MtCO2/yr"), ("K", "mK")]:
        assert Unit.parse(a).conversion_factor(Unit.parse(b)) == pytest.approx(
            JaxUnit.parse(a).conversion_factor(JaxUnit.parse(b)), rel=1e-15
        )


def test_default_device_without_card_raises(monkeypatch):
    from rscm_tpu_torch.parallel import EnsembleRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    model = build_udeb("rscm_tpu_torch", YEARS, step_erf(YEARS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnsembleRunner(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.run()
    assert np.isnan(model.collection.get_data("Sea Surface Temperature").values()[1:]).all()
    assert resolve_device("cpu") == torch.device("cpu")
    model.run(device="cpu")
    assert np.isfinite(model.collection.get_data("Sea Surface Temperature").values()[1:]).all()


def tridiagonal(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 0.0, shape)
    c = rng.uniform(-1.0, 0.0, shape)
    b = 2.5 + rng.uniform(0.0, 1.0, shape)
    d = rng.uniform(-3.0, 3.0, shape)
    return a, b, c, d


def test_thomas_solve_host_and_tensor_forms():
    a, b, c, d = tridiagonal(0, (50,))
    host = la.thomas_solve(a, b, c, d)
    np.testing.assert_allclose(host, jax_la.thomas_solve(a, b, c, d), rtol=1e-15)
    np.testing.assert_allclose(host, np.linalg.solve(
        np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1), d), rtol=1e-12)

    batch = tridiagonal(1, (3, 2, 50))
    got = la.thomas_solve_batched(*(torch.tensor(x) for x in batch))
    want = np.asarray(jax_la.thomas_solve_batched(*batch))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)
    assert torch.equal(la.thomas_solve(*(torch.tensor(x) for x in batch)), got)


def test_invert_4x4_host_and_tensor_forms():
    rng = np.random.default_rng(4)
    m = rng.uniform(-1.0, 1.0, (6, 4, 4)) + 4.0 * np.eye(4)
    for k in range(len(m)):
        np.testing.assert_allclose(la.invert_4x4(m[k]), jax_la.invert_4x4(m[k]), rtol=1e-14)
    got = la.invert_4x4(torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_la.invert_4x4_traced(m)),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(got.numpy() @ m, np.broadcast_to(np.eye(4), m.shape), atol=1e-12)
    assert la.invert_4x4(np.zeros((4, 4))) is None
