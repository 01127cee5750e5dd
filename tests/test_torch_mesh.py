"""Splitting the batch over a device mesh (``make_mesh``, ``run(mesh=)``,
``mesh=`` on the samplers) on the CPU.

The port's sharded runs go over ``make_mesh(devices=["cpu"] * 8)`` and are
held against the port's unsharded runs (rtol 1e-12, atol 0 beyond index 0:
the bar of ``tests/test_ensemble.py:342-345``) and against ``rscm_tpu``'s
sharded runs on the 8 virtual CPU devices ``tests/conftest.py`` gives.  The
JAX package's runs use the configurations of ``tests/test_ensemble.py:73-160``
and ``:307-395``.  Against the JAX package the bar is rtol 1e-12 with an
atol of 1e-14: the temperatures cross zero in the first years, where the two
packages' ~1e-15 K of rounding is a large relative error.  On the CPU a
shard is not always bit-equal to the unsharded run: PyTorch's vectorised
and scalar loops round some transcendentals differently, and which runs
depends on the batch.

Also here: ``batched_params(mesh=, device=)`` placement, ``make_mesh``'s
refusals, the device-engine sampler's same-seed chain and its "divisible"
refusal (``tests/test_calibration.py:361-408``), and NUTS on a mesh
(``tests/test_nuts.py:161-200``): the reference's contract is statistical;
on the CPU the port's sharded chains equal its unsharded chains at 1e-12.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import rscm_tpu_torch.calibrate as pc
from rscm_tpu.parallel import EnsembleRunner as JaxRunner
from rscm_tpu.parallel import make_mesh as jax_make_mesh
from rscm_tpu_torch.calibrate.gradients import value_and_grad
from rscm_tpu_torch.parallel import EnsembleRunner, Mesh, make_mesh
from rscm_tpu_torch.utils import mesh_context, mesh_platform
from test_torch_support import toy_problem

SAME = dict(rtol=1e-12, atol=0.0)
JAX_TOL = dict(rtol=1e-12, atol=1e-14)
ST = "Surface Temperature"
TWO_LAYER_PARAMS = dict(lambda0=1.0, a=0.0, efficacy=1.0, eta=0.7,
                        heat_capacity_surface=8.0, heat_capacity_deep=100.0)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


def two_layer(pkg, years, erf):
    """``tests/test_ensemble.py::build_model`` in package ``pkg``."""
    core = importlib.import_module(f"{pkg}.core")
    components = importlib.import_module(f"{pkg}.components")
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(components.TwoLayer(**TWO_LAYER_PARAMS))
        .with_exogenous_variable("Effective Radiative Forcing",
                                 core.Timeseries.from_values(erf, years))
        .with_initial_values({"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0})
        .build()
    )


def jax_sharded(model, overrides, out_vars, exo=None):
    """``rscm_tpu``'s run over its 8 virtual CPU devices, as numpy."""
    mesh = jax_make_mesh()
    runner = JaxRunner(model)
    out = runner.run(params=runner.batched_params(overrides, mesh=mesh), exo=exo, mesh=mesh,
                     out_vars=out_vars)
    return {name: np.asarray(v) for name, v in out.items()}


def assert_sharded(sharded, unsharded, jax_out, names):
    for name in names:
        got = sharded[name].numpy()
        assert got.shape == tuple(unsharded[name].shape) == jax_out[name].shape, name
        assert np.all(np.isfinite(got[:, 1:])), name
        np.testing.assert_allclose(got[:, 1:], unsharded[name].numpy()[:, 1:], err_msg=name,
                                   **SAME)
        np.testing.assert_allclose(got[:, 1:], jax_out[name][:, 1:], err_msg=name, **JAX_TOL)


# -- the mesh ---------------------------------------------------------------------


def test_make_mesh_and_its_refusals():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.size == 8 and mesh.axis_names == ("batch",)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_mesh(3, axis_name="walkers", devices=["cpu"] * 8).size == 3
    assert make_mesh(3, axis_name="walkers", devices=["cpu"] * 8).axis_names == ("walkers",)
    assert mesh_platform(mesh) == "cpu"
    with mesh_context(mesh), mesh_context(None):
        pass
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.devices = ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh(0, devices=["cpu"])


def test_run_refuses_an_object_that_is_not_a_mesh():
    years = np.arange(2000.0, 2005.0)
    runner = EnsembleRunner(two_layer("rscm_tpu_torch", years, np.full(len(years), 3.7)),
                            device="cpu")
    params = runner.batched_params({"TwoLayer.lambda0": np.ones(2)})
    with pytest.raises(TypeError, match="Mesh"):
        runner.run(params, mesh=object())


def test_batched_params_placement():
    """Batched leaves go to ``device``, else to the mesh's first device, else
    to the runner's; unswept parameters stay host scalars (the meta device
    stands in for a second device on the CPU)."""
    years = np.arange(2000.0, 2005.0)
    runner = EnsembleRunner(two_layer("rscm_tpu_torch", years, np.full(len(years), 3.7)),
                            device="cpu")
    lambdas = {"TwoLayer.lambda0": np.linspace(0.7, 2.0, 4)}
    meta = make_mesh(devices=["meta", "cpu"])
    for kwargs, want in (({}, "cpu"), ({"mesh": meta}, "meta"),
                         ({"mesh": meta, "device": "cpu"}, "cpu"), ({"device": "meta"}, "meta")):
        params = runner.batched_params(lambdas, **kwargs)
        (node,) = params
        assert params[node]["lambda0"].device.type == want, kwargs
        assert params[node]["lambda0"].shape == (4,)
        for name, value in params[node].items():
            if name != "lambda0":
                assert isinstance(value, np.ndarray) and value.ndim == 0, name


# -- ensembles ----------------------------------------------------------------------


@pytest.mark.parametrize("batch", [16, 11])
def test_two_layer_even_and_uneven_batches(mesh, batch):
    """``tests/test_ensemble.py:73-124``: an uneven batch pads with its last
    member and sheds the padding."""
    years = np.arange(2000.0, 2015.0)
    erf = np.full(len(years), 3.7)
    overrides = {"TwoLayer.lambda0": np.linspace(0.7, 2.0, batch)}
    runner = EnsembleRunner(two_layer("rscm_tpu_torch", years, erf), device="cpu")
    params = runner.batched_params(overrides)
    unsharded = runner.run(params, out_vars=[ST])
    sharded = runner.run(params, mesh=mesh, out_vars=[ST])
    assert sharded[ST].shape == (batch, len(years), 1)
    assert_sharded(sharded, unsharded,
                   jax_sharded(two_layer("rscm_tpu", years, erf), overrides, [ST]), [ST])
    # the full loop shards the same way, every trajectory returned
    full = runner.run(params, mesh=mesh, stream=False)
    assert set(full) == {ST, "Deep Ocean Temperature"}
    torch.testing.assert_close(full[ST], unsharded[ST], rtol=0, atol=0)


@pytest.mark.parametrize("n_scenarios", [8, 5])
def test_batched_exogenous_scenarios_shard(mesh, n_scenarios):
    """``tests/test_ensemble.py:126-160``: batched ``exo`` rows split with the
    parameters (the batch comes from the scenarios alone in the uneven
    case, one scenario per device and three devices of padding)."""
    years = np.arange(2000.0, 2012.0)
    zeros = np.zeros(len(years))
    scenarios = np.stack([np.full((len(years), 1), f)
                          for f in np.linspace(1.0, 4.0, n_scenarios)])
    exo = {"Effective Radiative Forcing": scenarios}
    runner = EnsembleRunner(two_layer("rscm_tpu_torch", years, zeros), device="cpu")
    params = (runner.batched_params({"TwoLayer.lambda0": np.ones(n_scenarios)})
              if n_scenarios == 8 else runner.base_params())
    unsharded = runner.run(params, exo=exo, out_vars=[ST])
    sharded = runner.run(params, exo={k: torch.as_tensor(v) for k, v in exo.items()},
                         mesh=mesh, out_vars=[ST])
    temps = sharded[ST].numpy()
    assert temps.shape == (n_scenarios, len(years), 1)
    assert np.all(np.diff(temps[:, -1, 0]) > 0)
    jax_out = jax_sharded(two_layer("rscm_tpu", years, zeros),
                          {"TwoLayer.lambda0": np.ones(n_scenarios)}, [ST], exo=exo)
    assert_sharded(sharded, unsharded, jax_out, [ST])


MAGICC_OUT = ["Surface Temperature", "Atmospheric Concentration|CO2",
              "Atmospheric Concentration|CH4"]


def magicc_overrides(batch):
    """``tests/test_ensemble.py:321-335``."""
    rng = np.random.default_rng(3)
    return {"ClimateUDEB.ecs": rng.uniform(2.0, 4.5, batch),
            "TerrestrialCarbon.beta": rng.uniform(0.3, 0.9, batch)}


def test_magicc_graph_on_a_mesh(mesh):
    """``tests/test_ensemble.py:307-360``: the ten-component graph, 16
    members over the 8 devices, streamed."""
    from rscm_tpu.magicc.coupled import build_magicc_model as jax_magicc
    from rscm_tpu_torch.magicc.coupled import build_magicc_model

    years = np.arange(1850.0, 1871.0)
    overrides = magicc_overrides(16)
    runner = EnsembleRunner(build_magicc_model(years=years), device="cpu")
    unsharded = runner.run(runner.batched_params(overrides), out_vars=MAGICC_OUT)
    sharded = runner.run(runner.batched_params(overrides, mesh=mesh), mesh=mesh,
                         out_vars=MAGICC_OUT)
    assert_sharded(sharded, unsharded,
                   jax_sharded(jax_magicc(years=years), overrides, MAGICC_OUT), MAGICC_OUT)

    # each device of the mesh keeps its program and its gathered inputs
    assert runner._programs == {} and len(runner._inputs) == 1


def test_permafrost_slr_variant_on_a_mesh(mesh):
    """``tests/test_ensemble.py:372-395``: the graph with permafrost and
    sea-level rise, 16 members over the 8 devices."""
    from rscm_tpu.magicc.coupled import build_magicc_model as jax_magicc
    from rscm_tpu_torch.magicc.coupled import build_magicc_model

    years = np.arange(1850.0, 1863.0)
    out_vars = ["Sea Level Rise", "Permafrost|Total Pool"]
    overrides = {"ClimateUDEB.ecs": np.linspace(2.0, 4.5, 16)}
    runner = EnsembleRunner(
        build_magicc_model(years=years, include_permafrost=True, include_slr=True), device="cpu")
    unsharded = runner.run(runner.batched_params(overrides), out_vars=out_vars)
    sharded = runner.run(runner.batched_params(overrides, mesh=mesh), mesh=mesh,
                         out_vars=out_vars)
    jax_out = jax_sharded(
        jax_magicc(years=years, include_permafrost=True, include_slr=True), overrides, out_vars)
    assert_sharded(sharded, unsharded, jax_out, out_vars)


# -- calibration ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy():
    return toy_problem("rscm_tpu_torch", ("lambda0",), years=np.arange(2000.0, 2021.0))


def sample(toy, mesh, n_walkers, engine="device", n_iterations=4):
    sampler = pc.EnsembleSampler(*toy)
    chain = sampler.run(n_iterations=n_iterations, init=pc.WalkerInit.from_prior(), thin=1,
                        n_walkers=n_walkers, seed=21, engine=engine, mesh=mesh)
    return chain


def test_device_sampler_on_a_mesh_gives_the_same_chain(toy, mesh):
    """``tests/test_calibration.py:361-388``: the same seed gives the same
    chain (the proposals are drawn on the mesh's first device)."""
    n_walkers = 4 * mesh.size
    plain = sample(toy, None, n_walkers)
    sharded = sample(toy, mesh, n_walkers)
    assert sharded.flat_samples(discard=0).shape == (4 * n_walkers, 1)
    assert np.all(np.isfinite(sharded.flat_samples(discard=0)))
    np.testing.assert_allclose(sharded.flat_samples(discard=0), plain.flat_samples(discard=0),
                               **SAME)
    np.testing.assert_allclose(sharded.flat_log_probs(), plain.flat_log_probs(), **SAME)


def test_device_sampler_mesh_rejects_indivisible_walkers(toy, mesh):
    """``tests/test_calibration.py:390-408``."""
    with pytest.raises(ValueError, match="divisible"):
        sample(toy, mesh, 2 * mesh.size + 2, n_iterations=2)


def test_host_engine_ignores_the_mesh(toy, mesh):
    plain = sample(toy, None, 6, engine="host", n_iterations=2)
    sharded = sample(toy, mesh, 6, engine="host", n_iterations=2)
    np.testing.assert_array_equal(sharded.flat_samples(discard=0), plain.flat_samples(discard=0))


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_gradient_through_the_mesh(mode):
    """A batched value and gradient of the log posterior, split over the
    mesh, in both modes, equals the unsplit one."""
    toy2 = toy_problem("rscm_tpu_torch", ("lambda0", "eta"), years=np.arange(2000.0, 2011.0))
    log_prob = pc.EnsembleSampler(*toy2)._build_device_log_prob()
    thetas = torch.tensor([[1.1, 0.6], [1.4, 0.9], [0.9, 0.5], [2.0, 1.2]], dtype=torch.float64)
    mesh = make_mesh(devices=["cpu"] * 2)
    value, grad = value_and_grad(log_prob, thetas, mode)
    s_value, s_grad = value_and_grad(lambda t: log_prob(t, mesh=mesh), thetas, mode)
    np.testing.assert_allclose(s_value.numpy(), value.numpy(), **SAME)
    np.testing.assert_allclose(s_grad.numpy(), grad.numpy(), **SAME)
    assert bool((grad != 0).all())


def test_nuts_on_a_mesh(toy):
    """``tests/test_nuts.py:161-200`` at a size out of the slow marker: the
    chains split over the mesh sample the same posterior; on the CPU the
    split chains equal the unsplit ones at 1e-12.  Chains that do not
    divide over the mesh are refused."""
    mesh = make_mesh(devices=["cpu"] * 4)

    def run(mesh):
        sampler = pc.NUTSSampler(*toy, max_tree_depth=2, grad_mode="rev")
        chain = sampler.run(n_iterations=2, n_chains=8, warmup=1, seed=13, mesh=mesh)
        return chain, sampler.last_diagnostics

    plain, plain_diag = run(None)
    sharded, diag = run(mesh)
    flat, flat_plain = sharded.flat_samples(), plain.flat_samples()
    assert flat.shape == (2 * 8, 1) and np.all(np.isfinite(flat))
    assert flat[:, 0].mean() == pytest.approx(flat_plain[:, 0].mean(), abs=0.02)
    assert flat[:, 0].std() == pytest.approx(flat_plain[:, 0].std(), rel=0.5)
    np.testing.assert_allclose(flat, flat_plain, **SAME)
    np.testing.assert_allclose(sharded.flat_log_probs(), plain.flat_log_probs(), **SAME)
    assert diag["n_model_evals"] == plain_diag["n_model_evals"]
    with pytest.raises(ValueError, match="divisible"):
        pc.NUTSSampler(*toy, max_tree_depth=2).run(n_iterations=1, n_chains=6, warmup=1,
                                                   seed=1, mesh=mesh)
