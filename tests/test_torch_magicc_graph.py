"""The ten-component emissions-driven MAGICC graph through the port.

``build_magicc_model`` over 1850-1930 is built in both packages:

- one member, ``Model.run`` on the CPU, against the reference's compiled
  run and its host run, at 1e-9 (rtol) on every variable the graph
  computes;
- a 16-member ``EnsembleRunner.run`` swept over ECS, kappa and
  ``TerrestrialCarbon.beta`` (the JAX package's bench sweep), the port's
  parameters carried across with ``params_from_jax``, against
  ``rscm_tpu``'s ``EnsembleRunner.run`` at 1e-8;
- the same with static parameters set on the JAX model (the exp-sum
  engine, a bfloat16 ring history, the OLBL forcing method, 30 layers)
  carried across
  with ``static_params_from_jax`` / ``apply_static_params``; the bfloat16
  history is held at the component test's 1e-5;
- the permafrost and sea-level branches, each alone, at one member.
"""

import numpy as np
import pytest
import torch

from rscm_tpu.magicc.coupled import build_magicc_model as jax_build
from rscm_tpu.parallel import EnsembleRunner as JaxEnsembleRunner
from rscm_tpu_torch.magicc.carbon.ocean import OCEAN_CARBON_PRESETS
from rscm_tpu_torch.convert import apply_static_params, params_from_jax, static_params_from_jax
from rscm_tpu_torch.magicc.coupled import FORCER_VARIABLES, build_magicc_model
from rscm_tpu_torch.parallel import EnsembleRunner

YEARS = np.arange(1850.0, 1931.0)
B = 16
OUT = ["Surface Temperature", "Atmospheric Concentration|CO2",
       "Atmospheric Concentration|CH4", "Carbon Flux|Ocean", "Carbon Pool|Soil"]


def sweep(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "ClimateUDEB.ecs": rng.uniform(1.8, 5.5, B),
        "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, B),
        "TerrestrialCarbon.beta": rng.uniform(0.3, 0.9, B),
    }


def trajectories(model):
    return {item.name: np.asarray(model.collection.get_data(item.name).values())
            for item in model.collection}


@pytest.fixture(scope="module")
def port_single():
    model = build_magicc_model(years=YEARS)
    model.run(device="cpu")
    return trajectories(model)


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "host"])
def test_single_member_matches_jax(port_single, compiled):
    ref = jax_build(years=YEARS)
    ref.run(compiled=compiled)
    want = trajectories(ref)
    assert set(port_single) == set(want)
    assert {"Effective Radiative Forcing", *FORCER_VARIABLES} <= set(want)
    for name, got in port_single.items():
        assert got.shape == want[name].shape, name
        np.testing.assert_allclose(got, want[name], rtol=1e-9, atol=1e-12, err_msg=name)
    erf = port_single["Effective Radiative Forcing"][1:]
    forcers = sum(port_single[name][1:] for name in FORCER_VARIABLES)
    np.testing.assert_allclose(erf, forcers, rtol=1e-12, atol=1e-12)
    assert np.isfinite(port_single["Surface Temperature"][1:]).all()


@pytest.mark.parametrize(
    "ocean_params, udeb_params, forcing_method, engine, tol",
    [
        (None, None, None, "ring", 1e-8),
        ({"engine": "expsum"}, {"n_layers": 30}, "Olbl", "expsum", 1e-8),
        ({"history_dtype": "bfloat16"}, None, None, "ring", 1e-5),
    ],
    ids=["default", "expsum_olbl_30_layers", "ring_bfloat16"],
)
def test_ensemble_matches_jax_runner(ocean_params, udeb_params, forcing_method, engine, tol):
    """The axis's 984-month window is below the exp-sum threshold, so the
    default engine is the ring here (exp-sum from 120 years up)."""
    swept = sweep()
    ref = jax_build(years=YEARS, ocean_params=ocean_params, udeb_params=udeb_params)
    if forcing_method is not None:
        node = next(n for n, c in enumerate(ref.graph.nodes) if type(c).__name__ == "GhgForcing")
        ref.graph.nodes[node].method = forcing_method
    jax_runner = JaxEnsembleRunner(ref)
    want = jax_runner.run(jax_runner.batched_params(swept), out_vars=OUT)

    model = build_magicc_model(years=YEARS)
    apply_static_params(model, static_params_from_jax(ref))
    runner = EnsembleRunner(model, device="cpu")
    params = params_from_jax(jax_runner.program.gather_params(), swept,
                             node_names=runner.program.node_names(), device="cpu",
                             dtype=torch.float64)
    ocean = next(c for c in model.graph.nodes if type(c).__name__ == "OceanCarbon")
    assert ocean.resolved_engine() == engine
    got = runner.run(params, out_vars=OUT)
    for name in OUT:
        w = np.asarray(want[name])
        assert tuple(got[name].shape) == w.shape == (B, len(YEARS), w.shape[-1]), name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=tol, atol=1e-9, err_msg=name)


#: ring engine against its exp-sum twin, max |ring - expsum| over max
#: |expsum| per variable: the tail fit's <= 1e-8 relative error with the
#: history in the run's dtype; a bfloat16 history rounds each stored flux
#: at 2^-9.  chip_smoke.py holds the card's run to the same bounds.
RING_TWIN = {"float32": 1e-8, "bfloat16": 5e-3}


def scale_relative(a, b):
    return float(np.nanmax(np.abs(a - b)) / np.nanmax(np.abs(b)))


@pytest.mark.parametrize("history_dtype", sorted(RING_TWIN))
def test_ring_matches_expsum_twin(history_dtype):
    swept = {k: v[:4] for k, v in sweep().items()}
    out = {}
    for engine in ("ring", "expsum"):
        model = build_magicc_model(years=YEARS, ocean_params={
            "engine": engine, "history_dtype": history_dtype})
        runner = EnsembleRunner(model, device="cpu")
        out[engine] = runner.run(runner.batched_params(swept), out_vars=OUT)
    for name in OUT:
        err = scale_relative(out["ring"][name].numpy(), out["expsum"][name].numpy())
        assert err < RING_TWIN[history_dtype], f"{name}: {err:.2e}"


def test_static_params_carry_across():
    ref = jax_build(years=YEARS[:5], ocean_params={"engine": "ring",
                                                   "history_dtype": "bfloat16"},
                    udeb_params={"n_layers": 17, "month_engine": "xla"})
    model = build_magicc_model(years=YEARS[:5])
    apply_static_params(model, static_params_from_jax(ref))
    comps = {type(c).__name__: c for c in model.graph.nodes}
    assert comps["OceanCarbon"].engine == "ring"
    assert comps["OceanCarbon"].history_dtype == "bfloat16"
    assert comps["ClimateUDEB"].n_layers == 17
    assert comps["ClimateUDEB"].month_engine == "torch"
    assert comps["GhgForcing"].method == "Ipcctar"
    assert comps["OceanCarbon"].irf_late == OCEAN_CARBON_PRESETS["3D-GFDL"]["irf_late"]
    node = next(n for n, c in enumerate(model.graph.nodes) if type(c).__name__ == "ClimateUDEB")
    assert model.component_states[node]["ocean_temps"].shape == (2, 17)
    model.run(device="cpu")
    with pytest.raises(ValueError, match="fresh model"):
        apply_static_params(model, static_params_from_jax(ref))


def test_unported_branches_raise():
    """The branches for the modules beyond the reference (which raised
    before ``Permafrost`` and ``SeaLevelRise`` were ported) build, each
    alone, and match the JAX package on every variable at 1e-9
    (``tests/test_torch_permafrost.py`` runs both together)."""
    for flag in ("include_permafrost", "include_slr"):
        model = build_magicc_model(years=YEARS[:11], **{flag: True})
        model.run(device="cpu")
        ref = jax_build(years=YEARS[:11], **{flag: True})
        ref.run()
        got, want = trajectories(model), trajectories(ref)
        assert set(got) == set(want)
        assert len(got) > len(trajectories(build_magicc_model(years=YEARS[:11])))
        for name, values in got.items():
            np.testing.assert_allclose(values, want[name], rtol=1e-9, atol=1e-12,
                                       err_msg=f"{flag}: {name}")
