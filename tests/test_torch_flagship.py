"""The two-layer + carbon-cycle flagship graph (``bench.py:123-214``)
through ``rscm_tpu_torch`` against ``rscm_tpu`` on the CPU in float64.

- 16 members x 80 years through both packages' ``EnsembleRunner.run``
  with bench.py's four-parameter sweep (seed 42), at rtol 1e-12 on every
  variable the graph computes;
- one member through each of the port's executors (the year loop and the
  step-by-step executor) against the reference's compiled and host runs.
"""

import numpy as np
import pytest

from test_torch_support import FLAGSHIP_OUTPUTS, build_flagship, flagship_sweep, values

YEARS = np.arange(1750.0, 1830.0)  # 80 years
MEMBERS = 16


@pytest.fixture(scope="module")
def ensembles():
    from rscm_tpu.parallel import EnsembleRunner as JaxRunner
    from rscm_tpu_torch.parallel import EnsembleRunner

    sweep = flagship_sweep(MEMBERS)
    ref_runner = JaxRunner(build_flagship("rscm_tpu", YEARS))
    ref = ref_runner.run(params=ref_runner.batched_params(sweep), out_vars=FLAGSHIP_OUTPUTS)
    runner = EnsembleRunner(build_flagship("rscm_tpu_torch", YEARS), device="cpu")
    got = runner.run(runner.batched_params(sweep), out_vars=FLAGSHIP_OUTPUTS)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("name", FLAGSHIP_OUTPUTS)
def test_flagship_ensemble_matches_jax_runner(ensembles, name):
    ref, got = ensembles
    assert got[name].shape == (MEMBERS, len(YEARS), 1)
    assert np.isfinite(got[name][:, 1:]).all()
    np.testing.assert_allclose(got[name], ref[name], rtol=1e-12, atol=1e-12, err_msg=name)


def test_flagship_members_differ(ensembles):
    """The sweep reaches the run: every member's final temperature differs."""
    _, got = ensembles
    final = got["Surface Temperature"][:, -1, 0]
    assert len(np.unique(final)) == MEMBERS
    assert (final > 0.0).all()


@pytest.mark.parametrize("compiled", [True, False], ids=["year_loop", "step_by_step"])
def test_flagship_single_member_matches_jax(compiled):
    ref = build_flagship("rscm_tpu", YEARS)
    ref.run(compiled=compiled)
    port = build_flagship("rscm_tpu_torch", YEARS)
    port.run(compiled=compiled, device="cpu")
    for name in FLAGSHIP_OUTPUTS:
        np.testing.assert_allclose(
            values(port, name), values(ref, name), rtol=1e-12, atol=1e-12, err_msg=name
        )


def test_flagship_params_carried_from_jax():
    """The JAX runner's batched parameters, carried with ``params_from_jax``,
    give the port's runner the same ensemble."""
    from rscm_tpu.parallel import EnsembleRunner as JaxRunner
    from rscm_tpu_torch.convert import params_from_jax
    from rscm_tpu_torch.parallel import EnsembleRunner

    years = YEARS[:30]
    sweep = flagship_sweep(4, seed=7)
    ref_runner = JaxRunner(build_flagship("rscm_tpu", years))
    ref_params = ref_runner.batched_params(sweep)
    want = ref_runner.run(params=ref_params, out_vars=FLAGSHIP_OUTPUTS)
    runner = EnsembleRunner(build_flagship("rscm_tpu_torch", years), device="cpu")
    host = {nk: {pn: np.asarray(v) for pn, v in node.items()} for nk, node in ref_params.items()}
    params = params_from_jax(host, node_names=runner.program.node_names())
    assert params["1"]["tau"].shape == (4,) and isinstance(params["1"]["conc_pi"], float)
    got = runner.run(params, out_vars=FLAGSHIP_OUTPUTS)
    for name in FLAGSHIP_OUTPUTS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_static_params_of_the_new_components_carry_across():
    """``static_params_from_jax`` reads the new components' static
    parameters (CarbonCycle's RK4 step, HalocarbonChemistry's species
    table) and ``apply_static_params`` rebuilds the port's components."""
    from rscm_tpu.magicc import HALOCARBON_SPECIES as JAX_SPECIES
    from rscm_tpu_torch.convert import apply_static_params, static_params_from_jax
    from rscm_tpu_torch.magicc.chemistry.halocarbon import HalocarbonSpecies

    years = YEARS[:20]
    ref = build_flagship("rscm_tpu", years)
    ref.graph.nodes[1].step_size = 0.05  # node 0 is the graph's root
    statics = static_params_from_jax(ref)
    assert statics == {"1": {"step_size": 0.05}}
    port = build_flagship("rscm_tpu_torch", years)
    apply_static_params(port, statics)
    assert port.graph.nodes[1].step_size == 0.05
    ref.run(compiled=False)
    port.run(compiled=False, device="cpu")
    for name in FLAGSHIP_OUTPUTS:
        np.testing.assert_allclose(values(port, name), values(ref, name), rtol=1e-12,
                                   atol=1e-12, err_msg=name)

    from test_torch_support import build_single
    import rscm_tpu.magicc as jax_magicc

    subset = tuple(s for s in JAX_SPECIES if s.name in ("CFC-11", "SF6", "CH3Br"))
    jax_model = build_single("rscm_tpu", jax_magicc.HalocarbonChemistry(species=subset), years,
                             {}, {f"Atmospheric Concentration|{s.name}": 0.0 for s in subset})
    carried = static_params_from_jax(jax_model)["1"]["species"]
    assert all(type(s) is HalocarbonSpecies for s in carried)
    assert [s.name for s in carried] == [s.name for s in subset] == ["SF6", "CFC-11", "CH3Br"]
    assert carried[0].lifetime == subset[0].lifetime
