"""The calibration modules of the port against ``rscm_tpu.calibrate``.

The same priors, observations, arrays and seeds go through both packages:

- the distributions' ``ln_pdf`` and seeded ``sample_n`` are exact (the same
  numpy arithmetic and draws; ``ln_pdf`` on tensors within 1e-15);
- ``log_prior``, ``Target.compile`` and both likelihoods agree within 1e-12;
- ``Chain`` statistics (``r_hat``, ESS, autocorrelation time,
  ``flat_samples``) on the same arrays are exact;
- ``RandomSearch`` with the same seed evaluates the same points, with
  log-likelihoods within 1e-9 (the model runs in two packages);
- the host ``EnsembleSampler`` with the same seed gives the same chain
  within 1e-9, under the stretch and the DE move;
- a checkpoint the JAX package wrote loads in the port, and a run resumed
  from it in either package gives the same chain.

The model is the TwoLayer toy of ``tests/test_nuts.py``.
"""

import numpy as np
import pytest
import torch

import rscm_tpu.calibrate as jc
import rscm_tpu_torch.calibrate as pc
from rscm_tpu.core import TimeAxis as JaxTimeAxis
from rscm_tpu_torch.convert import parameter_set_from_jax, target_from_jax
from test_torch_support import toy_problem

DISTRIBUTIONS = [
    ("Uniform", (0.5, 2.5)),
    ("Normal", (1.0, 0.3)),
    ("LogNormal", (0.1, 0.4)),
]


def both(kind, args):
    return getattr(jc, kind)(*args), getattr(pc, kind)(*args)


@pytest.mark.parametrize("kind,args", DISTRIBUTIONS + [("Bound", None)])
def test_distributions_are_exact(kind, args):
    if kind == "Bound":
        ref, port = jc.Bound(jc.Normal(1.0, 0.5), 0.2, 1.8), pc.Bound(pc.Normal(1.0, 0.5), 0.2, 1.8)
    else:
        ref, port = both(kind, args)
    x = np.linspace(-0.5, 3.0, 41)
    np.testing.assert_array_equal(port.ln_pdf(x), ref.ln_pdf(x))
    assert port.ln_pdf(0.7) == ref.ln_pdf(0.7)
    got = port.ln_pdf(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref.ln_pdf(x), rtol=1e-15, atol=0.0)
    np.testing.assert_array_equal(
        port.sample_n(64, np.random.default_rng(3)), ref.sample_n(64, np.random.default_rng(3))
    )
    assert port.bounds() == ref.bounds()
    assert port.to_dict() == ref.to_dict()


def test_device_sampling_draws_from_the_prior():
    port = pc.ParameterSet().add("a", pc.Uniform(0.5, 2.5)).add("b", pc.Normal(1.0, 0.3))
    gen = torch.Generator().manual_seed(0)
    draws = port.sample_torch(gen, 4000).numpy()
    assert draws.shape == (4000, 2)
    assert 0.5 <= draws[:, 0].min() and draws[:, 0].max() <= 2.5
    np.testing.assert_allclose(draws.mean(0), [1.5, 1.0], atol=0.03)
    np.testing.assert_allclose(draws.std(0), [2.0 / np.sqrt(12.0), 0.3], rtol=0.05)


def test_log_prior_matches():
    ref = (jc.ParameterSet().add("a", jc.Uniform(0.5, 2.5)).add("b", jc.Normal(1.0, 0.3))
           .add("c", jc.LogNormal(0.1, 0.4)))
    port = parameter_set_from_jax(ref)
    assert port.param_names() == ref.param_names()
    thetas = np.random.default_rng(1).uniform(0.0, 3.0, (16, 3))
    want = ref.log_prior(thetas)
    np.testing.assert_allclose(port.log_prior(thetas), want, rtol=1e-12)
    np.testing.assert_allclose(port.log_prior(torch.tensor(thetas)).numpy(), want, rtol=1e-12)
    assert port.bounds() == ref.bounds()
    np.testing.assert_array_equal(port.sample_lhs(8, np.random.default_rng(2)),
                                  ref.sample_lhs(8, np.random.default_rng(2)))


class _Grid:
    weights = [0.3, 0.2, 0.35, 0.15]

    def size(self):
        return 4


class _Collection:
    """A collection whose 'T' lives on a four-box grid."""

    def get_data(self, name):
        return type("Data", (), {"grid": _Grid()})() if name == "T" else None


def targets():
    ref = jc.Target()
    rng = np.random.default_rng(4)
    for t in (2003.0, 2007.0, 2011.0, 2015.0):
        ref.add_observation("T", t, rng.normal(), 0.1 + rng.uniform())
        ref.add_observation("C", t, 300.0 + rng.normal(), 2.0)
    ref.set_reference_period("T", 2001.0, 2004.0)
    return ref, target_from_jax(ref)


def test_target_compile_matches():
    ref, port = targets()
    axis = JaxTimeAxis.from_values(np.arange(2000.0, 2020.0))
    want = ref.compile(axis, _Collection()).per_variable
    got = port.compile(axis, _Collection()).per_variable
    assert got.keys() == want.keys()
    for name in want:
        for key, value in want[name].items():
            if value is None:
                assert got[name][key] is None
            else:
                np.testing.assert_array_equal(got[name][key], value)


@pytest.mark.parametrize("normalize", [False, True])
def test_likelihoods_match(normalize):
    import jax.numpy as jnp

    ref, port = targets()
    axis = JaxTimeAxis.from_values(np.arange(2000.0, 2020.0))
    rng = np.random.default_rng(5)
    trajs = {"T": rng.normal(size=(20, 4)), "C": 300.0 + rng.normal(size=(20, 1))}
    jl, pl = jc.GaussianLikelihood(normalize), pc.GaussianLikelihood(normalize)

    # host path, through ModelOutput
    outputs = []
    for cls in (jc, pc):
        out = cls.ModelOutput()
        for name, traj in trajs.items():
            var = cls.VariableOutput(name)
            series = traj @ np.asarray(_Grid.weights) if traj.shape[1] > 1 else traj[:, 0]
            for t, v in zip(np.arange(2000.0, 2020.0), series):
                var.add(float(t), float(v))
            out.add_variable(var)
        outputs.append(out)
    want = jl.ln_likelihood(outputs[0], ref)
    np.testing.assert_allclose(pl.ln_likelihood(outputs[1], port), want, rtol=1e-12)

    # the device path, one member and a batch of walkers
    want = float(jl.ln_likelihood_traced({k: jnp.asarray(v) for k, v in trajs.items()},
                                         ref.compile(axis, _Collection())))
    compiled = port.compile(axis, _Collection())
    got = pl.ln_likelihood_traced({k: torch.tensor(v) for k, v in trajs.items()}, compiled)
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    batch = {k: torch.tensor(np.stack([v, v + 0.01])) for k, v in trajs.items()}
    batch["C"][1, 7, 0] = float("nan")  # a walker failed at an observed year: -inf
    got = pl.ln_likelihood_traced(batch, compiled)
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-12)
    assert float(got[1]) == -np.inf


def test_chain_statistics_are_exact():
    rng = np.random.default_rng(6)
    samples, log_probs = rng.normal(size=(40, 8, 2)), rng.normal(size=(40, 8))
    chains = []
    for cls in (jc, pc):
        chain = cls.Chain(["a", "b"], thin=2)
        chain.push_stacked(samples, log_probs)
        chains.append(chain)
    ref, port = chains
    np.testing.assert_array_equal(port.flat_samples(discard=3), ref.flat_samples(discard=3))
    np.testing.assert_array_equal(port.flat_log_probs(2), ref.flat_log_probs(2))
    assert port.r_hat(discard=2) == ref.r_hat(discard=2)
    assert port.ess() == ref.ess()
    assert port.autocorr_time() == ref.autocorr_time()


@pytest.fixture(scope="module")
def toys():
    """The two-parameter toy in the JAX package and in the port."""
    return (toy_problem("rscm_tpu", ("lambda0", "eta")),
            toy_problem("rscm_tpu_torch", ("lambda0", "eta")))


def test_random_search_evaluates_the_same_points(toys):
    (jp, jr, jl, jt), (pp, pr, pl, pt) = toys
    ref = jc.PointEstimator(jp, jr, jl, jt)
    port = pc.PointEstimator(pp, pr, pl, pt)
    want = ref.optimize(jc.RandomSearch(seed=9), n_samples=6)
    got = port.optimize(pc.RandomSearch(seed=9), n_samples=6)
    np.testing.assert_array_equal(np.asarray(port.evaluated_params()),
                                  np.asarray(ref.evaluated_params()))
    np.testing.assert_allclose(port.evaluated_log_likelihoods(),
                               ref.evaluated_log_likelihoods(), rtol=1e-9)
    assert got.best_params == want.best_params
    np.testing.assert_allclose(got.best_log_posterior, want.best_log_posterior, rtol=1e-9)


@pytest.mark.parametrize("move", ["stretch", "de"])
def test_host_ensemble_sampler_gives_the_same_chain(toys, move):
    (jp, jr, jl, jt), (pp, pr, pl, pt) = toys
    ref = jc.EnsembleSampler(jp, jr, jl, jt, move=jc.DEMove() if move == "de" else None)
    port = pc.EnsembleSampler(pp, pr, pl, pt, move=pc.DEMove() if move == "de" else None)
    kwargs = dict(n_iterations=4, init=None, n_walkers=8, seed=12, engine="host")
    want = ref.run(**{**kwargs, "init": jc.WalkerInit.from_prior()})
    got = port.run(**{**kwargs, "init": pc.WalkerInit.from_prior()})
    np.testing.assert_allclose(got.flat_samples(), want.flat_samples(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.flat_log_probs(), want.flat_log_probs(), rtol=1e-9)
    assert 0 < np.ptp(got.flat_samples()[:, 0])  # the walkers moved


def test_jax_checkpoint_loads_and_resumes_in_the_port(toys, tmp_path):
    (jp, jr, jl, jt), (pp, pr, pl, pt) = toys
    path = str(tmp_path / "ckpt")
    ref = jc.EnsembleSampler(jp, jr, jl, jt)
    ref.run_with_checkpoint(n_iterations=4, init=jc.WalkerInit.from_prior(), thin=1,
                            checkpoint_every=2, checkpoint_path=path, n_walkers=8,
                            seed=13, engine="host")
    want = jc.SamplerState.load_checkpoint(path + ".state")
    got = pc.SamplerState.load_checkpoint(path + ".state")
    assert got.param_names == want.param_names and got.iteration == want.iteration == 4
    for key in ("positions", "log_probs", "n_accepted", "n_proposed"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))

    # resumed to six iterations in each package, from copies of the files
    chains = []
    for cls, sampler in ((jc, ref), (pc, pc.EnsembleSampler(pp, pr, pl, pt))):
        copy = str(tmp_path / f"{cls.__name__}_ckpt")
        for suffix in (".state", ".chain"):
            with open(path + suffix, "rb") as src, open(copy + suffix, "wb") as dst:
                dst.write(src.read())
        chains.append(sampler.resume_from_checkpoint(
            n_iterations=6, thin=1, checkpoint_every=2, checkpoint_path=copy, seed=14,
            engine="host"))
    assert len(chains[1]) == len(chains[0]) == 6
    np.testing.assert_allclose(chains[1].flat_samples(), chains[0].flat_samples(),
                               rtol=1e-9, atol=1e-12)
