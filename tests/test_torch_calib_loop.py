"""The year loop under autograd, in reverse and forward mode.

The loop keeps each trajectory as a list of rows and replaces a row on
write (nothing is modified in place), and a read-side aggregation
aggregates the row it reads, so it carries gradients from swept parameters
given as tensors that require them, and from dual tensors
(``torch.autograd.forward_ad``):

- the forward values with gradients recorded are bit-equal to the values
  without, on the MAGICC graph and on the flagship graph;
- on the flagship (a clean float64 model) the reverse- and forward-mode
  gradients of a scalar of the trajectory agree within 1e-12, the bar the
  JAX package holds its own two modes to (``tests/test_nuts.py:285-301``).
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from rscm_tpu_torch.magicc.coupled import build_magicc_model
from rscm_tpu_torch.parallel.ensemble import EnsembleRunner
from test_torch_support import build_flagship, flagship_sweep

B = 4


def flagship():
    return build_flagship("rscm_tpu_torch", np.arange(1750.0, 1781.0)), flagship_sweep(B, seed=3)


def magicc():
    rng = np.random.default_rng(4)
    sweep = {
        "ClimateUDEB.ecs": rng.uniform(2.0, 4.5, B),
        "ClimateUDEB.kappa": rng.uniform(0.5, 1.5, B),
        "TerrestrialCarbon.beta": rng.uniform(0.3, 0.8, B),
        "OceanCarbon.gas_exchange_scale": rng.uniform(1.0, 2.5, B),
        "CH4Chemistry.tau_oh": rng.uniform(8.0, 11.0, B),
    }
    return build_magicc_model(years=np.arange(1850.0, 1861.0)), sweep


def swept_leaves(runner, params, sweep):
    names = runner.program.node_names()
    return [v for nk, node in params.items() for pn, v in node.items()
            if f"{names[nk]}.{pn}" in sweep]


@pytest.mark.parametrize("graph", [flagship, magicc])
def test_forward_values_are_bit_equal_with_gradients_recorded(graph):
    model, sweep = graph()
    runner = EnsembleRunner(model, device="cpu")
    with torch.no_grad():
        plain = runner.run(runner.batched_params(sweep))
    params = runner.batched_params(sweep)
    for leaf in swept_leaves(runner, params, sweep):
        leaf.requires_grad_(True)
    taped = runner.run(params)
    assert any(v.requires_grad for v in taped.values())
    assert plain.keys() == taped.keys()
    for name in plain:  # bit-equal; the initial rows of outputs are NaN in both
        torch.testing.assert_close(taped[name].detach(), plain[name], rtol=0.0, atol=0.0,
                                   equal_nan=True, msg=name)


def test_flagship_reverse_and_forward_gradients_agree():
    model, sweep = flagship()
    runner = EnsembleRunner(model, device="cpu")
    rng = np.random.default_rng(5)
    weights = torch.tensor(rng.uniform(0.5, 1.5, (B, len(model.time_axis), 1)))

    def scalar(out):  # (B,): a weighted sum of each member's temperature
        return (out["Surface Temperature"] * weights).sum((1, 2))

    params = runner.batched_params(sweep)
    leaves = swept_leaves(runner, params, sweep)
    for leaf in leaves:
        leaf.requires_grad_(True)
    rev = torch.stack(torch.autograd.grad(scalar(runner.run(params)).sum(), leaves))  # (P, B)

    fwd = []
    names = runner.program.node_names()
    for j in range(len(leaves)):  # one forward-mode run per swept parameter
        with torch.no_grad(), fwAD.dual_level():
            params = runner.batched_params(sweep)
            swept = [(node, pn) for nk, node in params.items() for pn in node
                     if f"{names[nk]}.{pn}" in sweep]
            for i, (node, pn) in enumerate(swept):
                node[pn] = fwAD.make_dual(node[pn], torch.full_like(node[pn], float(i == j)))
            fwd.append(fwAD.unpack_dual(scalar(runner.run(params))).tangent)
    fwd = torch.stack(fwd)
    assert torch.all(rev != 0.0)
    np.testing.assert_allclose(fwd.numpy(), rev.numpy(), rtol=1e-12, atol=0.0)
