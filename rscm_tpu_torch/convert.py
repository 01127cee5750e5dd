"""
Carry parameters across from the JAX package to the port.

The JAX package's ``ModelProgram.gather_params()`` returns
``{node_key: {param_name: ndarray}}`` and its ``EnsembleRunner`` sweeps
members with a ``{"Component.param": (B,) ndarray}`` dict.  Both packages
number the nodes of a model built the same way identically, so one
function turns those numpy arrays into the parameter dict the port's
``EnsembleRunner.run`` takes.

Static parameters (an engine, a storage dtype, a forcing method, a layer
count) are part of a component, not of a run: :func:`static_params_from_jax`
reads them off a JAX model's components and :func:`apply_static_params`
rebuilds the port model's components with them.  The JAX model is only
read through its attributes; nothing of the JAX package is imported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = [
    "apply_static_params",
    "params_from_jax",
    "parameter_set_from_jax",
    "static_params_from_jax",
    "target_from_jax",
]


def params_from_jax(
    base_params: Dict[str, dict],
    swept: Optional[Dict[str, np.ndarray]] = None,
    *,
    node_names: Dict[str, str],
    device="cpu",
    dtype=torch.float64,
) -> Dict[str, dict]:
    """The port's parameter dict from the JAX package's parameters.

    ``base_params`` is a ``gather_params()`` (or ``batched_params()``)
    result of the JAX package, as numpy arrays; ``swept`` maps
    ``"ComponentName.param"`` to a ``(B,)`` array; ``node_names`` maps node
    keys to component names (the port's ``ModelProgram.node_names()``).
    Scalars come back as host floats, arrays as tensors on ``device`` in
    ``dtype``.
    """
    swept = dict(swept or {})
    out: Dict[str, dict] = {}
    for node_key, params in base_params.items():
        out[node_key] = {}
        for pname, value in params.items():
            value = np.asarray(swept.pop(f"{node_names[node_key]}.{pname}", value))
            out[node_key][pname] = (
                torch.as_tensor(value, dtype=dtype, device=device)
                if value.ndim >= 1
                else float(value)
            )
    if swept:
        raise KeyError(f"params_from_jax: unknown swept parameter(s) {sorted(swept)}")
    return out


#: static parameters naming one of the JAX package's engines, with the
#: port's engine for each (ClimateUDEB also takes the JAX names as aliases)
_ENGINES = {("ClimateUDEB", "month_engine"): {"auto": "auto", "xla": "torch", "pallas": "cuda"}}


def _host_static(value):
    """A static parameter value as the port holds it: an impulse-response
    form becomes the port's own ``IrfForm``, a halocarbon species table the
    port's ``HalocarbonSpecies``, arrays become numpy copies."""
    if all(hasattr(value, k) for k in ("kind", "coefficients", "timescales")):
        from rscm_tpu_torch.magicc.carbon.ocean import IrfForm

        return IrfForm(value.kind, tuple(value.coefficients), tuple(value.timescales))
    if isinstance(value, tuple) and value and all(
        hasattr(v, "lifetime") and hasattr(v, "radiative_efficiency") for v in value
    ):
        from dataclasses import fields

        from rscm_tpu_torch.magicc.chemistry.halocarbon import HalocarbonSpecies

        names = [f.name for f in fields(HalocarbonSpecies)]
        return tuple(HalocarbonSpecies(**{n: getattr(v, n) for n in names}) for v in value)
    if isinstance(value, np.ndarray):
        return np.array(value, dtype=np.float64)
    return value


def static_params_from_jax(jax_model) -> Dict[str, dict]:
    """``{node_key: {name: value}}`` of every static parameter of a JAX
    package model's components, keyed as the port numbers the same graph."""
    out: Dict[str, dict] = {}
    for node, comp in enumerate(jax_model.graph.nodes):
        cls = type(comp).__name__
        static = {}
        for name, decl in getattr(comp, "_component_parameters", {}).items():
            if not decl.static:
                continue
            value = _host_static(getattr(comp, name))
            if (cls, name) in _ENGINES:
                value = _ENGINES[(cls, name)][value]
            static[name] = value
        if static:
            out[str(node)] = static
    return out


def apply_static_params(model, statics: Dict[str, dict]) -> None:
    """Rebuild the port ``model``'s components with ``statics`` (a
    :func:`static_params_from_jax` result) before it runs: each named node
    becomes a new component of its class with its other parameters kept,
    and its internal state restarts from the new component's initial state
    (the execution plan stays: it comes from the class's declarations).
    """
    if model.time_index != 0:
        raise ValueError(
            "apply_static_params: the model has been run to index "
            f"{model.time_index}; static parameters change the components' "
            "internal states, so apply them to a fresh model"
        )
    for key, static in statics.items():
        node = int(key)
        comp = model.graph.nodes[node]
        decls = getattr(comp, "_component_parameters", {})
        unknown = set(static) - set(decls)
        if unknown:
            raise KeyError(
                f"apply_static_params: {type(comp).__name__} (node {key}) has no "
                f"parameter(s) {sorted(unknown)}"
            )
        params = {name: getattr(comp, name) for name in decls}
        params.update(static)
        new = type(comp)(**params)
        model.graph.nodes[node] = new
        model.component_states[node] = new.create_initial_state()
    model._state_version += 1


def parameter_set_from_jax(params):
    """The port's ``ParameterSet`` with the same priors, in the same order,
    as a JAX package ``ParameterSet`` (read through each prior's
    ``to_dict``: kind, parameters and bounds)."""
    from rscm_tpu_torch.calibrate import Distribution, ParameterSet

    return ParameterSet(
        {name: Distribution.from_dict(dist.to_dict()) for name, dist in params.parameters.items()}
    )


def target_from_jax(target):
    """The port's ``Target`` with the same variables, observation times,
    values and uncertainties (and reference periods) as a JAX package
    ``Target``."""
    from rscm_tpu_torch.calibrate import Target

    out = Target()
    for name, vt in target.variables.items():
        new = out.add_variable(name)
        for obs in vt.observations:
            new.add(float(obs.time), float(obs.value), float(obs.uncertainty))
        if vt.reference_period is not None:
            new.with_reference_period(*vt.reference_period)
    return out
