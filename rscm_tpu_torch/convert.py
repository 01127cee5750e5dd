"""
Carry parameters across from the JAX package to the port.

The JAX package's ``ModelProgram.gather_params()`` returns
``{node_key: {param_name: ndarray}}`` and its ``EnsembleRunner`` sweeps
members with a ``{"Component.param": (B,) ndarray}`` dict.  Both packages
number the nodes of a model built the same way identically, so one
function turns those numpy arrays into the parameter dict the port's
``EnsembleRunner.run`` takes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_jax"]


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
