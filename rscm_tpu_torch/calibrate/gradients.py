"""
Value and gradient of a batched objective, in reverse or forward mode.

The JAX package picks its gradient engine by posterior shape: batched
forward-mode JVPs (``jax.vmap`` of ``jax.jvp`` over the basis) for a few
parameters, ``jax.value_and_grad`` above a threshold.  Here an objective
maps a ``(B, D)`` batch of walkers to ``(B,)`` values through one batched
model run, and:

- ``"rev"`` takes the gradient of the batch's sum with autograd (the
  walkers are independent members, so each row is its own gradient);
- ``"fwd"`` runs the D tangent directions of each walker as D members of
  one ``torch.autograd.forward_ad`` pass (``B * D`` members), as the JAX
  package's ``vmap(jvp)`` does.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["value_and_grad"]


def value_and_grad(fn, thetas: torch.Tensor, mode: str):
    """``(values (B,), grads (B, D))`` of ``fn`` at ``thetas`` ``(B, D)``,
    both detached."""
    if mode == "rev":
        with torch.enable_grad():
            x = thetas.detach().requires_grad_(True)
            values = fn(x)
            (grads,) = torch.autograd.grad(values.sum(), x)
        return values.detach(), grads
    if mode != "fwd":
        raise ValueError(f"mode must be 'fwd' or 'rev', got {mode!r}")
    b, d = thetas.shape
    primal = thetas.detach().repeat_interleave(d, dim=0)  # row b * d + j: walker b, direction j
    basis = torch.eye(d, dtype=thetas.dtype, device=thetas.device).repeat(b, 1)
    with torch.no_grad(), fwAD.dual_level():
        values, tangents = fwAD.unpack_dual(fn(fwAD.make_dual(primal, basis)))
    if tangents is None:  # the values do not depend on theta
        tangents = torch.zeros_like(values)
    return values.view(b, d)[:, 0], tangents.view(b, d)
