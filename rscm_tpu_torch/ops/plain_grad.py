"""
Derivatives of a kernel from its plain PyTorch version.

Neither Pallas kernel of the JAX package has a backward kernel: each sits
in a ``jax.custom_jvp`` whose rule differentiates the kernel's ``jnp``
reference.  The port's ``torch.autograd.Function`` around each CUDA kernel
does the same with these two helpers: the forward launches the kernel, and
the derivatives in either mode come from the plain version at the saved
inputs.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["plain_vjp", "plain_jvp"]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def plain_vjp(fn, inputs, needs, grad_outputs):
    """Gradients of ``fn``'s outputs, weighted by ``grad_outputs``, with
    respect to the ``inputs`` flagged in ``needs`` (None for the others):
    ``fn`` is recomputed under autograd on detached copies of the inputs."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(need) for x, need in zip(inputs, needs)]
        outs = _as_tuple(fn(*xs))
        wanted = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(
            outs, wanted,
            [torch.zeros_like(o) if g is None else g for o, g in zip(outs, grad_outputs)],
            allow_unused=True, materialize_grads=True,
        ))
    return [next(grads) if need else None for need in needs]


def plain_jvp(fn, inputs, tangents):
    """``fn``'s Jacobian-vector product at ``inputs`` (a missing tangent is
    zero), in forward mode.

    ``torch.autograd.Function.jvp`` runs inside the caller's
    ``torch.autograd.forward_ad`` level with forward gradients switched off,
    and PyTorch nests no second level (so ``torch.func.jvp`` cannot run
    there): the plain version runs on dual tensors of that same level, made
    from detached inputs, with forward gradients switched back on."""
    with fwAD._set_fwd_grad_enabled(True):
        duals = [x.detach() if t is None else fwAD.make_dual(x.detach(), t)
                 for x, t in zip(inputs, tangents)]
        outs = _as_tuple(fn(*duals))
        out_t = tuple(fwAD.unpack_dual(o).tangent for o in outs)
    out_t = tuple(torch.zeros_like(o) if t is None else t for o, t in zip(outs, out_t))
    return out_t if len(out_t) > 1 else out_t[0]
