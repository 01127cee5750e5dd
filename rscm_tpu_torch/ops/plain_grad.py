"""
The forward-mode derivative of a kernel's plain PyTorch version.

Neither Pallas kernel of the JAX package has a derivative kernel: each sits
in a ``jax.custom_jvp`` whose rule differentiates the kernel's ``jnp``
reference.  The port's ``torch.autograd.Function`` around each CUDA kernel
launches a tangent kernel and an adjoint kernel on CUDA tensors; on CPU
tensors its ``jvp`` takes :func:`plain_jvp` of the plain version (its
``backward`` the explicit adjoint twins in the kernels' modules), and
``chip_smoke.py`` holds each tangent kernel against it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["plain_jvp"]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def plain_jvp(fn, inputs, tangents):
    """``fn``'s Jacobian-vector product at ``inputs`` (a missing tangent is
    zero), in forward mode.

    ``torch.autograd.Function.jvp`` runs inside the caller's
    ``torch.autograd.forward_ad`` level with forward gradients switched
    off, and PyTorch nests no second level (so ``torch.func.jvp`` cannot run
    there): the plain version runs on dual tensors of the caller's level (a
    level of its own when there is none), made from detached inputs, with
    forward gradients switched back on.  ``plain_jvp.calls`` counts the
    calls."""
    plain_jvp.calls += 1
    level = fwAD.dual_level() if fwAD._current_level < 0 else contextlib.nullcontext()
    with level, fwAD._set_fwd_grad_enabled(True):
        # a dual is made of dense copies: a broadcast view (stride 0) cannot
        # take a tangent in place
        duals = [x.detach() if t is None
                 else fwAD.make_dual(x.detach().contiguous(), t.contiguous())
                 for x, t in zip(inputs, tangents)]
        outs = _as_tuple(fn(*duals))
        out_t = tuple(fwAD.unpack_dual(o).tangent for o in outs)
    out_t = tuple(torch.zeros_like(o) if t is None else t for o, t in zip(outs, out_t))
    return out_t if len(out_t) > 1 else out_t[0]


#: calls since the count was last set to 0 (none on a card's gradient path)
plain_jvp.calls = 0
