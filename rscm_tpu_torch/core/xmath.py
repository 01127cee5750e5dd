"""
Dual-mode scalar math: numpy float64 on host values, torch on tensors.

Component physics is written once against this module.  When inputs are
concrete host values (Python floats, numpy arrays) operations stay in
float64 numpy.  When any input is a ``torch.Tensor`` the same expressions
run as torch ops on the tensor's device and dtype.

The TPU package routes log/exp through minimax polynomials on the TPU only
(its native lowerings carry 1e-4-class float32 error there); every other
backend uses the native op, so the port uses torch's native functions.

Only the functions components actually need are exposed; plain ``+ - * /``
works directly on both value kinds via operator overloading.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

#: floating dtype of host-scalar branches that meet only a boolean tensor in
#: :func:`where`; the year loop sets it to its run's dtype (:func:`scalar_dtype`)
_SCALAR_DTYPE = contextvars.ContextVar("xmath_scalar_dtype", default=torch.float64)


@contextlib.contextmanager
def scalar_dtype(dtype):
    """Within the block, :func:`where` takes host-scalar branches selected by
    a boolean tensor in ``dtype`` (float64 outside any block)."""
    token = _SCALAR_DTYPE.set(dtype)
    try:
        yield
    finally:
        _SCALAR_DTYPE.reset(token)


def _is_tensor(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def static_value(x):
    """The concrete float value of ``x`` if it is a host scalar (a
    parameter baked as a constant), else ``None``."""
    if isinstance(x, (int, float)):
        return float(x)
    if isinstance(x, np.ndarray) and x.ndim == 0:
        return float(x)
    if isinstance(x, (np.floating, np.integer)):
        return float(x)
    return None


def _host(out):
    """A 0-d numpy result as a numpy scalar: a 0-d array on the left of an
    operator with a tensor raises (numpy defers to the tensor, which does
    not take arrays), where a numpy scalar acts like a Python float."""
    if isinstance(out, np.ndarray) and out.ndim == 0:
        return out[()]
    return out


def _dispatch(np_name, torch_name=None):
    torch_name = torch_name or np_name

    def fn(*args, **kwargs):
        if _is_tensor(*args):
            return getattr(torch, torch_name)(*args, **kwargs)
        return _host(getattr(np, np_name)(*args, **kwargs))

    fn.__name__ = np_name
    return fn


exp = _dispatch("exp")
log = _dispatch("log")
log1p = _dispatch("log1p")
expm1 = _dispatch("expm1")
sqrt = _dispatch("sqrt")
abs = _dispatch("abs")  # noqa: A001
sign = _dispatch("sign")
tanh = _dispatch("tanh")
sinh = _dispatch("sinh")
cosh = _dispatch("cosh")
sin = _dispatch("sin")
cos = _dispatch("cos")
arctan = _dispatch("arctan")
floor = _dispatch("floor")
ceil = _dispatch("ceil")
log2 = _dispatch("log2")
log10 = _dispatch("log10")
isnan = _dispatch("isnan")
nan_to_num = _dispatch("nan_to_num")


def clip(x, lo, hi):
    """``np.clip``; on tensors the bounds may be host scalars, host arrays
    or tensors."""
    if not _is_tensor(x, lo, hi):
        return _host(np.clip(x, lo, hi))
    ref = next(v for v in (x, lo, hi) if isinstance(v, torch.Tensor))
    x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    if any(b is not None and (isinstance(b, torch.Tensor) or np.ndim(b)) for b in (lo, hi)):
        lo, hi = (
            None if b is None else torch.as_tensor(b, dtype=x.dtype, device=x.device)
            for b in (lo, hi)
        )
        return torch.clamp(x, lo, hi)
    return torch.clamp(x, *(None if b is None else float(b) for b in (lo, hi)))
take = _dispatch("take")


def _pair(a, b):
    """Both operands as tensors when either is one (torch binary ops need
    tensor operands on one device and dtype)."""
    ref = a if isinstance(a, torch.Tensor) else b
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
    return a, b


def maximum(a, b):
    if _is_tensor(a, b):
        return torch.maximum(*_pair(a, b))
    return _host(np.maximum(a, b))


def minimum(a, b):
    if _is_tensor(a, b):
        return torch.minimum(*_pair(a, b))
    return _host(np.minimum(a, b))


def where(pred, on_true, on_false):
    """``np.where``.  When only ``pred`` is a tensor, host-scalar branches
    are taken in the dtype :func:`scalar_dtype` sets: the year loop's
    working dtype, so a float32 run stays float32, and float64 elsewhere
    (as the JAX package's weakly typed scalars are under x64), never
    torch's float32 default, which would round them in a float64 run."""
    if _is_tensor(pred, on_true, on_false):
        ref = next(x for x in (on_true, on_false, pred) if isinstance(x, torch.Tensor))
        if not isinstance(pred, torch.Tensor):
            pred = torch.as_tensor(pred, device=ref.device)
        dtype = ref.dtype if ref.is_floating_point() else _SCALAR_DTYPE.get()
        for x in (on_true, on_false):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                dtype = x.dtype
        on_true = torch.as_tensor(on_true, dtype=dtype, device=ref.device)
        on_false = torch.as_tensor(on_false, dtype=dtype, device=ref.device)
        return torch.where(pred, on_true, on_false)
    return _host(np.where(pred, on_true, on_false))


def asarray(x, like=None):
    """Array conversion following the mode of ``like`` (or of ``x``)."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if isinstance(x, torch.Tensor):
        return x
    return np.asarray(x, dtype=np.float64)


def stack(xs):
    if _is_tensor(*xs):
        ref = next(x for x in xs if isinstance(x, torch.Tensor))
        return torch.stack(
            [torch.as_tensor(x, dtype=ref.dtype, device=ref.device) for x in xs]
        )
    return np.asarray([float(x) for x in xs])


def push_front(buffer, value):
    """Shift a ring buffer right by one along its last axis and place
    ``value`` at index 0 (newest-first layout; the oldest entry falls off
    the end)."""
    if _is_tensor(buffer, value):
        ref = buffer if isinstance(buffer, torch.Tensor) else value
        buffer = torch.as_tensor(buffer, dtype=ref.dtype, device=ref.device)
        value = torch.as_tensor(value, dtype=buffer.dtype, device=buffer.device)
        head = value.reshape(value.shape + (1,)).expand(
            torch.broadcast_shapes(value.shape, buffer.shape[:-1]) + (1,)
        )
        tail = buffer[..., :-1].expand(head.shape[:-1] + (buffer.shape[-1] - 1,))
        return torch.cat([head, tail], dim=-1)
    buffer = np.asarray(buffer, dtype=np.float64)
    return np.concatenate([[float(value)], buffer[:-1]])


def dot(a, b):
    """Inner product over the last axis (batched over leading axes)."""
    if _is_tensor(a, b):
        a, b = _pair(a, b)
        return (a * b).sum(-1)
    return np.dot(a, b)


#: The TPU package's native-lowering exp (its ``exp`` routes through a
#: minimax polynomial on the TPU only); here both are torch's ``exp``.
exp_fast = exp


def _operand(x):
    """A torch operand: tensors as they are, host scalars as Python floats
    (kept exact), host arrays as float64 tensors."""
    if isinstance(x, torch.Tensor):
        return x
    if np.ndim(x) == 0:
        return float(x)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def power(a, b):
    if _is_tensor(a, b):
        return torch.pow(_operand(a), _operand(b))
    return _host(np.power(a, b))


def sum(x, axis=None):  # noqa: A001
    """Sum over ``axis`` (all axes when None)."""
    if _is_tensor(x):
        return x.sum() if axis is None else x.sum(dim=axis)
    return _host(np.sum(x, axis=axis))


def mean(x, axis=None):
    """Mean over ``axis`` (all axes when None)."""
    if _is_tensor(x):
        return x.mean() if axis is None else x.mean(dim=axis)
    return _host(np.mean(x, axis=axis))


def tile(x, reps: int):
    """``np.tile`` along the last axis: ``reps`` copies of ``x``'s last
    axis, end to end (leading member axes are kept)."""
    if _is_tensor(x):
        x = x if x.dim() else x.reshape(1)
        return x.repeat(*([1] * (x.dim() - 1)), int(reps))
    return np.tile(x, int(reps))


def repeat(x, repeats: int):
    """``np.repeat`` along the last axis: each element ``repeats`` times
    in a row (leading member axes are kept)."""
    if _is_tensor(x):
        x = x if x.dim() else x.reshape(1)
        return x.repeat_interleave(int(repeats), dim=-1)
    return np.repeat(x, int(repeats), axis=-1)


def interp(x, xp, fp):
    """``np.interp``: piecewise-linear through ``(xp, fp)`` at ``x``,
    clamped to ``fp``'s end values outside ``[xp[0], xp[-1]]``."""
    if not _is_tensor(x, xp, fp):
        return _host(np.interp(x, xp, fp))
    ref = next(v for v in (x, xp, fp) if isinstance(v, torch.Tensor))
    x, xp, fp = (torch.as_tensor(v, dtype=ref.dtype, device=ref.device) for v in (x, xp, fp))
    n = xp.shape[-1]
    # segment k spans [xp[k], xp[k+1]]: the last k with xp[k] <= x
    k = (torch.searchsorted(xp, x.contiguous(), right=True) - 1).clamp(0, n - 2)
    x0, x1, f0, f1 = xp[k], xp[k + 1], fp[k], fp[k + 1]
    inner = f0 + (x - x0) * ((f1 - f0) / (x1 - x0))
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], inner))


def select(pred, on_true, on_false):
    """Branch-free select usable in both modes (alias of :func:`where`)."""
    return where(pred, on_true, on_false)
