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

import numpy as np
import torch


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
isnan = _dispatch("isnan")
clip = _dispatch("clip", "clamp")
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
    if _is_tensor(pred, on_true, on_false):
        ref = next(x for x in (on_true, on_false, pred) if isinstance(x, torch.Tensor))
        if not isinstance(pred, torch.Tensor):
            pred = torch.as_tensor(pred, device=ref.device)
        dtype = ref.dtype if ref.is_floating_point() else torch.get_default_dtype()
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
