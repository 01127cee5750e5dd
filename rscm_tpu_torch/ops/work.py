"""
The work of a hand kernel's launch: the operations and bytes its function
needs, counted from its plain version, for the roofline bound
(``chip_smoke.py``'s timing phase) and for
:func:`~rscm_tpu_torch.utils.profiling.cost_analysis`.

- :func:`count_arithmetic` counts the floating-point arithmetic a function
  dispatches;
- each kernel's wrapper module states its launch's work
  (``udeb_month.udeb_year_work``, ``lamcalc_kernel.lamcalc_work``) and
  reports every launch to the observer :func:`observe_launches` installs,
  if any.
"""

from __future__ import annotations

import contextlib
import contextvars
import weakref

import torch

__all__ = ["count_arithmetic", "observe_launches", "note_launch"]

#: elementwise arithmetic counted once per output element; a division by a
#: tensor (or a reciprocal) is counted apart, since the kernels divide there
ARITHMETIC = frozenset({
    "add", "sub", "mul", "div", "maximum", "minimum", "clamp", "reciprocal", "rsub",
})

_OBSERVER = contextvars.ContextVar("kernel_launch_observer", default=None)


def count_arithmetic(fn, *args, only_from=None):
    """Floating-point arithmetic operations ``fn`` performs, as ``(other,
    divisions)``: elementwise add/sub/mul/min/max counted once per output
    element; a division by a tensor (or a reciprocal) counted apart, since
    the kernel divides there, while a division by a host scalar is a
    multiplication by its reciprocal in the kernel (and in PyTorch's CUDA
    division) and counts as other.  Negations and absolute values are not
    counted: in the kernels' SASS they are operand modifiers of the
    instruction that uses them.

    With ``only_from`` (tensors among ``args``), an operation counts only
    if it reads one of them, directly or through an earlier result: an
    adjoint's arithmetic on its cotangents, without the forward values it
    replays or recomputes from the primal inputs alone."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    counts = {"other": 0, "divisions": 0}
    # the live tensors computed from ``only_from``, by id (an entry goes with
    # its tensor, so a reused id is not taken for it)
    reached = None if only_from is None else weakref.WeakValueDictionary(
        {id(t): t for t in only_from})

    def reads_seed(args, kwargs, out):
        if reached is None:
            return True
        if not any(id(x) in reached for x in tree_leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)):
            return False
        reached.update((id(x), x) for x in tree_leaves(out) if isinstance(x, torch.Tensor))
        return True

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            # forward-mode AD of an operation with a constant operand also
            # dispatches primitive (prims) operations on zero tangents, which
            # a kernel does not perform: only aten operations count
            if (reads_seed(args, kwargs, out) and func.namespace == "aten"
                    and name in ARITHMETIC
                    and isinstance(out, torch.Tensor) and out.is_floating_point()):
                divides = name == "reciprocal" or (
                    name == "div" and isinstance(args[1], torch.Tensor))
                counts["divisions" if divides else "other"] += out.numel()
            return out

    with torch.no_grad(), Count():
        fn(*args)
    return counts["other"], counts["divisions"]


@contextlib.contextmanager
def observe_launches(callback):
    """Within the block, every hand-kernel launch calls ``callback(name,
    work)``, ``work()`` giving the launch's ``(operations, divisions,
    bytes)``."""
    token = _OBSERVER.set(callback)
    try:
        yield
    finally:
        _OBSERVER.reset(token)


def note_launch(name, work, *inputs):
    """Report a launch of kernel ``name`` to the observer, if one is
    installed; ``work(*inputs)`` gives its work."""
    callback = _OBSERVER.get()
    if callback is not None:
        callback(name, lambda: work(*inputs))
