"""
Profiling and numerical-diagnostics helpers (port of the JAX package's
``utils/profiling.py``).

The reference's observability story is ``Model::debug_info`` + dot export
(it has no profiler hooks).  The port's counterparts of the JAX package's:

- :func:`trace_profile` wraps ``torch.profiler`` so a model run (or any
  block) writes a TensorBoard trace of the host and the CUDA card;
- :func:`cost_analysis` counts the operations and bytes of one run of a
  model's year loop (the JAX package reports XLA's estimates of its
  compiled program, which cannot be reproduced here; see its docstring);
- :func:`diagnose_nans` steps a model and reports the first component
  writing a non-finite value.

The entry points that run a model run it on the CUDA card unless given
another ``device``; with no card and no device given they raise.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

__all__ = ["trace_profile", "cost_analysis", "count_costs", "diagnose_nans"]

#: elementwise arithmetic, one operation per output element
_ARITHMETIC = frozenset({
    "add", "sub", "mul", "div", "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    "reciprocal", "rsub", "neg", "abs", "pow", "sqrt", "where", "sign", "floor", "ceil",
    "fmod", "remainder", "lerp", "addcmul", "addcdiv",
})
#: transcendental functions, one evaluation per output element
_TRANSCENDENTAL = frozenset({
    "exp", "log", "log1p", "expm1", "log2", "log10", "tanh", "sinh", "cosh", "sin", "cos",
    "atan", "exp2", "sigmoid", "erf",
})
#: reductions, one operation per input element
_REDUCTION = frozenset({"sum", "mean", "prod", "cumsum", "amax", "amin", "max", "min"})
#: products, two operations per multiply-add
_PRODUCT = frozenset({"mm", "bmm", "addmm", "mv", "matmul", "dot", "baddbmm"})


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block, host and
    CUDA activity, written to ``log_dir`` in TensorBoard's format."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _product_flops(name, args, out):
    if name in ("mm", "matmul", "mv", "dot", "bmm"):
        a, b = args[0], args[1]
    else:  # addmm(c, a, b), baddbmm(c, a, b)
        a, b = args[1], args[2]
    return 2.0 * out.numel() * a.shape[-1] if b.dim() else 2.0 * out.numel()


@contextlib.contextmanager
def count_costs():
    """Count, within the block, the dispatched PyTorch operators and every
    hand-kernel launch; yields the dict :func:`cost_analysis` returns,
    filled in when the block ends."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..ops.work import observe_launches

    costs = {"flops": 0.0, "transcendentals": 0.0, "bytes accessed": 0.0,
             "operators": 0, "kernel launches": {}}
    paused = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if paused[0] or func.is_view:
                return out
            name = func.overloadpacket.__name__.rstrip("_")
            outs = _tensors(out)
            costs["operators"] += 1
            costs["bytes accessed"] += sum(
                t.numel() * t.element_size() for t in _tensors((args, kwargs)) + outs
            )
            floating = [t for t in outs if t.is_floating_point()]
            if name in _ARITHMETIC:
                costs["flops"] += sum(t.numel() for t in floating)
            elif name in _TRANSCENDENTAL:
                costs["transcendentals"] += sum(t.numel() for t in floating)
            elif name in _REDUCTION and floating:
                costs["flops"] += args[0].numel()
            elif name in _PRODUCT and floating:
                costs["flops"] += _product_flops(name, args, floating[0])
            return out

    def launched(name, work):
        paused[0] += 1  # the work is counted from the plain version: not the run's
        try:
            operations, divisions, nbytes = work()
        finally:
            paused[0] -= 1
        costs["flops"] += operations + divisions
        costs["bytes accessed"] += nbytes
        costs["kernel launches"][name] = costs["kernel launches"].get(name, 0) + 1

    with observe_launches(launched), Count():
        yield costs


def cost_analysis(model, device=None) -> dict:
    """Operations and bytes of one run of the model's year loop (one member,
    float64, from the model's current time index), on the CUDA card unless
    ``device`` names another.  The model itself is not advanced.

    Keys (the JAX package's names; XLA's estimates of a compiled program
    cannot be reproduced on an eager loop, so here they count):

    - ``"flops"``: the floating-point operations of the dispatched PyTorch
      operators of the run (one per output element of elementwise
      arithmetic, one per input element of a reduction, two per
      multiply-add of a product), counted with a ``TorchDispatchMode``,
      plus each hand kernel's operations per launch, from the same formulas
      as the kernels' roofline bound (``ops/udeb_month.py::udeb_year_work``,
      ``ops/lamcalc_kernel.py::lamcalc_work``, a division counted once);
    - ``"transcendentals"``: elementwise ``exp``/``log``/``tanh``-class
      evaluations of the dispatched operators;
    - ``"bytes accessed"``: the bytes of every dispatched operator's tensor
      inputs and outputs (views excluded), plus each hand kernel's inputs
      read once and outputs written once;
    - ``"operators"``: the dispatched operators counted;
    - ``"kernel launches"``: ``{kernel: launches}`` of the hand kernels (on
      the CPU the wrappers take the plain versions, whose operators are
      counted instead).
    """
    from .target import resolve_device

    program = model._get_program(resolve_device(device))
    params = {
        nk: {pn: float(v) for pn, v in node.items()}
        for nk, node in program.gather_params().items()
    }
    args = (program.gather_endo(1), program.gather_exo(), params, program.gather_internals())
    with count_costs() as costs:
        program.run_fn(*args, start_idx=model.time_index)
    return costs


def diagnose_nans(model, max_steps: Optional[int] = None, device=None) -> list:
    """Step the model from its current index on the step-by-step executor,
    recording each first appearance of a non-finite output.

    Returns a list of ``{"step", "time", "component", "variable"}`` dicts
    (empty when the run stays finite).  The model is mutated (it runs).
    Runs on the CUDA card unless ``device`` names another; with no card
    and no device given it raises.
    """
    from ..core.model.graph import NullComponent
    from .target import resolve_device

    dev = resolve_device(device)
    findings = []
    seen = set()
    steps = 0
    while not model.finished():
        if max_steps is not None and steps >= max_steps:
            break
        t = model.current_time()
        idx = model.time_index
        for node in model.exec_order:
            component = model.graph.nodes[node]
            if isinstance(component, NullComponent):
                continue
            name = getattr(component, "component_name", type(component).__name__)
            model._step_component(node, dev)
            _, write_specs = model._plan[node]
            for var in write_specs:
                data = model.collection.get_data(var)
                if data is None:
                    continue
                row = data.values()[idx + 1]
                if not np.all(np.isfinite(row)) and var not in seen:
                    seen.add(var)
                    findings.append(
                        {"step": idx, "time": t, "component": name, "variable": var}
                    )
        model.time_index += 1
        model._state_version += 1
        steps += 1
    return findings
