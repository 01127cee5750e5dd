"""
Typed Python components (reference-API surface of ``python/rscm/component.py``).

The port's declarative component API is the same design, so this is a
direct re-export: subclass :class:`Component`, declare I/O with
:class:`Input`/:class:`Output`/:class:`State` class attributes, implement
``solve(t_current, t_next, inputs)`` returning ``self.Outputs(...)``, and
wrap with ``PythonComponent.build`` (``rscm_tpu_torch.compat.core``) for
model integration — or add the component directly, in which case physics
written with tensor arithmetic runs in the year loop.
"""

from rscm_tpu_torch.core.component import Component, Input, Output, Parameter, State

__all__ = ["Component", "Input", "Output", "Parameter", "State"]
