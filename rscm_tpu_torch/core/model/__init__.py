"""
Model assembly and execution.

- :mod:`builder` — ``ModelBuilder``: component graph construction, variable
  classification, unit/grid validation, transform planning, collection
  allocation (mirror of ``crates/rscm-core/src/model/builder.rs``).
- :mod:`runtime` — ``Model``: the static execution plan and ``run()``.
- :mod:`program` — the batched year loop that runs a model for one member
  or an ensemble.
"""

from .builder import ModelBuilder
from .runtime import Model

__all__ = ["ModelBuilder", "Model"]
