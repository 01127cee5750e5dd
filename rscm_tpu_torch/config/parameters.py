"""Parameter metadata for configuration dataclasses.

Provides the reference's ``rscm.config.parameters`` API surface
(`python/rscm/config/parameters.py`): a ``parameter()`` field factory that
attaches :class:`ParameterMetadata` to dataclass fields, metadata extraction,
and instance validation. The design here differs from the reference's
procedural validator: each metadata record knows how to check a value
(:meth:`ParameterMetadata.check`), so documentation tooling and validation
share one object.
"""

from __future__ import annotations

import warnings
from dataclasses import MISSING, dataclass, field, fields
from typing import Any, Iterator, List, Optional, Tuple

__all__ = [
    "ParameterMetadata",
    "parameter",
    "get_parameter_metadata",
    "validate_parameters",
]

_META_KEY = "param"


@dataclass
class ParameterMetadata:
    """Everything the framework knows about one configuration parameter.

    ``range`` is a hard constraint (violations are errors);
    ``typical_range`` is soft guidance used only by documentation.
    """

    name: str
    unit: Optional[str] = None
    description: Optional[str] = None
    range: Optional[Tuple[float, float]] = None
    typical_range: Optional[Tuple[float, float]] = None
    choices: Optional[List[Any]] = None
    source: Optional[str] = None
    deprecated: bool = False
    deprecated_message: Optional[str] = None

    def check(self, value: Any) -> Iterator[str]:
        """Yield an error message for each hard constraint ``value`` breaks."""
        if self.range is not None:
            lo, hi = self.range
            if value < lo or value > hi:
                yield (
                    f"Parameter '{self.name}' value {value} is outside valid "
                    f"range [{lo}, {hi}]"
                )
        if self.choices is not None and value not in self.choices:
            yield (
                f"Parameter '{self.name}' value {value!r} is not in valid "
                f"choices: {self.choices}"
            )

    def warn_if_deprecated(self) -> None:
        if self.deprecated:
            warnings.warn(
                self.deprecated_message
                or f"Parameter '{self.name}' is deprecated",
                DeprecationWarning,
                stacklevel=3,
            )


def parameter(default: Any = MISSING, **meta: Any) -> Any:
    """Dataclass field with validation/documentation metadata attached.

    Keyword arguments are the :class:`ParameterMetadata` fields (``unit``,
    ``description``, ``range``, ``typical_range``, ``choices``, ``source``,
    ``deprecated``, ``deprecated_message``); the name is filled in from the
    dataclass field at extraction time.
    """
    record = ParameterMetadata(name="", **meta)
    kwargs = {} if default is MISSING else {"default": default}
    return field(metadata={_META_KEY: record}, **kwargs)


def get_parameter_metadata(cls: type) -> dict:
    """Name -> :class:`ParameterMetadata` for every ``parameter()`` field."""
    table = {}
    for f in fields(cls):
        record = f.metadata.get(_META_KEY)
        if record is not None:
            record.name = f.name
            table[f.name] = record
    return table


def validate_parameters(instance: Any) -> list:
    """Validate an instance against its metadata; returns error messages.

    Deprecated parameters raise :class:`DeprecationWarning` as a side
    effect; hard-range and choices violations come back as strings (empty
    list means valid).
    """
    errors: list = []
    for name, record in get_parameter_metadata(type(instance)).items():
        record.warn_if_deprecated()
        errors.extend(record.check(getattr(instance, name)))
    return errors
