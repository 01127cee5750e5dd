"""
The ``Unit`` class: parse, compare, convert.

Mirror of ``crates/rscm-core/src/units/conversion.rs:106-285``.
"""

from __future__ import annotations

from .dimension import Dimension
from .parser import ParsedUnit, ParseError

__all__ = ["Unit", "ConversionError", "units_equal", "conversion_factor"]


class ConversionError(ValueError):
    pass


class Unit:
    __slots__ = ("_original", "_parsed")

    def __init__(self, unit_str: str):
        self._original = unit_str
        self._parsed = ParsedUnit.parse(unit_str)

    @staticmethod
    def parse(text: str) -> "Unit":
        return Unit(text)

    @property
    def original(self) -> str:
        return self._original

    def normalized(self) -> str:
        return self._parsed.normalized()

    def is_dimensionless(self) -> bool:
        try:
            return self._parsed.is_dimensionless()
        except ParseError:
            return False

    def dimension(self) -> Dimension:
        return self._parsed.dimension()

    def to_si_factor(self) -> float:
        return self._parsed.to_si_factor()

    def is_compatible(self, other: "Unit") -> bool:
        try:
            return self.dimension().is_compatible(other.dimension())
        except ParseError:
            return False

    def conversion_factor(self, other: "Unit") -> float:
        dim_self = self.dimension()
        dim_other = other.dimension()
        if not dim_self.is_compatible(dim_other):
            raise ConversionError(
                f"cannot convert from '{self._original}' to '{other._original}': "
                f"incompatible dimensions ({dim_self} vs {dim_other})"
            )
        return self.to_si_factor() / other.to_si_factor()

    def convert(self, value: float, other: "Unit") -> float:
        return value * self.conversion_factor(other)

    # Alias matching the Rust name
    convert_to = convert

    def __eq__(self, other):
        return isinstance(other, Unit) and self._parsed == other._parsed

    def __hash__(self):
        return hash(self.normalized())

    def __str__(self):
        return self.normalized()

    def __repr__(self):
        return f"Unit({self._original!r})"


def units_equal(a: str, b: str) -> bool:
    return Unit(a) == Unit(b)


def conversion_factor(from_unit: str, to_unit: str) -> float:
    return Unit(from_unit).conversion_factor(Unit(to_unit))
