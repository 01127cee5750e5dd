"""
7-dimensional SI dimensional vectors.

Mirror of ``crates/rscm-core/src/units/dimension.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Dimension"]

_FIELDS = ("mass", "length", "time", "temperature", "amount", "current", "luminosity")
_SYMBOLS = {
    "mass": "M",
    "length": "L",
    "time": "T",
    "temperature": "Θ",
    "amount": "N",
    "current": "I",
    "luminosity": "J",
}


@dataclass(frozen=True)
class Dimension:
    mass: int = 0
    length: int = 0
    time: int = 0
    temperature: int = 0
    amount: int = 0
    current: int = 0
    luminosity: int = 0

    @staticmethod
    def dimensionless() -> "Dimension":
        return Dimension()

    def is_dimensionless(self) -> bool:
        return all(getattr(self, f) == 0 for f in _FIELDS)

    def is_compatible(self, other: "Dimension") -> bool:
        return self == other

    def pow(self, exp: int) -> "Dimension":
        return Dimension(**{f: getattr(self, f) * exp for f in _FIELDS})

    def __mul__(self, other: "Dimension") -> "Dimension":
        return Dimension(**{f: getattr(self, f) + getattr(other, f) for f in _FIELDS})

    # dimension "addition" is composition (mirror of dimension.rs Add impl)
    __add__ = __mul__

    def __sub__(self, other: "Dimension") -> "Dimension":
        return Dimension(**{f: getattr(self, f) - getattr(other, f) for f in _FIELDS})

    def __neg__(self) -> "Dimension":
        return Dimension(**{f: -getattr(self, f) for f in _FIELDS})

    def __str__(self) -> str:
        parts = []
        for f in _FIELDS:
            e = getattr(self, f)
            if e == 1:
                parts.append(_SYMBOLS[f])
            elif e != 0:
                parts.append(f"{_SYMBOLS[f]}^{e}")
        return " ".join(parts) if parts else "1"


Dimension.MASS = Dimension(mass=1)
Dimension.LENGTH = Dimension(length=1)
Dimension.TIME = Dimension(time=1)
Dimension.TEMPERATURE = Dimension(temperature=1)
Dimension.AMOUNT = Dimension(amount=1)
Dimension.CURRENT = Dimension(current=1)
Dimension.LUMINOSITY = Dimension(luminosity=1)
Dimension.AREA = Dimension(length=2)
Dimension.VOLUME = Dimension(length=3)
Dimension.FORCE = Dimension(mass=1, length=1, time=-2)
Dimension.ENERGY = Dimension(mass=1, length=2, time=-2)
Dimension.POWER = Dimension(mass=1, length=2, time=-3)
Dimension.RADIATIVE_FLUX = Dimension(mass=1, time=-3)
