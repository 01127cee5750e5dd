"""
Unit registry: base/derived units, SI prefixes, climate-specific units.

Mirror of ``crates/rscm-core/src/units/registry.rs:64-346`` including the
CO2/C 44:12 mass ratio and ppm/ppb/ppt pseudo-dimensionless units.

Deliberate reference-parity behaviours (do not "fix" — the upstream
registry behaves identically and the compat contract pins them):

- CO2-family units store *carbon-equivalent* SI factors under the shared
  MASS dimension (``registry.rs:348-361``): ``GtCO2 -> Gt`` converts by
  12/44 by design — all carbon-cycle bookkeeping is in GtC.
- ``degC`` is a multiplicative alias of K for temperature *differences*
  (``registry.rs:395-397``, mod.rs:66); there is no affine 273.15 offset.
- Prefixed lookup falls through to single-letter aliases exactly like
  ``registry.rs:216-245``: ``"Pa"`` resolves as peta-annum, not pascal
  (pascal is not a registered unit upstream either).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .dimension import Dimension

__all__ = [
    "UnitInfo",
    "SiPrefix",
    "SI_PREFIXES",
    "UnitRegistry",
    "UNIT_REGISTRY",
    "SECONDS_PER_YEAR",
    "CO2_TO_C_RATIO",
    "C_TO_CO2_RATIO",
]

SECONDS_PER_YEAR = 365.25 * 24.0 * 3600.0
SECONDS_PER_DAY = 24.0 * 3600.0
SECONDS_PER_HOUR = 3600.0
SECONDS_PER_MINUTE = 60.0

CO2_TO_C_RATIO = 44.0 / 12.0
C_TO_CO2_RATIO = 12.0 / 44.0


@dataclass(frozen=True)
class UnitInfo:
    name: str
    dimension: Dimension
    to_si_factor: float
    base_unit: Optional[str] = None


@dataclass(frozen=True)
class SiPrefix:
    symbol: str
    factor: float


SI_PREFIXES = [
    SiPrefix("Y", 1e24),
    SiPrefix("Z", 1e21),
    SiPrefix("E", 1e18),
    SiPrefix("P", 1e15),
    SiPrefix("T", 1e12),
    SiPrefix("G", 1e9),
    SiPrefix("M", 1e6),
    SiPrefix("k", 1e3),
    SiPrefix("h", 1e2),
    SiPrefix("da", 1e1),
    SiPrefix("d", 1e-1),
    SiPrefix("c", 1e-2),
    SiPrefix("m", 1e-3),
    SiPrefix("u", 1e-6),  # 'u' for micro
    SiPrefix("n", 1e-9),
    SiPrefix("p", 1e-12),
    SiPrefix("f", 1e-15),
    SiPrefix("a", 1e-18),
    SiPrefix("z", 1e-21),
    SiPrefix("y", 1e-24),
]


class UnitRegistry:
    def __init__(self):
        self._units: dict[str, UnitInfo] = {}
        self._aliases: dict[str, str] = {}
        self._register_base_units()
        self._register_time_units()
        self._register_carbon_units()
        self._register_concentration_units()
        self._register_energy_units()
        self._register_temperature_units()

    # -- registration -------------------------------------------------------

    def _add(self, name: str, dimension: Dimension, to_si: float, base: Optional[str] = None):
        self._units[name] = UnitInfo(name, dimension, to_si, base)

    def _register_base_units(self):
        self._add("kg", Dimension.MASS, 1.0)
        self._add("g", Dimension.MASS, 1e-3)
        self._add("t", Dimension.MASS, 1e3)  # metric tonne
        self._add("m", Dimension.LENGTH, 1.0)
        self._add("s", Dimension.TIME, 1.0)
        self._add("K", Dimension.TEMPERATURE, 1.0)
        self._add("mol", Dimension.AMOUNT, 1.0)
        self._add("A", Dimension.CURRENT, 1.0)
        self._add("1", Dimension.dimensionless(), 1.0)
        self._aliases["dimensionless"] = "1"

    def _register_time_units(self):
        self._add("yr", Dimension.TIME, SECONDS_PER_YEAR)
        self._add("day", Dimension.TIME, SECONDS_PER_DAY)
        self._add("h", Dimension.TIME, SECONDS_PER_HOUR)
        self._add("min", Dimension.TIME, SECONDS_PER_MINUTE)
        self._aliases.update(
            {
                "year": "yr",
                "years": "yr",
                "a": "yr",  # annum
                "days": "day",
                "hour": "h",
                "hours": "h",
                "minute": "min",
                "minutes": "min",
                "sec": "s",
                "second": "s",
                "seconds": "s",
            }
        )

    def _register_carbon_units(self):
        # Carbon-mass family: "C" is its own mass scale so that C- and
        # CO2-denominated masses convert through the 44/12 molar-mass ratio
        # (registry.rs:252-300).
        self._add("C", Dimension.MASS, 1.0)
        self._add("tC", Dimension.MASS, 1e3, "C")
        self._add("ktC", Dimension.MASS, 1e6, "C")
        self._add("MtC", Dimension.MASS, 1e9, "C")
        self._add("GtC", Dimension.MASS, 1e12, "C")
        self._add("PgC", Dimension.MASS, 1e12, "C")  # 1 Pg = 1 Gt
        self._add("CO2", Dimension.MASS, C_TO_CO2_RATIO)
        self._add("tCO2", Dimension.MASS, 1e3 * C_TO_CO2_RATIO, "CO2")
        self._add("ktCO2", Dimension.MASS, 1e6 * C_TO_CO2_RATIO, "CO2")
        self._add("MtCO2", Dimension.MASS, 1e9 * C_TO_CO2_RATIO, "CO2")
        self._add("GtCO2", Dimension.MASS, 1e12 * C_TO_CO2_RATIO, "CO2")

    def _register_concentration_units(self):
        self._add("ppm", Dimension.dimensionless(), 1e-6)
        self._add("ppb", Dimension.dimensionless(), 1e-9)
        self._add("ppt", Dimension.dimensionless(), 1e-12)

    def _register_energy_units(self):
        self._add("J", Dimension.ENERGY, 1.0)
        self._add("W", Dimension.POWER, 1.0)

    def _register_temperature_units(self):
        self._add("degC", Dimension.TEMPERATURE, 1.0)
        self._add("delta_degC", Dimension.TEMPERATURE, 1.0)
        self._aliases.update({"celsius": "degC", "Celsius": "degC", "deg_C": "degC"})

    # -- lookup -------------------------------------------------------------

    def lookup(self, symbol: str) -> Optional[UnitInfo]:
        info = self._units.get(symbol)
        if info is not None:
            return info
        canonical = self._aliases.get(symbol)
        if canonical is not None and canonical in self._units:
            return self._units[canonical]
        return self._lookup_prefixed(symbol)

    def _lookup_prefixed(self, symbol: str) -> Optional[UnitInfo]:
        # Longest prefixes first so "da" beats "d" (registry.rs:181-183).
        for prefix in sorted(SI_PREFIXES, key=lambda p: -len(p.symbol)):
            if symbol.startswith(prefix.symbol):
                base_symbol = symbol[len(prefix.symbol):]
                base_info = self._units.get(base_symbol)
                if base_info is not None:
                    return UnitInfo(
                        symbol, base_info.dimension,
                        base_info.to_si_factor * prefix.factor, base_info.name,
                    )
                canonical = self._aliases.get(base_symbol)
                if canonical is not None and canonical in self._units:
                    base_info = self._units[canonical]
                    return UnitInfo(
                        symbol, base_info.dimension,
                        base_info.to_si_factor * prefix.factor, canonical,
                    )
        return None


UNIT_REGISTRY = UnitRegistry()
