"""
Physical unit system: 7-dimensional SI analysis, registry, parser, conversion.

Mirror of ``crates/rscm-core/src/units/`` — a flexible parser
(``W/m^2`` == ``W m^-2`` == ``W per m ^ 2``), SI prefixes, climate units
(C/CO2 with the 44/12 mass ratio, t/Gt/ppm/ppb/ppt, W/m^2, ...),
normalisation, compatibility checks and conversion factors.

All unit work happens at build/trace time — conversion factors are folded
into the compiled program as constants, so units cost nothing on device.
"""

from .dimension import Dimension
from .parser import ParsedUnit, ParseError
from .registry import UNIT_REGISTRY, SI_PREFIXES, UnitInfo, UnitRegistry
from .unit import ConversionError, Unit, conversion_factor, units_equal

__all__ = [
    "Dimension",
    "ParsedUnit",
    "ParseError",
    "UNIT_REGISTRY",
    "SI_PREFIXES",
    "UnitInfo",
    "UnitRegistry",
    "Unit",
    "ConversionError",
    "conversion_factor",
    "units_equal",
]
