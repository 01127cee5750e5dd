"""
MAGICC7-derived component library.

This slice of the port carries the climate core: ClimateUDEB (4-box
atmosphere + upwelling-diffusion ocean) with its LAMCALC feedback solve.
"""

from .climate.udeb import ClimateUDEB, ClimateUDEBBuilder

__all__ = ["ClimateUDEB", "ClimateUDEBBuilder"]
