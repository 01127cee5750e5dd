"""
MAGICC7-derived component library.

Port of ``rscm_tpu/magicc``: the ten components of the emissions-driven
MAGICC graph (:func:`build_magicc_model`) —

- Forcing: GhgForcing (CO2/CH4/N2O, IPCCTAR + OLBL methods), OzoneForcing,
  AerosolDirect, AerosolIndirect
- Chemistry: CH4Chemistry, N2OChemistry (and HalocarbonChemistry, which
  the graph does not use)
- Carbon: TerrestrialCarbon, OceanCarbon, CO2Budget
- Climate: ClimateUDEB (4-box atmosphere + upwelling-diffusion ocean)
- Beyond the reference: Permafrost (module_12) and SeaLevelRise
  (module_14), the graph's optional branches
"""

from .forcing.ghg import ForcingMethod, GhgForcing, GhgForcingBuilder
from .chemistry.ch4 import CH4Chemistry, CH4ChemistryBuilder
from .chemistry.n2o import N2OChemistry, N2OChemistryBuilder
from .chemistry.halocarbon import (
    HALOCARBON_SPECIES,
    HalocarbonChemistry,
    HalocarbonChemistryBuilder,
)
from .forcing.ozone import OzoneForcing, OzoneForcingBuilder
from .forcing.aerosol_direct import AerosolDirect, AerosolDirectBuilder
from .forcing.aerosol_indirect import AerosolIndirect, AerosolIndirectBuilder
from .carbon.terrestrial import TerrestrialCarbon, TerrestrialCarbonBuilder
from .carbon.ocean import OceanCarbon, OceanCarbonBuilder
from .carbon.budget import CO2Budget, CO2BudgetBuilder
from .carbon.permafrost import (
    CH4ChemistryWithPermafrost,
    CO2BudgetWithPermafrost,
    Permafrost,
    PermafrostBuilder,
)
from .slr import SeaLevelRise, SeaLevelRiseBuilder
from .climate.udeb import ClimateUDEB, ClimateUDEBBuilder

__all__ = [
    "AerosolDirect",
    "AerosolDirectBuilder",
    "AerosolIndirect",
    "AerosolIndirectBuilder",
    "CH4Chemistry",
    "CH4ChemistryBuilder",
    "CH4ChemistryWithPermafrost",
    "CO2Budget",
    "CO2BudgetBuilder",
    "CO2BudgetWithPermafrost",
    "ClimateUDEB",
    "ClimateUDEBBuilder",
    "ForcingMethod",
    "GhgForcing",
    "GhgForcingBuilder",
    "HALOCARBON_SPECIES",
    "HalocarbonChemistry",
    "HalocarbonChemistryBuilder",
    "N2OChemistry",
    "N2OChemistryBuilder",
    "OceanCarbon",
    "OceanCarbonBuilder",
    "OzoneForcing",
    "OzoneForcingBuilder",
    "Permafrost",
    "PermafrostBuilder",
    "SeaLevelRise",
    "SeaLevelRiseBuilder",
    "TerrestrialCarbon",
    "TerrestrialCarbonBuilder",
]
