"""Shared builders for the ``rscm_tpu_torch`` parity tests (no tests here).

The same ClimateUDEB model, driven by an exogenous effective radiative
forcing, is built in either package from the same numpy inputs.
"""

import importlib

import numpy as np

UDEB_OUTPUTS = [
    "Surface Temperature", "Heat Uptake", "Ocean Heat Content",
    "Sea Surface Temperature",
]


def build_udeb(pkg, years, erf, *, from_bounds=False, **params):
    """ClimateUDEB on ``years`` driven by ``erf``, built with package
    ``pkg`` (``"rscm_tpu"`` or ``"rscm_tpu_torch"``).  ``from_bounds``
    builds the time axis as the golden regression tests do."""
    core = importlib.import_module(f"{pkg}.core")
    spatial = importlib.import_module(f"{pkg}.core.spatial")
    magicc = importlib.import_module(f"{pkg}.magicc")
    years = np.asarray(years, dtype=np.float64)
    if from_bounds:
        axis = core.TimeAxis.from_bounds(np.concatenate([years, [years[-1] + 1.0]]))
    else:
        axis = core.TimeAxis.from_values(years)
    schema = core.VariableSchema()
    schema.add_variable("Effective Radiative Forcing", "W/m^2")
    schema.add_variable("Surface Temperature", "K", core.GridType.FourBox)
    schema.add_variable("Heat Uptake", "W/m^2")
    schema.add_variable("Ocean Heat Content", "J/m^2")
    schema.add_variable("Sea Surface Temperature", "K")
    return (
        core.ModelBuilder()
        .with_time_axis(axis)
        .with_schema(schema)
        .with_component(magicc.ClimateUDEB(**params))
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            core.Timeseries(
                np.asarray(erf, dtype=np.float64)[:, None], axis, spatial.ScalarGrid(), "W/m^2"
            ),
        )
        .with_initial_values({"Surface Temperature": 0.0})
        .build()
    )


def step_erf(years, level=3.71, step_year=1851.0):
    return np.where(np.asarray(years) >= step_year, level, 0.0)


def values(model, name):
    return np.asarray(model.collection.get_data(name).values())
