"""Physics invariants of the port on the CPU (the counterpart of
``tests/test_physics_invariants.py``): ECS tracking, RLO convergence, the
OHC / heat-uptake identity and terrestrial pool positivity at both
land-use levels, with the reference's assertions.

The ECS and RLO cases run 1850-2049 instead of the reference's 1850-2450,
to keep each case under ~15 s of the port's CPU year loop; at 200 years
the reference itself reaches equilibration fractions of 0.92-0.96 and an
RLO of 1.239, inside the same bounds.  The other cases run on the
reference's own axes.
"""

import numpy as np
import pytest

from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries
from rscm_tpu_torch.core.spatial import ScalarGrid
from rscm_tpu_torch.magicc import ClimateUDEB
from rscm_tpu_torch.magicc.carbon.terrestrial import TerrestrialCarbon
from rscm_tpu_torch.parallel import EnsembleRunner
from test_torch_support import build_udeb, values

# UDEB with state feedbacks disabled: constant circulation and constant
# effective ECS, the configuration the reference's ECS diagnostics sweep.
DIAG_PARAMS = dict(
    w_variable_fraction=0.0,
    feedback_cumt_sensitivity=0.0,
    feedback_q_sensitivity=0.0,
)
EQUILIBRIUM_YEARS = np.arange(1850.0, 2050.0)


def step_to_2xco2(years):
    return np.where(years >= 1851.0, 3.71, 0.0)


class TestEcsDiagnostics:
    def test_equilibrium_warming_tracks_ecs(self):
        years = EQUILIBRIUM_YEARS
        runner = EnsembleRunner(build_udeb("rscm_tpu_torch", years, step_to_2xco2(years),
                                           **DIAG_PARAMS), device="cpu")
        ecs_values = np.array([2.0, 3.0, 4.5])
        out = runner.run(runner.batched_params({"ClimateUDEB.ecs": ecs_values}),
                         out_vars=["Surface Temperature"])
        fourbox = out["Surface Temperature"].numpy()[:, -1, :]
        weights = np.asarray(ClimateUDEB(**DIAG_PARAMS).global_box_fractions())
        t_global = fourbox @ weights
        fraction = t_global / ecs_values
        assert np.all(fraction > 0.75), fraction
        assert np.all(fraction < 1.02), fraction
        assert t_global[0] < t_global[1] < t_global[2]

    def test_rlo_convergence(self):
        """Land/ocean warming ratio approaches the prescribed RLO."""
        years = EQUILIBRIUM_YEARS
        model = build_udeb("rscm_tpu_torch", years, step_to_2xco2(years), **DIAG_PARAMS)
        model.run(device="cpu")
        fourbox = values(model, "Surface Temperature")[-1]
        t_ocean = 0.5 * (fourbox[0] + fourbox[2])  # NO, SO
        t_land = 0.5 * (fourbox[1] + fourbox[3])   # NL, SL
        rlo = ClimateUDEB(**DIAG_PARAMS).rlo
        assert abs(t_land / t_ocean - rlo) / rlo < 0.15, (t_land, t_ocean, rlo)


class TestHeatUptakeIdentity:
    def test_ohc_derivative_matches_uptake(self):
        """dOHC/dt tracks the heat-uptake flux (energy bookkeeping)."""
        seconds_per_year = 31557600.0
        years = np.arange(1850.0, 2100.0)
        erf = np.linspace(0.0, 6.0, len(years))
        model = build_udeb("rscm_tpu_torch", years, erf, **DIAG_PARAMS)
        model.run(device="cpu")
        ohc = values(model, "Ocean Heat Content")[:, 0]
        uptake = values(model, "Heat Uptake")[:, 0]
        dohc = np.diff(ohc[1:]) / seconds_per_year
        flux = uptake[2:]
        mask = flux > 0.1
        ratio = dohc[mask[: len(dohc)]] / flux[: len(dohc)][mask[: len(dohc)]]
        assert np.all(np.isfinite(ratio))
        assert ratio.std() / ratio.mean() < 0.2, (ratio.mean(), ratio.std())


class TestPoolPositivity:
    """Terrestrial pools stay non-negative under extreme land-use flux."""

    @pytest.mark.parametrize("landuse", [50.0, 500.0])
    def test_pools_nonnegative(self, landuse):
        years = np.arange(2000.0, 2101.0)
        ta = TimeAxis.from_values(years)

        def exo(value, unit):
            return Timeseries(np.full((len(years), 1), value), ta, ScalarGrid(), unit)

        model = (
            ModelBuilder()
            .with_time_axis(ta)
            .with_component(TerrestrialCarbon())
            .with_exogenous_variable("Atmospheric Concentration|CO2", exo(400.0, "ppm"))
            .with_exogenous_variable("Surface Temperature", exo(2.0, "K"))
            .with_exogenous_variable("Emissions|CO2|Land Use", exo(landuse, "GtC/yr"))
            .with_initial_values({
                "Carbon Pool|Plant": 884.86,
                "Carbon Pool|Detritus": 92.77,
                "Carbon Pool|Soil": 1681.53,
                "Carbon Pool|Humus": 836.0,
            })
            .build()
        )
        model.run(device="cpu")
        for pool in ["Plant", "Detritus", "Soil", "Humus"]:
            series = values(model, f"Carbon Pool|{pool}")
            assert np.all(np.isfinite(series)), pool
            assert np.all(series >= 0.0), f"{pool} went negative at landuse={landuse}"
