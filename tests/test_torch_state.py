"""Windows over batched tensors keep the host windows' semantics.

The port's year loop hands components windows over ``(n_steps, B,
regions)`` tensors (shared exogenous data: ``(n_steps, regions)``).  Every
read must give, per member, what the host window gives on that member's
``(n_steps, regions)`` numpy array — including the VariableSource rule:
Exogenous and OwnState read index N, UpstreamOutput reads N+1.
"""

import numpy as np
import pytest
import torch

from rscm_tpu_torch.core.spatial import FourBoxGrid, GridType, ScalarGrid
from rscm_tpu_torch.core.state import (
    FourBoxSlice,
    StateValue,
    VariableSource,
    make_window,
)
from test_torch_support import values

N_STEPS, B = 6, 3
SOURCES = [VariableSource.Exogenous, VariableSource.OwnState, VariableSource.UpstreamOutput]


def trajectories(regions, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (N_STEPS, B, regions))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("idx", [1, 3])
def test_scalar_window_reads_per_member(source, idx):
    data = trajectories(1)
    t = make_window(GridType.Scalar, torch.tensor(data), idx, 2000.0 + idx, source=source,
                    grid=ScalarGrid(), factor=2.0)
    for m in range(B):
        h = make_window(GridType.Scalar, data[:, m], idx, 2000.0 + idx, source=source,
                        grid=ScalarGrid(), factor=2.0)
        for read in ("at_start", "at_end", "get", "previous"):
            assert float(getattr(t, read)()[m]) == getattr(h, read)(), read
        np.testing.assert_array_equal(t.last_n(2)[m].numpy(), h.last_n(2))
    expected_row = idx + 1 if source == VariableSource.UpstreamOutput else idx
    np.testing.assert_array_equal(t.get().numpy(), 2.0 * data[expected_row, :, 0])


@pytest.mark.parametrize("source", SOURCES)
def test_four_box_window_reads_per_member(source):
    data = trajectories(4, seed=1)
    grid = FourBoxGrid.magicc_standard()
    t = make_window(GridType.FourBox, torch.tensor(data), 2, 2002.0, source=source, grid=grid)
    for m in range(B):
        h = make_window(GridType.FourBox, data[:, m], 2, 2002.0, source=source, grid=grid)
        for region in range(4):
            assert float(t.get(region)[m]) == h.get(region)
            assert float(t.at_end(region)[m]) == h.at_end(region)
        assert [float(v[m]) for v in t.get_all()] == h.get_all()
        assert float(t.current_global()[m]) == pytest.approx(h.current_global(), rel=1e-15)


def test_shared_exogenous_rows_broadcast():
    data = np.random.default_rng(2).uniform(size=(N_STEPS, 1))
    w = make_window(GridType.Scalar, torch.tensor(data), 2, 2002.0)
    assert w.at_start().shape == ()
    assert float(w.at_start()) == data[2, 0]


def test_slices_and_state_values_of_member_tensors():
    cols = [torch.full((B,), float(k)) for k in range(4)]
    value = StateValue.four_box(FourBoxSlice.from_array(cols))
    assert tuple(value.as_array().shape) == (B, 4)
    np.testing.assert_array_equal(value.as_array()[0].numpy(), [0.0, 1.0, 2.0, 3.0])
    scalar = StateValue.scalar(torch.arange(B, dtype=torch.float64))
    assert tuple(scalar.as_array().shape) == (B, 1)


def test_schema_aggregate_feeds_udeb_like_rscm_tpu():
    """An ERF built by a schema Sum aggregate of two exogenous series (an
    AggregatorComponent node, read by ClimateUDEB as an upstream output)
    runs the same in both packages."""
    import importlib

    years = np.arange(1850.0, 1870.0)
    parts = [np.where(years >= 1851.0, 3.0, 0.0), np.linspace(0.0, 0.7, len(years))]
    out = {}
    for pkg in ("rscm_tpu", "rscm_tpu_torch"):
        core = importlib.import_module(f"{pkg}.core")
        spatial = importlib.import_module(f"{pkg}.core.spatial")
        magicc = importlib.import_module(f"{pkg}.magicc")
        axis = core.TimeAxis.from_values(years)
        schema = core.VariableSchema()
        for name in ("ERF|A", "ERF|B"):
            schema.add_variable(name, "W/m^2")
        schema.add_aggregate("Effective Radiative Forcing", "W/m^2", "Sum", ["ERF|A", "ERF|B"])
        schema.add_variable("Surface Temperature", "K", core.GridType.FourBox)
        schema.add_variable("Heat Uptake", "W/m^2")
        schema.add_variable("Ocean Heat Content", "J/m^2")
        schema.add_variable("Sea Surface Temperature", "K")
        builder = (
            core.ModelBuilder().with_time_axis(axis).with_schema(schema)
            .with_component(magicc.ClimateUDEB(month_engine="xla" if pkg == "rscm_tpu" else "torch"))
            .with_initial_values({"Surface Temperature": 0.0})
        )
        for name, series in zip(("ERF|A", "ERF|B"), parts):
            builder = builder.with_exogenous_variable(
                name, core.Timeseries(series[:, None], axis, spatial.ScalarGrid(), "W/m^2"))
        model = builder.build()
        if pkg == "rscm_tpu":
            model.run(compiled=True)
        else:
            model.run(device="cpu")
        out[pkg] = model
    for name in ("Effective Radiative Forcing", "Sea Surface Temperature", "Surface Temperature"):
        np.testing.assert_allclose(values(out["rscm_tpu_torch"], name),
                                   values(out["rscm_tpu"], name), rtol=1e-9, atol=1e-9,
                                   err_msg=name)
