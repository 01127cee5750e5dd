"""Checkpoints and whole-model serialisation of the port against the
reference.

Mirrors ``tests/test_internal_state_checkpoint.py`` and the checkpoint case
of ``tests/test_model.py``, and holds the port to the reference across the
packages: a checkpoint written by either restores in the other and the
continued run matches the reference's at 1e-9 (ClimateUDEB, and the MAGICC
graph under both ocean-carbon engines); reference ``to_full_dict`` /
``to_toml`` output rebuilds the port's model; ``as_dot`` and
``debug_info("json")`` give the reference's nodes, edges and entries.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_support import UDEB_OUTPUTS, build_udeb, step_erf, values

ROOT = Path(__file__).resolve().parent.parent
#: the reference's model bar
MODEL_TOL = dict(rtol=1e-9, atol=1e-9)


def trajectories(model):
    return {item.name: np.asarray(model.collection.get_data(item.name).values())
            for item in model.collection}


def assert_same_run(got, want, **tol):
    got, want = trajectories(got), trajectories(want)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], err_msg=name, **(tol or MODEL_TOL))


def build_ocean_carbon(pkg, years, **ocean_kwargs):
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    magicc = importlib.import_module(f"{pkg}.magicc")
    return (
        core.ModelBuilder()
        .with_time_axis(core.TimeAxis.from_values(years))
        .with_component(magicc.OceanCarbon(**ocean_kwargs))
        .with_exogenous_variable(
            "Atmospheric Concentration|CO2",
            core.Timeseries.from_values(np.linspace(300.0, 400.0, len(years)), years),
        )
        .with_exogenous_variable(
            "Sea Surface Temperature", core.Timeseries.from_values(np.zeros(len(years)), years)
        )
        .with_initial_values({"Ocean Surface pCO2": 278.0, "Cumulative Ocean Uptake": 0.0})
        .build()
    )


def magicc(pkg, years, **kw):
    import importlib

    return importlib.import_module(f"{pkg}.magicc.coupled").build_magicc_model(years=years, **kw)


# -- mirrors of the reference's checkpoint tests --------------------------------------


def test_ocean_carbon_flux_history_roundtrip():
    from rscm_tpu_torch.core import Model

    years = np.arange(2000.0, 2020.0)
    model = build_ocean_carbon("rscm_tpu_torch", years)
    ref = build_ocean_carbon("rscm_tpu", years)
    for _ in range(8):
        model.step(device="cpu")
        ref.step()
    restored = Model.from_full_dict(model.to_full_dict())
    node = model.exec_order[1]
    np.testing.assert_array_equal(restored.component_states[node]["flux_history"],
                                  model._host_states()[node]["flux_history"])
    np.testing.assert_allclose(restored.component_states[node]["flux_history"],
                               ref.component_states[node]["flux_history"], **MODEL_TOL)
    model.run(compiled=False, device="cpu")
    restored.run(compiled=False, device="cpu")
    ref.run(compiled=False)
    assert_same_run(restored, model, rtol=0.0, atol=0.0)
    assert_same_run(restored, ref)


@pytest.mark.parametrize("writer", ["rscm_tpu", "rscm_tpu_torch"])
def test_ring_checkpoint_migrates_into_expsum_engine(writer):
    """A ring-engine checkpoint, written by either package, restores into
    the port's exp-sum component through ``migrate_internal_state``: the
    state equals the reference's migration, and the run continues with the
    ring engine's values (the tail-fit bound of the reference's test)."""
    years = np.arange(2000.0, 2040.0)
    ring = build_ocean_carbon(writer, years, engine="ring")
    for _ in range(8):  # 96 months of history > the 36-month young window
        ring.step(**({"device": "cpu"} if writer == "rscm_tpu_torch" else {}))
    snapshot = json.loads(ring.checkpoint())

    port = build_ocean_carbon("rscm_tpu_torch", years, engine="expsum")
    port.restore(snapshot)
    ref = build_ocean_carbon("rscm_tpu", years, engine="expsum")
    ref.restore(json.loads(json.dumps(snapshot)))
    node = port.exec_order[1]
    state, want = port.component_states[node], ref.component_states[node]
    assert set(state) == {"flux_history", "tail_accum"}
    for key in state:
        np.testing.assert_allclose(state[key], want[key], rtol=1e-12, atol=1e-15, err_msg=key)
    assert np.any(state["tail_accum"] != 0.0)

    ring_ref = build_ocean_carbon("rscm_tpu", years, engine="ring")
    ring_ref.restore(json.loads(json.dumps(snapshot)))
    ring_ref.run(compiled=False)
    port.run(compiled=False, device="cpu")
    np.testing.assert_allclose(values(port, "Cumulative Ocean Uptake"),
                               values(ring_ref, "Cumulative Ocean Uptake"), rtol=1e-7)


def test_expsum_checkpoint_into_ring_engine_raises():
    years = np.arange(2000.0, 2020.0)
    model = build_ocean_carbon("rscm_tpu_torch", years, engine="expsum")
    for _ in range(4):
        model.step(device="cpu")
    target = build_ocean_carbon("rscm_tpu_torch", years, engine="ring")
    with pytest.raises(ValueError, match="cannot migrate a checkpoint"):
        target.restore(json.loads(model.checkpoint()))
    ref = build_ocean_carbon("rscm_tpu", years, engine="ring")
    with pytest.raises(ValueError, match="cannot migrate a checkpoint"):
        ref.restore(json.loads(model.checkpoint()))


def test_schema_mismatch_without_migration_hook_raises():
    years = np.arange(2000.0, 2020.0)
    model = build_ocean_carbon("rscm_tpu_torch", years, engine="ring")
    for _ in range(4):
        model.step(device="cpu")
    snapshot = json.loads(model.checkpoint())
    node = str(model.exec_order[1])
    snapshot["component_states"][node] = {"flux_history": [0.0] * 7, "unknown_extra": 1.0}
    for pkg in ("rscm_tpu", "rscm_tpu_torch"):
        target = build_ocean_carbon(pkg, years, engine="ring")
        target.graph.nodes[target.exec_order[1]].migrate_internal_state = None
        with pytest.raises(ValueError, match="does not match its current schema"):
            target.restore(snapshot)


def test_migration_producing_the_wrong_schema_raises():
    years = np.arange(2000.0, 2020.0)
    model = build_ocean_carbon("rscm_tpu_torch", years, engine="ring")
    model.step(device="cpu")
    snapshot = json.loads(model.checkpoint())
    node = str(model.exec_order[1])
    snapshot["component_states"][node] = {"flux_history": [0.0] * 7}
    target = build_ocean_carbon("rscm_tpu_torch", years, engine="ring")
    target.graph.nodes[target.exec_order[1]].migrate_internal_state = lambda saved: saved
    with pytest.raises(ValueError, match="migrate_internal_state produced"):
        target.restore(snapshot)


@pytest.mark.parametrize("writer", ["rscm_tpu", "rscm_tpu_torch"])
def test_udeb_state_roundtrip_toml(writer):
    """ClimateUDEB stepped ten years, written as TOML by either package and
    read by the port: the ocean columns come through, and the continued run
    matches the reference's."""
    from rscm_tpu_torch.core import Model

    years = np.arange(1850.0, 1880.0)
    erf = step_erf(years)
    source = build_udeb(writer, years, erf)
    ref = build_udeb("rscm_tpu", years, erf)
    for _ in range(10):
        source.step(**({"device": "cpu"} if writer == "rscm_tpu_torch" else {}))
        if writer == "rscm_tpu_torch":
            ref.step()
    ref = source if writer == "rscm_tpu" else ref
    restored = Model.from_toml(source.to_toml())
    assert restored.time_index == 10
    node = restored.exec_order[1]
    np.testing.assert_allclose(np.asarray(restored.component_states[node]["ocean_temps"]),
                               np.asarray(ref.component_states[node]["ocean_temps"]),
                               rtol=1e-12 if writer == "rscm_tpu" else 1e-10)
    restored.run(compiled=False, device="cpu")
    ref.run(compiled=False)
    for name in UDEB_OUTPUTS:
        np.testing.assert_allclose(values(restored, name), values(ref, name), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


def test_two_layer_checkpoint_roundtrip():
    """Mirror of ``tests/test_model.py::TestBuilderAPI::test_checkpoint_roundtrip``."""
    from test_torch_support import build_flagship

    years = np.arange(1750.0, 1760.0)
    model, other, ref = (build_flagship(pkg, years) for pkg in
                         ("rscm_tpu_torch", "rscm_tpu_torch", "rscm_tpu"))
    model.step(device="cpu")
    model.step(device="cpu")
    ref.step()
    ref.step()
    other.restore(model.to_dict())
    assert other.time_index == 2
    model.run(compiled=False, device="cpu")
    other.run(device="cpu")
    ref.run(compiled=False)
    assert_same_run(other, model, rtol=1e-12, atol=1e-12)
    assert_same_run(other, ref)


# -- across the packages ------------------------------------------------------------------


CASES = {
    "udeb": lambda pkg: build_udeb(pkg, np.arange(1850.0, 1880.0),
                                   step_erf(np.arange(1850.0, 1880.0))),
    "magicc_ring": lambda pkg: magicc(pkg, np.arange(1850.0, 1870.0),
                                      ocean_params={"engine": "ring"}),
    "magicc_expsum": lambda pkg: magicc(pkg, np.arange(1850.0, 1870.0),
                                        ocean_params={"engine": "expsum"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoint_crosses_the_packages(case, direction):
    """Checkpoint at year 10 in one package, restore in the other and
    continue: the continued run matches the reference's uninterrupted run
    at 1e-9."""
    ref = CASES[case]("rscm_tpu")
    port = CASES[case]("rscm_tpu_torch")
    for _ in range(10):
        ref.step()
        port.step(device="cpu")
    if direction == "reference_to_port":
        resumed = CASES[case]("rscm_tpu_torch")
        resumed.restore(json.loads(ref.checkpoint()))
        resumed.run(device="cpu")
    else:
        resumed = CASES[case]("rscm_tpu")
        resumed.restore(json.loads(port.checkpoint()))
        resumed.run(compiled=False)
    ref.run(compiled=False)
    assert resumed.time_index == ref.time_index
    assert_same_run(resumed, ref)


def test_full_options_checkpoint_after_step_resumes_bit_equal():
    """``step()`` leaves the permafrost and sea-level states with a member
    axis; the checkpoint writes the host layout, so a fresh model restores
    it and the year loop continues exactly as without the checkpoint."""
    years = np.arange(1850.0, 1862.0)
    kw = dict(include_permafrost=True, include_slr=True)
    a, straight = magicc("rscm_tpu_torch", years, **kw), magicc("rscm_tpu_torch", years, **kw)
    for _ in range(4):
        a.step(device="cpu")
        straight.step(device="cpu")
    text = a.checkpoint()
    b = magicc("rscm_tpu_torch", years, **kw)
    b.restore(json.loads(text))
    for node, state in b.component_states.items():
        if isinstance(state, dict):
            for key, leaf in state.items():
                assert not isinstance(leaf, torch.Tensor), (node, key)
                assert np.shape(leaf) == np.shape(b.graph.nodes[node].create_initial_state()[key])
    b.run(device="cpu")
    straight.run(device="cpu")
    assert_same_run(b, straight, rtol=0.0, atol=0.0)


def test_restore_drops_programs_and_the_runner_regathers():
    """A restore to the same time index with other states: the cached
    programs go, the state version moves, and an ``EnsembleRunner`` over the
    model gathers its inputs again (its run equals a fresh runner's)."""
    from rscm_tpu_torch.parallel import EnsembleRunner

    years = np.arange(1850.0, 1866.0)
    swept = {"ClimateUDEB.ecs": np.array([2.0, 3.0, 4.5])}
    model = build_udeb("rscm_tpu_torch", years, step_erf(years))
    other = build_udeb("rscm_tpu_torch", years, step_erf(years, level=7.0))
    for _ in range(4):
        model.step(device="cpu")
        other.step(device="cpu")
    model.run(device="cpu")  # builds a cached program
    model.time_index = 4
    runner = EnsembleRunner(model, device="cpu")
    first = runner.run(runner.batched_params(swept), out_vars=UDEB_OUTPUTS, start_idx=4)
    version = model._state_version
    model.restore(json.loads(other.checkpoint()))
    assert model._programs == {} and model._state_version == version + 1
    assert model.time_index == 4
    got = runner.run(runner.batched_params(swept), out_vars=UDEB_OUTPUTS, start_idx=4)
    fresh = EnsembleRunner(other, device="cpu")
    want = fresh.run(fresh.batched_params(swept), out_vars=UDEB_OUTPUTS, start_idx=4)
    for name in UDEB_OUTPUTS:
        torch.testing.assert_close(got[name], want[name], rtol=0.0, atol=0.0, equal_nan=True)
    assert not torch.allclose(got["Heat Uptake"], first["Heat Uptake"])


# -- whole-model serialisation ----------------------------------------------------------


def test_reference_full_dict_rebuilds_the_port_model():
    """The reference's ``to_full_dict`` of the MAGICC graph (stepped five
    years) rebuilds the port's model, which continues as the reference."""
    from rscm_tpu_torch.core import Model

    years = np.arange(1850.0, 1866.0)
    ref = magicc("rscm_tpu", years, ocean_params={"engine": "ring"})
    for _ in range(5):
        ref.step()
    port = Model.from_full_dict(ref.to_full_dict())
    assert all(type(c).__module__.startswith("rscm_tpu_torch.") for c in port.graph.nodes)
    assert port.exec_order == ref.exec_order
    port.run(device="cpu")
    ref.run(compiled=False)
    assert_same_run(port, ref)


def test_reference_toml_loads_without_the_reference(tmp_path):
    """A reference ``to_toml`` rebuilds the port's ClimateUDEB model in an
    interpreter where neither ``jax`` nor the JAX package can be imported,
    and its run matches the reference's at 1e-9."""
    years = np.arange(1850.0, 1880.0)
    ref = build_udeb("rscm_tpu", years, step_erf(years))
    for _ in range(10):
        ref.step()
    (tmp_path / "model.toml").write_text(ref.to_toml())
    ref.run(compiled=False)
    code = (
        "import sys\n"
        "for name in ('jax', 'rscm_tpu', 'rscm'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from rscm_tpu_torch.core import Model\n"
        f"model = Model.from_toml(open({str(tmp_path / 'model.toml')!r}).read())\n"
        "model.run(device='cpu')\n"
        "np.save(sys.argv[1], model.collection.get_data('Surface Temperature').values())\n"
    )
    out_file = tmp_path / "temps.npy"
    out = subprocess.run([sys.executable, "-c", code, str(out_file)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    np.testing.assert_allclose(np.load(out_file), values(ref, "Surface Temperature"),
                               **MODEL_TOL)


def test_full_options_toml_rebuild_runs_bit_equal():
    """The full-options graph (with OceanCarbon's impulse-response forms,
    which the reference's TOML writer refuses) rebuilt from its own TOML
    runs an ensemble bit-equal to the original."""
    from rscm_tpu_torch.core import Model
    from rscm_tpu_torch.parallel import EnsembleRunner

    years = np.arange(1850.0, 1866.0)
    model = magicc("rscm_tpu_torch", years, include_permafrost=True, include_slr=True)
    rebuilt = Model.from_toml(model.to_toml())
    swept = {"ClimateUDEB.ecs": np.array([2.0, 3.0, 4.5, 5.0])}
    out = []
    for m in (model, rebuilt):
        runner = EnsembleRunner(m, device="cpu")
        out.append(runner.run(runner.batched_params(swept), out_vars=["Surface Temperature",
                                                                      "Sea Level Rise"]))
    for name in out[0]:
        torch.testing.assert_close(out[1][name], out[0][name], rtol=0.0, atol=0.0,
                                   equal_nan=True)


def test_as_dot_and_debug_info_match_the_reference():
    years = np.arange(1850.0, 1856.0)
    ref = magicc("rscm_tpu", years, include_permafrost=True, include_slr=True)
    port = magicc("rscm_tpu_torch", years, include_permafrost=True, include_slr=True)
    dot, ref_dot = port.as_dot().splitlines(), ref.as_dot().splitlines()
    edges = [line for line in dot if "->" in line]
    assert edges == [line for line in ref_dot if "->" in line]
    nodes = [line.split(" [")[0] for line in dot if "label" in line and "->" not in line]
    assert nodes == [line.split(" [")[0] for line in ref_dot
                     if "label" in line and "->" not in line]
    assert json.loads(port.debug_info("json")) == json.loads(ref.debug_info("json"))
    plain, rich = port.debug_info("plain"), port.debug_info("rich")
    assert plain == ref.debug_info("plain")
    assert "\033[" in rich and "\033[" not in plain
    assert plain.index("ClimateUDEB") < plain.index("SeaLevelRise")
