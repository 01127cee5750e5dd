"""The port's layered TOML configs against the reference's.

Mirrors ``tests/test_config.py`` and ``tests/test_config_magicc_legacy.py``:
each test runs the reference's function and the port's on the same inputs.
Host-only functions (merging, validation, the registry, the legacy .CFG
mapping, docs) must give equal results; models built from the same config
run on the CPU and match the reference's runs at 1e-9.
"""

import importlib
import logging
from dataclasses import dataclass

import numpy as np
import pytest

REPO_CONFIG = "configs/two-layer/defaults.toml"
TUNING_CONFIG = "configs/two-layer/tuning/high-sensitivity.toml"
PACKAGES = ("rscm_tpu", "rscm_tpu_torch")
MODEL_TOL = dict(rtol=1e-9, atol=1e-9)


def config_of(pkg):
    return importlib.import_module(f"{pkg}.config")


def both(fn):
    """``fn(config_module)`` for the reference and the port."""
    return [fn(config_of(pkg)) for pkg in PACKAGES]


def run(model, pkg):
    if pkg == "rscm_tpu":
        model.run(compiled=False)
    else:
        model.run(device="cpu")
    return np.asarray(model.collection.get_data("Surface Temperature").values())


def build_and_run(config):
    """The config built and run by both packages; the port's temperatures
    match the reference's."""
    ref, port = (run(config_of(pkg).build_model(config), pkg) for pkg in PACKAGES)
    np.testing.assert_allclose(port, ref, **MODEL_TOL)
    return port


# -- base, loader, validation, registry, parameters ------------------------------


def test_time_config_and_input_spec():
    for c in (config_of(pkg) for pkg in PACKAGES):
        assert c.TimeConfig(1750, 2100).to_time_axis() == (1750, 2100)
        with pytest.raises(ValueError, match="must be greater"):
            c.TimeConfig(2100, 2100)
        assert not c.InputSpec().is_complete()
        assert c.InputSpec(file="x.csv", unit="W/m^2").is_complete()


def test_deep_merge():
    base = {"a": 1, "nested": {"x": 1, "y": 2}, "list": [1, 2]}
    override = {"b": 2, "nested": {"y": 3}, "list": [3]}
    ref, port = both(lambda c: c.deep_merge(base, override))
    assert port == ref == {"a": 1, "b": 2, "nested": {"x": 1, "y": 3}, "list": [3]}


def test_load_config_and_layers():
    ref, port = both(lambda c: c.load_config(REPO_CONFIG))
    assert port == ref
    assert port["components"]["climate"]["parameters"]["lambda0"] == 1.0
    ref, port = both(lambda c: c.load_config_layers(REPO_CONFIG, TUNING_CONFIG))
    assert port == ref
    assert port["components"]["climate"]["parameters"]["lambda0"] == 0.8
    assert port["components"]["climate"]["parameters"]["eta"] == 0.7
    assert both(lambda c: c.load_config_layers()) == [{}, {}]


def test_unknown_keys_warn(tmp_path, caplog):
    p = tmp_path / "odd.toml"
    p.write_text('[model]\nname = "x"\n[bogus]\nkey = 1\n')
    for c in (config_of(pkg) for pkg in PACKAGES):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            c.load_config(p)
        assert "bogus" in caplog.text


def test_semver_and_schema_version(caplog):
    for c in (config_of(pkg) for pkg in PACKAGES):
        assert c.parse_semver("1.2.3") == (1, 2, 3)
        for bad in ("1.2", "a.b.c"):
            with pytest.raises(ValueError):
                c.parse_semver(bad)
        c.check_schema_version("1.0.0", "1.0.0")
        with pytest.raises(c.IncompatibleSchemaError):
            c.check_schema_version("2.0.0", "1.0.0")
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            c.check_schema_version("1.1.0", "1.0.0")
        assert "newer" in caplog.text
        assert c.find_unknown_keys({"a": 1, "b": 2}, {"a"}) == ["b"]
        assert c.find_unknown_keys({"a": 1}, {"a", "b"}) == []


def test_incompatible_schema_version_rejected_at_load(tmp_path):
    p = tmp_path / "v2.toml"
    p.write_text('[schema]\nversion = "2.0.0"\n[model]\ntype = "two-layer"\n')
    for c in (config_of(pkg) for pkg in PACKAGES):
        with pytest.raises(c.IncompatibleSchemaError):
            c.load_config(p)


def test_registry():
    class A:
        pass

    class B:
        pass

    for c in (config_of(pkg) for pkg in PACKAGES):
        registry = c.ComponentRegistry()
        registry.register("X", A)
        registry.register("X", A)  # idempotent
        assert registry.get("X") is A and registry.is_registered("X") and registry.list() == ["X"]
        with pytest.raises(ValueError, match="already registered"):
            registry.register("X", B)
        with pytest.raises(c.ComponentNotFoundError, match="not found"):
            registry.get("Missing")
    # the two-layer builder each package registers builds its own component
    for pkg in PACKAGES:
        importlib.import_module(f"{pkg}.config.models")
        builder = config_of(pkg).component_registry.get("TwoLayer")
        params = {"lambda0": 1.0, "a": 0.0, "efficacy": 1.0, "eta": 0.7,
                  "heat_capacity_surface": 8.0, "heat_capacity_deep": 100.0}
        assert type(builder.from_parameters(params).build()).__module__.startswith(f"{pkg}.")


def test_parameter_metadata_and_validation():
    for c in (config_of(pkg) for pkg in PACKAGES):
        @dataclass
        class MyParams:
            value: float = c.parameter(default=5.0, range=(0, 10), unit="K")
            mode: str = c.parameter(default="a", choices=["a", "b"])

        assert c.validate_parameters(MyParams()) == []
        errors = c.validate_parameters(MyParams(value=15.0, mode="c"))
        assert len(errors) == 2 and "outside valid range" in errors[0]
        assert set(c.get_parameter_metadata(MyParams)) == {"value", "mode"}


def test_two_layer_params_validate_on_construction():
    for pkg in PACKAGES:
        params = importlib.import_module(f"{pkg}.config.models.two_layer").TwoLayerParams
        with pytest.raises(ValueError, match="outside valid range"):
            params(lambda0=20.0)


def test_docs_generation_matches_reference():
    for name in ("generate_parameter_docs", "export_parameter_json"):
        ref, port = (
            getattr(config_of(pkg), name)(
                importlib.import_module(f"{pkg}.config.models.two_layer").TwoLayerParams)
            for pkg in PACKAGES
        )
        assert port == ref
    md = config_of("rscm_tpu_torch").generate_parameter_docs(
        importlib.import_module("rscm_tpu_torch.config.models.two_layer").TwoLayerParams)
    assert "lambda0" in md and "W/m^2/K" in md


def test_component_metadata_export():
    for pkg in PACKAGES:  # registers their components
        importlib.import_module(f"{pkg}.components")
        importlib.import_module(f"{pkg}.magicc")
    ref, port = both(lambda c: c.export_component_metadata())
    assert "TwoLayer" in port
    assert any(v["variable_name"] == "Effective Radiative Forcing"
               for v in port["TwoLayer"]["inputs"])
    for name in ("TwoLayer", "ClimateUDEB", "CarbonCycle"):
        assert port[name]["inputs"] == ref[name]["inputs"], name
        assert port[name]["outputs"] == ref[name]["outputs"], name


def test_component_docs_match_reference():
    ref, port = (
        config_of(pkg).generate_component_docs(
            importlib.import_module(f"{pkg}.components").TwoLayer)
        for pkg in PACKAGES
    )
    assert port.splitlines()[0] == ref.splitlines()[0] == "# TwoLayer"
    assert [line for line in port.splitlines() if line.startswith("|")] == [
        line for line in ref.splitlines() if line.startswith("|")]


# -- building models ------------------------------------------------------------------


def test_build_from_toml():
    for pkg in PACKAGES:
        config = config_of(pkg).load_config(REPO_CONFIG)
        config["time"] = {"start": 2000, "end": 2010}
        model = config_of(pkg).build_model(config)
        assert len(model.time_axis) == 11
        if pkg == "rscm_tpu":
            model.run(compiled=False)
        else:
            model.run(compiled=False, device="cpu")
        assert model.finished()
        assert model.collection.get_data("Surface Temperature").at_scalar(0) == 0.0


def test_build_layers_override():
    for pkg in PACKAGES:
        config = config_of(pkg).load_config_layers(REPO_CONFIG, TUNING_CONFIG)
        config["time"] = {"start": 2000, "end": 2005}
        model = config_of(pkg).build_model(config)
        component = model.graph.nodes[model.exec_order[1]]
        assert (component.lambda0, component.efficacy) == (0.8, 1.3)


def test_unknown_model_type():
    for c in (config_of(pkg) for pkg in PACKAGES):
        with pytest.raises(ValueError, match="Unknown model type"):
            c.build_model({"model": {"type": "nope"}})


def write_erf(path, years, erf, name="Effective Radiative Forcing"):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"time,{name}\n" + "".join(f"{t},{v}\n" for t, v in zip(years, erf)))


def test_typed_config_with_inputspec_builds(tmp_path):
    years = np.arange(2000.0, 2031.0)
    write_erf(tmp_path / "erf.csv", years, np.linspace(0.0, 3.0, len(years)))
    temps = []
    for pkg in PACKAGES:
        c = config_of(pkg)
        two_layer = importlib.import_module(f"{pkg}.config.models.two_layer")
        cfg = two_layer.TwoLayerConfig(
            name="t", time=c.TimeConfig(start=2000, end=2030),
            inputs={"Effective Radiative Forcing": c.InputSpec(file=str(tmp_path / "erf.csv"),
                                                               unit="W/m^2")},
        )
        temps.append(run(c.build_model(cfg), pkg))
    assert np.isfinite(temps[1]).all()
    np.testing.assert_allclose(temps[1], temps[0], **MODEL_TOL)


def test_required_and_optional_inputspecs():
    for pkg in PACKAGES:
        c = config_of(pkg)
        two_layer = importlib.import_module(f"{pkg}.config.models.two_layer")
        cfg = two_layer.TwoLayerConfig(
            name="t", time=c.TimeConfig(start=2000, end=2002),
            inputs={"Effective Radiative Forcing": c.InputSpec(required=True)},
        )
        with pytest.raises(ValueError, match="required but no file"):
            c.build_model(cfg)
        resolve = importlib.import_module(f"{pkg}.config.builder")._resolve_inputs
        assert resolve({"X": c.InputSpec(required=False)}, {"start": 2000, "end": 2002},
                       None) == {}
        with pytest.raises(ValueError, match="unsupported spec"):
            resolve({"X": "text"}, {}, None)


def test_layered_file_inputs_resolve_against_their_own_layer(tmp_path):
    """The defaults layer names a file relative to its own directory; an
    override layer elsewhere must not redirect it."""
    years = np.arange(2000.0, 2021.0)
    write_erf(tmp_path / "data" / "erf.csv", years, np.full(len(years), 2.0))
    defaults = tmp_path / "defaults.toml"
    defaults.write_text(
        '[model]\ntype = "two-layer"\n[time]\nstart = 2000\nend = 2020\n'
        "[components.climate.parameters]\n"
        "lambda0 = 1.1\na = 0.0\nefficacy = 1.0\neta = 0.7\n"
        "heat_capacity_surface = 8.0\nheat_capacity_deep = 100.0\n"
        '[inputs."Effective Radiative Forcing"]\nfile = "data/erf.csv"\nunit = "W/m^2"\n'
    )
    (tmp_path / "tuning").mkdir()
    override = tmp_path / "tuning" / "high.toml"
    override.write_text("[components.climate.parameters]\nlambda0 = 1.5\n")
    configs = both(lambda c: c.load_config_layers(defaults, override))
    assert configs[1] == configs[0]
    temps = build_and_run(configs[1])
    assert np.isfinite(temps).all() and temps[-1] > 0.5


def test_inline_and_constant_inputs():
    config = {
        "model": {"type": "two-layer"},
        "time": {"start": 2000, "end": 2050},
        "components": {"climate": {"parameters": {
            "lambda0": 1.0, "a": 0.0, "efficacy": 1.0, "eta": 0.7,
            "heat_capacity_surface": 8.0, "heat_capacity_deep": 100.0,
        }}},
        "inputs": {"Effective Radiative Forcing": {
            "values": [0.0, 4.0], "times": [2000.0, 2050.0], "unit": "W/m^2",
        }},
    }
    assert build_and_run(config)[-1] > 0.5
    config["inputs"] = {"Effective Radiative Forcing": 3.0}
    assert build_and_run(config)[-1] > 0.5


# -- the MAGICC legacy .CFG mapping -------------------------------------------------------


def legacy(pkg):
    return importlib.import_module(f"{pkg}.config.models.magicc")


LEGACY_INPUTS = [
    {"CORE_CLIMATESENSITIVITY": 2.5, "CORE_DELQ2XCO2": 3.71, "STARTYEAR": 1750,
     "ENDYEAR": 2100},
    {"core_co2ch4n2o_rfmethod": "OLBL", "core_rfrapidadjust_co2": 1.05},
    {"Core_ClimateSensitivity": 4.5, "core_initial_upwelling_rate": 3.5},
    {"file_co2_conc": "SSP245_CO2_CONC.IN"},
]


@pytest.mark.parametrize("legacy_in", LEGACY_INPUTS, ids=range(len(LEGACY_INPUTS)))
def test_from_legacy_dict_matches_reference(legacy_in):
    ref, port = (legacy(pkg).from_legacy_dict(legacy_in) for pkg in PACKAGES)
    assert port == ref
    assert legacy("rscm_tpu_torch").to_legacy_dict(port) == legacy("rscm_tpu").to_legacy_dict(ref)


def test_legacy_supported_parameters_map():
    config = legacy("rscm_tpu_torch").from_legacy_dict(LEGACY_INPUTS[0])
    params = config["components"]["climate"]["parameters"]
    assert (params["climate_sensitivity"], params["forcing_2xco2"]) == (2.5, 3.71)
    assert (config["time"]["start"], config["time"]["end"]) == (1750, 2100)
    ghg = legacy("rscm_tpu_torch").from_legacy_dict(LEGACY_INPUTS[1])["components"]
    assert ghg["ghg_forcing"]["parameters"] == {"method": "OLBL", "adjust_co2": 1.05}


@pytest.mark.parametrize(
    "key, level, text",
    [("file_co2_conc", logging.INFO, None), ("core_amv_apply", logging.INFO, "not implemented"),
     ("totally_bogus_param", logging.WARNING, "Unknown legacy parameter")],
)
def test_legacy_triage_logging(caplog, key, level, text):
    for pkg in PACKAGES:
        caplog.clear()
        with caplog.at_level(level):
            assert legacy(pkg).from_legacy_dict({key: 1}) == {}
        if text is None:
            assert key not in caplog.text
        else:
            assert text in caplog.text


def test_legacy_roundtrip_and_export():
    legacy_in = {"core_climatesensitivity": 3.0, "core_delq2xco2": 3.71, "startyear": 1750,
                 "endyear": 2100, "core_initial_upwelling_rate": 3.5}
    mod = legacy("rscm_tpu_torch")
    legacy_out = mod.to_legacy_dict(mod.from_legacy_dict(legacy_in))
    assert all(legacy_out[k] == v for k, v in legacy_in.items())
    for pkg in PACKAGES:
        assert legacy(pkg).to_legacy_dict({"time": {"start": 1850}}) == {"startyear": 1850}


def test_legacy_coverage_matches_reference():
    ref, port = legacy("rscm_tpu"), legacy("rscm_tpu_torch")
    assert port.get_coverage_stats() == ref.get_coverage_stats()
    assert port.get_coverage_report() == ref.get_coverage_report()
    assert port.LEGACY_MAPPING == ref.LEGACY_MAPPING
    stats = port.get_coverage_stats()
    assert stats["total"] == len(port.MAGICC_PARAMETERS) == sum(
        stats[s.name] for s in port.ParameterStatus)
    assert stats["SUPPORTED"] >= 20
    for param in port.MAGICC_PARAMETERS.values():
        if param.status == port.ParameterStatus.SUPPORTED:
            assert param.rscm_path, param.name
    with pytest.raises(ValueError, match="must have rscm_path"):
        port.ParameterInfo("x", port.ParameterStatus.SUPPORTED)


def test_magicc_config_defaults():
    for pkg in PACKAGES:
        config = legacy(pkg).MAGICCConfig(name="test")
        assert config.model_type == "magicc"
        assert config.climate.climate_sensitivity == 3.0
        assert config.forcing.solar_scale == 1.0
        assert config.aggregation.run_modus == "ALL"
