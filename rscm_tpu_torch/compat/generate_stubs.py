"""
Generate .pyi type stubs for the compat surface's ``_lib`` modules.

The reference ships hand-maintained stubs for its native extension
(python/rscm/_lib/*.pyi, validated by mypy.stubtest); here the modules
are pure Python, so the stubs are generated by introspection — run this
after changing the public surface, from the repository root:

    python -m rscm_tpu_torch.compat.generate_stubs

Stubs are intentionally shallow (signatures + attribute names, loose
types) — their job is editor autocompletion and the name-level contract,
which tests/test_torch_compat.py pins against the live modules.
"""

import importlib
import inspect
import pathlib

HEADER = "# Auto-generated by rscm_tpu_torch/compat/generate_stubs.py — do not edit.\n"

#: module -> stub path, relative to the repository root
MODULES = {
    "rscm_tpu_torch.compat._lib.core": "rscm_tpu_torch/compat/_lib/core/__init__.pyi",
    "rscm_tpu_torch.compat._lib.core.state": "rscm_tpu_torch/compat/_lib/core/state.pyi",
    "rscm_tpu_torch.compat._lib.core.spatial": "rscm_tpu_torch/compat/_lib/core/spatial.pyi",
    "rscm_tpu_torch.compat._lib.two_layer": "rscm_tpu_torch/compat/_lib/two_layer.pyi",
    "rscm_tpu_torch.compat._lib.components": "rscm_tpu_torch/compat/_lib/components.pyi",
    "rscm_tpu_torch.compat._lib.magicc": "rscm_tpu_torch/compat/_lib/magicc.pyi",
    "rscm_tpu_torch.compat._lib.calibrate": "rscm_tpu_torch/compat/_lib/calibrate.pyi",
}


def _signature(obj) -> str:
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return "(*args, **kwargs)"
    params = []
    for p in sig.parameters.values():
        if p.kind is p.VAR_POSITIONAL:
            params.append(f"*{p.name}")
        elif p.kind is p.VAR_KEYWORD:
            params.append(f"**{p.name}")
        elif p.default is not p.empty:
            params.append(f"{p.name}=...")
        else:
            params.append(p.name)
    return "(" + ", ".join(params) + ")"


def _class_stub(name: str, cls: type) -> list:
    lines = [f"class {name}:"]
    members = []
    for attr in sorted(dir(cls)):
        if attr.startswith("_"):
            continue
        value = inspect.getattr_static(cls, attr)
        if isinstance(value, staticmethod):
            members.append(f"    @staticmethod\n    def {attr}{_signature(value.__wrapped__)}: ...")
        elif isinstance(value, classmethod):
            sig = _signature(value.__wrapped__)
            members.append(f"    @classmethod\n    def {attr}{sig}: ...")
        elif isinstance(value, property):
            members.append(f"    @property\n    def {attr}(self): ...")
        elif inspect.isfunction(value):
            members.append(f"    def {attr}{_signature(value)}: ...")
        elif not callable(value):
            members.append(f"    {attr}: object")
    if "__init__" in vars(cls) and inspect.isfunction(vars(cls)["__init__"]):
        members.insert(0, f"    def __init__{_signature(vars(cls)['__init__'])} -> None: ...")
    lines.extend(members or ["    ..."])
    return lines


def stub_module(module) -> str:
    lines = [HEADER]
    names = getattr(module, "__all__", None) or [
        n for n in dir(module) if not n.startswith("_")
    ]
    for name in names:
        obj = getattr(module, name, None)
        if obj is None:
            lines.append(f"{name}: object")
        elif inspect.ismodule(obj):
            continue  # submodules get their own stub files
        elif inspect.isclass(obj):
            lines.extend(_class_stub(name, obj))
            lines.append("")
        elif callable(obj):
            lines.append(f"def {name}{_signature(obj)}: ...")
        else:
            lines.append(f"{name}: object")
    return "\n".join(lines) + "\n"


def main():
    root = pathlib.Path(__file__).resolve().parents[2]
    for mod_name, rel_path in MODULES.items():
        module = importlib.import_module(mod_name)
        (root / rel_path).write_text(stub_module(module))
        print(f"wrote {rel_path}")


if __name__ == "__main__":
    main()
