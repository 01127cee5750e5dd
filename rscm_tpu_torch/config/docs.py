"""Documentation generation from parameter and component metadata.

Mirror of python/rscm/config/docs.py plus the component-metadata extraction
that the reference's ``rscm-doc-gen`` CLI provides
(``crates/rscm-doc-gen/src/main.rs``): here component I/O metadata comes
straight from the declarative :class:`~rscm_tpu_torch.core.component.Component`
registry — no source parsing needed.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .parameters import get_parameter_metadata

__all__ = [
    "generate_parameter_docs",
    "export_parameter_json",
    "export_component_metadata",
    "generate_component_docs",
]


def generate_parameter_docs(cls: type) -> str:
    """Markdown documentation for a parameter dataclass."""
    lines = [f"# {cls.__name__}", ""]
    if cls.__doc__:
        lines += [cls.__doc__.strip(), ""]
    metadata = get_parameter_metadata(cls)
    if metadata:
        lines += ["## Parameters", ""]
        for name, meta in metadata.items():
            lines += [f"### `{name}`", ""]
            if meta.description:
                lines += [meta.description, ""]
            lines.append(f"- **Unit**: {meta.unit if meta.unit else 'dimensionless'}")
            if meta.range is not None:
                lines.append(f"- **Valid range**: [{meta.range[0]}, {meta.range[1]}]")
            if meta.typical_range is not None:
                lines.append(
                    f"- **Typical range**: [{meta.typical_range[0]}, "
                    f"{meta.typical_range[1]}]"
                )
            if meta.source:
                lines.append(f"- **Source**: {meta.source}")
            lines.append("")
    return "\n".join(lines)


def export_parameter_json(cls: type) -> Dict[str, Any]:
    """Parameter metadata as a JSON-serialisable dict."""
    metadata = get_parameter_metadata(cls)
    parameters = []
    for name, meta in metadata.items():
        field_type = "float"
        annotation = getattr(cls, "__annotations__", {}).get(name)
        if annotation is not None:
            type_name = getattr(annotation, "__name__", str(annotation)).lower()
            for candidate in ("int", "str", "bool", "float"):
                if candidate in type_name:
                    field_type = candidate
                    break
        parameters.append(
            {
                "name": name,
                "type": field_type,
                "unit": meta.unit,
                "description": meta.description,
                "range": list(meta.range) if meta.range else None,
                "typical_range": list(meta.typical_range)
                if meta.typical_range
                else None,
                "source": meta.source,
            }
        )
    return {
        "class": cls.__name__,
        "description": cls.__doc__.strip() if cls.__doc__ else None,
        "parameters": parameters,
    }


def export_component_metadata(output_dir: str = None) -> Dict[str, dict]:
    """Component I/O metadata JSON for every registered component.

    Equivalent of the reference's ``rscm-doc-gen`` output
    (``docs/component_metadata/*.json``), sourced from the component
    registry instead of parsing Rust sources.
    """
    import os

    from rscm_tpu_torch.core.component import Component

    out = {}
    for name, cls in sorted(Component.get_registered_components().items()):
        out[name] = cls.component_metadata()
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        for name, meta in out.items():
            with open(os.path.join(output_dir, f"{name}.json"), "w") as f:
                json.dump(meta, f, indent=2, default=repr)
    return out


def generate_component_docs(cls) -> str:
    """Markdown documentation for a Component class (I/O + parameters)."""
    meta = cls.component_metadata()
    lines = [f"# {meta['name']}", ""]
    if cls.__doc__:
        lines += [cls.__doc__.strip(), ""]
    if meta["category"]:
        lines.append(f"**Category**: {meta['category']}")
    if meta["tags"]:
        lines.append(f"**Tags**: {', '.join(meta['tags'])}")
    lines.append("")
    for section in ("inputs", "outputs", "states"):
        if meta[section]:
            lines += [f"## {section.capitalize()}", ""]
            lines.append("| Variable | Unit | Grid |")
            lines.append("|---|---|---|")
            for var in meta[section]:
                lines.append(
                    f"| {var['variable_name']} | {var['unit']} | {var['grid']} |"
                )
            lines.append("")
    if meta["parameters"]:
        lines += ["## Parameters", ""]
        lines.append("| Name | Default | Unit | Description |")
        lines.append("|---|---|---|---|")
        for p in meta["parameters"]:
            lines.append(
                f"| {p['name']} | {p['default']} | {p['unit']} | {p['description']} |"
            )
        lines.append("")
    return "\n".join(lines)
