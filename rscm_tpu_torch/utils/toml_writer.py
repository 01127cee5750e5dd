"""
Minimal TOML encoder (stdlib has tomllib for reading only).

Supports the subset needed for model checkpoints: nested dicts (tables),
lists (arrays, including nested), strings, numbers (NaN/inf as ``nan`` /
``inf``), booleans.  Output round-trips through ``tomllib.loads``.
"""

from __future__ import annotations

import math

__all__ = ["dumps_toml"]


def _format_value(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int,)):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return "nan"
        if math.isinf(value):
            return "inf" if value > 0 else "-inf"
        return repr(value)
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        return f'"{escaped}"'
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_format_value(v) for v in value) + "]"
    if isinstance(value, dict):
        # inline table (used for dicts inside arrays)
        inner = ", ".join(
            f"{_escape_key(k)} = {_format_value(v)}"
            for k, v in value.items()
            if v is not None
        )
        return "{" + inner + "}"
    raise TypeError(f"Cannot TOML-encode value of type {type(value)}: {value!r}")


def _escape_key(key: str) -> str:
    if key and all(c.isalnum() or c in "-_" for c in key):
        return key
    return '"' + key.replace("\\", "\\\\").replace('"', '\\"') + '"'


def dumps_toml(data: dict, _prefix: str = "") -> str:
    """Encode a nested dict as a TOML document."""
    lines = []
    tables = []
    for key, value in data.items():
        if isinstance(value, dict):
            tables.append((key, value))
        else:
            lines.append(f"{_escape_key(key)} = {_format_value(value)}")
    out = "\n".join(lines)
    for key, value in tables:
        full_key = f"{_prefix}.{_escape_key(key)}" if _prefix else _escape_key(key)
        body = dumps_toml(value, full_key)
        header = f"[{full_key}]"
        out += ("\n\n" if out else "") + header + ("\n" + body if body else "")
    return out
