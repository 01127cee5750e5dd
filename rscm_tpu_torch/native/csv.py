"""
ctypes binding for the native CSV scenario loader (``native/csv_loader.cpp``)
with a pure-Python fallback of identical semantics (port of the JAX
package's ``native/csv.py``).

``read_numeric_csv(path)`` parses a plain numeric table —

    time,Var A,Var B
    1750.0,0.0,1.2
    1751.0,0.1,1.3

— into ``(header: list[str], values: (rows, cols) float64 array)``.
The native path is used when the shared library loads (compiled on
demand into ``rscm_tpu_torch/_build/``, like the graph engine);
``RSCM_TPU_NATIVE=0`` forces the fallback, and :func:`native_loader`
says which one reads.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from . import build_library, native_enabled

__all__ = ["read_numeric_csv", "native_loader"]

_lib_cache: Optional[ctypes.CDLL] = None
_load_attempted = False

_ERRORS = {
    -1: "could not open file",
    -2: "malformed numeric CSV (ragged row, empty or non-numeric cell)",
    -3: "internal capacity overflow",
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib_cache, _load_attempted
    if _lib_cache is not None:
        return _lib_cache
    if _load_attempted or not native_enabled():
        return _lib_cache
    _load_attempted = True
    path = build_library("csv_loader.cpp")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64
        lib.rscm_csv_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64)
        ]
        lib.rscm_csv_dims.restype = i64
        lib.rscm_csv_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), i64
        ]
        lib.rscm_csv_read.restype = i64
        _lib_cache = lib
    except OSError:
        return None
    return _lib_cache


def native_loader() -> bool:
    """True when :func:`read_numeric_csv` reads through the native library
    (building it first if needed), False when it takes the Python fallback."""
    return _load() is not None


def _read_header(path) -> List[str]:
    with open(path, "r", newline="") as f:
        header = f.readline().rstrip("\r\n")
    if not header:
        raise ValueError(f"{path}: empty file")
    return [h.strip() for h in header.split(",")]


def _read_python(path) -> Tuple[List[str], np.ndarray]:
    """Pure-Python fallback, same strictness as the native parser."""
    import csv as _csv

    with open(path, "r", newline="") as f:
        reader = _csv.reader(f)
        try:
            header = [h.strip() for h in next(reader)]
        except StopIteration:
            raise ValueError(f"{path}: empty file") from None
        rows = []
        for row in reader:
            if not row or (len(row) == 1 and row[0].strip() == ""):
                continue
            if len(row) != len(header):
                raise ValueError(
                    f"{path}: malformed numeric CSV (ragged row, empty or "
                    f"non-numeric cell)"
                )
            try:
                rows.append([float(cell) for cell in row])
            except ValueError:
                raise ValueError(
                    f"{path}: malformed numeric CSV (ragged row, empty or "
                    f"non-numeric cell)"
                ) from None
    return header, np.asarray(rows, dtype=np.float64).reshape(-1, len(header))


def read_numeric_csv(path) -> Tuple[List[str], np.ndarray]:
    """Parse a plain numeric CSV into (header, (rows, cols) float64)."""
    path = os.fspath(path)
    lib = _load()
    if lib is None:
        return _read_python(path)

    header = _read_header(path)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.rscm_csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(int(rc), f'error {rc}')}")
    if cols.value != len(header):
        raise ValueError(
            f"{path}: malformed numeric CSV (ragged row, empty or "
            f"non-numeric cell)"
        )
    out = np.empty(rows.value * cols.value, dtype=np.float64)
    written = lib.rscm_csv_read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.size,
    )
    if written < 0:
        raise ValueError(f"{path}: {_ERRORS.get(int(written), f'error {written}')}")
    if written != out.size:
        raise ValueError(f"{path}: malformed numeric CSV (row count changed mid-read)")
    return header, out.reshape(rows.value, cols.value)
