"""
Build and load the hand-written CUDA kernels in ``rscm_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface, so it compiles in seconds
with ``nvcc`` into a shared library that ``ctypes`` loads (no PyTorch
headers, no C++ extension build).  Libraries go into ``_build/`` inside
the package, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built when
this module is imported: the first launch builds its kernel, and
:func:`build_all` builds several at once (one ``nvcc`` process each).

Flags: ``-fmad=false`` keeps the compiler from contracting ``a * b + c``
into a fused multiply-add, so each kernel rounds after every operation
exactly as its plain PyTorch version does and the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["NVCC_FLAGS", "build_all", "function", "load", "ptxas_summary"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
#: (id of the library, symbol, argtypes) -> (the library, kept so that its id
#: stays its own, and the function)
_FUNCTIONS: Dict[tuple, tuple] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Build the named kernels that are not built yet, all ``nvcc`` runs
    started together; returns ``{name: ptxas report}`` for those built.
    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    reports = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)  # atomic: concurrent builders never see half a file
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of kernel ``name``'s library (:func:`load`), its ``ctypes``
    signature (``argtypes``, an ``int`` result) set on first use."""
    lib = load(name)
    key = (id(lib), symbol, tuple(argtypes))
    if key not in _FUNCTIONS:
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[key] = (lib, fn)
    return _FUNCTIONS[key][1]


def ptxas_summary(report: str) -> list:
    """The registers / stack / spill lines of an ``-Xptxas -v`` report."""
    keep = ("Compiling entry", "registers", "stack frame", "spill")
    return [line.strip() for line in report.splitlines() if any(k in line for k in keep)]
