"""
ctypes bindings for the native (C++) host pieces: the graph-traversal
engine (``native/graph_engine.cpp``) and the CSV scenario loader
(``native/csv_loader.cpp``, :mod:`.csv`).

The reference implements its graph/schedule core in native code
(``crates/rscm-core/src/model/runtime.rs``, petgraph); the port binds the
repository's C++ sources through ``ctypes``.  Everything has a pure-Python
fallback with the same results (``rscm_tpu_torch.core.model.graph``), which
the tests hold the native path against.  This is host code: no device
kernel runs here.

Loading strategy:

1. ``RSCM_TPU_NATIVE=0`` disables native code entirely (pure Python).
2. Otherwise each library is compiled with ``g++`` at first use into
   ``rscm_tpu_torch/_build/``, named by a hash of its source and flags, and
   reused while the source is unchanged; the sources under ``native/`` are
   only read.  A missing compiler or source, or a failed build, falls back
   to pure Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

__all__ = ["load_graph_engine", "GraphEngine", "native_enabled", "build_library"]

_ABI_VERSION = 1
_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_engine_cache: Optional["GraphEngine"] = None
_load_attempted = False


def native_enabled() -> bool:
    return os.environ.get("RSCM_TPU_NATIVE", "1") != "0"


def build_library(source: str) -> Optional[Path]:
    """The shared library built from ``native/<source>``, compiled into
    ``_build/`` unless an unchanged build is there; None when the source is
    missing or the build fails."""
    src = _NATIVE_DIR / source
    if not src.exists():
        return None
    digest = hashlib.sha1(src.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()
    target = _BUILD_DIR / f"{src.stem}-{digest[:12]}.so"
    if target.exists():
        return target
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", tmp, str(src)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, target)  # atomic: concurrent builders never see half a file
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return target


class GraphEngine:
    """Thin typed wrapper over the graph engine's library."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        i32 = ctypes.c_int32
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.rscm_bfs_order.argtypes = [i32, i32, p32, p32, i32, p32]
        lib.rscm_bfs_order.restype = i32
        lib.rscm_topo_order.argtypes = [i32, i32, p32, p32, p32]
        lib.rscm_topo_order.restype = i32
        lib.rscm_find_cycle.argtypes = [i32, i32, p32, p32]
        lib.rscm_find_cycle.restype = i32

    @staticmethod
    def _edge_arrays(n_nodes: int, edges: Sequence[Tuple[int, int]]):
        # The C functions index src/dst unchecked, so an out-of-range edge
        # must surface here as a Python exception, not heap corruption.
        for a, b in edges:
            if not (0 <= a < n_nodes and 0 <= b < n_nodes):
                raise ValueError(
                    f"edge ({a}, {b}) out of range for graph with {n_nodes} nodes"
                )
        n = len(edges)
        Arr = ctypes.c_int32 * max(n, 1)
        src = Arr(*(e[0] for e in edges)) if n else Arr()
        dst = Arr(*(e[1] for e in edges)) if n else Arr()
        return n, src, dst

    @staticmethod
    def _check_count(count: int) -> int:
        if count < 0:  # -2: native-side edge bounds check tripped
            raise ValueError(f"native graph engine rejected edges (code {count})")
        return count

    def bfs_order(self, n_nodes: int, edges: Sequence[Tuple[int, int]], start: int) -> List[int]:
        n_edges, src, dst = self._edge_arrays(n_nodes, edges)
        out = (ctypes.c_int32 * max(n_nodes, 1))()
        count = self._check_count(
            self._lib.rscm_bfs_order(n_nodes, n_edges, src, dst, start, out)
        )
        return list(out[:count])

    def topo_order(self, n_nodes: int, edges: Sequence[Tuple[int, int]]) -> List[int]:
        n_edges, src, dst = self._edge_arrays(n_nodes, edges)
        out = (ctypes.c_int32 * max(n_nodes, 1))()
        count = self._check_count(self._lib.rscm_topo_order(n_nodes, n_edges, src, dst, out))
        return list(out[:count])

    def find_cycle(self, n_nodes: int, edges: Sequence[Tuple[int, int]]) -> int:
        """Index of a node on a cycle, or -1 if acyclic."""
        n_edges, src, dst = self._edge_arrays(n_nodes, edges)
        result = int(self._lib.rscm_find_cycle(n_nodes, n_edges, src, dst))
        if result < -1:
            raise ValueError(f"native graph engine rejected edges (code {result})")
        return result


def load_graph_engine() -> Optional[GraphEngine]:
    """Load (compiling if needed) the native graph engine, or None."""
    global _engine_cache, _load_attempted
    if _engine_cache is not None:
        return _engine_cache
    if _load_attempted or not native_enabled():
        return _engine_cache
    _load_attempted = True
    path = build_library("graph_engine.cpp")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        if lib.rscm_graph_abi_version() != _ABI_VERSION:
            return None
        _engine_cache = GraphEngine(lib)
    except OSError:
        return None
    return _engine_cache
