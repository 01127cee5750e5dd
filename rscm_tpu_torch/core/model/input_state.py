"""
InputState: per-step view of a component's inputs as windows.

Mirror of ``crates/rscm-core/src/state/mod.rs:190-575`` — the runtime hands
each component an ``InputState`` exposing typed windows with the component's
unit conversion, variable source and read-side grid aggregation baked in.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..state import FourBoxWindow, HemisphericWindow, ScalarWindow, host_window

__all__ = ["InputState"]


class InputState:
    """Mapping from variable name to lazily-built window."""

    def __init__(self, window_builders: Dict[str, Callable], current_time):
        self._builders = window_builders
        self._windows: Dict[str, object] = {}
        self._current_time = current_time

    def has(self, name: str) -> bool:
        return name in self._builders

    def current_time(self):
        return self._current_time

    def names(self):
        return list(self._builders)

    def get_window(self, name: str):
        if name not in self._windows:
            if name not in self._builders:
                raise KeyError(f"Variable '{name}' not found in input state")
            self._windows[name] = self._builders[name]()
        return self._windows[name]

    def get_scalar_window(self, name: str) -> ScalarWindow:
        window = self.get_window(name)
        if not isinstance(host_window(window), ScalarWindow):
            raise TypeError(f"Variable '{name}' is not a scalar timeseries")
        return window

    def get_four_box_window(self, name: str) -> FourBoxWindow:
        window = self.get_window(name)
        if not isinstance(host_window(window), FourBoxWindow):
            raise TypeError(f"Variable '{name}' is not a FourBox timeseries")
        return window

    def get_hemispheric_window(self, name: str) -> HemisphericWindow:
        window = self.get_window(name)
        if not isinstance(host_window(window), HemisphericWindow):
            raise TypeError(f"Variable '{name}' is not a Hemispheric timeseries")
        return window

    def get_global(self, name: str):
        """Globally-aggregated current value of a variable."""
        window = self.get_window(name)
        if isinstance(host_window(window), ScalarWindow):
            return window.get()
        return window.current_global()

    def __contains__(self, name):
        return self.has(name)

    def __getitem__(self, name):
        return self.get_window(name)

    def __repr__(self):
        return f"InputState({list(self._builders)})"
