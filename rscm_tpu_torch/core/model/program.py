"""
The model program: the whole run as a loop over years on batched tensors.

Port of ``rscm_tpu/core/model/program.py``.  The TPU package traces the
builder's static execution plan into one step function and lets
``lax.scan`` drive it over the time axis, with ``vmap`` adding the member
axis.  PyTorch runs eagerly, so here the same plan runs as a Python loop
over years, with the member axis written out:

- every endogenous variable keeps its trajectory as a list of ``(B,
  n_regions)`` rows (:class:`~rscm_tpu_torch.core.state.Trajectory`) and
  each component's outputs are written at index **N+1**, so upstream
  outputs written earlier in a step are visible to later components'
  ``at_end`` reads.  A write replaces a row, and nothing is modified in
  place, so the loop carries gradients (reverse and forward mode) from
  parameters given as tensors that require them;
- exogenous data is ``(n_steps, n_regions)``, shared by every member;
- parameters are a ``{node: {name: value}}`` dict whose values are host
  floats (shared) or ``(B,)`` tensors (swept per member);
- component internal states enter and leave in their host layout; the
  components' ``pack_scan_state`` / ``unpack_scan_state`` hooks convert
  them at entry and exit, as in the TPU package.

The streaming mode (:meth:`ModelProgram.run_window_fn`) runs the same loop
but keeps, for every variable not asked for, only the rows a reader can
still reach (its :attr:`~ModelProgram.lookbacks` depth plus the current
and next rows) and releases older ones, so memory grows with the emitted
trajectories only.  The TPU package rolls fixed-size buffers through its
``lax.scan`` carry for the same end; an eager loop can simply drop rows.
Every read is the same operation on the same row, so the values equal the
full loop's bit for bit.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch

from .. import xmath as xm
from ..component import SolveContext, state_to_host, state_to_tensors
from ..state import StateValue, Trajectory, make_window
from ..timeseries import VariableType
from .graph import NullComponent
from ...utils.target import resolve_device
from .input_state import InputState
from .runtime import prepare_inputs

__all__ = ["ModelProgram"]


class ModelProgram:
    """The batched year loop of a built model on one device and dtype.

    ``device`` defaults to the CUDA card and raises when there is none
    (:func:`~rscm_tpu_torch.utils.target.resolve_device`).
    """

    def __init__(self, model, dtype=torch.float64, device=None):
        self.model = model
        self.dtype = dtype
        self.device = resolve_device(device)
        self.exec_nodes = [
            node
            for node in model.exec_order
            if not isinstance(model.graph.nodes[node], NullComponent)
        ]
        for node in self.exec_nodes:
            component = model.graph.nodes[node]
            if not getattr(component, "traceable", True):
                raise TypeError(
                    f"Component '{getattr(component, 'component_name', component)}' "
                    f"cannot run in the year loop (arbitrary Python solve); the model "
                    f"runs on the step-by-step executor instead."
                )
        self.n_steps = len(model.time_axis)
        self.time_values = np.asarray(model.time_axis.values(), dtype=np.float64)
        self.time_bounds = np.asarray(model.time_axis.bounds(), dtype=np.float64)
        # static step widths for per-component sub-stepping
        self.spans = np.diff(self.time_bounds)

        self._matrices = {}  # id(plan matrix) -> (the matrix, its device copy)
        self.endo_names = []
        self.exo_names = []
        for item in model.collection:
            if item.variable_type is VariableType.Endogenous:
                self.endo_names.append(item.name)
            else:
                self.exo_names.append(item.name)

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _matrix(self, matrix):
        """A plan's constant grid-transform matrix on the run's device,
        copied there once (not once a year)."""
        if matrix is None:
            return None
        key = id(matrix)
        if key not in self._matrices:
            self._matrices[key] = (matrix, self._tensor(np.array(matrix)))
        return self._matrices[key][1]

    # -- the loop ------------------------------------------------------------

    def _solve_all_nodes(self, endo, exo, internals, ctx, params):
        """Solve every node for step ``ctx.step_index`` in topological order."""
        model = self.model
        plan = model._plan
        idx = ctx.step_index

        for node in self.exec_nodes:
            component = model.graph.nodes[node]
            read_specs, write_specs = plan[node]

            builders = {}
            for spec in read_specs:
                item = model.collection.get_item(spec.var_name)
                values = endo[spec.var_name] if spec.var_name in endo else exo[spec.var_name]

                def make(spec=spec, values=values, item=item):
                    return make_window(
                        spec.window_grid,
                        values,
                        idx,
                        ctx.t_current,
                        factor=spec.factor,
                        source=spec.source,
                        strategy=item.data.interpolation_strategy,
                        time_values=self.time_values,
                        grid=model._grid_obj(spec.window_grid),
                        aggregation=self._matrix(spec.aggregation),
                    )

                builders[spec.var_name] = make
            input_state = InputState(builders, ctx.t_current)

            node_params = params.get(str(node), {})
            bound = component.with_params(node_params) if node_params else component

            inputs = prepare_inputs(bound, input_state)
            outputs, internals[str(node)] = bound.solve_ctx(ctx, inputs, internals.get(str(node)))

            if hasattr(outputs, "to_dict"):
                outputs = outputs.to_dict()
            for key, value in outputs.items():
                if key not in endo:
                    continue
                row = self._tensor(StateValue.wrap(value).as_array())
                spec = write_specs.get(key)
                if spec is not None and spec.matrix is not None:
                    row = row @ self._matrix(spec.matrix)
                # member-independent outputs broadcast to the member axis
                endo[key][idx + 1] = row.expand_as(endo[key].rows[idx + 1])

    def _pack_internals(self, internals, start_idx: int):
        out = dict(internals)
        dt = self._uniform_dt()
        for node in self.exec_nodes:
            comp, key = self.model.graph.nodes[node], str(node)
            if out.get(key) is not None and hasattr(comp, "pack_scan_state"):
                out[key] = comp.pack_scan_state(out[key], start_idx, dt=dt)
        return out

    def _unpack_internals(self, internals, end_idx: int):
        out = dict(internals)
        for node in self.exec_nodes:
            comp, key = self.model.graph.nodes[node], str(node)
            if out.get(key) is not None and hasattr(comp, "unpack_scan_state"):
                out[key] = comp.unpack_scan_state(out[key], end_idx)
        return out

    def _uniform_dt(self):
        """The axis step if the time axis is uniform, else None."""
        dts = np.diff(self.time_values)
        if dts.size and np.allclose(dts, dts[0], rtol=1e-12, atol=0.0):
            return float(dts[0])
        return None

    def _loop(self, endo, exo, params, internals, start_idx, release=None):
        """Solve every step from ``start_idx``; ``endo`` maps names to
        :class:`Trajectory` objects updated in place.  ``release`` maps
        names to lookback depths: after step ``idx`` such a trajectory drops
        its row ``idx - depth``, which no later step reads."""
        internals = self._pack_internals(internals, start_idx)
        with xm.scalar_dtype(self.dtype):
            for idx in range(start_idx, self.n_steps - 1):
                ctx = SolveContext(
                    float(self.time_bounds[idx]),
                    float(self.time_bounds[idx + 1]),
                    idx,
                    spans=self.spans,
                    scan_mode=True,
                )
                self._solve_all_nodes(endo, exo, internals, ctx, params)
                for name, depth in (release or {}).items():
                    if idx - depth >= 0:
                        endo[name].release(idx - depth)
        return self._unpack_internals(internals, self.n_steps - 1)

    def run_fn(self, endo, exo, params, internals, start_idx: int = 0):
        """Run the loop from ``start_idx`` to the end of the axis.

        ``endo`` maps each endogenous name to its ``(n_steps, B, n_regions)``
        initial trajectory (rows up to ``start_idx`` are read, the rest are
        replaced); ``exo`` maps each exogenous name to ``(n_steps,
        n_regions)`` (shared) or ``(n_steps, B, n_regions)`` (one series per
        member); ``params`` is ``{node: {name: float | (B,) tensor}}``;
        ``internals`` the host-layout internal states.  Returns ``(endo,
        internals)`` after the final step, ``endo`` as new ``(n_steps, B,
        n_regions)`` tensors.
        """
        if self.n_steps - 1 - start_idx <= 0:
            return endo, internals
        endo = {name: Trajectory.from_tensor(values) for name, values in endo.items()}
        internals = self._loop(endo, exo, params, internals, start_idx)
        # one variable at a time, each trajectory's rows dropped once stacked
        endo = {name: endo.pop(name).stack() for name in list(endo)}
        return endo, internals

    # -- streaming ------------------------------------------------------------

    @functools.cached_property
    def lookbacks(self) -> Dict[str, int]:
        """Deepest lookback any component reads, per endogenous variable
        (``Component.input_lookback``; 1 is ``previous()``)."""
        lb = {name: 1 for name in self.endo_names}
        for node in self.exec_nodes:
            component = self.model.graph.nodes[node]
            read_specs, _ = self.model._plan[node]
            get_lb = getattr(component, "input_lookback", None)
            for spec in read_specs:
                if spec.var_name in lb:
                    depth = int(get_lb(spec.var_name)) if get_lb is not None else 1
                    lb[spec.var_name] = max(lb[spec.var_name], depth)
        return lb

    def _host_rows(self, name: str) -> torch.Tensor:
        """A variable's stored ``(n_steps, g)`` values on the device."""
        return self._tensor(self.model.collection.get_data(name)._values)

    def gather_endo_window(self, batch: int, start_idx: int = 0) -> Dict[str, torch.Tensor]:
        """The rows the streaming loop starts from: for each endogenous
        variable the stored rows ``start_idx - L .. start_idx + 1`` (``L``
        its lookback, indices clamped to the axis), broadcast to ``(L + 2,
        batch, g)`` as views of the shared data."""
        out = {}
        for name in self.endo_names:
            host = self._host_rows(name)
            rows = [
                min(max(start_idx - self.lookbacks[name] + k, 0), self.n_steps - 1)
                for k in range(self.lookbacks[name] + 2)
            ]
            out[name] = host[rows][:, None].expand(-1, batch, -1)
        return out

    def run_window_fn(
        self,
        endo_bufs,
        exo,
        params,
        internals,
        out_vars: Sequence[str],
        start_idx: int = 0,
    ):
        """The streaming run: returns ``({name: (n_steps, B, g)}, (window,
        internals))`` for the endogenous variables named in ``out_vars``.

        ``endo_bufs`` comes from :meth:`gather_endo_window`; ``exo``,
        ``params`` and ``internals`` are as for :meth:`run_fn`.  Rows after
        ``start_idx + 1`` start as the model's stored rows (NaN, or the
        values the builder stored, which a row no component writes keeps);
        rows up to ``start_idx`` are the stored history.  ``window`` holds
        each variable's rows after the final step, laid out as
        ``gather_endo_window(B, n_steps - 1)`` lays them out.
        """
        out_vars = tuple(out_vars)
        unknown = [v for v in out_vars if v not in set(self.endo_names)]
        if unknown:
            raise KeyError(
                f"run_window_fn: not endogenous variables: {unknown}; "
                f"endogenous: {sorted(self.endo_names)}"
            )
        batch = next(iter(endo_bufs.values())).shape[1] if endo_bufs else 1
        if self.n_steps - 1 - start_idx <= 0:
            host = {name: self._host_rows(name) for name in out_vars}
            return {
                name: rows[:, None].expand(-1, batch, -1) for name, rows in host.items()
            }, (endo_bufs, internals)

        endo = {}
        for name in self.endo_names:
            host = self._host_rows(name)
            rows = [row.expand(batch, -1) for row in host.unbind(0)]
            lb = self.lookbacks[name]
            for k, row in enumerate(endo_bufs[name].unbind(0)):
                if start_idx - lb + k >= 0:
                    rows[start_idx - lb + k] = row
            endo[name] = Trajectory(rows)
        release = {name: lb for name, lb in self.lookbacks.items() if name not in out_vars}
        for name, depth in release.items():
            for i in range(max(start_idx - depth, 0)):
                endo[name].release(i)
        internals = self._loop(endo, exo, params, internals, start_idx, release=release)

        final = self.n_steps - 1
        window = {
            name: torch.stack([
                endo[name][min(max(final - lb + k, 0), self.n_steps - 1)]
                for k in range(lb + 2)
            ])
            for name, lb in self.lookbacks.items()
        }
        trajs = {name: endo.pop(name).stack() for name in out_vars}
        return trajs, (window, internals)

    # -- host data marshalling ------------------------------------------------

    def gather_endo(self, batch: int) -> Dict[str, torch.Tensor]:
        """Endogenous trajectories broadcast to ``(n_steps, batch, g)``: views
        of the shared ``(n_steps, g)`` data (the loop replaces rows and never
        writes into them)."""
        out = {}
        for name in self.endo_names:
            values = self._tensor(self.model.collection.get_data(name)._values)
            out[name] = values[:, None].expand(-1, batch, -1)
        return out

    def gather_exo(self) -> Dict[str, torch.Tensor]:
        return {
            name: self._tensor(self.model.collection.get_data(name)._values)
            for name in self.exo_names
        }

    def gather_params(self) -> Dict[str, dict]:
        """Every node's non-static parameters as host float64 arrays."""
        params = {}
        for node in self.exec_nodes:
            pytree = self.model.graph.nodes[node].param_pytree()
            if pytree:
                params[str(node)] = {
                    k: np.asarray(v, dtype=np.float64) for k, v in pytree.items()
                }
        return params

    def gather_internals(self) -> Dict[str, object]:
        """Internal states in the host layout, float leaves as tensors."""
        return {
            str(node): state_to_tensors(
                self.model.component_states[node], self.dtype, self.device
            )
            for node in self.exec_nodes
        }

    def node_names(self) -> Dict[str, str]:
        """``{node key: component name}`` of the solved nodes."""
        return {
            str(node): getattr(
                self.model.graph.nodes[node], "component_name",
                type(self.model.graph.nodes[node]).__name__,
            )
            for node in self.exec_nodes
        }

    # -- execution --------------------------------------------------------------

    def run_into_collection(self, model):
        """Run one member from the model's current time index and write the
        trajectories back into its collection."""
        start_idx = model.time_index
        params = {
            nk: {pn: float(v) for pn, v in node.items()}
            for nk, node in self.gather_params().items()
        }
        endo, internals = self.run_fn(
            self.gather_endo(1), self.gather_exo(), params, self.gather_internals(),
            start_idx=start_idx,
        )
        for name, arr in endo.items():
            data = model.collection.get_data(name)
            # only the rows the loop wrote: earlier rows are committed history
            data._values[start_idx + 1 :, :] = (
                arr[start_idx + 1 :, 0].to(torch.float64).cpu().numpy()
            )
            data._recompute_latest()
        for node in self.exec_nodes:
            new_state = internals.get(str(node))
            if new_state is not None:
                model.component_states[node] = state_to_host(
                    new_state, model.component_states[node]
                )
