"""
Model runners: map a parameter vector to model outputs.

Port of ``rscm_tpu/calibrate/model_runner.py``:

- :class:`ModelRunner` — the protocol (``param_names``, ``run``,
  ``run_batch``);
- :class:`DefaultModelRunner` — builds a fresh model per parameter vector
  through a user factory and extracts named scalar outputs (host path);
- :class:`CompiledModelRunner` — one model whose calibrated parameters are
  swept members of the year loop: ``trajectories_fn`` is a function theta
  -> {var: trajectory} on tensors that autograd differentiates in both
  modes, for one ``(D,)`` vector or a ``(B, D)`` batch of walkers at once.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .likelihood import ModelOutput, VariableOutput

__all__ = ["ModelRunner", "DefaultModelRunner", "CompiledModelRunner", "SensitivityAnalyzer"]


class ModelRunner:
    """Protocol base.

    Also usable directly with the reference's convenience constructor:
    ``ModelRunner(model_factory=fn, param_names=[...],
    output_variables=[...])`` where ``fn(param_dict)`` returns
    ``{var_name: {time: value}}``.
    """

    def __init__(self, model_factory=None, param_names=None, output_variables=None):
        self._factory = model_factory
        self._param_names = list(param_names) if param_names is not None else None
        self._output_variables = (
            list(output_variables) if output_variables is not None else None
        )

    def param_names(self) -> List[str]:
        if self._param_names is not None:
            return list(self._param_names)
        raise NotImplementedError

    def run(self, params) -> ModelOutput:
        if self._factory is None:
            raise NotImplementedError
        param_dict = dict(zip(self._param_names, np.asarray(params, dtype=float)))
        result = self._factory(param_dict)
        output = ModelOutput()
        for name in self._output_variables or list(result):
            var_output = VariableOutput(name)
            for t, v in result[name].items():
                var_output.add(float(t), float(v))
            output.add_variable(var_output)
        return output

    def run_batch(self, param_sets) -> list:
        """Default sequential batch; entries are ModelOutput or Exception."""
        out = []
        for params in param_sets:
            try:
                out.append(self.run(params))
            except Exception as e:  # failed runs become -inf posterior
                out.append(e)
        return out


class DefaultModelRunner(ModelRunner):
    def __init__(
        self,
        param_names: List[str],
        output_variables: List[str],
        factory: Callable,
    ):
        self._param_names = list(param_names)
        self.output_variables = list(output_variables)
        self.factory = factory

    def param_names(self):
        return self._param_names

    def run(self, params) -> ModelOutput:
        params = list(np.asarray(params, dtype=np.float64))
        if len(params) != len(self._param_names):
            raise ValueError(
                f"Expected {len(self._param_names)} parameters, got {len(params)}"
            )
        model = self.factory(params)
        model.run()
        if not model.finished():
            raise RuntimeError("Model did not complete all timesteps")
        return self.extract_outputs(model)

    def extract_outputs(self, model) -> ModelOutput:
        output = ModelOutput()
        collection = model.timeseries()
        for var_name in self.output_variables:
            data = collection.get_data(var_name)
            if data is None:
                raise ValueError(f"Model output missing variable: {var_name}")
            if data.grid.size() != 1:
                raise ValueError(f"Grid variables not yet supported: {var_name}")
            var_output = VariableOutput(var_name)
            times = data.time_axis().values()
            values = data.values()[:, 0]
            for t, v in zip(times, values):
                if not np.isnan(v):
                    var_output.add(float(t), float(v))
            output.add_variable(var_output)
        return output


class CompiledModelRunner(ModelRunner):
    """Runner over a built model's year loop, on the CUDA card unless
    ``device`` says otherwise.

    ``param_map`` maps sampled parameter names to model parameters as
    ``"ComponentName.param"`` strings (one sampled value may drive several
    model parameters by listing multiple targets).  Each walker is one
    member of an :class:`~rscm_tpu_torch.parallel.EnsembleRunner` run: a
    ``(B, D)`` batch of parameter vectors is one batched run whose swept
    parameters are the batch's columns.

    ``stream=True`` (the default) runs the streaming loop
    (:meth:`~rscm_tpu_torch.core.model.program.ModelProgram.run_window_fn`),
    which keeps only the rows a reader can still reach of every variable
    that is not an output; ``False`` runs the full loop.  The values are the
    same.  ``scan_unroll`` is kept for API parity: it tunes ``lax.scan`` in
    the JAX package and has no counterpart in an eager loop.
    """

    def __init__(
        self,
        model,
        param_map: Dict[str, object],
        output_variables: List[str],
        dtype=torch.float64,
        stream: bool = True,
        scan_unroll: int = 1,
        device=None,
    ):
        from rscm_tpu_torch.parallel.ensemble import EnsembleRunner

        self.model = model
        self.ensemble = EnsembleRunner(model, dtype=dtype, device=device)
        self.program = self.ensemble.program
        self.device = self.ensemble.device
        self.output_variables = list(output_variables)
        self.stream = bool(stream)
        self.scan_unroll = int(scan_unroll)
        self._param_names = list(param_map)
        # normalise: name -> list of "Component.param"
        self.param_map = {
            name: ([targets] if isinstance(targets, str) else list(targets))
            for name, targets in param_map.items()
        }

        # resolve Component.param -> (node_key, param_name); duplicate
        # component names are a hard error — letting the last node win would
        # bind calibration parameters to the wrong instance
        name_for_node = {}
        for node in self.program.exec_nodes:
            comp = model.graph.nodes[node]
            comp_name = getattr(comp, "component_name", type(comp).__name__)
            if comp_name in name_for_node:
                raise ValueError(
                    f"CompiledModelRunner: two components share the name "
                    f"{comp_name!r}; param_map targets would be ambiguous. "
                    "Give each instance a distinct component_name."
                )
            name_for_node[comp_name] = str(node)
        self._targets = {}
        base = self.program.gather_params()
        for name, targets in self.param_map.items():
            resolved = []
            for target in targets:
                comp_name, _, pname = target.partition(".")
                if comp_name not in name_for_node:
                    raise KeyError(f"Unknown component '{comp_name}' in param_map")
                node_key = name_for_node[comp_name]
                if pname not in base.get(node_key, {}):
                    raise KeyError(
                        f"Unknown parameter '{pname}' on component '{comp_name}'"
                    )
                resolved.append((node_key, pname))
            self._targets[name] = resolved
        self._base_params = base

    def param_names(self):
        return self._param_names

    # -- the differentiable core ------------------------------------------------

    def as_theta(self, theta, device=None) -> torch.Tensor:
        """``theta`` as a tensor of the run's dtype on ``device`` (the
        runner's by default; a tensor already there is returned as it is, so
        its gradient is kept)."""
        device = self.device if device is None else device
        if isinstance(theta, torch.Tensor):
            return theta.to(dtype=self.program.dtype, device=device)
        return torch.as_tensor(theta, dtype=self.program.dtype, device=device)

    def params_pytree(self, theta):
        """The program's parameter dict with a ``(B, D)`` batch (or a
        ``(D,)`` vector, as a batch of one) substituted: each sampled
        parameter becomes a ``(B,)`` swept column."""
        thetas = theta if theta.dim() == 2 else theta[None]
        out = {k: dict(v) for k, v in self._base_params.items()}
        for j, name in enumerate(self._param_names):
            for node_key, pname in self._targets[name]:
                out[node_key][pname] = thetas[:, j]
        return out

    def trajectories_fn(self, mesh=None):
        """Function: theta ``(D,)`` -> ``{var: (n_steps, g)}``, or ``(B, D)``
        -> ``{var: (B, n_steps, g)}``, on tensors; gradients flow from a
        ``theta`` that requires them (reverse mode) or is dual (forward
        mode, ``torch.autograd.forward_ad``).  With a ``mesh``
        (:func:`~rscm_tpu_torch.parallel.make_mesh`) the batch is split over
        its devices (:meth:`EnsembleRunner.run`) and theta and the
        trajectories live on its first device."""
        out_vars = self.output_variables
        device = None if mesh is None else mesh.devices[0]

        def fn(theta):
            theta = self.as_theta(theta, device)
            out = self.ensemble.run(
                self.params_pytree(theta), out_vars=out_vars, stream=self.stream, mesh=mesh
            )
            if theta.dim() == 1:
                return {name: out[name][0] for name in out_vars}
            return {name: out[name] for name in out_vars}

        return fn

    # -- ModelRunner protocol (host API parity) --------------------------------

    def _series(self, name: str, traj) -> np.ndarray:
        """(n_steps,) scalar series from a trajectory.

        Multi-region (grid) variables reduce to the area-weighted global
        aggregate — the same ``aggregate_global`` semantics the device
        likelihood applies.
        """
        arr = np.asarray(traj)
        if arr.ndim == 2 and arr.shape[1] > 1:
            data = self.model.collection.get_data(name)
            return arr @ np.asarray(data.grid.weights, dtype=arr.dtype)
        return arr[:, 0] if arr.ndim == 2 else arr

    def _output(self, trajectories, i=None) -> ModelOutput:
        output = ModelOutput()
        times = self.model.time_axis.values()
        for name in self.output_variables:
            var_output = VariableOutput(name)
            traj = trajectories[name] if i is None else trajectories[name][i]
            series = self._series(name, traj.to(torch.float64).cpu().numpy())
            for t, v in zip(times, series):
                if not np.isnan(v):
                    var_output.add(float(t), float(v))
            output.add_variable(var_output)
        return output

    def run(self, params) -> ModelOutput:
        with torch.no_grad():
            trajectories = self.trajectories_fn()(np.asarray(params, dtype=np.float64))
        return self._output(trajectories)

    def run_batch(self, param_sets) -> list:
        with torch.no_grad():
            batched = self.trajectories_fn()(np.asarray(param_sets, dtype=np.float64))
        return [self._output(batched, i) for i in range(len(param_sets))]


class SensitivityAnalyzer:
    """Exact parameter sensitivities through the model.

    ``d output(t) / d theta_j`` comes from one forward-mode pass through
    the year loop (the D tangent directions ride as D members of one
    batched run), at machine precision.  Built on
    :class:`CompiledModelRunner`'s ``theta -> trajectories`` core; results
    are plain numpy.
    """

    def __init__(self, runner: CompiledModelRunner):
        if not isinstance(runner, CompiledModelRunner):
            raise TypeError("SensitivityAnalyzer requires a CompiledModelRunner")
        self.runner = runner

    def jacobian(self, theta) -> Dict[str, np.ndarray]:
        """``{var: (n_steps, n_regions, D)}`` — d trajectory / d theta.

        Forward mode: D is small and trajectories are long, so D tangent
        directions beat reverse mode's per-output vector-Jacobian products.
        """
        theta = self.runner.as_theta(np.asarray(theta, dtype=np.float64))
        d = theta.shape[0]
        basis = torch.eye(d, dtype=theta.dtype, device=theta.device)
        with torch.no_grad(), fwAD.dual_level():
            out = self.runner.trajectories_fn()(fwAD.make_dual(theta.expand(d, d).contiguous(), basis))
            tangents = {name: fwAD.unpack_dual(v).tangent for name, v in out.items()}
        # (D, n_steps, g) -> (n_steps, g, D)
        return {
            name: t.movedim(0, -1).to(torch.float64).cpu().numpy()
            for name, t in tangents.items()
        }

    def elasticities(self, theta) -> Dict[str, np.ndarray]:
        """Dimensionless sensitivities ``(theta_j / y(t)) * dy/dtheta_j``.

        Comparable across parameters and variables; entries where the
        trajectory is ~0 are returned as NaN rather than blowing up.
        """
        theta = np.asarray(theta, dtype=np.float64)
        jac = self.jacobian(theta)
        with torch.no_grad():
            base = self.runner.trajectories_fn()(theta)
        out = {}
        for name, j in jac.items():
            y = base[name].to(torch.float64).cpu().numpy()[..., None]  # (n_steps, g, 1)
            with np.errstate(divide="ignore", invalid="ignore"):
                e = j * theta[None, None, :] / y
            e[np.broadcast_to(np.abs(y) < 1e-30, e.shape)] = np.nan
            out[name] = e
        return out
