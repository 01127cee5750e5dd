"""
Batched ensemble execution of a model program.

Port of ``rscm_tpu/parallel/ensemble.py``.  Typical use::

    runner = EnsembleRunner(model)                       # on the CUDA card
    params = runner.batched_params({"ClimateUDEB.ecs": ecs})  # (B,) sweep
    out = runner.run(params, out_vars=["Surface Temperature"])
    # one emission pathway per member: (B, n_steps, g)
    out = runner.run(params, exo={"Emissions|CO2|Anthropogenic": scenarios})

``params`` follows the program's parameter dict —
``{node_id: {param_name: value}}`` — where a swept parameter is a ``(B,)``
array or tensor and every other one a scalar (:func:`stack_params` builds
one from per-member dicts).  Scalars are baked into the run as host floats,
so only the swept parameters and batched scenarios occupy batch-sized
device memory.  A run that names ``out_vars`` streams by default
(:meth:`ModelProgram.run_window_fn`).  Sharding the batch over several
cards is not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from rscm_tpu_torch.core.model.program import ModelProgram
from rscm_tpu_torch.utils.target import resolve_device

__all__ = ["EnsembleRunner", "stack_params"]


def stack_params(member_params: list) -> dict:
    """Stack a list of per-member parameter dicts into ``(B,)`` leaves
    (tensors when any member's leaf is one, numpy arrays otherwise)."""
    out: dict = {}
    for nk, node in member_params[0].items():
        out[nk] = {}
        for pn in node:
            leaves = [m[nk][pn] for m in member_params]
            if any(isinstance(v, torch.Tensor) for v in leaves):
                ref = next(v for v in leaves if isinstance(v, torch.Tensor))
                out[nk][pn] = torch.stack(
                    [torch.as_tensor(v, dtype=ref.dtype, device=ref.device) for v in leaves]
                )
            else:
                out[nk][pn] = np.stack([np.asarray(v) for v in leaves])
    return out


class EnsembleRunner:
    """Run a model's program over a batch of members.

    ``device`` defaults to the CUDA card (raising when there is none);
    ``dtype`` is the working floating-point type of the run.
    """

    def __init__(self, model, dtype=torch.float64, device=None):
        self.model = model
        self.device = resolve_device(device)
        self.dtype = dtype
        self.program = ModelProgram(model, dtype=dtype, device=self.device)
        self._inputs = None  # {(stream, start_idx): device inputs}, built on first use
        self._inputs_version = self._model_version()

    def _model_version(self):
        """Staleness key of the model's mutable state (the TPU package's
        ``ensemble.py:65-67``)."""
        return (self.model.time_index, self.model._state_version)

    def refresh_inputs(self):
        """Drop the cached device copies of the model's inputs.

        :meth:`run` gathers the model's exogenous data and internal states
        onto the device on first use and reuses them.  The cache drops
        itself when the model is run (its ``time_index`` or
        ``_state_version`` changes); call this after any other in-place
        change to the model's data.
        """
        self._inputs = None
        self._inputs_version = self._model_version()

    def _cached_inputs(self, stream: bool, start_idx: int):
        """The model's shared inputs ``(endo, exo, internals)`` on the
        device, gathered once per (mode, start) and reused until the
        model's state changes."""
        if self._model_version() != self._inputs_version:
            self.refresh_inputs()
        key = (bool(stream), int(start_idx))
        if self._inputs is None:
            self._inputs = {}
        if key not in self._inputs:
            p = self.program
            endo = p.gather_endo_window(1, start_idx) if stream else p.gather_endo(1)
            self._inputs[key] = (endo, p.gather_exo(), p.gather_internals())
        return self._inputs[key]

    def base_args(self):
        """The single-member program inputs ``(endo, exo, params,
        internals)`` (``endo`` at one member)."""
        p = self.program
        return (p.gather_endo(1), p.gather_exo(), p.gather_params(), p.gather_internals())

    def base_params(self) -> dict:
        return self.program.gather_params()

    def batched_params(self, overrides: Dict[str, np.ndarray]) -> dict:
        """Parameter dict from per-parameter override arrays.

        ``overrides`` maps ``"ComponentName.param"`` to a ``(B,)`` array;
        those leaves become ``(B,)`` tensors on the runner's device, every
        other parameter stays a 0-d host array (baked by :meth:`run`).
        """
        sizes = {np.shape(v)[0] for v in overrides.values()}
        if len(sizes) != 1:
            raise ValueError("batched_params: override arrays must share the batch size")
        names = self.program.node_names()
        out = {}
        matched = set()
        for node_key, params in self.base_params().items():
            out[node_key] = {}
            for pname, value in params.items():
                key = f"{names[node_key]}.{pname}"
                if key in overrides:
                    matched.add(key)
                    out[node_key][pname] = torch.as_tensor(
                        np.asarray(overrides[key]), dtype=self.dtype, device=self.device
                    )
                else:
                    out[node_key][pname] = value
        unknown = set(overrides) - matched
        if unknown:
            known = sorted(
                f"{names[nk]}.{pn}" for nk, params in self.base_params().items() for pn in params
            )
            raise KeyError(
                f"batched_params: unknown parameter(s) {sorted(unknown)}; "
                f"known parameters: {known}"
            )
        return out

    @staticmethod
    def _split_params(params):
        """Partition the parameter dict into batched ``(B,)`` leaves and
        scalars baked as host floats (the TPU package's constant baking,
        ``ensemble.py:202-229``: unswept parameters are constants of the
        run, so physics can special-case their values on the host)."""
        batched: dict = {}
        baked: dict = {}
        for nk in sorted(params):
            for pn in sorted(params[nk]):
                v = params[nk][pn]
                if np.ndim(v) >= 1:
                    batched.setdefault(nk, {})[pn] = v
                else:
                    baked.setdefault(nk, {})[pn] = float(v)
        return batched, baked

    def _batched_exo(self, exo):
        """``exo`` on the device: a ``(B, n_steps, g)`` scenario batch as an
        ``(n_steps, B, g)`` view (no copy), a ``(n_steps, g)`` series as it
        is."""
        p = self.program
        out = {}
        for name, values in (exo or {}).items():
            if name not in p.exo_names:
                raise KeyError(
                    f"EnsembleRunner.run: {name!r} is not an exogenous variable; "
                    f"exogenous: {sorted(p.exo_names)}"
                )
            t = p._tensor(values)
            if t.dim() == 3:
                if t.shape[1] != p.n_steps:
                    raise ValueError(
                        f"EnsembleRunner.run: exo[{name!r}] has {t.shape[1]} steps, "
                        f"the time axis {p.n_steps}"
                    )
                t = t.transpose(0, 1)
            out[name] = t
        return out

    def run(
        self,
        params: dict,
        exo: Optional[dict] = None,
        mesh=None,
        out_vars: Optional[list] = None,
        start_idx: int = 0,
        stream: Optional[bool] = None,
    ):
        """Run the ensemble; returns ``{var_name: (B, n_steps, n_regions)}``
        tensors on the runner's device.

        ``exo`` optionally gives batched exogenous data ``{name: (B, n_steps,
        g)}`` (one scenario per member, numpy or tensor) or shared ``(n_steps,
        g)`` data in place of the model's; the batch may come from ``exo``
        alone.  ``out_vars`` restricts which trajectories come back.
        ``stream`` selects the streaming loop, which keeps only the rows a
        reader can still reach of every variable not in ``out_vars``; it
        defaults to ``out_vars is not None``, and the values are the same
        either way.  ``mesh`` (sharding the batch over several cards) is not
        ported and raises.
        """
        if mesh is not None:
            raise NotImplementedError(
                "EnsembleRunner.run(mesh=...): splitting the batch over several "
                "cards is not ported yet (ROADMAP A.6)"
            )
        if start_idx == 0 and self.model.time_index > 0:
            warnings.warn(
                "EnsembleRunner.run(start_idx=0) on a model that has been run "
                f"to index {self.model.time_index}: component internal states "
                "are snapshotted from the model's CURRENT position. Rebuild the "
                "model for a from-scratch ensemble.",
                stacklevel=2,
            )
        p = self.program
        if stream is None:
            stream = out_vars is not None
        batched, baked = self._split_params(params)
        batch_exo = self._batched_exo(exo)
        sizes = {int(np.shape(v)[0]) for node in batched.values() for v in node.values()}
        sizes |= {int(v.shape[1]) for v in batch_exo.values() if v.dim() == 3}
        if not sizes:
            raise ValueError(
                "EnsembleRunner.run: nothing is batched — provide (B,) parameters "
                "(batched_params/stack_params) and/or (B, n_steps, g) exogenous "
                "scenarios"
            )
        if len(sizes) != 1:
            raise ValueError(
                f"EnsembleRunner.run: batched parameters and scenarios disagree on B: "
                f"{sorted(sizes)}"
            )
        (batch,) = sizes

        merged = {nk: dict(node) for nk, node in baked.items()}
        for nk, node in batched.items():
            for pn, v in node.items():
                merged.setdefault(nk, {})[pn] = torch.as_tensor(
                    v, dtype=self.dtype, device=self.device
                )

        endo, exo_in, internals = self._cached_inputs(stream, start_idx)
        endo = {name: v.expand(-1, batch, -1) for name, v in endo.items()}
        exo_in = {**exo_in, **batch_exo}
        if stream:
            names = list(out_vars) if out_vars is not None else list(p.endo_names)
            out, _ = p.run_window_fn(endo, exo_in, merged, internals, names,
                                     start_idx=start_idx)
        else:
            out, _ = p.run_fn(endo, exo_in, merged, internals, start_idx=start_idx)
            names = p.endo_names if out_vars is None else [n for n in p.endo_names if n in out_vars]
        return {name: out[name].transpose(0, 1) for name in names}

    def cost_analysis(
        self,
        params: dict,
        exo: Optional[dict] = None,
        out_vars: Optional[list] = None,
        start_idx: int = 0,
        stream: Optional[bool] = None,
    ) -> dict:
        """Operations and bytes of the run :meth:`run` makes for these
        arguments, counted while it runs once (the model's inputs are
        gathered onto the device first and not counted).  The keys and
        what they count: :func:`rscm_tpu_torch.utils.profiling.cost_analysis`."""
        from rscm_tpu_torch.utils.profiling import count_costs

        if stream is None:
            stream = out_vars is not None
        self._cached_inputs(stream, start_idx)
        with count_costs() as costs:
            self.run(params, exo=exo, out_vars=out_vars, start_idx=start_idx, stream=stream)
        return costs
