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
(:meth:`ModelProgram.run_window_fn`).  ``run(params, mesh=make_mesh())``
splits the batch over the mesh's devices: each device runs its contiguous
shard through its own program, one shard after another from the host, and
the outputs are gathered onto the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from rscm_tpu_torch.core.model.program import ModelProgram
from rscm_tpu_torch.utils.target import device_guard, resolve_device

__all__ = ["EnsembleRunner", "Mesh", "make_mesh", "stack_params"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: the devices a batch is split over, in shard order.

    A device may appear more than once; each entry then takes its own
    shard, which is how one card or the CPU exercises the split.
    """

    devices: tuple
    axis_names: tuple = ("batch",)

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "batch",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A one-axis :class:`Mesh` over the first ``n_devices`` devices.

    ``devices`` defaults to every CUDA card (``torch.cuda.device_count()``);
    with no card that raises, as the entry points do.  Pass ``devices`` to
    split over others, e.g. ``["cpu"] * 8``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices=[...] "
                "(e.g. ['cpu'] * 8) to split over other devices"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(tuple(devices), (axis_name,))


def _device_key(device) -> str:
    """A device's identity: ``"cuda"`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _take(values, lo: int, hi: int, batch: int):
    """Members ``lo .. hi - 1`` of a batched leaf; past the batch's end the
    last member stands in (the padding a split sheds again)."""
    if hi <= batch:
        return values[lo:hi]
    n_pad = hi - max(lo, batch)
    if isinstance(values, torch.Tensor):
        tail = values[-1:].expand((n_pad,) + tuple(values.shape[1:]))
        return torch.cat([values[lo:batch], tail])
    values = np.asarray(values)
    tail = np.broadcast_to(values[-1:], (n_pad,) + values.shape[1:])
    return np.concatenate([values[lo:batch], tail])


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
        self._programs = {}  # {device key: the program of another device of a mesh}
        self._inputs = None  # {(stream, start_idx, device key): inputs}, built on first use
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

    def _program_on(self, device) -> ModelProgram:
        """The program that runs on ``device``: the runner's own, or one
        built for that device of a mesh (kept for later runs)."""
        key = _device_key(device)
        if key == _device_key(self.device):
            return self.program
        if key not in self._programs:
            self._programs[key] = ModelProgram(self.model, dtype=self.dtype, device=key)
        return self._programs[key]

    def _cached_inputs(self, stream: bool, start_idx: int, program=None):
        """The model's shared inputs ``(endo, exo, internals)`` on
        ``program``'s device (the runner's by default), gathered once per
        (mode, start, device) and reused until the model's state changes."""
        p = self.program if program is None else program
        if self._model_version() != self._inputs_version:
            self.refresh_inputs()
        key = (bool(stream), int(start_idx), _device_key(p.device))
        if self._inputs is None:
            self._inputs = {}
        if key not in self._inputs:
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

    def batched_params(
        self, overrides: Dict[str, np.ndarray], mesh: Optional[Mesh] = None, device=None
    ) -> dict:
        """Parameter dict from per-parameter override arrays.

        ``overrides`` maps ``"ComponentName.param"`` to a ``(B,)`` array;
        those leaves become ``(B,)`` tensors on ``device``, else on the
        first device of ``mesh`` (the one :meth:`run` splits them from),
        else on the runner's device.  Every other parameter stays a 0-d
        host array (baked by :meth:`run`).
        """
        sizes = {np.shape(v)[0] for v in overrides.values()}
        if len(sizes) != 1:
            raise ValueError("batched_params: override arrays must share the batch size")
        if device is not None:
            target = resolve_device(device)
        elif mesh is not None:
            target = mesh.devices[0]
        else:
            target = self.device
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
                        np.asarray(overrides[key]), dtype=self.dtype, device=target
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

    @staticmethod
    def _batched_exo(exo, program):
        """``exo`` on ``program``'s device: a ``(B, n_steps, g)`` scenario
        batch as an ``(n_steps, B, g)`` view (no copy), a ``(n_steps, g)``
        series as it is."""
        p = program
        out = {}
        for name, values in exo.items():
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
        mesh: Optional[Mesh] = None,
        out_vars: Optional[list] = None,
        start_idx: int = 0,
        stream: Optional[bool] = None,
    ):
        """Run the ensemble; returns ``{var_name: (B, n_steps, n_regions)}``
        tensors on the runner's device, or on the mesh's first device.

        ``exo`` optionally gives batched exogenous data ``{name: (B, n_steps,
        g)}`` (one scenario per member, numpy or tensor) or shared ``(n_steps,
        g)`` data in place of the model's; the batch may come from ``exo``
        alone.  ``out_vars`` restricts which trajectories come back.
        ``stream`` selects the streaming loop, which keeps only the rows a
        reader can still reach of every variable not in ``out_vars``; it
        defaults to ``out_vars is not None``, and the values are the same
        either way.

        ``mesh`` (:func:`make_mesh`) splits the batch into ``mesh.size``
        contiguous shards, the batched parameters and scenarios alike; a
        batch that does not divide is padded with its last member.  Each
        shard runs on its device through that device's program, one after
        another, and the outputs are gathered onto ``mesh.devices[0]`` with
        the padding sliced off.  Members are independent, so a shard's
        values are those of the unsharded run.
        """
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"EnsembleRunner.run: mesh must be a Mesh (make_mesh), not "
                f"{type(mesh).__name__}"
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
        exo = dict(exo or {})
        for name in exo:
            if name not in p.exo_names:
                raise KeyError(
                    f"EnsembleRunner.run: {name!r} is not an exogenous variable; "
                    f"exogenous: {sorted(p.exo_names)}"
                )
        batched, baked = self._split_params(params)
        sizes = {int(np.shape(v)[0]) for node in batched.values() for v in node.values()}
        sizes |= {int(np.shape(v)[0]) for v in exo.values() if np.ndim(v) == 3}
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
        if mesh is None:
            return self._run_on(p, batched, baked, exo, batch, out_vars, start_idx, stream)

        per = -(-batch // mesh.size)
        shards = []
        for k, device in enumerate(mesh.devices):
            lo, hi = k * per, (k + 1) * per
            shard_params = {
                nk: {pn: _take(v, lo, hi, batch) for pn, v in node.items()}
                for nk, node in batched.items()
            }
            shard_exo = {
                name: _take(v, lo, hi, batch) if np.ndim(v) == 3 else v
                for name, v in exo.items()
            }
            with device_guard(device):
                shards.append(self._run_on(
                    self._program_on(device), shard_params, baked, shard_exo, per,
                    out_vars, start_idx, stream,
                ))
        anchor = mesh.devices[0]
        return {
            name: torch.cat([shard.pop(name).to(anchor) for shard in shards])[:batch]
            for name in list(shards[0])
        }

    def _run_on(self, p, batched, baked, exo, batch, out_vars, start_idx, stream):
        """One batch through program ``p``, on its device."""
        merged = {nk: dict(node) for nk, node in baked.items()}
        for nk, node in batched.items():
            for pn, v in node.items():
                merged.setdefault(nk, {})[pn] = p._tensor(v)

        endo, exo_in, internals = self._cached_inputs(stream, start_idx, p)
        endo = {name: v.expand(-1, batch, -1) for name, v in endo.items()}
        exo_in = {**exo_in, **self._batched_exo(exo, p)}
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
