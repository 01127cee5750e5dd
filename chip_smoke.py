#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rscm_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` on a machine with a CUDA card and ``nvcc``.

Phases, each printed with its elapsed time:

1. device  -- the card's name and power limit (``nvidia-smi``), torch versions;
2. build   -- both CUDA sources built from ``rscm_tpu_torch/csrc`` (one ``nvcc``
              each, run together: the forward, tangent and adjoint kernels of
              ``udeb_year`` and ``lamcalc``), with the ``-Xptxas -v``
              register/spill report and the launch configuration and
              occupancy of ``udeb_year`` and its tangent and adjoint; beside
              them a probe of one IEEE division per dtype, built with the same
              flags, whose SASS (``cuobjdump -sass``) gives the instructions a
              division takes;
3. kernels -- each kernel against its plain PyTorch version on the card, at
              B = 100,000 and a ragged B = 99,997, in float64 and float32, and
              ``udeb_year`` at B = 99,997 at n = 2, 3, 17, 50, 100 and its
              layer limit, and with a per-member initial profile at n = 3
              and 50; ``udeb_year`` must equal its plain version bit for bit
              and raise one layer past its limit; then the four derivative
              kernels (``udeb_year_jvp``, ``udeb_year_vjp``, ``lamcalc_jvp``,
              ``lamcalc_vjp``) at B = 1, 512, 99,997 and 100,000 (n = 50),
              at B = 512 at n = 2, 3, 17, 50, 100 and at each kernel's own
              layer limits (one past a limit raises), with a per-member profile at n = 3 and 50, in
              float64 and float32: each tangent kernel against ``plain_jvp``
              of the plain forward at KERNEL_TOL, each adjoint against its
              explicit twin bit for bit and against autograd of the plain
              forward at AUTOGRAD_TOL, a LAMCALC fallback member's
              derivatives zero, while the references run (below); and,
              once they are collected, each derivative kernel's device time a
              launch at B = 1, 8, 512 and 100,000 (``udeb_year``'s in float64
              and float32) with its bound (its plain version's time at
              100,000 in float64) (``python3 chip_smoke.py kernels`` runs
              this phase alone);
4. main    -- the port's main path: a 100,000-member, 251-year ClimateUDEB
              ensemble driven by the 1pctCO2 forcing ramp, built with
              ``ModelBuilder`` and run by ``EnsembleRunner.run`` in float64;
              the launch counts of both kernels must be 250; 64 members re-run
              with the plain engine must agree (a reference: see below);
              one member built as the golden
              10_full_default regression case must match the Fortran MAGICC7
              data at that test's tolerance; then a second path, 10,000
              members with 30 layers through ``month_engine="auto"``, whose
              ``udeb_year`` count must be 250 and whose first 16 members must
              agree with the plain engine (a reference);
5. timing  -- the main path's wall time and member-years/s, a torch.profiler
              breakdown of one main-path run (device activity: busy time,
              idle share), per kernel its device time per launch (profiler), the time per
              back-to-back call (CUDA events), the plain version's time and the
              least time the card could take: the larger of the bytes over
              3.35 TB/s and the operations over the issue rate without
              contraction (17e12 FP64 / 33.5e12 FP32 additions or
              multiplications a second: the kernels are built with
              ``-fmad=false``), a division counted at the FMA-pipe
              instructions it takes; ``lamcalc``'s device time on a batch
              where every 64th member takes the fallback;
6. magicc  -- the ten-component emissions-driven MAGICC graph
              (``build_magicc_model``, 1850-2100, ``history_dtype="bfloat16"``,
              which resolves to the exp-sum ocean-carbon engine) at 100,000
              members in float64 through ``EnsembleRunner.run``, swept as the
              JAX package's bench sweeps it (ECS, kappa,
              ``TerrestrialCarbon.beta``, seed 3): both launch counts must be
              250 and every output finite; 64 members re-run with the plain
              engines must agree within 1e-10 (a reference); the run
              streams (``out_vars``
              given), and the full loop (``stream=False``) at the same batch
              must give the same values bit for bit, beside its peak memory;
              a ring-engine run (10,000 members, 1850-1950) must agree with
              its exp-sum twin within the CPU test's bounds; it prints the
              warm run's wall and member-years/s, the PyTorch calls a year
              and peak device memory, and over the first 51 years at the
              same batch the device busy time and idle share, the top device
              operations with both kernels' ms a launch and the device
              operations a year;
7. flagship -- the flagship graph (bench.py's two-layer + carbon cycle) at
              100,000 members x 551 years;
8. scenarios -- bench.py's cross product (``bench.py:390-430``) on the
              flagship graph: 10,000 members x 8 emission pathways = 80,000
              members x 551 years through ``run(exo=...)``, float64, streamed;
              no kernel may launch; every output finite, every member warmer
              under the highest pathway than under the lowest, one (scenario,
              member) pair within 1e-10 of a single-scenario run; wall,
              member-years/s, peak memory; over the first 51 years 16
              members streamed bit-equal to the full loop, the calls a year
              and a profile;
9. fullmagicc -- the full-options MAGICC graph (``bench.py:305-359``: ten
              components + permafrost + sea-level rise, bfloat16 flux
              history) at 100,000 members x 251 years, ECS and the arctic
              amplification swept (seed 3), streamed: both launch counts must
              be 250, every output finite from index 1, the permafrost pools
              conserve carbon per member, 64 members agree with the plain
              engines within 1e-10 (a reference); wall, member-years/s,
              peak memory; over
              the first 51 years 16 streamed members equal to the full loop
              bit for bit, the calls a year and a profile; the permafrost
              and sea-level solves' device time alone;
10. host -- the step-by-step executor (the flagship at one member against the
              year loop, ten ClimateUDEB ``step()``s), then the host surface:
              the MAGICC graph checkpointed after ten ``step()``s and resumed
              in a fresh model on the year loop (10 and 240 launches of each
              kernel; bit-equal to stepping on without a checkpoint, within
              1e-10 of the CPU), and a 100,000-member ensemble resumed from
              the same checkpoint (240 launches each; member 0 within 1e-10
              of the single member); the full-options graph rebuilt from
              its TOML, both running 10,000 members bit-equal (250 launches
              each a run); the two-layer model from the layered configs
              with its ERF from a scenario CSV, 100,000 members x 351 years
              bit-equal to the model built by hand (no launches); and
              ``diagnose_nans`` on the card naming the year, reader and
              output of a NaN put into an exogenous input; the eleven
              host-path methods of ClimateUDEB and OceanCarbon on host values,
              the ocean heat content, heat uptake and SST->air map within
              1e-10 of what the card's step wrote;
11. mesh -- the batch split over a device mesh, each split run against the
              unsplit run of the same members: the MAGICC path (100,000
              members x 251 years, streamed) on ``make_mesh()``, bit-equal,
              250 launches of each kernel; through two shards of the card
              (``make_mesh(devices=["cuda:0"] * 2)``) the MAGICC graph at
              100,001 members (one member of padding; 2 x 250 launches of
              each kernel; wall and member-years/s), the full-options graph
              at 10,000 members x 151 years and the scenario cross product
              at 80,000 members x 101 years (batched ``exo`` rows split),
              each within rtol 1e-12 beyond index 0; the device-engine
              sampler (MAGICC
              posterior, 1,024 walkers, 2 iterations, 1850-1900) whose split
              chain equals the unsplit chain with the same seed (rtol 1e-12,
              the same acceptance counts) and whose split log posteriors
              equal those of the same shards run alone, bit for bit; NUTS, 64
              chains in two shards, one warmup iteration and one transition
              at depth 2, 1850-1855: finite;
12. calibrate -- the MAGICC synthetic-truth calibration (``magicc_calibration``,
              1850-2100, eight parameters, float64, bfloat16 flux history)
              through the port's entry points, with both launch counts read
              around each step: the log posterior of 1,024 prior walkers as
              one batched run (250 launches each; 16 walkers against the
              plain engines within rtol 1e-10); at the 1850-1900 cut, the MAP
              objective's reverse-mode gradient at the truth (50 launches of
              each forward and each adjoint kernel; walls, peak memory) and
              its checks: against the plain engines within rtol 1e-9 (and
              16 walkers' log posterior, one batch through each, within
              rtol 1e-10), forward
              mode along a seeded direction (50 launches of each tangent
              kernel) at the JAX package's bfloat16 bar, and, with the flux
              history in float64, central differences of 16 perturbed
              walkers in one batched run within 1e-3 of its largest
              component, no derivative of a plain version taken on the card
              (``plain_jvp.calls`` 0); the same gradient over 1850-2100 (250
              launches of each forward and each adjoint kernel; the forward's
              and the backward's walls, peak memory), and with the flux
              history in float64 against central differences within 1e-3 as
              at the cut; each kernel's
              reverse-mode derivative
              at B = 1 timed alone, through its adjoint kernel and through
              its plain version differentiated under autograd; one Adam step
              from the prior midpoint at the cut in reverse and in forward
              mode (the default, ``fwd_threshold=32``); the device ensemble
              sampler, 1,024 walkers, 2 iterations under the stretch and
              the DE move, with a checkpoint round trip; NUTS, 64 chains,
              tree depth 2, one warmup iteration and one transition at
              1850-1860, with ``grad_mode="rev"`` and ``"auto"`` (forward
              mode);
13. compat -- the reference-API surface (``rscm_tpu_torch.compat``) on the
              card, with no ``device=`` given: the ten-component MAGICC
              graph (1850-2100, 50 layers, one member) assembled from the
              ``compat.magicc`` builders with ``with_rust_component`` and
              run by ``Model.run()``, 250 launches of each kernel, bit-equal
              to ``build_magicc_model()``'s run; the idioms of
              ``tests/test_rscm_compat.py`` (the two-layer builder model, the
              TOML round trip, a typed Python component reading
              ``previous`` / ``last_n`` through the reference windows built
              from CUDA tensors, ``PointEstimator.optimize(
              Optimizer.RandomSearch, 25)`` over a ``DefaultModelRunner``),
              each against the same code on the CPU within 1e-10; the
              windows from CUDA tensors against the same windows from numpy
              (the same values, the same exceptions); the phase's wall, the
              MAGICC run's warm wall and its launches.

The references are the plain-engine re-runs that the main, second,
magicc, fullmagicc and calibrate phases hold the kernels to (each path's
checked members over its whole axis; the calibration's walkers, its
1850-1900 gradient and its 1850-2100 central differences): functions
``ref_*`` that need nothing of the run but its seeds.  Host-bound, one
after another they would take most of the script's limit, so each runs in
a worker process of its own on the card, at most REFERENCE_WORKERS at
once, while the kernels phase checks the kernels (timing nothing); the
kernels phase waits for them before it times anything, and each phase
compares its kernels' values with its references at its tolerance.

``python3 chip_smoke.py PHASE ...`` runs the device and build phases and the
named later phases only (``kernels`` and ``timing`` go with ``main``;
``kernels`` also runs alone), e.g. ``python3 chip_smoke.py scenarios
fullmagicc``.

Any failed check raises and the script exits non-zero.  The last three lines
are the per-kernel JSON record, the ``nvidia-smi`` name/power line and
``{"ok": true, "device": {...}}``.
"""

import copy
import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

GOLDEN = os.path.join(HERE, "tests", "regression", "data", "ocean_udeb")
#: MAGICC default area fractions: NH ocean/land, SH ocean/land
FOURBOX_WEIGHTS = (0.5 * 0.58, 0.5 * 0.42, 0.5 * 0.79, 0.5 * 0.21)
HBM_BYTES_PER_S = 3.35e12
#: data-sheet peak outside the tensor cores, which counts a fused multiply-add
#: as two operations (the bound's rule before the kernels' -fmad=false was
#: accounted for; logged beside the bound for comparison)
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
#: one addition or multiplication per lane and clock: half the peak, since
#: -fmad=false keeps every add and multiply its own instruction
ISSUE_RATE = {"float64": 17e12, "float32": 33.5e12}
N_MEMBERS = 100_000
RAGGED = 99_997
#: layer counts udeb_year is held to its plain version at
LAYER_CHECKS = (2, 3, 17, 50, 100)
#: the plain-engine re-runs that the paths' checked members are held to
#: cost ~0.15-0.2 s of host calls a year whatever the batch (most of a
#: minute each over 251 years): each runs in a worker process of its own
#: on the card (References), at most this many at once (on the H100, six
#: such processes each ran 1.5x slower than one alone), and each result is
#: awaited at most REFERENCE_TIMEOUT s
REFERENCE_WORKERS = 6
REFERENCE_TIMEOUT = 600
#: the main path's members re-run through the plain engines
MAIN_CHECKED = 64
#: the second main path: a narrower ocean through month_engine="auto"
SECOND = {"members": 10_000, "n_layers": 30, "checked": 16}
#: the MAGICC path: members, members re-run through the plain engines, and
#: the ring-engine check's members and last year
MAGICC = {"members": 100_000, "checked": 64, "ring_members": 10_000, "ring_last_year": 1950.0,
          "profile_years": 51}
MAGICC_OUT = ["Surface Temperature", "Atmospheric Concentration|CO2"]
#: the MAGICC path's ocean carbon: bench.py's bfloat16 flux history
MAGICC_OCEAN = {"history_dtype": "bfloat16"}
#: ring engine against its exp-sum twin, max |ring - expsum| / max |expsum|
#: per variable (tests/test_torch_magicc_graph.py::RING_TWIN)
RING_TWIN = {"float32": 1e-8, "bfloat16": 5e-3}
#: the flagship path (bench.py:123-214): members, years, members re-run on the
#: CPU, the sweep's seed; and the step-by-step executor's flagship run
FLAGSHIP = {"members": 100_000, "years": 551, "checked": 64, "seed": 42, "step_years": 100,
            "profile_years": 51}
FLAGSHIP_OUT = ["Surface Temperature"]
#: the scenario cross product (bench.py:390-430): members, emission
#: pathways, years (1750-2300), the sweep's seed, the (scenario, member) pair
#: held against a single-scenario run, members streamed against the full
#: loop, and the profile's years
SCENARIOS = {"members": 10_000, "scenarios": 8, "years": 551, "seed": 5, "spot": (5, 7),
             "streamed_checked": 16, "profile_years": 51}
SCENARIOS_OUT = ["Surface Temperature"]
#: the full-options MAGICC graph (bench.py:305-359, the 100k point): members,
#: the sweep's seed, members re-run through the plain engines, members
#: streamed against the full loop, the profile's years, and the standalone
#: solves timed for the permafrost and sea-level shares of device time
FULLMAGICC = {"members": 100_000, "seed": 3, "checked": 64, "streamed_checked": 16,
              "profile_years": 51, "component_reps": 10}
#: bench.py's outputs, and the permafrost outputs the conservation identity
#: is read from
FULLMAGICC_OUT = ["Surface Temperature", "Sea Level Rise", "Emissions|CO2|Permafrost",
                  "Emissions|CH4|Permafrost", "Permafrost|Total Pool"]
#: |total pool + cumulative emissions - initial pool| per member, GtC
#: (tests/test_torch_permafrost.py::CONSERVATION_GTC)
CONSERVATION_GTC = 1e-8
#: ClimateUDEB through step(): the years it steps
HOST_UDEB_STEPS = 10
#: the host surface (the host phase's later runs): the steps taken before the
#: checkpoint, the members of the ensemble resumed from it, of the TOML
#: rebuild (full-options graph, 1850-2100) and of the layered-config run
#: (1750-2100, its sweep's seed); the diagnose_nans run's last year, the
#: exogenous input that gets a NaN, and the year it gets it
HOST = {"checkpoint_steps": 10, "resume_members": 100_000, "toml_members": 10_000,
        "config_members": 100_000, "config_seed": 5, "nan_last_year": 1875.0,
        "nan_input": "Emissions|CH4", "nan_year": 1860.0}
#: the layered configs the host phase builds the two-layer model from
TWO_LAYER_LAYERS = ("configs/two-layer/defaults.toml",
                    "configs/two-layer/tuning/high-sensitivity.toml")
#: the calibration path (bench.py:666-760, magicc_calibration at 1850-2100,
#: eight parameters): walkers, walkers re-run through the plain engines, the
#: finite-difference step (of each prior's span), the axis of the gradient,
#: its checks and Adam (1850 to this year), Adam's steps, the ensemble
#: sampler's iterations, NUTS's axis (1850 to this year), chains, tree depth
#: and initial step size (the default 0.1 diverges at once on this posterior
#: from around the truth: 63 of 64 chains on the H100)
CALIB = {"walkers": 1024, "checked": 16, "fd_rel_step": 1e-6, "cut_last_year": 1900.0,
         "adam_steps": 1, "ensemble_iterations": 2, "nuts_last_year": 1860.0,
         "nuts_chains": 64, "nuts_depth": 2, "nuts_step_size": 0.01}
#: the mesh phase: the MAGICC path's members on make_mesh() (the card), the
#: uneven batch split into two shards of the card, the full-options graph's
#: members and last year, the scenario cross product's members and years
#: (1750-1850), the
#: device-engine sampler's walkers, iterations and axis (1850 to this year),
#: and NUTS's chains and axis (cut from the calibrate phase's 1850-1860 to keep
#: the phase near two minutes: its backward is host-bound and two shards
#: double it)
MESH = {"members": 100_000, "uneven": 100_001, "shards": 2, "fullmagicc_members": 10_000,
        "fullmagicc_last_year": 2000.0, "scenario_members": 10_000, "scenario_years": 101,
        "walkers": 1024, "iterations": 2,
        "sampler_last_year": 1900.0, "nuts_chains": 64, "nuts_last_year": 1855.0}
#: a split run against the unsplit run of the same members, beyond index 0,
#: and the split sampler's chain against the unsplit chain (rtol, atol: the
#: JAX package's bar, tests/test_ensemble.py:342-345)
MESH_TOL = (1e-12, 0.0)
#: the compat phase: the reference-idiom MAGICC graph's axis, the two-layer
#: model's axis (tests/test_rscm_compat.py), the points RandomSearch draws,
#: and the bar of each idiom's card run against the CPU (the host phase's)
COMPAT = {"magicc_years": (1850.0, 2100.0), "two_layer_years": (2000.0, 2014.0),
          "random_search": 25, "tol": (1e-10, 1e-10)}
DEVICE = "cuda"
#: kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|.  Both do
#: the same operations in the same order and the kernels are built with
#: -fmad=false, so they should agree exactly; the bound allows a few units in
#: the last place of each dtype.  udeb_year is held to exact equality.
KERNEL_TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5)}
EXACT = (0.0, 0.0)
#: each adjoint kernel against its explicit twin, which performs the kernel's
#: operations in the kernel's order: held to exact equality
TWIN_TOL = EXACT
#: each adjoint kernel against autograd of the plain forward, which sums the
#: cotangents by PyTorch's backward formulas and in its own order: in
#: float64 within KERNEL_TOL; in float32 the two orders round apart on the
#: scalar rows' cotangents (sums of ~1,200 terms a member) by up to 1.9e-5
#: at B = 100,000, n = 50 and 5.3e-5 at B = 512, n = 348 in absolute terms
#: (H100), on elements below 1 in size, so KERNEL_TOL's rtol stands and
#: atol is set just above the larger reading.  (At the float32 layer limits
#: of 792 / 813 the adjoint first read 1.4e-4 from autograd at 792 (H100):
#: its one running sum of kappa's cotangent over all the year's rows lay
#: five times further from the float64 derivative than autograd's (on the
#: CPU).  Its sums over a month's rows now enter the year's once a month,
#: as tests/test_torch_adjoint.py holds at 400 layers, and read 1.5e-5 /
#: 1.1e-5 there.)
AUTOGRAD_TOL = {"float64": KERNEL_TOL["float64"], "float32": (1e-5, 1e-4)}
#: the derivative kernels' batches: a MAP gradient (one walker), one walker's
#: eight forward-mode directions, 64 NUTS chains x 8, and the ensemble's
GRAD_BATCHES = (1, 8, 512, N_MEMBERS)

_T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - _T0:9.2f} s] {msg}", flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name} ...")

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"phase {self.name}: {status} in {time.perf_counter() - self.t:.2f} s")
        return False


def check_close(what, got, want, rtol, atol):
    """Max abs error of ``got`` against ``want``; raises beyond the tolerance."""
    import torch

    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    max_abs = float(diff.max())
    log(f"  {what}: max abs err {max_abs:.3e} (rtol {rtol:g}, atol {atol:g})")
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel and plain version disagree (max abs err {max_abs:.3e})")
    return max_abs


#: each reference's result, by the name of its function, once collected
_REFERENCE_RESULTS = {}


class References:
    """The plain-engine re-runs that the paths' checks hold the kernels to
    (the ``ref_*`` functions of this module: each needs nothing of the run
    but its seeds), each in a worker process of its own on the card, at
    most REFERENCE_WORKERS at once.  Started after the build, they run while
    the kernels phase checks the kernels, which times nothing, and
    :meth:`collect` waits for them before anything is timed; leaving the
    ``with`` block stops every worker."""

    def __init__(self, jobs):
        self.jobs, self.pool, self.pending = jobs, None, {}

    def __enter__(self):
        import multiprocessing

        if self.jobs:
            workers = min(len(self.jobs), REFERENCE_WORKERS)
            self.pool = multiprocessing.get_context("spawn").Pool(workers)
            self.pending = {job.__name__: self.pool.apply_async(run_reference, (job,))
                            for job in self.jobs}
            log(f"  {len(self.jobs)} references started in {workers} worker processes")
        return self

    def collect(self):
        for name, result in self.pending.items():
            wall, _REFERENCE_RESULTS[name] = result.get(timeout=REFERENCE_TIMEOUT)
            log(f"  reference {name}: {wall:.3f} s in its worker")
        self.pending = {}
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
            self.pool = None

    def __exit__(self, *exc):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
        return False


def reference(name, device=None):
    """The collected result of reference ``name`` (on ``device``)."""
    value = _REFERENCE_RESULTS[name]
    if device is None:
        return value
    if isinstance(value, dict):
        return {k: v.to(device) for k, v in value.items()}
    return value.to(device)


def run_reference(job):
    """A worker's reference run: ``job()``, and its wall."""
    import torch

    t = time.perf_counter()
    value = job()
    torch.cuda.synchronize()
    return time.perf_counter() - t, value


def udeb_plain_run(years, erf, params, sweep):
    """ClimateUDEB as :func:`build_udeb_model` builds it, through the plain
    versions of both kernels, for the members of ``sweep``: their surface
    temperature on the host."""
    from rscm_tpu_torch.parallel import EnsembleRunner

    plain = EnsembleRunner(build_udeb_model(years, erf, {**params, "month_engine": "torch"}))
    return plain.run(plain.batched_params(sweep),
                     out_vars=["Surface Temperature"])["Surface Temperature"].cpu()


def magicc_plain_run(model_kwargs, sweep, out_vars):
    """``build_magicc_model(**model_kwargs)`` through the plain versions of
    both kernels, for the members of ``sweep``: ``out_vars`` on the host."""
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.parallel import EnsembleRunner

    plain = EnsembleRunner(build_magicc_model(**model_kwargs,
                                              udeb_params={"month_engine": "torch"}))
    out = plain.run(plain.batched_params(sweep), out_vars=out_vars)
    return {name: out[name].cpu() for name in out_vars}


def ref_main():
    base, years, erf, sweep, _ = main_inputs()
    return udeb_plain_run(years, erf, base, {k: v[:MAIN_CHECKED] for k, v in sweep.items()})


def ref_second():
    base, years, erf, sweep = second_inputs()
    return udeb_plain_run(years, erf, base, {k: v[:SECOND["checked"]] for k, v in sweep.items()})


def ref_magicc():
    sweep = magicc_sweep(MAGICC["members"])
    return magicc_plain_run({"ocean_params": MAGICC_OCEAN},
                            {n: v[:MAGICC["checked"]] for n, v in sweep.items()}, MAGICC_OUT)


def ref_fullmagicc():
    options, sweep = fullmagicc_inputs()
    return magicc_plain_run(options, {n: v[:FULLMAGICC["checked"]] for n, v in sweep.items()},
                            FULLMAGICC_OUT)


def ref_calib_log_prob():
    """The calibrate phase's 1,024 prior walkers' log posterior through the
    kernels, as one batch, and for the first CALIB["checked"] with a finite
    one, through the plain engines as one batch: their indices and the
    latter."""
    import torch

    calib = calib_problem()
    walkers = calib_walkers(calib)
    with torch.no_grad():
        lp = calib_log_prob(calib, calib.target)(walkers)
        idx = torch.nonzero(torch.isfinite(lp))[:CALIB["checked"], 0]
        plain = calib_log_prob(calib_plain_runner(calib), calib.target)(walkers[idx])
    return idx.cpu(), plain.cpu()


def ref_cut_log_prob():
    """The same at the 1850-1900 cut, for the first CALIB["checked"] of the
    first 4 x CALIB["checked"] walkers with a finite log posterior there,
    those walkers as one batch through each."""
    import torch

    walkers = calib_walkers(calib_problem())
    cut = calib_problem(CALIB["cut_last_year"])
    k = CALIB["checked"]
    with torch.no_grad():
        lp = calib_log_prob(cut, cut.target)(walkers[:4 * k])
        idx = torch.nonzero(torch.isfinite(lp))[:k, 0]
        plain = calib_log_prob(calib_plain_runner(cut), cut.target)(walkers[idx])
    return idx.cpu(), plain.cpu()


def ref_cut_gradient():
    return calib_plain_gradient(CALIB["cut_last_year"])


def ref_full_central_differences():
    return central_differences(None)


#: each phase's references
REFERENCE_JOBS = {
    "main": (ref_main,), "second": (ref_second,), "magicc": (ref_magicc,),
    "fullmagicc": (ref_fullmagicc,),
    "calibrate": (ref_calib_log_prob, ref_cut_gradient, ref_full_central_differences,
                  ref_cut_log_prob),
}


#: one IEEE division and one multiplication per dtype, built with the kernels'
#: flags: the SASS difference is what a division costs in instructions
DIVISION_PROBE = r"""
extern "C" __global__ void div_f64(const double* a, const double* b, double* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x; o[i] = a[i] / b[i]; }
extern "C" __global__ void mul_f64(const double* a, const double* b, double* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x; o[i] = a[i] * b[i]; }
extern "C" __global__ void div_f32(const float* a, const float* b, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x; o[i] = a[i] / b[i]; }
extern "C" __global__ void mul_f32(const float* a, const float* b, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x; o[i] = a[i] * b[i]; }
"""


def start_division_probe(build):
    """Start ``nvcc`` on the division probe; returns ``(process, cubin)``."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "division_probe.cu"
    src.write_text(DIVISION_PROBE)
    cubin = build.BUILD_DIR / "division_probe.cubin"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [build._nvcc(), *flags, "-cubin", "-o", str(cubin), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), cubin


#: the arithmetic instructions of each dtype's FMA pipe, which the issue
#: rate counts; a division's other instructions (its reciprocal seed on the
#: special-function unit, its range checks, its branch) issue to other pipes
FMA_PIPE = {"float64": ("DADD", "DMUL", "DFMA"), "float32": ("FADD", "FMUL", "FFMA")}


def sass_opcodes(sass):
    """``{function: [opcode, ...]}`` of a ``cuobjdump -sass`` listing, each
    function's instructions up to its first unpredicated EXIT."""
    import re

    ops, name, done = {}, None, False
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name, done = fn.group(1), False
            ops[name] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is None or done or not ins:
            continue
        words = ins.group(1).split()
        opcode = words[1] if words[0].startswith("@") else words[0]
        ops[name].append(opcode)
        if words[0] == "EXIT":
            done = True
    return ops


def division_instructions(probe):
    """What an IEEE division takes per dtype, from the probe's SASS:
    ``{dtype: (instructions, FMA-pipe instructions)}``, each the division
    kernel's count up to its exit less the multiplication kernel's, plus
    the one multiplication."""
    proc, cubin = probe
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the division probe:\n{out}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    ops = sass_opcodes(sass)
    out = {}
    for dn, sfx in (("float64", "f64"), ("float32", "f32")):
        div, mul = ops[f"div_{sfx}"], ops[f"mul_{sfx}"]

        def fma_pipe(listing):
            return sum(op.split(".")[0] in FMA_PIPE[dn] for op in listing)

        out[dn] = (len(div) - len(mul) + 1, fma_pipe(div) - fma_pipe(mul) + 1)
    return out


def cuda_ms(fn, reps):
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA events:
    the stream's span, so it includes any gap the host leaves between
    launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, kernel, reps):
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, over ``reps`` calls of ``fn``, from torch.profiler: the
    kernel alone, without the host's launch overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a cycle of ``reps`` calls while tracing starts, then the recorded one:
    # the profiler can miss the first launches of a trace (PyTorch 2.11 on
    # the H100 recorded 9 of 20 short lamcalc launches without this)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    if len(rows) > 1 or (rows and rows[0].count > reps):
        raise AssertionError(f"profiler found {[(e.key, e.count) for e in rows]} for {kernel}")
    if rows and rows[0].count >= reps // 2:
        # the mean over the launches the profiler recorded
        return rows[0].self_device_time_total / 1e3 / rows[0].count
    # the profiler missed the launches (PyTorch 2.11 on the H100 recorded
    # none of 20 short lamcalc launches in one run): CUDA events around the
    # launches queued behind a spin kernel, so that the card runs them back
    # to back and the span is theirs alone
    log(f"  the profiler recorded {rows[0].count if rows else 0} of {reps} {kernel} launches: "
        f"timed by CUDA events behind a spin kernel instead")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    log(f"card: {smi} | torch device: {torch.cuda.get_device_name(0)} | "
        f"devices: {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build(smi):
    import torch

    from rscm_tpu_torch.ops import build
    from rscm_tpu_torch.ops.udeb_month import kernel_config

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from the sources, always
    t = time.perf_counter()
    probe = start_division_probe(build)
    reports = build.build_all(["udeb_year", "lamcalc"])
    div_instr = division_instructions(probe)
    log(f"  built {sorted(reports)} with nvcc {' '.join(build.NVCC_FLAGS)} "
        f"in {time.perf_counter() - t:.2f} s")
    for name, report in sorted(reports.items()):
        for line in build.ptxas_summary(report):
            log(f"  {name}: {line} [{smi}]")
    for dn, (total, pipe) in div_instr.items():
        log(f"  an IEEE division in {dn} takes {total} instructions, {pipe} of them on the "
            f"{dn[5:]}-bit FMA pipe (SASS of the division probe)")
    # the tangent kernel at a gradient's batch and at the ensemble's: its
    # library keeps c' in shared memory for the first, in device memory
    # through a ring for the second
    for dtype in (torch.float64, torch.float32):
        for kernel, b in (("udeb_year", 0), ("udeb_year_jvp", 512), ("udeb_year_jvp", N_MEMBERS),
                          ("udeb_year_vjp", 0)):
            for n in (50, SECOND["n_layers"]):
                c = kernel_config(n, dtype, kernel=kernel, b=b)
                warps = c["threads"] * c["blocks_per_sm"] // 32
                at = (f" at B={b} ({jvp_layout(n, b, dtype)})" if kernel == "udeb_year_jvp"
                      else "")
                log(f"  {kernel} occupancy{at}, {str(dtype)[6:]}, n={n}: {c['threads']} threads "
                    f"a block, {c['shared_bytes']} shared bytes a block, {c['blocks_per_sm']} "
                    f"blocks ({warps} warps) resident per SM [{smi}]")
    return div_instr


def jvp_layout(n, b, dtype):
    """Where the tangent kernel keeps its c' in a launch of ``b`` members, as
    its library picks it."""
    from rscm_tpu_torch.ops.udeb_month import kernel_config

    c = kernel_config(n, dtype, kernel="udeb_year_jvp", b=b)
    return "c' in shared memory" if c["scratch"] == 0 else "c' through the ring"


def udeb_inputs(b, dtype, seed, n_layers=50, per_member_profile=False):
    """Kernel inputs as the main path builds them: packed scalar rows from a
    default ClimateUDEB with swept ECS/kappa, warm ocean columns, the shared
    initial profile as a broadcast view (or, with ``per_member_profile``, a
    contiguous profile perturbed per member)."""
    import numpy as np
    import torch

    from rscm_tpu_torch.magicc import ClimateUDEB
    from rscm_tpu_torch.ops.udeb_month import static_from_component

    comp = ClimateUDEB(n_layers=n_layers)
    rng = np.random.default_rng(seed)
    n = comp.n_layers

    def u(lo, hi):
        return rng.uniform(lo, hi, b)

    rows = [
        u(0.5, 2.5), u(1.0, 3.0), u(0.4, 1.5), np.full(b, comp.kappa_dkdt),
        np.full(b, comp.kappa_min_m2_per_yr()), np.full(b, comp.w_initial),
        np.full(b, comp.w_variable_fraction), np.full(b, comp.k_lo), np.full(b, comp.k_ns),
        np.full(b, comp.k_lg), np.full(b, comp.amplify_ocean_to_land),
        np.full(b, comp.polar_sinking_ratio), np.full(b, comp.temp_adjust_alpha),
        np.full(b, comp.temp_adjust_gamma), np.full(b, comp.max_temperature),
        np.full(b, comp.ground_heat_capacity()), u(0.0, 8.0), u(0.0, 8.0), np.full(b, 1.0),
        np.full(b, comp.w_threshold_temp_nh), np.full(b, comp.w_threshold_temp_sh),
    ]
    dev = dict(dtype=dtype, device=DEVICE)
    scal = torch.tensor(np.stack(rows), **dev)
    ocean = torch.tensor(rng.uniform(0.0, 4.0, (2 * n, b)), **dev)
    init = torch.tensor(np.asarray(comp.create_initial_state()["initial_ocean_profile"]), **dev)
    init = init.reshape(2 * n, 1).expand(2 * n, b)
    if per_member_profile:
        init = init + torch.tensor(rng.uniform(-0.2, 0.2, (2 * n, b)), **dev)
    vec = torch.tensor(np.concatenate([
        rng.uniform(0.0, 4.0, (4, b)), rng.uniform(-0.5, 0.5, (2, b)),
        rng.uniform(1.0, 3.5, (2, b)), rng.uniform(1.0, 1.04, (2, b)),
    ]), **dev)
    return static_from_component(comp, 1.0), scal, ocean, init, vec


def lamcalc_inputs(b, dtype, seed, fallback_every=64):
    """(6, B) LAMCALC inputs with the main path's ECS spread; every
    ``fallback_every``-th member asks for an unreachable land/ocean warming
    ratio and takes the fallback (none when it is 0)."""
    import numpy as np
    import torch

    from rscm_tpu_torch.magicc import ClimateUDEB
    from rscm_tpu_torch.magicc.climate.lamcalc import LamcalcParams
    from rscm_tpu_torch.ops.lamcalc_kernel import lam_static

    comp = ClimateUDEB()
    fgno, fgnl, fgso, fgsl = comp.global_box_fractions()
    params = LamcalcParams(
        q_2xco2=comp.rf_2xco2, k_lo=comp.k_lo, k_ns=comp.k_ns, ecs=comp.ecs, rlo=comp.rlo,
        amplify_ocean_to_land=comp.amplify_ocean_to_land,
        fgno=fgno, fgnl=fgnl, fgso=fgso, fgsl=fgsl, rf_regions_co2=tuple(comp.rf_regions_co2),
    )
    st = lam_static(params, (comp.lambda_ocean, comp.lambda_land, comp.matrix_inverse,
                             comp.co2_internal_efficacy))
    rng = np.random.default_rng(seed)
    rlo = np.full(b, comp.rlo)
    if fallback_every:
        rlo[::fallback_every] = 100.0
    packed = torch.tensor(np.stack([
        rng.uniform(1.8, 5.5, b), np.full(b, comp.rf_2xco2), np.full(b, comp.k_lo),
        np.full(b, comp.k_ns), rlo, np.full(b, comp.amplify_ocean_to_land),
    ]), dtype=dtype, device=DEVICE)
    return st, packed


def phase_kernels(smi, div_instr, refs):
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc, lamcalc_plain_with_iterations
    from rscm_tpu_torch.ops.udeb_month import max_kernel_layers, udeb_year, udeb_year_plain

    def check_udeb(b, dtype, dname, n_layers, per_member_profile=False):
        st, scal, ocean, init, vec = udeb_inputs(b, dtype, seed=b + n_layers, n_layers=n_layers,
                                                 per_member_profile=per_member_profile)
        if per_member_profile != (init.stride(1) != 0):
            raise AssertionError(f"initial profile strides {init.stride()}")
        ko, kv = udeb_year(st, scal, ocean, init, vec)
        po, pv = udeb_year_plain(st, scal, ocean, init, vec)
        torch.cuda.synchronize()
        what = f"udeb_year {dname} B={b} n={n_layers}"
        if per_member_profile:
            what += " per-member profile"
        return max(check_close(f"{what} ocean", ko, po, *EXACT),
                   check_close(f"{what} vec", kv, pv, *EXACT))

    errs = {}
    for b in (N_MEMBERS, RAGGED):
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            rtol, atol = KERNEL_TOL[dname]
            errs[("udeb_year", b, dname)] = check_udeb(b, dtype, dname, 50)

            lst, packed = lamcalc_inputs(b, dtype, seed=b)
            k = lamcalc(lst, packed)
            p, iters = lamcalc_plain_with_iterations(lst, packed)
            torch.cuda.synchronize()
            n_fallback = int((iters == 39).sum())
            if n_fallback == 0:
                raise AssertionError("lamcalc check has no fallback members")
            errs[("lamcalc", b, dname)] = check_close(
                f"lamcalc {dname} B={b} ({n_fallback} members take the fallback)",
                k, p, rtol, atol,
            )
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        limit = max_kernel_layers(dtype)
        log(f"  udeb_year takes at most {limit} layers in {dname} (the kernel's library)")
        for n_layers in (*LAYER_CHECKS, limit):
            check_udeb(RAGGED, dtype, dname, n_layers)
        for n_layers in (3, 50):
            check_udeb(RAGGED, dtype, dname, n_layers, per_member_profile=True)
        try:
            check_udeb(RAGGED, dtype, dname, limit + 1)
        except ValueError as exc:
            log(f"  n={limit + 1} in {dname} raises: {exc}")
        else:
            raise AssertionError(f"udeb_year took {limit + 1} layers in {dname}")
    errs.update(derivative_kernel_checks())
    refs.collect()  # nothing is timed while a reference runs
    derivative_records = derivative_timing(smi, div_instr)
    for record in derivative_records:
        record["max_abs_err"] = errs[(record["name"], N_MEMBERS, "float64")]
    return errs, derivative_records


def seeded(shape, dtype, seed):
    """Normal draws on the card from a seeded generator."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=DEVICE)


def derivative_kernel_checks():
    """The four derivative kernels against their plain versions on the card:
    each tangent kernel against ``plain_jvp`` of the plain forward at
    KERNEL_TOL, each adjoint kernel against its explicit twin at TWIN_TOL
    and against autograd of the plain forward at AUTOGRAD_TOL; at the
    gradients' batches and 99,997 members, over the layer counts and up to
    each kernel's layer limit (one past it raises), with a broadcast and a
    per-member initial profile, ``lamcalc`` with fallback members (zero
    derivatives), in float64 and float32.  Returns ``{(kernel, B, dtype):
    max abs err}`` against the plain versions."""
    import functools

    import torch

    from rscm_tpu_torch.ops import lamcalc_kernel as lk
    from rscm_tpu_torch.ops import udeb_month as um
    from rscm_tpu_torch.ops.plain_grad import plain_jvp

    def check_udeb(b, dtype, dname, n_layers, per_member_profile=False, jvp=True, vjp=True):
        rtol, atol = KERNEL_TOL[dname]
        st, scal, ocean, init, vec = udeb_inputs(b, dtype, seed=b + n_layers + 7,
                                                 n_layers=n_layers,
                                                 per_member_profile=per_member_profile)
        primals = (scal, ocean, init, vec)
        tangents = [seeded(x.shape, dtype, k) for k, x in enumerate(primals)]
        if not per_member_profile:  # a broadcast tangent, staged like the profile
            tangents[2] = seeded((2 * n_layers, 1), dtype, 2).expand(2 * n_layers, b)
        what = f"{dname} B={b} n={n_layers}" + (" per-member profile" if per_member_profile
                                                 else "")
        err_jvp = None
        if jvp:
            layout = jvp_layout(n_layers, b, dtype)
            got = um.udeb_year_jvp(st, primals, tangents)
            want = plain_jvp(functools.partial(um.udeb_year_plain, st), primals, tangents)
            torch.cuda.synchronize()
            err_jvp = max(check_close(f"udeb_year_jvp ({layout}) {what} {name} vs plain_jvp", g,
                                      w, rtol, atol)
                          for name, g, w in zip(("ocean", "vec"), got, want))
        if not vjp:
            return err_jvp, None
        g_ocean, g_vec = seeded(ocean.shape, dtype, 11), seeded((8, b), dtype, 12)
        got = um.udeb_year_vjp(st, *primals, g_ocean, g_vec)
        twin = um.udeb_year_vjp_plain(st, *primals, g_ocean, g_vec)
        xs = [x.detach().clone().requires_grad_(True) for x in primals]
        auto = torch.autograd.grad(um.udeb_year_plain(st, *xs), xs, (g_ocean, g_vec))
        torch.cuda.synchronize()
        err_vjp = 0.0
        for name, g, t, a in zip(("scal", "ocean", "init_prof", "vec"), got, twin, auto):
            err_vjp = max(err_vjp, check_close(f"udeb_year_vjp {what} {name} vs its twin", g, t,
                                               *TWIN_TOL))
            check_close(f"udeb_year_vjp {what} {name} vs autograd", g, a,
                        *AUTOGRAD_TOL[dname])
        return err_jvp, err_vjp

    def check_lamcalc(b, dtype, dname, fallback_every):
        rtol, atol = KERNEL_TOL[dname]
        lst, packed = lamcalc_inputs(b, dtype, seed=b + 3, fallback_every=fallback_every)
        tangent, g_out = seeded(packed.shape, dtype, 21), seeded((3, b), dtype, 22)
        got_t = lk.lamcalc_jvp(lst, packed, tangent)
        want_t = plain_jvp(functools.partial(lk.lamcalc_plain, lst), (packed,), (tangent,))
        got_g = lk.lamcalc_vjp(lst, packed, g_out)
        twin = lk.lamcalc_vjp_plain(lst, packed, g_out)
        x = packed.clone().requires_grad_(True)
        (auto,) = torch.autograd.grad(lk.lamcalc_plain(lst, x), x, g_out)
        _, iters = lk.lamcalc_plain_with_iterations(lst, packed)
        torch.cuda.synchronize()
        fallback = iters == lk.MAX_ITERATIONS - 1
        what = f"{dname} B={b} ({int(fallback.sum())} members take the fallback)"
        if bool(got_t[:, fallback].any()) or bool(got_g[:, fallback].any()):
            raise AssertionError(f"lamcalc derivatives {what}: a fallback member's is not 0")
        err_jvp = check_close(f"lamcalc_jvp {what} vs plain_jvp", got_t, want_t, rtol, atol)
        err_vjp = check_close(f"lamcalc_vjp {what} vs its twin", got_g, twin, *TWIN_TOL)
        check_close(f"lamcalc_vjp {what} vs autograd", got_g, auto, *AUTOGRAD_TOL[dname])
        return err_jvp, err_vjp

    errs = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b in (1, 512, RAGGED, N_MEMBERS):
            errs[("udeb_year_jvp", b, dname)], errs[("udeb_year_vjp", b, dname)] = check_udeb(
                b, dtype, dname, 50)
            errs[("lamcalc_jvp", b, dname)], errs[("lamcalc_vjp", b, dname)] = check_lamcalc(
                b, dtype, dname, 64 if b >= 512 else 0)
        limits = {k: um.max_kernel_layers(dtype, k)
                  for k in ("udeb_year_jvp", "udeb_year_vjp", "udeb_year_jvp_shared")}
        log(f"  layer limits in {dname} (the kernels' library): {limits}")
        # each kernel at the common layer counts and at its own limits
        for n_layers in sorted({*LAYER_CHECKS, *limits.values()}):
            check_udeb(512, dtype, dname, n_layers,
                       jvp=n_layers in LAYER_CHECKS or n_layers in (
                           limits["udeb_year_jvp"], limits["udeb_year_jvp_shared"]),
                       vjp=n_layers in LAYER_CHECKS or n_layers == limits["udeb_year_vjp"])
        for n_layers in (3, 50):
            check_udeb(RAGGED, dtype, dname, n_layers, per_member_profile=True)
        for kernel in ("udeb_year_jvp", "udeb_year_vjp"):
            limit = limits[kernel]
            st, *args = udeb_inputs(2, dtype, seed=1, n_layers=limit + 1)
            try:
                if kernel == "udeb_year_jvp":
                    um.udeb_year_jvp(st, args, [None] * 4)
                else:
                    um.udeb_year_vjp(st, *args, None, None)
            except ValueError as exc:
                log(f"  {kernel} at n={limit + 1} in {dname} raises: {exc}")
            else:
                raise AssertionError(f"{kernel} took {limit + 1} layers in {dname}")
    return errs


def read_golden(name):
    """Years, global surface temperature and config of a golden case."""
    with open(os.path.join(GOLDEN, f"{name}_config.json")) as f:
        config = json.load(f)
    with open(os.path.join(GOLDEN, f"{name}.csv"), newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader]
    meta = 7
    years = [float(h[:4]) for h in header[meta:]]
    col = {c: i for i, c in enumerate(header[:meta])}
    for r in rows:
        if r[col["variable"]] == "Surface Temperature" and r[col["region"]] == "World":
            return years, [float(v) for v in r[meta:]], config
    raise KeyError(f"{name}: no World Surface Temperature row")


def ramp_forcing_1pct(years, rf_2xco2, start_year):
    import numpy as np

    dt = np.asarray(years) - start_year
    co2_ratio = np.where(dt > 0, 1.01**dt, 1.0)
    return rf_2xco2 * np.log(co2_ratio) / np.log(2.0)


def build_udeb_model(years, erf, params):
    """ClimateUDEB driven by an exogenous ERF, as the golden regression
    test builds it (time axis from bounds, float64 forcing)."""
    import numpy as np

    from rscm_tpu_torch.core import (
        GridType, ModelBuilder, TimeAxis, Timeseries, VariableSchema,
    )
    from rscm_tpu_torch.core.spatial import ScalarGrid
    from rscm_tpu_torch.magicc import ClimateUDEB

    years = np.asarray(years, dtype=np.float64)
    axis = TimeAxis.from_bounds(np.concatenate([years, [years[-1] + 1.0]]))
    schema = VariableSchema()
    schema.add_variable("Effective Radiative Forcing", "W/m^2")
    schema.add_variable("Surface Temperature", "K", GridType.FourBox)
    schema.add_variable("Heat Uptake", "W/m^2")
    schema.add_variable("Ocean Heat Content", "J/m^2")
    schema.add_variable("Sea Surface Temperature", "K")
    return (
        ModelBuilder()
        .with_time_axis(axis)
        .with_schema(schema)
        .with_component(ClimateUDEB(**params))
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            Timeseries(np.asarray(erf, dtype=np.float64)[:, None], axis, ScalarGrid(), "W/m^2"),
        )
        .with_initial_values({"Surface Temperature": 0.0})
        .build()
    )


def main_inputs():
    """The main path's ClimateUDEB parameters, years, forcing and sweep, and
    the golden case's config."""
    import numpy as np

    _, _, config = read_golden("10_full_default")
    base = {"ecs": config["core_climatesensitivity"], "rf_2xco2": config["core_delq2xco2"]}
    years = np.arange(1850.0, 2101.0)  # 251 years, 250 steps
    erf = ramp_forcing_1pct(years, base["rf_2xco2"], config["startyear"])
    rng = np.random.default_rng(3)
    sweep = {
        "ClimateUDEB.ecs": rng.uniform(1.8, 5.5, N_MEMBERS),
        "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, N_MEMBERS),
    }
    return base, years, erf, sweep, config


def phase_main():
    import numpy as np
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    base, years, erf, sweep, config = main_inputs()
    runner = EnsembleRunner(build_udeb_model(years, erf, {**base, "month_engine": "auto"}))
    params = runner.batched_params(sweep)
    udeb_year.launches = 0
    lamcalc.launches = 0
    out = runner.run(params, out_vars=["Surface Temperature"])
    torch.cuda.synchronize()
    launches = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
    temps = out["Surface Temperature"]
    log(f"  main path: {N_MEMBERS} members x {len(years)} years; launches {launches}")
    if tuple(temps.shape) != (N_MEMBERS, len(years), 4) or not bool(torch.isfinite(temps).all()):
        raise AssertionError(f"main path output: shape {tuple(temps.shape)}, or non-finite values")
    n_steps = len(years) - 1
    if launches != {"udeb_year": n_steps, "lamcalc": n_steps}:
        raise AssertionError(f"main path launches {launches}, expected {n_steps} each")
    w = torch.tensor(FOURBOX_WEIGHTS, dtype=temps.dtype, device=temps.device)
    final = (temps[:, -1] * w).sum(-1)
    log(f"  {int(years[-1])} global warming: min {float(final.min()):.3f} K, "
        f"median {float(final.median()):.3f} K, max {float(final.max()):.3f} K")

    # 64 members again through the plain versions of both kernels (a
    # reference, ref_main).  Same arithmetic per member; the 4-box sums may
    # be reduced in another order at another batch size, so allow the last
    # bits to differ over 250 years.
    n_check = MAIN_CHECKED
    check_close(f"{n_check} members, month_engine='torch' vs the kernels",
                temps[:n_check], reference("ref_main", temps.device), 1e-10, 1e-10)

    # the golden 10_full_default case, built as tests/regression/
    # test_ocean_udeb.py::test_ocean_10_full_default builds it, on the card
    g_years, expected, _ = read_golden("10_full_default")
    golden = build_udeb_model(g_years, ramp_forcing_1pct(g_years, base["rf_2xco2"],
                                                         config["startyear"]), base)
    golden.run()
    actual = np.asarray(golden.collection.get_data("Surface Temperature").values()) @ np.asarray(
        FOURBOX_WEIGHTS)
    expected = np.asarray(expected)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(np.abs(expected) > 1e-6, (actual - expected) / expected, 0.0)
    ok = np.all(np.abs(actual - expected) <= 1e-6 + 0.1 * np.abs(expected))
    log(f"  golden 10_full_default: max rel err {np.max(np.abs(rel)):.4f} "
        f"(rtol 0.1, atol 1e-06): {'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("golden 10_full_default check failed")

    small = runner.batched_params({k: v[:n_check] for k, v in sweep.items()})
    calls, syncs = count_torch_calls(lambda: runner.run(small, out_vars=["Surface Temperature"]))
    log(f"  main path: {calls} PyTorch operator calls a run, {calls / n_steps:.1f} a year, "
        f"{syncs / n_steps:.1f} of them synchronising (at {n_check} members; the count does "
        f"not depend on the batch)")
    return runner, params, launches, n_steps


def second_inputs():
    """The second path's ClimateUDEB parameters, years, forcing and sweep."""
    import numpy as np

    _, _, config = read_golden("10_full_default")
    base = {"ecs": config["core_climatesensitivity"], "rf_2xco2": config["core_delq2xco2"],
            "n_layers": SECOND["n_layers"]}
    years = np.arange(1850.0, 2101.0)
    erf = ramp_forcing_1pct(years, base["rf_2xco2"], config["startyear"])
    rng = np.random.default_rng(4)
    b = SECOND["members"]
    sweep = {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, b),
             "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, b)}
    return base, years, erf, sweep


def phase_second_path():
    """A narrower ocean (SECOND["n_layers"] layers) through month_engine="auto":
    the kernel takes the model's own layer count."""
    import numpy as np
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    base, years, erf, sweep = second_inputs()
    b = SECOND["members"]
    runner = EnsembleRunner(build_udeb_model(years, erf, {**base, "month_engine": "auto"}))
    params = runner.batched_params(sweep)
    udeb_year.launches = 0
    lamcalc.launches = 0
    temps = runner.run(params, out_vars=["Surface Temperature"])["Surface Temperature"]
    torch.cuda.synchronize()
    launches = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
    n_steps = len(years) - 1
    log(f"  second path: {b} members x {len(years)} years, {SECOND['n_layers']} layers, "
        f"month_engine='auto'; launches {launches}")
    if tuple(temps.shape) != (b, len(years), 4) or not bool(torch.isfinite(temps).all()):
        raise AssertionError(f"second path output: shape {tuple(temps.shape)}, or non-finite values")
    if launches != {"udeb_year": n_steps, "lamcalc": n_steps}:
        raise AssertionError(f"second path launches {launches}, expected {n_steps} each")
    k = SECOND["checked"]
    check_close(f"second path: {k} members, month_engine='torch' vs the kernels",
                temps[:k], reference("ref_second", temps.device), 1e-10, 1e-10)


def profile_main(runner, params, wall, smi, out_vars=("Surface Temperature",),
                 what="main-path", n_steps=None, host_ops=True, exo=None):
    """Device time of one run by kernel, from torch.profiler, and the
    device's idle share against the run's wall time; with ``n_steps``, the
    device operations a year too.  ``host_ops=False`` records device
    activity only (tracing every host operator of a run with ~400,000 of
    them costs minutes).  Returns the busy milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        runner.run(params, exo=exo, out_vars=list(out_vars))
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): the CPU-op rows carry the
    # same device time again under the op's name
    rows = [
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for ms, _, _ in rows)
    if not rows:
        log("  profile: the profiler recorded no device time (not measured)")
        return None
    log(f"  profile of one {what} run: device busy {busy_ms:.1f} ms of a {wall * 1e3:.1f} ms "
        f"unprofiled wall (idle share {1 - busy_ms / (wall * 1e3):.3f}) on {smi}; "
        f"top device time:")
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        log(f"    {ms:9.2f} ms {ms / busy_ms:6.1%} x{count:<6d} {key[:90]}")
    if n_steps:
        launches = sum(count for _, count, _ in rows)
        log(f"  profile: {launches} device operations (kernels and copies) in the {what} run, "
            f"{launches / n_steps:.1f} a year")
    for kernel in ("udeb_year_kernel", "lamcalc_kernel"):
        for ms, count, key in rows:
            if kernel in key:
                log(f"  profile: {kernel} {ms:.2f} ms over {count} launches "
                    f"({ms / count:.4f} ms a launch) on the {what} path")
    return busy_ms


def count_torch_calls(fn):
    """PyTorch operator calls ``fn`` makes (every aten operator the
    dispatcher sees: arithmetic, views, copies, indexing), and how many of
    them made the host wait for the card (the warnings of
    ``torch.cuda.set_sync_debug_mode``: a copy from host memory, a read of a
    device value)."""
    import warnings

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with Count():
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return Count.calls, syncs


def magicc_sweep(n, seed=3):
    """The JAX package's bench sweep (``bench.py:237-246``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "ClimateUDEB.ecs": rng.uniform(1.8, 5.5, n),
        "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, n),
        "TerrestrialCarbon.beta": rng.uniform(0.3, 0.9, n),
    }


def phase_magicc(smi):
    """The ten-component MAGICC graph at 100,000 members x 251 years."""
    import numpy as np
    import torch

    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    ocean_params = MAGICC_OCEAN
    model = build_magicc_model(ocean_params=ocean_params)
    n_years = len(model.time_axis)
    n_steps = n_years - 1
    ocean = next(c for c in model.graph.nodes if type(c).__name__ == "OceanCarbon")
    engine = ocean.resolved_engine()
    log(f"  MAGICC graph: {len(model.exec_order)} nodes, {n_years} years, ocean carbon "
        f"engine {engine!r} (window {ocean.max_history_months} months, history_dtype "
        f"{ocean.history_dtype!r})")
    if engine != "expsum":
        raise AssertionError(f"the MAGICC path resolved to the {engine!r} engine")
    b = MAGICC["members"]
    sweep = magicc_sweep(b)
    runner = EnsembleRunner(model)
    params = runner.batched_params(sweep)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    udeb_year.launches = 0
    lamcalc.launches = 0
    out = runner.run(params, out_vars=MAGICC_OUT)
    torch.cuda.synchronize()
    launches = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  MAGICC path: {b} members x {n_years} years, float64, streamed (out_vars given); "
        f"launches {launches}; peak device memory {peak / 2**30:.2f} GiB on {smi}")
    if launches != {"udeb_year": n_steps, "lamcalc": n_steps}:
        raise AssertionError(f"MAGICC path launches {launches}, expected {n_steps} each")
    # the full loop (every trajectory kept) at the same batch: its peak
    # memory, and its values against the streamed run's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full = runner.run(params, stream=False)
    torch.cuda.synchronize()
    full_peak = torch.cuda.max_memory_allocated()
    log(f"  MAGICC path, full loop (stream=False): peak device memory {full_peak / 2**30:.2f} "
        f"GiB against {peak / 2**30:.2f} GiB streamed on {smi}")
    for name in MAGICC_OUT:
        assert_bit_equal(f"MAGICC {b} members {name}, streamed vs full loop", out[name],
                         full[name])
    del full
    for name, arr in out.items():
        if tuple(arr.shape)[:2] != (b, n_years) or not bool(torch.isfinite(arr).all()):
            raise AssertionError(f"MAGICC output {name}: shape {tuple(arr.shape)}, "
                                 "or non-finite values")
    temps, co2 = out["Surface Temperature"], out["Atmospheric Concentration|CO2"][..., 0]
    w = torch.tensor(FOURBOX_WEIGHTS, dtype=temps.dtype, device=temps.device)
    final = (temps[:, -1] * w).sum(-1)
    log(f"  2100: global warming min {float(final.min()):.3f} K, median "
        f"{float(final.median()):.3f} K, max {float(final.max()):.3f} K; CO2 median "
        f"{float(co2[:, -1].median()):.2f} ppm")

    # the plain versions of both kernels on the first members (the same
    # per-member arithmetic; reductions may run in another order): a
    # reference, ref_magicc
    k = MAGICC["checked"]
    plain_out = reference("ref_magicc", DEVICE)
    for name in MAGICC_OUT:
        check_close(f"MAGICC {k} members {name}, month_engine='torch' vs the kernels",
                    out[name][:k], plain_out[name], 1e-10, 1e-10)
    del plain_out

    # the ring engine's (B, N) @ (N, 12) product on the card, against its
    # exp-sum twin, in the run's dtype and with a bfloat16 history
    ring_years = np.arange(1850.0, MAGICC["ring_last_year"] + 1.0)
    ring_sweep = magicc_sweep(MAGICC["ring_members"], seed=5)
    twin = {}
    for eng, history in (("expsum", "float32"), ("ring", "float32"), ("ring", "bfloat16")):
        r = EnsembleRunner(build_magicc_model(
            years=ring_years, ocean_params={"engine": eng, "history_dtype": history}))
        twin[(eng, history)] = r.run(r.batched_params(ring_sweep), out_vars=MAGICC_OUT)
    for history, bound in sorted(RING_TWIN.items()):
        for name in MAGICC_OUT:
            a, ref = twin[("ring", history)][name], twin[("expsum", "float32")][name]
            err = float((a - ref).abs().max() / ref.abs().max())
            log(f"  ring ({history} history) vs exp-sum, {MAGICC['ring_members']} members x "
                f"{len(ring_years)} years, {name}: max |diff| / max |exp-sum| {err:.3e} "
                f"(bound {bound:g})")
            if not err < bound or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"ring ({history}) disagrees with exp-sum on {name}")
    del twin

    # timing: a warm run, its profile, and the calls a year at 64 members
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(params, out_vars=MAGICC_OUT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"  MAGICC path: warm wall {wall:.3f} s, {b * n_steps / wall:.4e} member-years/s "
        f"on {smi}")
    small = runner.batched_params({n: v[:k] for n, v in sweep.items()})
    calls, syncs = count_torch_calls(lambda: runner.run(small, out_vars=MAGICC_OUT))
    log(f"  MAGICC path: {calls} PyTorch operator calls a run, {calls / n_steps:.1f} a year, "
        f"{syncs / n_steps:.1f} of them synchronising (at {k} members; the count does not "
        f"depend on the batch)")
    del runner, params

    # the profile over the first years at the same batch: tracing the
    # ~300,000 device operations of the whole run takes a minute
    n_short = MAGICC["profile_years"]
    short = EnsembleRunner(build_magicc_model(years=np.arange(1850.0, 1850.0 + n_short),
                                              ocean_params=ocean_params))
    short_params = short.batched_params(sweep)
    short.run(short_params, out_vars=MAGICC_OUT)
    torch.cuda.synchronize()
    t = time.perf_counter()
    short.run(short_params, out_vars=MAGICC_OUT)
    torch.cuda.synchronize()
    short_wall = time.perf_counter() - t
    log(f"  MAGICC path, first {n_short} years: warm wall {short_wall:.3f} s, "
        f"{b * (n_short - 1) / short_wall:.4e} member-years/s on {smi}")
    profile_main(short, short_params, short_wall, smi, out_vars=MAGICC_OUT,
                 what=f"{n_short}-year MAGICC", n_steps=n_short - 1, host_ops=False)
    return launches


def flagship_emissions(n_years):
    """bench.py's emissions ramp (GtC / yr): slow growth, peak, decline."""
    import numpy as np

    return np.concatenate([
        np.linspace(0.0, 2.0, 100), np.linspace(2.0, 12.0, 165),
        np.linspace(12.0, 4.0, 86), np.full(max(0, n_years - 351), 4.0),
    ])[:n_years]


def build_flagship(n_years, emissions=None):
    """The flagship graph of ``bench.py:123-180``, built with the port
    (``emissions``, GtC / yr a year, in place of bench.py's ramp)."""
    import numpy as np

    from rscm_tpu_torch.components import CO2ERF, CarbonCycle, TwoLayer
    from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries, VariableSchema

    years = np.arange(1750.0, 1750.0 + n_years)
    schema = VariableSchema()
    for name, unit in [
        ("Emissions|CO2|Anthropogenic", "GtC / yr"), ("Surface Temperature", "K"),
        ("Deep Ocean Temperature", "K"), ("Atmospheric Concentration|CO2", "ppm"),
        ("Cumulative Emissions|CO2", "Gt C"), ("Cumulative Land Uptake", "Gt C"),
        ("Effective Radiative Forcing|CO2", "W/m^2"),
    ]:
        schema.add_variable(name, unit)
    schema.add_aggregate("Effective Radiative Forcing", "W/m^2", "Sum",
                         ["Effective Radiative Forcing|CO2"])
    return (
        ModelBuilder()
        .with_time_axis(TimeAxis.from_values(years))
        .with_schema(schema)
        .with_component(CarbonCycle(tau=30.0, conc_pi=278.0, alpha_temperature=0.03))
        .with_component(CO2ERF(erf_2xco2=3.93, conc_pi=278.0))
        .with_component(TwoLayer(lambda0=1.1, a=0.0, efficacy=1.3, eta=0.8,
                                 heat_capacity_surface=8.0, heat_capacity_deep=110.0))
        .with_exogenous_variable("Emissions|CO2|Anthropogenic", Timeseries.from_values(
            flagship_emissions(n_years) if emissions is None else emissions, years))
        .with_initial_values({
            "Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0,
            "Atmospheric Concentration|CO2": 278.0, "Cumulative Emissions|CO2": 0.0,
            "Cumulative Land Uptake": 0.0,
        })
        .build()
    )


def flagship_sweep(n, seed=FLAGSHIP["seed"]):
    """bench.py's four-parameter sweep (``bench.py:189-197``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "TwoLayer.lambda0": rng.uniform(0.8, 1.8, n),
        "TwoLayer.eta": rng.uniform(0.5, 1.2, n),
        "CarbonCycle.tau": rng.uniform(15.0, 60.0, n),
        "CO2ERF.erf_2xco2": rng.uniform(3.0, 4.5, n),
    }


def phase_flagship(smi):
    """The flagship graph at 100,000 members x 551 years, as bench.py runs it."""
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    model = build_flagship(FLAGSHIP["years"])
    n_years = len(model.time_axis)
    n_steps = n_years - 1
    b = FLAGSHIP["members"]
    sweep = flagship_sweep(b)
    runner = EnsembleRunner(model)
    params = runner.batched_params(sweep)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    udeb_year.launches = 0
    lamcalc.launches = 0
    t = time.perf_counter()
    out = runner.run(params, out_vars=FLAGSHIP_OUT)
    torch.cuda.synchronize()
    first = time.perf_counter() - t
    launches = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  flagship path: {len(model.exec_order)} nodes, {b} members x {n_years} years, "
        f"float64; launches {launches} (no kernel runs on this path); first run {first:.3f} s; "
        f"peak device memory {peak / 2**30:.2f} GiB on {smi}")
    if launches != {"udeb_year": 0, "lamcalc": 0}:
        raise AssertionError(f"flagship path launches {launches}, expected none")
    temps = out["Surface Temperature"]
    if tuple(temps.shape) != (b, n_years, 1) or not bool(torch.isfinite(temps).all()):
        raise AssertionError(f"flagship output: shape {tuple(temps.shape)}, or non-finite values")
    final = temps[:, -1, 0]
    log(f"  {1750 + n_years - 1}: warming min {float(final.min()):.3f} K, median "
        f"{float(final.median()):.3f} K, max {float(final.max()):.3f} K")

    k = FLAGSHIP["checked"]
    cpu = EnsembleRunner(build_flagship(n_years), device="cpu")
    cpu_out = cpu.run(cpu.batched_params({n: v[:k] for n, v in sweep.items()}),
                      out_vars=FLAGSHIP_OUT)
    for name in FLAGSHIP_OUT:
        check_close(f"flagship {k} members {name}, the card vs the CPU",
                    out[name][:k].cpu(), cpu_out[name], 1e-10, 1e-10)
    del out, temps, cpu, cpu_out

    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(params, out_vars=FLAGSHIP_OUT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"  flagship path: warm wall {wall:.3f} s, {b * n_steps / wall:.4e} member-years/s "
        f"(first run {b * n_steps / first:.4e}) on {smi}")
    del runner, params

    # the profile and the call count over the first years at the same batch:
    # tracing the ~925,000 device operations of the whole run takes minutes
    n_short = FLAGSHIP["profile_years"]
    short = EnsembleRunner(build_flagship(n_short))
    short_params = short.batched_params(sweep)
    short.run(short_params, out_vars=FLAGSHIP_OUT)
    torch.cuda.synchronize()
    t = time.perf_counter()
    short.run(short_params, out_vars=FLAGSHIP_OUT)
    torch.cuda.synchronize()
    short_wall = time.perf_counter() - t
    log(f"  flagship path, first {n_short} years: warm wall {short_wall:.3f} s, "
        f"{b * (n_short - 1) / short_wall:.4e} member-years/s on {smi}")
    profile_main(short, short_params, short_wall, smi, out_vars=FLAGSHIP_OUT,
                 what=f"{n_short}-year flagship", n_steps=n_short - 1, host_ops=False)
    small = short.batched_params({n: v[:k] for n, v in sweep.items()})
    calls, syncs = count_torch_calls(lambda: short.run(small, out_vars=FLAGSHIP_OUT))
    log(f"  flagship path: {calls} PyTorch operator calls in {n_short - 1} years, "
        f"{calls / (n_short - 1):.1f} a year, {syncs / (n_short - 1):.1f} of them "
        f"synchronising (at {k} members; the count does not depend on the batch)")


def assert_bit_equal(what, got, want):
    """``got`` and ``want`` equal bit for bit (NaN where the other has NaN)."""
    import torch

    same = (tuple(got.shape) == tuple(want.shape)
            and torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))
    log(f"  {what}: {'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError(f"{what}: not bit-equal")


def ssp_scenarios(n_years, n_scenarios):
    """bench.py's eight sine-peak emission pathways (``bench.py:398-410``),
    peaks 2-30 GtC / yr, declines 0.9-0: ``(S, n_years, 1)``."""
    import numpy as np

    ramp = np.linspace(0.0, 1.0, n_years)
    peaks = np.linspace(2.0, 30.0, n_scenarios)
    declines = np.linspace(0.9, 0.0, n_scenarios)
    return np.stack([
        np.maximum(peak * np.sin(np.pi * np.clip(ramp / (1.0 - 0.4 * dec), 0, 1)), 0.0)[:, None]
        for peak, dec in zip(peaks, declines)
    ])


def phase_scenarios(smi):
    """bench.py's parameter x scenario cross product on the flagship graph:
    10,000 members x 8 emission pathways x 551 years through ``run(exo=...)``."""
    import numpy as np
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    n, n_scen, n_years = SCENARIOS["members"], SCENARIOS["scenarios"], SCENARIOS["years"]
    b = n * n_scen
    n_steps = n_years - 1
    model = build_flagship(n_years)
    runner = EnsembleRunner(model)
    rng = np.random.default_rng(SCENARIOS["seed"])
    member = {"TwoLayer.lambda0": rng.uniform(0.8, 1.8, n),
              "CarbonCycle.tau": rng.uniform(15.0, 60.0, n)}
    params = runner.batched_params({k: np.tile(v, n_scen) for k, v in member.items()})
    scenarios = ssp_scenarios(n_years, n_scen)
    emis = "Emissions|CO2|Anthropogenic"
    # the scenario batch made on the card in bulk: (B, n_years, 1)
    exo = {emis: torch.as_tensor(scenarios, dtype=torch.float64, device=DEVICE)
           .repeat_interleave(n, dim=0)}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    udeb_year.launches = 0
    lamcalc.launches = 0
    t = time.perf_counter()
    out = runner.run(params, exo=exo, out_vars=SCENARIOS_OUT)
    torch.cuda.synchronize()
    first = time.perf_counter() - t
    launches = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  scenarios path: {n} members x {n_scen} pathways = {b} members x {n_years} years, "
        f"float64, streamed; launches {launches} (no kernel runs on this graph); first run "
        f"{first:.3f} s; peak device memory {peak / 2**30:.2f} GiB (the scenario batch "
        f"{exo[emis].numel() * 8 / 2**30:.2f} GiB of it) on {smi}")
    if launches != {"udeb_year": 0, "lamcalc": 0}:
        raise AssertionError(f"scenarios path launches {launches}, expected none")
    temps = out["Surface Temperature"]
    if tuple(temps.shape) != (b, n_years, 1) or not bool(torch.isfinite(temps).all()):
        raise AssertionError(f"scenarios output: shape {tuple(temps.shape)}, or non-finite")
    final = temps[:, -1, 0].reshape(n_scen, n)
    log(f"  2300 warming by pathway (median over members): "
        f"{[round(float(v), 3) for v in final.median(dim=1).values]} K")
    if not bool((final[-1] > final[0]).all()):
        raise AssertionError("a member is not warmer under the highest pathway than the lowest")

    # one (scenario, member) pair against a single-scenario run of the port
    s, m = SCENARIOS["spot"]
    single = EnsembleRunner(build_flagship(n_years, emissions=scenarios[s, :, 0]))
    one = single.run(single.batched_params({k: v[m:m + 1] for k, v in member.items()}),
                     out_vars=SCENARIOS_OUT)["Surface Temperature"]
    check_close(f"scenario {s} member {m} against a single-scenario run",
                temps[s * n + m], one[0], 1e-10, 0.0)

    del out, temps, single

    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(params, exo=exo, out_vars=SCENARIOS_OUT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"  scenarios path: warm wall {wall:.3f} s, {b * n_steps / wall:.4e} member-years/s "
        f"(first run {b * n_steps / first:.4e}) on {smi}")
    del runner, params

    # the profile and the calls a year over the first years at the same batch
    n_short = SCENARIOS["profile_years"]
    short = EnsembleRunner(build_flagship(n_short))
    short_params = short.batched_params({k: np.tile(v, n_scen) for k, v in member.items()})
    short_exo = {emis: exo[emis][:, :n_short]}
    short.run(short_params, exo=short_exo, out_vars=SCENARIOS_OUT)
    torch.cuda.synchronize()
    t = time.perf_counter()
    short.run(short_params, exo=short_exo, out_vars=SCENARIOS_OUT)
    torch.cuda.synchronize()
    short_wall = time.perf_counter() - t
    log(f"  scenarios path, first {n_short} years: warm wall {short_wall:.3f} s, "
        f"{b * (n_short - 1) / short_wall:.4e} member-years/s on {smi}")
    profile_main(short, short_params, short_wall, smi, out_vars=SCENARIOS_OUT,
                 what=f"{n_short}-year scenarios", n_steps=n_short - 1, host_ops=False,
                 exo=short_exo)
    # members streamed against the full loop bit for bit, and the calls a year
    k = SCENARIOS["streamed_checked"]
    tiny = short.batched_params({key: np.tile(v, n_scen)[:k] for key, v in member.items()})
    tiny_exo = {emis: short_exo[emis][:k]}
    streamed = short.run(tiny, exo=tiny_exo, out_vars=SCENARIOS_OUT)
    full = short.run(tiny, exo=tiny_exo, stream=False)
    assert_bit_equal(f"scenarios {k} members x {n_short} years, streamed vs full loop",
                     streamed["Surface Temperature"], full["Surface Temperature"])
    calls, syncs = count_torch_calls(lambda: short.run(tiny, exo=tiny_exo,
                                                       out_vars=SCENARIOS_OUT))
    log(f"  scenarios path: {calls} PyTorch operator calls in {n_short - 1} years, "
        f"{calls / (n_short - 1):.1f} a year, {syncs / (n_short - 1):.1f} of them "
        f"synchronising (at {k} members)")


def component_device_ms(solve, reps):
    """Device milliseconds of one ``solve()`` call (a component's yearly
    solve alone), from torch.profiler over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            solve()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / reps


def fullmagicc_inputs():
    """The full-options graph's options and sweep."""
    import numpy as np

    options = {"include_permafrost": True, "include_slr": True, "ocean_params": MAGICC_OCEAN}
    b = FULLMAGICC["members"]
    rng = np.random.default_rng(FULLMAGICC["seed"])
    sweep = {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, b),
             "Permafrost.arctic_amplification": rng.uniform(1.5, 2.5, b)}
    return options, sweep


def phase_fullmagicc(smi):
    """The full-options MAGICC graph (ten components + permafrost + sea-level
    rise) at 100,000 members x 251 years, as bench.py's 100k point runs it."""
    import numpy as np
    import torch

    from rscm_tpu_torch.magicc.carbon.permafrost import MT_CH4_PER_GTC
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    options, sweep = fullmagicc_inputs()
    model = build_magicc_model(**options)
    n_years = len(model.time_axis)
    n_steps = n_years - 1
    comps = {type(c).__name__: c for c in model.graph.nodes}
    engine = comps["OceanCarbon"].resolved_engine()
    log(f"  full-options graph: {len(model.exec_order)} nodes, {n_years} years, ocean carbon "
        f"engine {engine!r}, month engine {comps['ClimateUDEB'].month_engine!r}, permafrost "
        f"{comps['Permafrost'].n_bands} bands, SLR history {comps['SeaLevelRise'].max_history_steps}"
        f" steps ({comps['SeaLevelRise'].ais_sid_parameterisation})")
    if engine != "expsum":
        raise AssertionError(f"the full-options path resolved to the {engine!r} engine")
    b = FULLMAGICC["members"]
    runner = EnsembleRunner(model)
    params = runner.batched_params(sweep)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    udeb_year.launches = 0
    lamcalc.launches = 0
    t = time.perf_counter()
    out = runner.run(params, out_vars=FULLMAGICC_OUT)
    torch.cuda.synchronize()
    first = time.perf_counter() - t
    launches = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  full-options path: {b} members x {n_years} years, float64, streamed; launches "
        f"{launches}; first run {first:.3f} s; peak device memory {peak / 2**30:.2f} GiB on "
        f"{smi}")
    if launches != {"udeb_year": n_steps, "lamcalc": n_steps}:
        raise AssertionError(f"full-options path launches {launches}, expected {n_steps} each")
    for name, arr in out.items():
        if tuple(arr.shape)[:2] != (b, n_years) or not bool(torch.isfinite(arr[:, 1:]).all()):
            raise AssertionError(f"full-options output {name}: shape {tuple(arr.shape)}, or "
                                 "non-finite values from index 1")
    if not bool(torch.isfinite(out["Surface Temperature"]).all()):
        raise AssertionError("full-options Surface Temperature not finite")
    # total pool + cumulative emissions == initial pool, per member
    dt = torch.as_tensor(np.diff(model.time_axis.values()), dtype=torch.float64, device=DEVICE)
    emitted = ((out["Emissions|CO2|Permafrost"][:, 1:, 0]
                + out["Emissions|CH4|Permafrost"][:, 1:, 0] / MT_CH4_PER_GTC) * dt).cumsum(1)
    balance = out["Permafrost|Total Pool"][:, 1:, 0] + emitted
    err = float((balance - float(comps["Permafrost"].total_pool)).abs().max())
    log(f"  permafrost conservation: max |pool + cumulative emissions - "
        f"{float(comps['Permafrost'].total_pool):g}| {err:.3e} GtC over {b} members x "
        f"{n_steps} years (bound {CONSERVATION_GTC:g})")
    if not err < CONSERVATION_GTC:
        raise AssertionError(f"permafrost carbon not conserved: {err:.3e} GtC")
    w = torch.tensor(FOURBOX_WEIGHTS, dtype=torch.float64, device=DEVICE)
    final = (out["Surface Temperature"][:, -1] * w).sum(-1)
    slr = out["Sea Level Rise"][:, -1, 0]
    log(f"  2100: global warming median {float(final.median()):.3f} K, sea level rise min "
        f"{float(slr.min()):.1f} mm, median {float(slr.median()):.1f} mm, max "
        f"{float(slr.max()):.1f} mm; permafrost CO2 median "
        f"{float(out['Emissions|CO2|Permafrost'][:, -1, 0].median()):.4f} GtC/yr")

    # the plain versions of both kernels on the first members: a reference,
    # ref_fullmagicc
    k = FULLMAGICC["checked"]
    plain_out = reference("ref_fullmagicc", DEVICE)
    for name in FULLMAGICC_OUT:
        check_close(f"full-options {k} members {name}, month_engine='torch' vs the kernels",
                    out[name][:k, 1:], plain_out[name][:, 1:], 1e-10, 1e-10)
    del plain_out

    del out, balance, emitted

    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(params, out_vars=FULLMAGICC_OUT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"  full-options path: warm wall {wall:.3f} s, {b * n_steps / wall:.4e} member-years/s "
        f"(first run {b * n_steps / first:.4e}) on {smi}")
    del runner, params

    # over the first years: members streamed against the full loop bit for
    # bit, the calls a year, and the profile at the same batch
    n_short = FULLMAGICC["profile_years"]
    short = EnsembleRunner(build_magicc_model(years=np.arange(1850.0, 1850.0 + n_short),
                                              **options))
    short_params = short.batched_params(sweep)
    short.run(short_params, out_vars=FULLMAGICC_OUT)
    torch.cuda.synchronize()
    t = time.perf_counter()
    short.run(short_params, out_vars=FULLMAGICC_OUT)
    torch.cuda.synchronize()
    short_wall = time.perf_counter() - t
    log(f"  full-options path, first {n_short} years: warm wall {short_wall:.3f} s, "
        f"{b * (n_short - 1) / short_wall:.4e} member-years/s on {smi}")
    busy = profile_main(short, short_params, short_wall, smi, out_vars=FULLMAGICC_OUT,
                        what=f"{n_short}-year full-options", n_steps=n_short - 1,
                        host_ops=False)
    k = FULLMAGICC["streamed_checked"]
    small = short.batched_params({n: v[:k] for n, v in sweep.items()})
    streamed = short.run(small, out_vars=FULLMAGICC_OUT)
    full = short.run(small, stream=False)
    for name in FULLMAGICC_OUT:
        assert_bit_equal(f"full-options {k} members x {n_short} years {name}, streamed vs "
                         f"full loop", streamed[name], full[name])
    del streamed, full
    calls, syncs = count_torch_calls(lambda: short.run(small, out_vars=FULLMAGICC_OUT))
    log(f"  full-options path: {calls} PyTorch operator calls in {n_short - 1} years, "
        f"{calls / (n_short - 1):.1f} a year, {syncs / (n_short - 1):.1f} of them "
        f"synchronising (at {k} members)")

    # the permafrost and sea-level solves alone, a year each at the batch
    # (the permafrost grid: the (B, 12 * n_bands) month-major axis)
    pf = comps["Permafrost"].with_params({"arctic_amplification": torch.as_tensor(
        sweep["Permafrost.arctic_amplification"], dtype=torch.float64, device=DEVICE)})
    pf_state = {key: torch.as_tensor(np.asarray(v, dtype=np.float64), device=DEVICE)
                for key, v in pf.create_initial_state().items()}
    temp = torch.full((b,), 1.5, dtype=torch.float64, device=DEVICE)
    pf_ms = component_device_ms(lambda: pf.solve_permafrost(pf_state, temp, 1.0),
                                FULLMAGICC["component_reps"])
    slr = comps["SeaLevelRise"]
    slr_state = {key: torch.as_tensor(np.asarray(v, dtype=np.float64), device=DEVICE)
                 for key, v in slr.create_initial_state().items()}
    slr_state["t_hist"] = torch.zeros((b, slr.max_history_steps), dtype=torch.float64,
                                      device=DEVICE)
    ohc = torch.full((b,), 1e9, dtype=torch.float64, device=DEVICE)
    year = n_short - 2  # the profile's last year: the longest history product
    slr_ms = component_device_ms(
        lambda: slr.solve_slr(slr_state, temp, ohc, 1850.0 + year, year, 1.0),
        FULLMAGICC["component_reps"])
    log(f"  permafrost solve alone: {pf_ms:.3f} ms of device time a year at {b} members; "
        f"sea-level solve alone: {slr_ms:.3f} ms (year {year}) on {smi}")
    if busy:
        log(f"  permafrost share of the {n_short}-year profile's device time: "
            f"{pf_ms * (n_short - 1) / busy:.1%} ({pf_ms * (n_short - 1):.1f} of {busy:.1f} ms); "
            f"sea level at most {slr_ms * (n_short - 1) / busy:.1%}")


def phase_host_executor(smi, golden_base):
    """The step-by-step executor on the card: the flagship at one member
    against the year loop, and ClimateUDEB through ``step()``."""
    import numpy as np
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year

    n_years = FLAGSHIP["step_years"]
    loop, stepped = build_flagship(n_years), build_flagship(n_years)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t
    t = time.perf_counter()
    stepped.run(compiled=False)
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t
    log(f"  flagship, 1 member x {n_years} years on the card: year loop {loop_wall:.3f} s, "
        f"step-by-step {step_wall:.3f} s on {smi}")
    for item in loop.collection:
        if item.name == "Emissions|CO2|Anthropogenic":
            continue
        a = torch.as_tensor(np.asarray(stepped.collection.get_data(item.name).values())[1:])
        ref = torch.as_tensor(np.asarray(item.data.values())[1:])
        check_close(f"flagship {item.name}: step-by-step vs the year loop", a, ref, 1e-12, 1e-12)

    years = np.arange(1850.0, 1851.0 + HOST_UDEB_STEPS)
    erf = ramp_forcing_1pct(years, golden_base["rf_2xco2"], 1850.0)
    model = build_udeb_model(years, erf, golden_base)
    udeb_year.launches = 0
    lamcalc.launches = 0
    node = next(n for n in model.exec_order
                if type(model.graph.nodes[n]).__name__ == "ClimateUDEB")
    t = time.perf_counter()
    for k in range(HOST_UDEB_STEPS):
        if k == HOST_UDEB_STEPS - 1:  # the host state the last year starts from
            before = copy.deepcopy(model.component_states[node])
        model.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
    log(f"  ClimateUDEB, {HOST_UDEB_STEPS} steps through step() on the card in {wall:.3f} s; "
        f"launches {launches}")
    if launches != {"udeb_year": HOST_UDEB_STEPS, "lamcalc": HOST_UDEB_STEPS}:
        raise AssertionError(f"step() launches {launches}, expected {HOST_UDEB_STEPS} each")
    loop = build_udeb_model(years, erf, golden_base)
    loop.run()
    cpu = build_udeb_model(years, erf, golden_base)
    cpu.run(compiled=False, device="cpu")
    for name in ("Surface Temperature", "Heat Uptake", "Ocean Heat Content",
                 "Sea Surface Temperature"):
        got = torch.as_tensor(np.asarray(model.collection.get_data(name).values())[1:])
        for what, other in (("the year loop on the card", loop),
                            ("step-by-step on the CPU", cpu)):
            want = torch.as_tensor(np.asarray(other.collection.get_data(name).values())[1:])
            check_close(f"ClimateUDEB {name}: step() on the card vs {what}", got, want,
                        1e-10, 1e-10)
    t = time.perf_counter()
    host_methods(model, node, before, erf)
    log(f"  the host-path methods of ClimateUDEB and OceanCarbon: {time.perf_counter() - t:.3f} "
        f"s of wall on the host")

    # the host surface: checkpoints, TOML, layered configs, diagnostics
    for what, run in (("checkpoint and resume", host_checkpoint_resume),
                      ("TOML rebuild", host_toml_rebuild),
                      ("layered config and scenario input", host_layered_config),
                      ("diagnose_nans", host_diagnose_nans),
                      ("cost_analysis", lambda smi: host_cost_analysis(smi, golden_base))):
        t = time.perf_counter()
        run(smi)
        log(f"  host surface, {what}: {time.perf_counter() - t:.3f} s of wall on {smi}")


def host_methods(model, node, before, erf):
    """The eleven host-path methods of ClimateUDEB and OceanCarbon, each
    called once on host values: the ClimateUDEB ones on the host copy of the
    state ``step()`` left on the card (``before``: the state its last year
    started from).  Where the card's solve wrote the same quantity they are
    held against it at rtol 1e-10: the ocean heat content, the heat uptake
    (from the lambdas LAMCALC gives for the adjusted ECS) and the SST->air
    map of both columns.  ``solve_ocean``'s pCO2 must follow from its own
    history through ``calculate_delta_dic``."""
    import numpy as np
    import torch

    from rscm_tpu_torch.magicc.carbon.ocean import OceanCarbon

    comp = model.graph.nodes[node]
    state = model.component_states[node]
    last = HOST_UDEB_STEPS

    def written(name):
        return torch.as_tensor(np.asarray(model.collection.get_data(name).values())[last])

    def held(what, got, name):
        check_close(f"{what} on the host vs the card's {name}",
                    torch.tensor(got, dtype=torch.float64), written(name), 1e-10, 0.0)

    held("calculate_ocean_heat_content", [comp.calculate_ocean_heat_content(state)],
         "Ocean Heat Content")
    surface = written("Surface Temperature")
    air = [comp.sst_to_air_temperature(state["ocean_temps"][h][0]) for h in (0, 1)]
    check_close("sst_to_air_temperature of both columns on the host vs the card's ocean boxes",
                torch.tensor(air, dtype=torch.float64), surface[[0, 2]], 1e-10, 0.0)
    adjusted = comp.adjusted_ecs((erf[last - 1] + erf[last]) / 2.0, before)
    lam = comp._run_lamcalc(adjusted)
    forcing = comp.apply_efficacy_and_qfrac(erf[last], lam.co2_internal_efficacy)
    held("calculate_heat_uptake", [comp.calculate_heat_uptake(
        forcing, surface.numpy(), lam.lambda_ocean, lam.lambda_land)], "Heat Uptake")
    # the pieces no output shows, on a copy: one month of the northern column
    scratch = copy.deepcopy(state)
    kappas = comp.layer_diffusivities(scratch, 0)
    sst = comp.step_hemisphere(scratch, 0, forcing[0], 1.0 / 12.0, lam.lambda_ocean,
                               lam.lambda_land, scratch["hemi_heat_exchange"][0],
                               scratch["ground_temps"][0], scratch["alpha_eff"][0])
    land = comp.calculate_land_temperature(comp.sst_to_air_temperature(sst), forcing[1],
                                           comp.global_box_fractions()[1], lam.lambda_land)
    comp.update_upwelling(scratch, float(surface.numpy() @ np.asarray(comp.global_box_fractions())))
    log(f"  ClimateUDEB host pieces: adjusted ECS {adjusted:.6f} K (ecs {comp.ecs}), diffusivities "
        f"{kappas[0]:.3f}..{kappas[-1]:.3f} m2/yr, one more month: SST {sst:.6f} K, land "
        f"{land:.6f} K, upwelling {scratch['upwelling_rates'].tolist()} m/yr")
    if not (np.all(np.isfinite(kappas)) and np.isfinite(sst) and np.isfinite(land)
            and np.all(scratch["upwelling_rates"] > 0)):
        raise AssertionError("ClimateUDEB host pieces: non-finite values")

    ocean = OceanCarbon(engine="ring")
    history, pco2, cumulative, flux = ocean.solve_ocean(
        ocean.create_initial_state()["flux_history"], 400.0, 0.5, ocean.pco2_pi, 0.0, 1.0)
    implied = ocean.ocean_pco2_value(
        ocean.delta_pco2_from_dic(ocean.calculate_delta_dic(history)), 0.5)
    log(f"  OceanCarbon.solve_ocean, a year at 400 ppm: flux {flux:.6f} GtC/yr, cumulative "
        f"{cumulative:.6f} GtC, pCO2 {pco2:.6f} ppm (from its history {float(implied):.6f})")
    check_close("solve_ocean's pCO2 vs calculate_delta_dic of its history",
                torch.tensor([pco2], dtype=torch.float64),
                torch.tensor([float(implied)], dtype=torch.float64), 1e-10, 0.0)
    if not (flux > 0.0 and cumulative > 0.0 and pco2 > ocean.pco2_pi):
        raise AssertionError("OceanCarbon.solve_ocean: no uptake under elevated CO2")


def reset_launches():
    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year

    udeb_year.launches = 0
    lamcalc.launches = 0


def read_launches():
    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year

    return {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}


def expect_launches(what, n):
    launches = read_launches()
    log(f"  {what}: launches {launches}")
    if launches != {"udeb_year": n, "lamcalc": n}:
        raise AssertionError(f"{what}: launches {launches}, expected {n} each")


def trajectories(model):
    import numpy as np
    import torch

    return {item.name: torch.as_tensor(np.asarray(item.data.values()))
            for item in model.collection}


def host_checkpoint_resume(smi):
    """The ten-component MAGICC graph, one member, 1850-2100, on the card:
    ten ``step()``s, a checkpoint, a fresh model restored from it and run on
    the year loop; then an ensemble resumed from the same checkpoint."""
    import numpy as np
    import torch

    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.parallel import EnsembleRunner

    k = HOST["checkpoint_steps"]
    a = build_magicc_model()
    n_steps = len(a.time_axis) - 1
    reset_launches()
    t = time.perf_counter()
    for _ in range(k):
        a.step()
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t
    expect_launches(f"MAGICC, {k} step()s before the checkpoint", k)
    t = time.perf_counter()
    text = a.checkpoint()
    saved = json.loads(text)
    log(f"  checkpoint at index {a.time_index}: {len(text) / 1e6:.3f} MB of JSON in "
        f"{time.perf_counter() - t:.3f} s; {k} steps took {step_wall:.3f} s on {smi}")

    b = build_magicc_model()
    b.restore(saved)
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    expect_launches(f"MAGICC, restored at index {k} and run on the year loop", n_steps - k)
    log(f"  resumed run, 1 member x {n_steps - k} years on the card: {wall:.3f} s on {smi}")

    straight = build_magicc_model()
    for _ in range(k):
        straight.step()
    straight.run()
    cpu = build_magicc_model()
    for _ in range(k):
        cpu.step(device="cpu")
    cpu.run(device="cpu")
    resumed, want, on_cpu = trajectories(b), trajectories(straight), trajectories(cpu)
    differ = [name for name, got in resumed.items()
              if not (torch.equal(torch.isnan(got), torch.isnan(want[name]))
                      and torch.equal(got.nan_to_num(0.0), want[name].nan_to_num(0.0)))]
    log(f"  resumed vs stepped on without a checkpoint: {len(resumed) - len(differ)} of "
        f"{len(resumed)} trajectories bit-equal")
    if differ:
        raise AssertionError(f"resumed run not bit-equal in {differ}")
    worst = 0.0
    for name, got in resumed.items():
        other = on_cpu[name]
        ok = ~torch.isnan(other)
        if not torch.equal(torch.isnan(got), ~ok):
            raise AssertionError(f"resumed {name}: NaN where the CPU run has none, or not")
        diff = (got[ok] - other[ok]).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        if bool((diff > 1e-10 + 1e-10 * other[ok].abs()).any()):
            raise AssertionError(f"resumed {name}: off the CPU run by {float(diff.max()):.3e}")
    log(f"  every resumed trajectory within {worst:.3e} of the CPU run (rtol 1e-10, "
        f"atol 1e-10)")

    # an ensemble from the same checkpoint: ECS swept as on the MAGICC path,
    # member 0 at the model's own ECS
    resumed_model = build_magicc_model()
    resumed_model.restore(saved)
    members = HOST["resume_members"]
    ecs = magicc_sweep(members)["ClimateUDEB.ecs"]
    udeb = next(c for c in resumed_model.graph.nodes if type(c).__name__ == "ClimateUDEB")
    ecs[0] = udeb.ecs
    runner = EnsembleRunner(resumed_model)
    params = runner.batched_params({"ClimateUDEB.ecs": ecs})
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = runner.run(params, start_idx=k, out_vars=["Surface Temperature"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    expect_launches(f"ensemble resumed at index {k}, {members} members", n_steps - k)
    log(f"  ensemble resumed from the checkpoint: {members} members x {n_steps - k} years in "
        f"{wall:.3f} s, {members * (n_steps - k) / wall:.4e} member-years/s on {smi}")
    first = out["Surface Temperature"][0].cpu()
    check_close("resumed ensemble member 0 vs the resumed single-member run",
                first[1:], resumed["Surface Temperature"][1:], 1e-10, 1e-10)
    if not bool(torch.isfinite(out["Surface Temperature"][:, k + 1:]).all()):
        raise AssertionError("resumed ensemble: non-finite temperatures")


def host_toml_rebuild(smi):
    """The full-options graph rebuilt from its own TOML; both models run the
    same 10,000-member ensemble, bit-equal."""
    import numpy as np
    import torch

    from rscm_tpu_torch.core import Model
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.parallel import EnsembleRunner

    model = build_magicc_model(include_permafrost=True, include_slr=True)
    t = time.perf_counter()
    text = model.to_toml()
    rebuilt = Model.from_toml(text)
    log(f"  full-options graph through TOML ({len(text) / 1e6:.3f} MB) in "
        f"{time.perf_counter() - t:.3f} s")
    n_steps = len(model.time_axis) - 1
    members = HOST["toml_members"]
    rng = np.random.default_rng(FULLMAGICC["seed"])
    sweep = {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, members),
             "Permafrost.arctic_amplification": rng.uniform(1.5, 2.5, members)}
    outs = []
    for what, m in (("original", model), ("rebuilt", rebuilt)):
        runner = EnsembleRunner(m)
        params = runner.batched_params(sweep)
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(runner.run(params, out_vars=["Surface Temperature", "Sea Level Rise"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        expect_launches(f"full-options graph, {what}, {members} members", n_steps)
        log(f"  {what}: {members} members x {n_steps} years in {wall:.3f} s on {smi}")
    for name, got in outs[1].items():
        assert_bit_equal(f"rebuilt {name} vs the original", got, outs[0][name])


def host_layered_config(smi):
    """The two-layer model from the layered configs, its ERF from a scenario
    CSV, against the same model built by hand: a 100,000-member ensemble,
    bit-equal, no kernel."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        layered_config_run(smi, tmp)


def layered_config_run(smi, tmp):
    import numpy as np
    import torch

    from rscm_tpu_torch.components import TwoLayer
    from rscm_tpu_torch.config import build_model, load_config_layers
    from rscm_tpu_torch.core import ModelBuilder, TimeAxis, Timeseries
    from rscm_tpu_torch.core.spatial import ScalarGrid
    from rscm_tpu_torch.native.csv import native_loader
    from rscm_tpu_torch.parallel import EnsembleRunner

    years = np.arange(1750.0, 2101.0)
    erf = np.concatenate([np.linspace(0.0, 0.5, 100), np.linspace(0.5, 2.7, 175),
                          np.linspace(2.7, 4.5, 76)])
    with open(os.path.join(tmp, "erf.csv"), "w") as f:
        f.write("time,Effective Radiative Forcing\n")
        f.writelines(f"{float(t)!r},{float(v)!r}\n" for t, v in zip(years, erf))
    with open(os.path.join(tmp, "experiment.toml"), "w") as f:
        f.write('[inputs."Effective Radiative Forcing"]\nfile = "erf.csv"\nunit = "W/m^2"\n')
    t = time.perf_counter()
    config = load_config_layers(*(os.path.join(HERE, p) for p in TWO_LAYER_LAYERS),
                                os.path.join(tmp, "experiment.toml"))
    from_config = build_model(config)
    log(f"  layered config ({', '.join(TWO_LAYER_LAYERS)} + a scenario layer) built in "
        f"{time.perf_counter() - t:.3f} s; the scenario CSV read by the "
        f"{'native' if native_loader() else 'fallback Python'} loader")

    params = config["components"]["climate"]["parameters"]
    axis = TimeAxis.from_values(years)
    by_hand = (
        ModelBuilder()
        .with_time_axis(axis)
        .with_component(TwoLayer(**params))
        .with_exogenous_variable("Effective Radiative Forcing",
                                 Timeseries(erf[:, None], axis, ScalarGrid(), "W/m^2"))
        .with_initial_values({"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0})
        .build()
    )
    members = HOST["config_members"]
    rng = np.random.default_rng(HOST["config_seed"])
    sweep = {"TwoLayer.lambda0": rng.uniform(0.8, 1.8, members)}
    outs = []
    for what, m in (("from the layered config", from_config), ("built by hand", by_hand)):
        runner = EnsembleRunner(m)
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(runner.run(runner.batched_params(sweep), out_vars=["Surface Temperature",
                                                                      "Deep Ocean Temperature"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        expect_launches(f"two-layer model {what}", 0)
        log(f"  two-layer model {what}: {members} members x {len(years) - 1} years in "
            f"{wall:.3f} s, {members * (len(years) - 1) / wall:.4e} member-years/s on {smi}")
    for name, got in outs[0].items():
        assert_bit_equal(f"two-layer {name}, layered config vs by hand", got, outs[1][name])
    if not bool(torch.isfinite(outs[0]["Surface Temperature"]).all()):
        raise AssertionError("layered-config run: non-finite temperatures")


def host_diagnose_nans(smi):
    """A NaN in one exogenous input of the MAGICC graph at a known year:
    ``diagnose_nans`` on the card names that year, the first component that
    reads the input and a variable that component writes."""
    import numpy as np
    import torch

    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.utils.profiling import diagnose_nans

    model = build_magicc_model(years=np.arange(1850.0, HOST["nan_last_year"] + 1.0))
    data = model.collection.get_data(HOST["nan_input"])
    data._values[int(HOST["nan_year"] - 1850.0)] = np.nan
    data._recompute_latest()
    reader = next(node for node in model.exec_order
                  if any(spec.var_name == HOST["nan_input"] for spec in model._plan[node][0]))
    reader_name = model.graph.nodes[reader].component_name
    written = set(model._plan[reader][1])
    t = time.perf_counter()
    findings = diagnose_nans(model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"  diagnose_nans on the card ({len(model.time_axis) - 1} steps) in {wall:.3f} s on "
        f"{smi}: first finding {findings[0] if findings else None}, {len(findings)} in all")
    first = findings[0] if findings else {}
    if (first.get("time") != HOST["nan_year"] or first.get("component") != reader_name
            or first.get("variable") not in written):
        raise AssertionError(
            f"diagnose_nans: expected {HOST['nan_year']}, {reader_name} writing one of "
            f"{sorted(written)}; found {first}")


def host_cost_analysis(smi, golden_base):
    """``cost_analysis`` of ClimateUDEB's year loop on the card: the
    dispatched operators plus each kernel launch's work from its wrapper's
    formula (the roofline bound's)."""
    import numpy as np

    from rscm_tpu_torch.utils.profiling import cost_analysis

    years = np.arange(1850.0, 1851.0 + HOST_UDEB_STEPS)
    model = build_udeb_model(years, ramp_forcing_1pct(years, golden_base["rf_2xco2"], 1850.0),
                             golden_base)
    reset_launches()
    costs = cost_analysis(model)
    expect_launches(f"cost_analysis of ClimateUDEB, 1 member x {HOST_UDEB_STEPS} years",
                    HOST_UDEB_STEPS)
    log(f"  cost_analysis on the card: {costs}")
    if costs["kernel launches"] != {"udeb_year": HOST_UDEB_STEPS, "lamcalc": HOST_UDEB_STEPS}:
        raise AssertionError(f"cost_analysis saw launches {costs['kernel launches']}")


def phase_mesh(smi):
    """The batch split over a device mesh: ``make_mesh()`` (every card: one
    here) and two shards of the card (``make_mesh(devices=["cuda:0"] * 2)``),
    each against the unsplit run of the same members."""
    import numpy as np
    import torch

    from rscm_tpu_torch.calibrate import EnsembleSampler, NUTSSampler, SamplerState, WalkerInit
    from rscm_tpu_torch.magicc.calibration import magicc_calibration
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.ops import build
    from rscm_tpu_torch.parallel import EnsembleRunner, make_mesh

    def timed(what, fn, n_launches):
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        expect_launches(f"{what} ({wall:.3f} s)", n_launches)
        return out, wall

    def agree(what, split, plain):
        """Finite, the same shape, within MESH_TOL beyond index 0."""
        for name, want in plain.items():
            got = split[name]
            if tuple(got.shape) != tuple(want.shape) or not bool(torch.isfinite(got[:, 1:]).all()):
                raise AssertionError(f"{what} {name}: shape {tuple(got.shape)} against "
                                     f"{tuple(want.shape)}, or non-finite values")
            check_close(f"{what} {name}, split vs unsplit beyond index 0 "
                        f"({'bit-equal' if torch.equal(got[:, 1:], want[:, 1:]) else 'not bit-equal'})",
                        got[:, 1:], want[:, 1:], *MESH_TOL)

    one = make_mesh()
    card = torch.device("cuda", torch.cuda.current_device())
    two = make_mesh(devices=[card] * MESH["shards"])
    log(f"  make_mesh(): {one.size} device(s) {[str(d) for d in one.devices]}; the split mesh: "
        f"{[str(d) for d in two.devices]}")
    if one.size != torch.cuda.device_count():
        raise AssertionError(f"make_mesh() took {one.size} of {torch.cuda.device_count()} cards")

    # the MAGICC path on make_mesh(): bit-equal to the unsplit run
    ocean_params = {"history_dtype": "bfloat16"}
    runner = EnsembleRunner(build_magicc_model(ocean_params=ocean_params))
    n_steps = len(runner.model.time_axis) - 1
    sweep = magicc_sweep(MESH["uneven"])
    b = MESH["members"]
    even = {k: v[:b] for k, v in sweep.items()}
    plain, wall = timed(f"MAGICC {b} members x {n_steps + 1} years, unsplit",
                        lambda: runner.run(runner.batched_params(even), out_vars=MAGICC_OUT),
                        n_steps)
    split, wall_one = timed(f"MAGICC {b} members on make_mesh()", lambda: runner.run(
        runner.batched_params(even, mesh=one), mesh=one, out_vars=MAGICC_OUT),
        n_steps * one.size)
    for name in MAGICC_OUT:
        assert_bit_equal(f"MAGICC {b} members {name}, make_mesh() vs unsplit", split[name],
                         plain[name])
    log(f"  MAGICC {b} members: unsplit {wall:.3f} s, on make_mesh() {wall_one:.3f} s on {smi}")
    del plain, split

    # the uneven batch in two shards of the card: one member of padding
    b = MESH["uneven"]
    plain, wall = timed(f"MAGICC {b} members, unsplit", lambda: runner.run(
        runner.batched_params(sweep), out_vars=MAGICC_OUT), n_steps)
    split, wall_two = timed(f"MAGICC {b} members in {two.size} shards", lambda: runner.run(
        runner.batched_params(sweep, mesh=two), mesh=two, out_vars=MAGICC_OUT),
        n_steps * two.size)
    agree(f"MAGICC {b} members", split, plain)
    log(f"  MAGICC {b} members x {n_steps + 1} years: unsplit {wall:.3f} s "
        f"({b * n_steps / wall:.4e} member-years/s), {two.size} shards of the card "
        f"{wall_two:.3f} s ({b * n_steps / wall_two:.4e} member-years/s, "
        f"{wall_two / wall:.2f}x) on {smi}")
    del plain, split, runner

    # the full-options graph
    b = MESH["fullmagicc_members"]
    full = EnsembleRunner(build_magicc_model(
        years=np.arange(1850.0, MESH["fullmagicc_last_year"] + 1.0), include_permafrost=True,
        include_slr=True, ocean_params=ocean_params))
    n_steps = len(full.model.time_axis) - 1
    rng = np.random.default_rng(FULLMAGICC["seed"])
    fsweep = {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, b),
              "Permafrost.arctic_amplification": rng.uniform(1.5, 2.5, b)}
    plain, wall = timed(f"full-options {b} members, unsplit", lambda: full.run(
        full.batched_params(fsweep), out_vars=FULLMAGICC_OUT), n_steps)
    split, wall_two = timed(f"full-options {b} members in {two.size} shards", lambda: full.run(
        full.batched_params(fsweep, mesh=two), mesh=two, out_vars=FULLMAGICC_OUT),
        n_steps * two.size)
    agree(f"full-options {b} members", split, plain)
    log(f"  full-options {b} members x {n_steps + 1} years: unsplit {wall:.3f} s, "
        f"{two.size} shards {wall_two:.3f} s on {smi}")
    del plain, split, full

    # the scenario cross product: the batched exo rows split with the members
    n, n_scen, n_years = MESH["scenario_members"], SCENARIOS["scenarios"], MESH["scenario_years"]
    b = n * n_scen
    scen = EnsembleRunner(build_flagship(n_years))
    rng = np.random.default_rng(SCENARIOS["seed"])
    member = {"TwoLayer.lambda0": rng.uniform(0.8, 1.8, n),
              "CarbonCycle.tau": rng.uniform(15.0, 60.0, n)}
    params = scen.batched_params({k: np.tile(v, n_scen) for k, v in member.items()})
    exo = {"Emissions|CO2|Anthropogenic": torch.as_tensor(
        ssp_scenarios(n_years, n_scen), dtype=torch.float64, device=DEVICE
    ).repeat_interleave(n, dim=0)}
    plain, wall = timed(f"scenarios {b} members x {n_years} years, unsplit",
                        lambda: scen.run(params, exo=exo, out_vars=SCENARIOS_OUT), 0)
    split, wall_two = timed(f"scenarios {b} members in {two.size} shards", lambda: scen.run(
        params, exo=exo, mesh=two, out_vars=SCENARIOS_OUT), 0)
    agree(f"scenarios {b} members", split, plain)
    log(f"  scenarios {b} members x {n_years} years: unsplit {wall:.3f} s, {two.size} shards "
        f"{wall_two:.3f} s on {smi}")
    del plain, split, scen, exo

    # the device-engine sampler: the same seed gives the same chain
    years = np.arange(1850.0, MESH["sampler_last_year"] + 1.0)
    calib = magicc_calibration(years=years)
    cut_steps = len(years) - 1
    its, walkers = MESH["iterations"], MESH["walkers"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    runs = {}
    for label, mesh in (("unsplit", None), (f"{two.size} shards", two)):
        sampler = EnsembleSampler(calib.params, calib.runner, calib.likelihood, calib.target)
        path = str(build.BUILD_DIR / f"mesh_{label.replace(' ', '_')}")
        chain, wall = timed(
            f"ensemble sampler, {walkers} walkers x {its} iterations, {label}",
            lambda: sampler.run_with_checkpoint(
                n_iterations=its, init=WalkerInit.from_prior(), thin=1, checkpoint_every=its,
                checkpoint_path=path, n_walkers=walkers, seed=21, engine="device", mesh=mesh),
            cut_steps * (1 + 2 * its) * (1 if mesh is None else mesh.size))
        state = SamplerState.load_checkpoint(path + ".state")
        runs[label] = (chain, state)
        log(f"  ensemble sampler {label}: {wall:.3f} s, {walkers * (1 + its) / wall:.1f} model "
            f"evaluations a second, acceptance {state.mean_acceptance_rate():.4f} on {smi}")
    (chain, state), (s_chain, s_state) = runs.values()
    samples, s_samples = chain.flat_samples(discard=0), s_chain.flat_samples(discard=0)
    if samples.shape != (its * walkers, len(calib.param_names)) or not np.all(np.isfinite(s_samples)):
        raise AssertionError(f"split sampler chain: shape {s_samples.shape}, or non-finite")
    check_close("ensemble sampler chain, split vs unsplit", torch.as_tensor(s_samples),
                torch.as_tensor(samples), *MESH_TOL)
    # the log posteriors: a shard's values must be those of its walkers run
    # as a batch of their own, bit for bit; against the whole batch they
    # may differ where the model's thresholds (LAMCALC's convergence, its
    # fallback) turn a last-place difference of a reduction whose order
    # depends on the batch size into another branch: those are logged
    lp, s_lp = chain.flat_log_probs(), s_chain.flat_log_probs()
    lp_fn = EnsembleSampler(calib.params, calib.runner, calib.likelihood,
                            calib.target)._build_device_log_prob()
    final = calib.runner.as_theta(s_state.positions)
    half = walkers // two.size
    with torch.no_grad():
        whole = lp_fn(final)
        split = lp_fn(final, mesh=two)
        shards = torch.cat([lp_fn(final[k * half:(k + 1) * half]) for k in range(two.size)])
    assert_bit_equal(f"log posterior of the final {walkers} walkers in {two.size} shards vs the "
                     f"same shards run as batches of their own", split, shards)
    for what, a, b in (("the final walkers, split vs one batch", split.cpu().numpy(),
                        whole.cpu().numpy()),
                       ("the chains' log posteriors, split vs unsplit", s_lp, lp)):
        finite = np.isfinite(a) & np.isfinite(b)
        rel = np.abs(a[finite] - b[finite]) / np.maximum(np.abs(b[finite]), 1e-300)
        log(f"  {what}: {int((rel > 1e-10).sum())} of {a.size} beyond rtol 1e-10, max relative "
            f"difference {rel.max(initial=0.0):.3e}, "
            f"{int((np.isfinite(a) != np.isfinite(b)).sum())} differ in finiteness")
    if not np.array_equal(state.n_accepted, s_state.n_accepted):
        raise AssertionError(f"acceptance counts differ: {state.n_accepted.sum()} against "
                             f"{s_state.n_accepted.sum()}")
    log(f"  split sampler: the same acceptance counts ({int(state.n_accepted.sum())} of "
        f"{int(state.n_proposed.sum())} proposals)")
    del calib, runs

    # NUTS with its chains split over the shards (reverse-mode gradients)
    years = np.arange(1850.0, MESH["nuts_last_year"] + 1.0)
    nuts_cut = magicc_calibration(years=years)
    nuts = NUTSSampler(nuts_cut.params, nuts_cut.runner, nuts_cut.likelihood, nuts_cut.target,
                       max_tree_depth=CALIB["nuts_depth"], grad_mode="rev")
    c, d = MESH["nuts_chains"], len(nuts_cut.param_names)
    init = nuts_cut.theta_true * (
        1.0 + 0.01 * np.random.default_rng(6).uniform(-1.0, 1.0, (c, d)))
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    chain = nuts.run(n_iterations=1, n_chains=c, warmup=1, seed=5, init_positions=init,
                     step_size=CALIB["nuts_step_size"], mesh=two)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    diag = nuts.last_diagnostics
    expect_launches(f"NUTS, {c} chains in {two.size} shards",
                    (len(years) - 1) * diag["n_gradient_evals"] * two.size)
    samples = chain.flat_samples()
    log(f"  NUTS, {c} chains in {two.size} shards, depth {CALIB['nuts_depth']}, 1 warmup + 1 "
        f"transition, {len(years)} years: {wall:.3f} s, {diag['n_gradient_evals']} batched "
        f"value-and-gradient evaluations ({wall / diag['n_gradient_evals']:.3f} s each), "
        f"{diag['n_divergences']} divergences on {smi}")
    if samples.shape != (c, d) or not np.all(np.isfinite(samples)):
        raise AssertionError(f"split NUTS samples: shape {samples.shape}, or non-finite")


def phase_timing(smi, runner, params, launches, n_steps, errs, div_instr, derivative_records):
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import (
        lamcalc, lamcalc_plain, lamcalc_plain_with_iterations, lamcalc_work,
    )
    from rscm_tpu_torch.ops.udeb_month import udeb_year, udeb_year_plain, udeb_year_work

    # main path: wall (host clock, ends in a synchronize) and device span
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    runner.run(params, out_vars=["Surface Temperature"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    span = start.elapsed_time(end) / 1e3
    log(f"  main path: wall {wall:.3f} s, CUDA-event span {span:.3f} s, "
        f"{N_MEMBERS * n_steps / wall:.4e} member-years/s on {smi}")

    profile_main(runner, params, wall, smi, host_ops=False)

    records = []
    b, dtype, dname = N_MEMBERS, torch.float64, "float64"

    st, scal, ocean, init, vec = udeb_inputs(b, dtype, seed=1)
    ms = kernel_device_ms(lambda: udeb_year(st, scal, ocean, init, vec), "udeb_year_kernel", 20)
    call_ms = cuda_ms(lambda: udeb_year(st, scal, ocean, init, vec), 20)
    plain_ms = cuda_ms(lambda: udeb_year_plain(st, scal, ocean, init, vec), 2)
    *flops, nbytes = udeb_year_work(st, scal, ocean, init, vec)
    records.append(("udeb_year", "rscm_tpu_torch/csrc/udeb_year.cu",
                    "rscm_tpu/ops/udeb_month.py:400", ms, call_ms, plain_ms, flops, nbytes,
                    dname))

    # timed on the main path's kind of input: every member converges (the
    # fallback members of the check above hold whole warps for 39 iterations)
    lst, packed = lamcalc_inputs(b, dtype, seed=1, fallback_every=0)
    ms = kernel_device_ms(lambda: lamcalc(lst, packed), "lamcalc_kernel", 20)
    call_ms = cuda_ms(lambda: lamcalc(lst, packed), 20)
    plain_ms = cuda_ms(lambda: lamcalc_plain(lst, packed), 2)
    # the kernel stops each member when it converges: the work counts the
    # iterations each member of this batch needs
    *flops, nbytes = lamcalc_work(lst, packed)
    records.append(("lamcalc", "rscm_tpu_torch/csrc/lamcalc.cu",
                    "rscm_tpu/ops/lamcalc_kernel.py:252", ms, call_ms, plain_ms, flops, nbytes,
                    dname))

    # a batch where every 64th member never converges: a warp runs as long
    # as its slowest member (39 iterations)
    fst, fpacked = lamcalc_inputs(b, dtype, seed=2, fallback_every=64)
    fb_ms = kernel_device_ms(lambda: lamcalc(fst, fpacked), "lamcalc_kernel", 20)
    _, fb_iters = lamcalc_plain_with_iterations(fst, fpacked)
    log(f"  lamcalc with every 64th member on the fallback ({int((fb_iters == 39).sum())} "
        f"members, {float(fb_iters.double().mean()):.2f} iterations a member): {fb_ms:.4f} "
        f"ms/launch on the device (profiler) at B={b} {dname} on {smi}; all converging: "
        f"{ms:.4f} ms")

    # udeb_year in float32 at the same shape, for the record
    st32, scal32, ocean32, init32, vec32 = udeb_inputs(b, torch.float32, seed=1)
    ms32 = kernel_device_ms(lambda: udeb_year(st32, scal32, ocean32, init32, vec32),
                            "udeb_year_kernel", 20)
    log(f"  udeb_year float32: {ms32:.4f} ms/launch on the device at B={b}, n=50 on {smi}")

    kernels = []
    for name, source, replaces, ms, call_ms, plain_ms, (other, divs), nbytes, dn in records:
        bound_ms, bound_by = log_bound(name, b, dn, ms, call_ms, plain_ms, other, divs, nbytes,
                                       div_instr, smi)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[(name, N_MEMBERS, "float64")],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    return kernels + derivative_records


def log_bound(name, b, dn, ms, call_ms, plain_ms, other, divs, nbytes, div_instr, smi):
    """The least time the card could take for a launch's work, logged beside
    the kernel's: ``(bound ms, "operations" or "bytes")``."""
    div_total, div_pipe = div_instr[dn]
    ops = other + divs * div_pipe
    t_ops = ops / ISSUE_RATE[dn] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    earlier = max((other + divs) / PEAK_FLOPS[dn] * 1e3, t_bytes)
    plain = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    log(f"  {name}: {ms:.4f} ms/launch on the device ({call_ms:.4f} ms a call back to "
        f"back, host launch included), plain {plain}, bound {bound_ms:.4g} ms "
        f"by {bound_by} ({other:.4e} add/mul-class operations + {divs:.4e} divisions x "
        f"{div_pipe} FMA-pipe instructions, {nbytes:.4e} B; the kernel at "
        f"{bound_ms / ms:.1%} of its bound; {earlier:.4f} ms by the earlier rule, every "
        f"operation one at {PEAK_FLOPS[dn]:.3g}/s; "
        f"{(other + divs * div_total) / ISSUE_RATE[dn] * 1e3:.4f} ms with every "
        f"instruction of a division at the issue rate) at B={b} {dn} on {smi}")
    return bound_ms, bound_by


def derivative_timing(smi, div_instr):
    """The four derivative kernels a launch at the gradients' batches
    (GRAD_BATCHES, n = 50), each beside its bound (in float32 at B =
    100,000 only): ``udeb_year``'s in float64 and float32, ``lamcalc``'s
    in float64; at B = 100,000 in float64 also beside its plain version
    (``plain_jvp`` of the plain forward, or the adjoint's twin), for the
    ``kernels`` line."""
    import functools

    import torch

    from rscm_tpu_torch.ops import lamcalc_kernel as lk
    from rscm_tpu_torch.ops import udeb_month as um
    from rscm_tpu_torch.ops.plain_grad import plain_jvp

    records, readings = [], {}
    for dt, dn in ((torch.float64, "float64"), (torch.float32, "float32")):
        for b in GRAD_BATCHES:
            reps = 20 if b < N_MEMBERS else 5
            st, scal, ocean, init, vec = udeb_inputs(b, dt, seed=1)
            primals = (scal, ocean, init, vec)
            tangents = (seeded(scal.shape, dt, 1), seeded(ocean.shape, dt, 2), None,
                        seeded(vec.shape, dt, 3))
            g_ocean, g_vec = seeded(ocean.shape, dt, 4), seeded((8, b), dt, 5)
            runs = {
                "udeb_year_jvp": (
                    lambda: um.udeb_year_jvp(st, primals, tangents),
                    lambda: plain_jvp(functools.partial(um.udeb_year_plain, st), primals,
                                      tangents),
                    lambda: um.udeb_year_jvp_work(st, *primals),
                    "rscm_tpu_torch/csrc/udeb_year.cu", "rscm_tpu/ops/udeb_month.py:542"),
                "udeb_year_vjp": (
                    lambda: um.udeb_year_vjp(st, *primals, g_ocean, g_vec),
                    lambda: um.udeb_year_vjp_plain(st, *primals, g_ocean, g_vec),
                    lambda: um.udeb_year_vjp_work(st, *primals, g_ocean, g_vec),
                    "rscm_tpu_torch/csrc/udeb_year.cu", "rscm_tpu/ops/udeb_month.py:542"),
            }
            if dn == "float64":
                lst, packed = lamcalc_inputs(b, dt, seed=1, fallback_every=0)
                tangent, g_out = seeded(packed.shape, dt, 6), seeded((3, b), dt, 7)
                runs.update({
                    "lamcalc_jvp": (
                        lambda: lk.lamcalc_jvp(lst, packed, tangent),
                        lambda: plain_jvp(functools.partial(lk.lamcalc_plain, lst), (packed,),
                                          (tangent,)),
                        lambda: lk.lamcalc_jvp_work(lst, packed),
                        "rscm_tpu_torch/csrc/lamcalc.cu", "rscm_tpu/ops/lamcalc_kernel.py:317"),
                    "lamcalc_vjp": (
                        lambda: lk.lamcalc_vjp(lst, packed, g_out),
                        lambda: lk.lamcalc_vjp_plain(lst, packed, g_out),
                        lambda: lk.lamcalc_vjp_work(lst, packed, g_out),
                        "rscm_tpu_torch/csrc/lamcalc.cu", "rscm_tpu/ops/lamcalc_kernel.py:317"),
                })
            log(f"  udeb_year_jvp at B={b} {dn} n=50 runs as "
                f"{jvp_layout(50, b, dt)}")
            for name, (kernel, plain, work, source, replaces) in runs.items():
                ms = kernel_device_ms(kernel, f"{name}_kernel", reps)
                call_ms = cuda_ms(kernel, reps)
                # the plain versions are host-bound at every batch: timed once
                full = b == N_MEMBERS and dn == "float64"
                plain_ms = cuda_ms(plain, 1) if full else None
                if dn == "float64" or b == N_MEMBERS:
                    other, divs, nbytes = work()
                    bound_ms, bound_by = log_bound(name, b, dn, ms, call_ms, plain_ms, other,
                                                   divs, nbytes, div_instr, smi)
                else:  # a float32 bound at a gradient's batch is microseconds: not counted
                    log(f"  {name}: {ms:.4f} ms/launch on the device ({call_ms:.4f} ms a call "
                        f"back to back, host launch included) at B={b} {dn} on {smi}")
                readings.setdefault((name, dn), []).append((ms, bound_ms))
                if full:
                    records.append({
                        "name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None,
                    })
    for (name, dn), rows in readings.items():
        layers = ", n=50" if name.startswith("udeb") else ""
        log(f"  {name} {dn}{layers}: ms a launch at B = "
            f"{' / '.join(str(b) for b in GRAD_BATCHES)}: "
            f"{' / '.join(f'{ms:.4f}' for ms, _ in rows)}; at B={GRAD_BATCHES[-1]} "
            f"{rows[-1][1] / rows[-1][0]:.1%} of its bound {rows[-1][1]:.4f} ms on {smi}")
    return records


def backward_ms(grad, smi, what, reps=2):
    """One call of ``grad`` (a kernel's derivative at B = 1), timed alone:
    ``(device ms, wall ms)`` a call, from torch.profiler (every device
    operation of the calls, over the calls) and from the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    grad()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        grad()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / reps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            grad()
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps
    if device == 0.0:
        # the profiler can record none of a short call's launches (see
        # kernel_device_ms): CUDA events around calls queued behind a spin
        # kernel, so that the card runs them back to back
        log(f"  {what}: the profiler recorded no device time; timed by CUDA events behind a "
            f"spin kernel instead")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(reps):
            grad()
        end.record()
        torch.cuda.synchronize()
        device = start.elapsed_time(end) / reps
    log(f"  {what}: {device:.3f} ms of device time and {wall:.3f} ms of wall a call on {smi}")
    return device, wall


def calib_problem(last_year=None, **kwargs):
    """The MAGICC calibration problem (``magicc_calibration``) over its own
    axis, 1850-2100, or over 1850-``last_year``."""
    import numpy as np

    from rscm_tpu_torch.magicc.calibration import magicc_calibration

    if last_year is None:
        return magicc_calibration(**kwargs)
    return magicc_calibration(years=np.arange(1850.0, last_year + 1.0), **kwargs)


def calib_plain_runner(c):
    """``c`` with its runner through the plain versions of both kernels."""
    import numpy as np

    from rscm_tpu_torch.calibrate import CompiledModelRunner
    from rscm_tpu_torch.magicc.calibration import MAGICC_PARAM_SPECS
    from rscm_tpu_torch.magicc.coupled import build_magicc_model

    years = np.asarray(c.runner.model.time_axis.values())
    return dataclasses.replace(c, runner=CompiledModelRunner(
        build_magicc_model(years=years, ocean_params={"history_dtype": "bfloat16"},
                           udeb_params={"month_engine": "torch"}),
        param_map={n: MAGICC_PARAM_SPECS[n][0] for n in c.param_names},
        output_variables=c.runner.output_variables))


def calib_objective(c, target):
    from rscm_tpu_torch.calibrate import EstimateKind, PointEstimator

    return PointEstimator(c.params, c.runner, c.likelihood, target)._traced_objective(
        EstimateKind.MAP)


def calib_log_prob(c, target):
    from rscm_tpu_torch.calibrate import EnsembleSampler

    return EnsembleSampler(c.params, c.runner, c.likelihood, target)._build_device_log_prob()


def calib_walkers(c):
    """The calibrate phase's CALIB["walkers"] prior walkers (seed 11)."""
    import numpy as np

    return c.runner.as_theta(c.params.sample_random(CALIB["walkers"],
                                                    np.random.default_rng(11)))


def check_reference_walkers(name, idx):
    """The walkers reference ``name`` ran through the plain engines are
    those this run chose."""
    got = reference(name)[0]
    if len(got) != len(idx) or not bool((got == idx.cpu()).all()):
        raise AssertionError(f"{name} ran walkers {got.tolist()}, not {idx.tolist()}")


def calib_plain_gradient(last_year):
    """The MAP objective's reverse-mode gradient at the truth on the
    calibration problem through the plain engines, on the host."""
    from rscm_tpu_torch.calibrate.gradients import value_and_grad

    c = calib_problem(last_year)
    _, grad = value_and_grad(calib_objective(calib_plain_runner(c), c.target),
                             c.runner.as_theta(c.theta_true[None]), "rev")
    return grad[0].cpu()


def derivative_launches():
    """Each kernel's wrapper by name, with ``plain_jvp`` (whose calls count
    derivatives of a plain version)."""
    from rscm_tpu_torch.ops import lamcalc_kernel as lk
    from rscm_tpu_torch.ops import udeb_month as um

    return {"udeb_year": um.udeb_year, "lamcalc": lk.lamcalc,
            "udeb_year_jvp": um.udeb_year_jvp, "lamcalc_jvp": lk.lamcalc_jvp,
            "udeb_year_vjp": um.udeb_year_vjp, "lamcalc_vjp": lk.lamcalc_vjp}


def central_differences(last_year):
    """On the calibration problem over 1850-``last_year`` with the flux
    history in float64 (through a bfloat16 history the forward is flat
    between roundings at a step of 1e-6 of a prior span: on the CPU at
    1850-1890 such differences miss the gradient by 0.33 of its largest
    component, by 1.1e-8 in float64): the MAP objective's reverse-mode
    gradient at the truth through the kernels, each kernel's launches in
    it, and central differences of the 2d walkers one step of
    CALIB["fd_rel_step"] of each prior span either side of the truth, in
    one batched run; on the host."""
    import numpy as np
    import torch

    from rscm_tpu_torch.calibrate.gradients import value_and_grad
    from rscm_tpu_torch.ops.plain_grad import plain_jvp

    fine = calib_problem(last_year, model_kwargs={"ocean_params": {"history_dtype": "float32"}})
    fine_obj = calib_objective(fine, fine.target)
    counters = derivative_launches()
    for fn in counters.values():
        fn.launches = 0
    plain_jvp.calls = 0
    _, grad = value_and_grad(fine_obj, fine.runner.as_theta(fine.theta_true[None]), "rev")
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["plain_jvp"] = plain_jvp.calls
    d = len(fine.param_names)
    lower, upper = map(np.asarray, fine.params.bounds())
    h = CALIB["fd_rel_step"] * (upper - lower)
    steps = np.diag(h)
    points = fine.runner.as_theta(np.concatenate([fine.theta_true + steps,
                                                  fine.theta_true - steps]))
    with torch.no_grad():
        vals = fine_obj(points)
    fd = (vals[:d] - vals[d:]) / (2.0 * torch.as_tensor(h, dtype=vals.dtype, device=vals.device))
    return grad[0].cpu(), fd.cpu(), launches


def check_central_differences(what, grad, fd):
    fd_err = float((fd - grad).abs().max() / grad.abs().max())
    log(f"  {what}: max |fd - grad| / max |grad| {fd_err:.3e} (bound 1e-3)")
    if not fd_err < 1e-3:
        raise AssertionError(f"{what}: the gradient disagrees with central differences "
                             f"({fd_err:.3e})")


def phase_calibrate(smi):
    """The MAGICC calibration at full width through the port's entry points."""
    import functools

    import numpy as np
    import torch
    import torch.autograd.forward_ad as fwAD

    from rscm_tpu_torch.calibrate import (
        AdamOptimizer, Chain, DEMove, EnsembleSampler, NUTSSampler, PointEstimator,
        SamplerState, StretchMove, WalkerInit,
    )
    from rscm_tpu_torch.magicc.calibration import magicc_calibration
    from rscm_tpu_torch.ops import build
    from rscm_tpu_torch.ops import lamcalc_kernel as lk
    from rscm_tpu_torch.ops import udeb_month as um
    from rscm_tpu_torch.ops.plain_grad import plain_jvp

    counters = derivative_launches()

    def reset():
        for fn in counters.values():
            fn.launches = 0
        plain_jvp.calls = 0

    def expect(what, n, jvp=0, vjp=0):
        """Each forward kernel launched n times, each tangent kernel jvp
        times, each adjoint vjp times, and no derivative of a plain version
        taken on the card."""
        got = {name: fn.launches for name, fn in counters.items()}
        want = {"udeb_year": n, "lamcalc": n, "udeb_year_jvp": jvp, "lamcalc_jvp": jvp,
                "udeb_year_vjp": vjp, "lamcalc_vjp": vjp}
        log(f"  {what}: launches {got}, plain_jvp calls {plain_jvp.calls}")
        if got != want or plain_jvp.calls != 0:
            raise AssertionError(f"{what}: launches {got} and {plain_jvp.calls} plain_jvp "
                                 f"calls, expected {want} and none")
        return got

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    t = synced()
    calib = magicc_calibration()  # 1850-2100, eight parameters, float64, on the card
    n_steps = len(calib.runner.model.time_axis) - 1
    d = len(calib.param_names)
    log(f"  calibration problem: {d} parameters, {n_steps + 1} years, "
        f"{calib.target.total_observations()} observations; built (with its truth run) in "
        f"{synced() - t:.2f} s")
    objective, log_prob = calib_objective, calib_log_prob

    # 1. the log posterior of 1024 walkers as one batched run
    b = CALIB["walkers"]
    walkers = calib_walkers(calib)
    lp_fn = log_prob(calib, calib.target)
    with torch.no_grad():
        reset()
        t = synced()
        lp = lp_fn(walkers)
        wall = synced() - t
        expect(f"log posterior of {b} walkers", n_steps)
        finite = torch.isfinite(lp)
        n_finite = int(finite.sum())
        log(f"  log posterior of {b} prior walkers: wall {wall:.3f} s, {b / wall:.1f} model "
            f"evaluations a second, {n_finite} finite (a failed run is -inf), median "
            f"{float(lp.median()):.4e} on {smi}")
        if bool(torch.isnan(lp).any()) or n_finite < 0.99 * b or bool((lp == np.inf).any()):
            raise AssertionError(f"log posterior: {b - n_finite} walkers not finite")
        # the first walkers with a finite posterior, through the plain
        # engines (a reference, ref_calib_log_prob)
        k = CALIB["checked"]
        idx = torch.nonzero(finite)[:k, 0]
        check_reference_walkers("ref_calib_log_prob", idx)
        check_close(f"log posterior of {k} walkers, month_engine='torch' vs the kernels",
                    lp[idx], reference("ref_calib_log_prob")[1].to(lp.device), 1e-10, 0.0)
        for i in torch.nonzero(~finite)[:, 0].tolist():
            log(f"  walker {i} (-inf): {dict(zip(calib.param_names, walkers[i].tolist()))}")

    # 2. the MAP objective's gradient at the truth, reverse mode, through the
    # kernels, and its checks, at the 1850-1900 cut (through the plain
    # engines a 251-year gradient would take minutes): against the plain
    # engines, forward mode along a seeded unit direction, and central
    # differences; then the same gradient over 1850-2100, and central
    # differences there
    cut_years = np.arange(1850.0, CALIB["cut_last_year"] + 1.0)
    cut = calib_problem(CALIB["cut_last_year"])
    cut_steps = len(cut_years) - 1
    cut_obj = objective(cut, cut.target)
    cut_theta = cut.runner.as_theta(cut.theta_true[None])
    torch.cuda.reset_peak_memory_stats()
    reset()
    with torch.enable_grad():
        x = cut_theta.clone().requires_grad_(True)
        t = synced()
        value = cut_obj(x)
        t_fwd = synced() - t
        (cut_grad,) = torch.autograd.grad(value.sum(), x)
        t_bwd = synced() - t - t_fwd
    peak = torch.cuda.max_memory_allocated()
    grad_launches = expect(f"gradient at the truth, {cut_steps + 1} years, reverse mode",
                           cut_steps, vjp=cut_steps)
    grad = cut_grad[0]
    log(f"  gradient at the truth, reverse mode, {cut_steps + 1} years: forward with the tape "
        f"{t_fwd:.3f} s, backward {t_bwd:.3f} s, peak device memory {peak / 2**30:.3f} GiB on "
        f"{smi}; objective {float(value[0].detach()):.10e}, gradient {grad.tolist()}")
    if not bool(torch.isfinite(grad).all()) or not bool((grad != 0).all()):
        raise AssertionError(f"gradient {grad.tolist()}")
    # the same gradient through the plain engines (a reference, ref_cut_gradient)
    check_close(f"gradient at {cut_steps + 1} years, month_engine='torch' vs the kernels",
                cut_grad[0], reference("ref_cut_gradient", cut_grad.device), 1e-9, 0.0)
    # and, beside the 1,024-walker batch's check, the log posterior at the
    # cut of the first walkers with a finite one there, as one batch of the
    # same walkers through the kernels and through the plain engines (at
    # another batch size a reduction may round otherwise, and LAMCALC's
    # thresholds turn that into another branch: see the mesh phase)
    k = CALIB["checked"]
    with torch.no_grad():
        idx = torch.nonzero(torch.isfinite(log_prob(cut, cut.target)(walkers[:4 * k])))[:k, 0]
        if len(idx) < k:
            raise AssertionError(f"log posterior at the cut: {4 * k - len(idx)} of the first "
                                 f"{4 * k} walkers not finite")
        check_reference_walkers("ref_cut_log_prob", idx)
        check_close(f"log posterior of {k} walkers at {cut_steps + 1} years, one batch each, "
                    "month_engine='torch' vs the kernels", log_prob(cut, cut.target)(walkers[idx]),
                    reference("ref_cut_log_prob")[1].to(walkers.device), 1e-10, 0.0)

    v = np.random.default_rng(17).normal(size=d)
    v = cut.runner.as_theta(v / np.linalg.norm(v))
    reset()
    t = synced()
    with torch.no_grad(), fwAD.dual_level():
        jvp = fwAD.unpack_dual(cut_obj(fwAD.make_dual(cut_theta, v[None]))).tangent[0]
    t_jvp = synced() - t
    jvp_launches = expect("forward-mode run at the cut", cut_steps, jvp=cut_steps)
    gv = (cut_grad[0] * v).sum()
    scale = float(cut_grad.abs().max())
    log(f"  forward mode along a seeded direction, {cut_steps + 1} years: jvp {float(jvp):.10e}, "
        f"grad . v {float(gv):.10e}, {t_jvp:.3f} s on {smi}")
    if not abs(float(jvp - gv)) <= 2e-2 * abs(float(gv)) + 1e-6 * scale:
        raise AssertionError("forward and reverse mode disagree beyond the bfloat16 bar")

    # central differences with the flux history in float64
    fine_grad, fd, _ = central_differences(CALIB["cut_last_year"])
    check_central_differences(
        f"central differences, {cut_steps + 1} years, flux history in float64 ({2 * d} "
        f"walkers in one batched run, step {CALIB['fd_rel_step']:g} of each prior span)",
        fine_grad, fd)
    lower, upper = map(np.asarray, cut.params.bounds())

    # the same gradient over the whole 1850-2100 axis (the calibration
    # problem's own), reverse mode: the forward with its tape and the
    # backward, 250 launches of each forward kernel and each adjoint
    full_obj = objective(calib, calib.target)
    full_theta = calib.runner.as_theta(calib.theta_true[None])
    torch.cuda.reset_peak_memory_stats()
    reset()
    with torch.enable_grad():
        x = full_theta.clone().requires_grad_(True)
        t = synced()
        value = full_obj(x)
        t_full_fwd = synced() - t
        (full_grad,) = torch.autograd.grad(value.sum(), x)
        t_full_bwd = synced() - t - t_full_fwd
    peak = torch.cuda.max_memory_allocated()
    expect(f"gradient at the truth, {n_steps + 1} years, reverse mode", n_steps, vjp=n_steps)
    log(f"  gradient at the truth, reverse mode, {n_steps + 1} years: forward with the tape "
        f"{t_full_fwd:.3f} s, backward {t_full_bwd:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB on {smi}; objective {float(value[0].detach()):.10e}, "
        f"gradient {full_grad[0].tolist()}")
    if not bool(torch.isfinite(full_grad).all()) or not bool((full_grad != 0).all()):
        raise AssertionError(f"gradient over {n_steps + 1} years: {full_grad[0].tolist()}")
    del full_obj
    # the 250 adjoints chained: the same gradient with the flux history in
    # float64 against central differences (a reference,
    # ref_full_central_differences, which runs the kernels in its worker)
    what = (f"central differences, {n_steps + 1} years, flux history in float64 ({2 * d} "
            f"walkers in one batched run, step {CALIB['fd_rel_step']:g} of each prior span)")
    fine_grad, fd, launches = reference("ref_full_central_differences")
    log(f"  {what}: the gradient's launches {launches}")
    want = {**{name: n_steps for name in counters}, "udeb_year_jvp": 0, "lamcalc_jvp": 0,
            "plain_jvp": 0}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    check_central_differences(what, fine_grad, fd)

    # each kernel's reverse-mode derivative alone at the gradient's batch of one
    # walker: the adjoint kernel (the Function's backward), and the plain
    # version recomputed and differentiated under autograd, the derivative
    # the card ran before the adjoint kernels (kept for one comparison)
    st, *udeb_args = udeb_inputs(1, torch.float64, seed=5)
    lst, packed = lamcalc_inputs(1, torch.float64, seed=5, fallback_every=0)
    timed = {}
    for name, fn, args in (("udeb_year", functools.partial(um.UdebYearFunction.apply, st),
                            udeb_args),
                           ("lamcalc", functools.partial(lk.LamcalcFunction.apply, lst),
                            [packed]),
                           ("udeb_year_plain", functools.partial(um.udeb_year_plain, st),
                            udeb_args),
                           ("lamcalc_plain", functools.partial(lk.lamcalc_plain, lst),
                            [packed])):
        xs = [x.detach().clone().requires_grad_(True) for x in args]
        if name.endswith("_plain"):
            def grad(fn=fn, xs=xs):
                outs = fn(*xs)
                outs = outs if isinstance(outs, tuple) else (outs,)
                return torch.autograd.grad(outs, xs, [torch.ones_like(o) for o in outs])
            what = f"{name[:-6]}'s plain version recomputed and differentiated (B=1)"
        else:
            outs = fn(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)

            def grad(outs=outs, xs=xs):
                return torch.autograd.grad(outs, xs, [torch.ones_like(o) for o in outs],
                                           retain_graph=True)
            what = f"{name}'s backward through its adjoint kernel (B=1)"
        timed[name] = backward_ms(grad, smi, what)
    log(f"  the kernels' reverse-mode derivatives in one gradient: {cut_steps} x "
        f"({timed['udeb_year'][1]:.3f} + {timed['lamcalc'][1]:.3f}) ms = "
        f"{cut_steps * (timed['udeb_year'][1] + timed['lamcalc'][1]) / 1e3:.3f} s of wall, "
        f"against {cut_steps * (timed['udeb_year_plain'][1] + timed['lamcalc_plain'][1]) / 1e3:.3f}"
        f" s through the plain versions; the backward took {t_bwd:.3f} s")

    # 3. Adam from the prior midpoint (reverse-mode gradients), at the cut
    # (bfloat16 flux history)
    est = PointEstimator(cut.params, cut.runner, cut.likelihood, cut.target)
    mid = list(0.5 * (lower + upper))
    with torch.no_grad():
        start = float(cut_obj(cut.runner.as_theta(np.asarray(mid)[None]))[0])
    n_adam = CALIB["adam_steps"]
    reset()
    t = synced()
    fit = est.optimize(AdamOptimizer(learning_rate=0.03, n_steps=n_adam, fwd_threshold=0),
                       x0=mid)
    wall = synced() - t
    expect(f"Adam, {n_adam} step(s), reverse mode", cut_steps * (n_adam + 1) + cut_steps,
           vjp=cut_steps * n_adam)
    best = np.asarray(fit.best_params)
    with torch.no_grad():
        end = float(cut_obj(cut.runner.as_theta(best[None]))[0])
    log(f"  Adam, {n_adam} step(s) from the prior midpoint, {cut_steps + 1} years, reverse "
        f"mode: objective {start:.6e} -> {end:.6e}, "
        f"{wall:.3f} s ({wall / n_adam:.3f} s a step with the final objective and the "
        f"host evaluation) on {smi}")
    if not end <= start or not np.all((lower < best) & (best < upper)):
        raise AssertionError(f"Adam rose ({start} -> {end}) or left the support: {best}")
    # the users' default: forward mode up to 32 parameters (eight directions
    # as eight members of one run)
    reset()
    t = synced()
    fit_fwd = est.optimize(AdamOptimizer(learning_rate=0.03, n_steps=n_adam), x0=mid)
    wall_fwd = synced() - t
    expect(f"Adam, {n_adam} step(s), forward mode", cut_steps * (n_adam + 1) + cut_steps,
           jvp=cut_steps * n_adam)
    best_fwd = np.asarray(fit_fwd.best_params)
    with torch.no_grad():
        end_fwd = float(cut_obj(cut.runner.as_theta(best_fwd[None]))[0])
    log(f"  Adam, {n_adam} step(s), forward mode (fwd_threshold=32, the default): objective "
        f"{start:.6e} -> {end_fwd:.6e}, {wall_fwd:.3f} s ({wall_fwd / n_adam:.3f} s a step with "
        f"the final objective and the host evaluation); its iterate against reverse mode's: "
        f"max |diff| {float(np.abs(best_fwd - best).max()):.3e} on {smi}")
    if not end_fwd <= start or not np.all((lower < best_fwd) & (best_fwd < upper)):
        raise AssertionError(f"Adam (forward mode) rose ({start} -> {end_fwd}) or left the "
                             f"support: {best_fwd}")

    # 4. the device ensemble sampler, both moves, with a checkpoint round trip
    n_it = CALIB["ensemble_iterations"]
    records = {}
    for label, move in (("stretch", StretchMove()), ("DE", DEMove())):
        sampler = EnsembleSampler(calib.params, calib.runner, calib.likelihood, calib.target,
                                  move=move)
        path = str(build.BUILD_DIR / f"calibrate_{label}")
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        reset()
        t = synced()
        chain = sampler.run_with_checkpoint(
            n_iterations=n_it, init=WalkerInit.from_prior(), thin=1, checkpoint_every=n_it,
            checkpoint_path=path, n_walkers=b, seed=21, engine="device")
        wall = synced() - t
        expect(f"ensemble sampler ({label})", n_steps * (1 + 2 * n_it))
        state = SamplerState.load_checkpoint(path + ".state")
        saved = Chain.load(path + ".chain")
        samples = chain.flat_samples()
        acc = state.mean_acceptance_rate()
        evals = b * (1 + n_it)
        log(f"  ensemble sampler, {label} move, {b} walkers x {n_it} iterations: wall "
            f"{wall:.3f} s ({wall / (1 + n_it):.3f} s an iteration with the initial batch), "
            f"{evals / wall:.1f} model evaluations a second, acceptance {acc:.4f} on {smi}")
        if samples.shape != (n_it * b, d) or not np.all(np.isfinite(samples)):
            raise AssertionError(f"{label} chain: shape {samples.shape}, or non-finite samples")
        if not 0.0 <= acc <= 1.0 or state.iteration != n_it:
            raise AssertionError(f"{label}: acceptance {acc}, iteration {state.iteration}")
        if not (np.array_equal(saved.flat_samples(), samples)
                and np.array_equal(state.positions, chain.samples[-1])):
            raise AssertionError(f"{label}: the checkpoint did not round-trip")
        records[label] = wall

    # 5. NUTS at its own 1850-1860 cut, reverse-mode gradients
    nuts_years = np.arange(1850.0, CALIB["nuts_last_year"] + 1.0)
    nuts_cut = magicc_calibration(years=nuts_years)
    nuts_steps = len(nuts_years) - 1
    c = CALIB["nuts_chains"]
    # chains start around the truth, as the JAX package's NUTS test of the
    # MAGICC graph starts them (from prior draws the first trajectories of a
    # posterior this peaked diverge at once)
    init = nuts_cut.theta_true * (
        1.0 + 0.01 * np.random.default_rng(6).uniform(-1.0, 1.0, (c, d)))
    for mode in ("rev", "auto"):  # "auto": forward mode up to 32 parameters, the default
        nuts = NUTSSampler(nuts_cut.params, nuts_cut.runner, nuts_cut.likelihood,
                           nuts_cut.target, max_tree_depth=CALIB["nuts_depth"], grad_mode=mode)
        reset()
        t = synced()
        chain = nuts.run(n_iterations=1, n_chains=c, warmup=1, seed=5, init_positions=init,
                         step_size=CALIB["nuts_step_size"])
        wall = synced() - t
        diag = nuts.last_diagnostics
        evals = nuts_steps * diag["n_gradient_evals"]
        expect(f"NUTS, grad_mode={mode!r}", evals, jvp=0 if mode == "rev" else evals,
               vjp=evals if mode == "rev" else 0)
        samples = chain.flat_samples()
        log(f"  NUTS, grad_mode={mode!r}, {c} chains, depth {CALIB['nuts_depth']}, 1 warmup + 1 "
            f"transition, {nuts_steps + 1} years: wall {wall:.3f} s, "
            f"{diag['n_gradient_evals']} batched value-and-gradient evaluations "
            f"({wall / diag['n_gradient_evals']:.3f} s each, "
            f"{wall / (diag['n_gradient_evals'] * c) * 1e3:.1f} ms a chain), "
            f"{diag['n_model_evals']} chain leapfrog steps in growing trees, "
            f"{diag['n_divergences']} divergences, step sizes median "
            f"{float(np.median(diag['step_sizes'])):.4f} on {smi}")
        if samples.shape != (c, d) or not np.all(np.isfinite(samples)):
            raise AssertionError(f"NUTS samples: shape {samples.shape}, or non-finite")
        if not 0 < diag["n_model_evals"] <= c * diag["n_leapfrog_steps"]:
            raise AssertionError(f"NUTS counted {diag['n_model_evals']} model evaluations in "
                                 f"{diag['n_leapfrog_steps']} leapfrog steps of {c} chains")
    return {
        "udeb_year": {"launches_per_gradient": cut_steps,
                      "plain_derivative_ms": timed["udeb_year_plain"][0]},
        "lamcalc": {"launches_per_gradient": cut_steps,
                    "plain_derivative_ms": timed["lamcalc_plain"][0]},
        "udeb_year_jvp": {"launches": jvp_launches["udeb_year_jvp"]},
        "lamcalc_jvp": {"launches": jvp_launches["lamcalc_jvp"]},
        "udeb_year_vjp": {"launches": grad_launches["udeb_year_vjp"]},
        "lamcalc_vjp": {"launches": grad_launches["lamcalc_vjp"]},
    }

def compat_magicc(years):
    """``build_magicc_model()``'s graph (its parameters, exogenous inputs and
    component order) assembled with the reference's idiom: each component
    from its ``compat.magicc`` builder, added with ``with_rust_component``."""
    from rscm_tpu_torch.compat import core, magicc
    from rscm_tpu_torch.magicc.coupled import (INITIAL_VALUES, build_magicc_schema,
                                               idealised_emissions)

    emissions = idealised_emissions(years)
    pi = {gas: INITIAL_VALUES[f"Atmospheric Concentration|{gas.upper()}"]
          for gas in ("co2", "ch4", "n2o")}
    builders = [
        magicc.CH4ChemistryBuilder.from_parameters({"ch4_pi": pi["ch4"]}),
        magicc.N2OChemistryBuilder.from_parameters({"n2o_pi": pi["n2o"]}),
        magicc.GhgForcingBuilder.from_parameters({
            "method": "Ipcctar", "co2_pi": pi["co2"], "ch4_pi": pi["ch4"], "n2o_pi": pi["n2o"],
            "adjust_co2": 1.0, "adjust_ch4": 1.0, "adjust_n2o": 1.0,
        }),
        magicc.OzoneForcingBuilder.from_parameters({}),
        magicc.AerosolDirectBuilder.from_parameters({}),
        magicc.AerosolIndirectBuilder.from_parameters({}),
        magicc.ClimateUDEBBuilder.from_parameters({"ecs": 3.0}),
        magicc.TerrestrialCarbonBuilder.from_parameters({}),
        magicc.OceanCarbonBuilder.from_parameters({"max_history_months": 12 * (len(years) + 1)}),
        magicc.CO2BudgetBuilder.from_parameters({}),
    ]
    axis = core.TimeAxis.from_values(years)
    builder = core.ModelBuilder().with_time_axis(axis).with_schema(
        build_magicc_schema(emissions))
    for component in builders:
        builder = builder.with_rust_component(component.build())
    for name, (values, unit) in emissions.items():
        builder = builder.with_exogenous_variable(name, core.Timeseries(values, axis, unit))
    return builder.with_initial_values(dict(INITIAL_VALUES)).build()


def compat_two_layer(years, lambda0=1.0):
    """``tests/test_rscm_compat.py``'s two-layer model through
    ``TwoLayerBuilder`` and ``with_rust_component``."""
    import numpy as np

    from rscm_tpu_torch.compat.core import ModelBuilder, TimeAxis, Timeseries
    from rscm_tpu_torch.compat.two_layer import TwoLayerBuilder

    component = TwoLayerBuilder.from_parameters({
        "lambda0": float(lambda0), "a": 0.0, "efficacy": 1.0, "eta": 0.7,
        "heat_capacity_surface": 8.0, "heat_capacity_deep": 100.0,
    }).build()
    return (
        ModelBuilder()
        .with_time_axis(TimeAxis.from_values(years))
        .with_rust_component(component)
        .with_exogenous_variable(
            "Effective Radiative Forcing",
            Timeseries(np.full(len(years), 3.7), TimeAxis.from_values(years), "W/m^2"))
        .with_initial_values({"Surface Temperature": 0.0, "Deep Ocean Temperature": 0.0})
        .build()
    )


def compat_toml_model():
    """``tests/test_rscm_compat.py``'s TOML model (``TestComponentBuilder``)."""
    import numpy as np

    from rscm_tpu_torch.compat.core import ModelBuilder, TimeAxis, Timeseries
    from rscm_tpu_torch.compat.example_components import TestComponentBuilder

    years = np.arange(2020.0, 2025.0)
    return (
        ModelBuilder()
        .with_time_axis(TimeAxis.from_values(years))
        .with_rust_component(
            TestComponentBuilder.from_parameters({"conversion_factor": 2.0}).build())
        .with_exogenous_variable(
            "Emissions|CO2", Timeseries(np.arange(5.0), TimeAxis.from_values(years), "GtCO2"))
        .build()
    )


def compat_typed_model(device):
    """A typed Python component that reads its input's history through the
    reference's ``TimeseriesWindow`` built from a tensor on ``device``:
    the previous emission plus the mean of the last three."""
    import numpy as np
    import torch

    from rscm_tpu_torch.compat.component import Component, Input, Output
    from rscm_tpu_torch.compat.core import (ModelBuilder, PythonComponent, TimeAxis, Timeseries,
                                            TimeseriesWindow)

    class Lagged(Component, register=False):
        emissions = Input("Emissions|CO2", unit="GtCO2")
        concentration = Output("Concentrations|CO2", unit="ppm")

        def solve(self, t_current, t_next, inputs):
            history = torch.as_tensor(np.asarray(inputs.emissions.values), device=device)
            window = TimeseriesWindow(history, int(inputs.emissions.current_index))
            previous = window.previous if int(window.current_index) > 0 else window.at_offset(0)
            if not (type(previous) is float and type(window.last_n(3)) is np.ndarray):
                raise AssertionError("a reference window read returned a device value")
            return self.Outputs(concentration=previous + float(np.mean(window.last_n(3))))

    years = np.arange(2020.0, 2028.0)
    return (
        ModelBuilder()
        .with_time_axis(TimeAxis.from_values(years))
        .with_py_component(PythonComponent.build(Lagged()))
        .with_exogenous_variable(
            "Emissions|CO2",
            Timeseries(np.arange(1.0, 9.0) ** 1.5, TimeAxis.from_values(years), "GtCO2"))
        .build()
    )


def compat_point_estimator(device):
    """``tests/test_rscm_compat.py``'s point estimation: lambda0 of the
    two-layer model from one observation of its truth run, through a
    ``DefaultModelRunner`` whose models run on ``device`` (None: the card)."""
    import numpy as np

    from rscm_tpu_torch.compat.calibrate import (DefaultModelRunner, GaussianLikelihood,
                                                 ParameterSet, PointEstimator, Target, Uniform)

    years = np.arange(COMPAT["two_layer_years"][0], COMPAT["two_layer_years"][1] + 1.0)
    runner = DefaultModelRunner(["lambda0"], ["Surface Temperature"],
                                lambda theta: compat_two_layer(years, theta[0]), device=device)
    truth = compat_two_layer(years, 1.2)
    truth.run(device=device)
    temps = truth.timeseries().get_timeseries_by_name("Surface Temperature")
    target = Target()
    target.add_variable("Surface Temperature").add(2010.0, float(temps.at(10)), 0.05)
    params = ParameterSet()
    params.add("lambda0", Uniform(0.8, 1.8))
    return PointEstimator(params, runner, GaussianLikelihood(), target)


def compat_window_reads(window, n_regions):
    """What the reference windows' reads return, in a comparable form, with
    each ``ValueError``'s message; fails on a read that returns a tensor."""
    import numpy as np
    import torch

    reads = {"previous": lambda: window.previous, "len": lambda: len(window)}
    if n_regions == 1:
        reads.update({f"at_offset({o})": (lambda o=o: window.at_offset(o))
                      for o in (-7, -1, 0, 1, 7)})
        reads.update({f"last_n({n})": (lambda n=n: window.last_n(n)) for n in (1, 3, 9)})
        reads["to_array"] = window.to_array
    else:
        reads.update({f"region({r})": (lambda r=r: window.region(r).to_array())
                      for r in (-1, 0, n_regions - 1, n_regions)})
        reads.update({"at_start_all": window.at_start_all, "at_end_all": window.at_end_all})
    out = {}
    for name, read in reads.items():
        try:
            value = read()
        except ValueError as exc:
            out[name] = ("raises", str(exc))
            continue
        if isinstance(value, torch.Tensor):
            raise AssertionError(f"{type(window).__name__}.{name} returned a tensor")
        if hasattr(value, "as_array"):
            value = (type(value).__name__, [float(v) for v in value.as_array()])
        elif isinstance(value, np.ndarray):
            value = ("array", value.dtype.str, value.tolist())
        out[name] = value
    return out


def compat_windows_on_card():
    """The reference windows built from CUDA tensors against the same
    windows built from numpy: the same reads, the same exceptions (the
    constructor's too)."""
    import numpy as np
    import torch

    from rscm_tpu_torch.compat import core

    rng = np.random.default_rng(11)
    n_reads = 0
    for cls, n_regions in ((core.TimeseriesWindow, 1), (core.FourBoxTimeseriesWindow, 4),
                           (core.HemisphericTimeseriesWindow, 2)):
        values = rng.normal(size=(7, n_regions))
        on_card = torch.as_tensor(values, device=DEVICE)
        for index in (0, 3, 6):
            want = compat_window_reads(cls(values, index), n_regions)
            got = compat_window_reads(cls(on_card, index), n_regions)
            if got != want:
                raise AssertionError(f"{cls.__name__} at index {index}: from a CUDA tensor "
                                     f"{got} against from numpy {want}")
            n_reads += len(got)
        for bad, index in ((values, -1), (values, 7), (np.zeros((7, n_regions + 1)), 0)):
            messages = []
            for given in (bad, torch.as_tensor(bad, device=DEVICE)):
                try:
                    cls(given, index)
                except ValueError as exc:
                    messages.append(str(exc))
            if len(messages) != 2 or messages[0] != messages[1]:
                raise AssertionError(f"{cls.__name__}({bad.shape}, {index}): {messages}")
    log(f"  reference windows from CUDA tensors: {n_reads} reads and 9 bad constructions "
        f"equal to the same windows from numpy")


def compare_runs(what, got, want, tol):
    """Every trajectory of model ``got`` against model ``want``: bit for bit
    when ``tol`` is None, else within (rtol, atol); NaN where the other has
    NaN; float64."""
    import torch

    got, want = trajectories(got), trajectories(want)
    if set(got) != set(want):
        raise AssertionError(f"{what}: variables {sorted(set(got) ^ set(want))} in one run only")
    worst = 0.0
    for name, a in got.items():
        b = want[name]
        if a.dtype != torch.float64 or a.shape != b.shape:
            raise AssertionError(f"{what} {name}: {a.dtype} {tuple(a.shape)} against "
                                 f"{b.dtype} {tuple(b.shape)}")
        ok = ~torch.isnan(b)
        if not torch.equal(torch.isnan(a), ~ok):
            raise AssertionError(f"{what} {name}: NaN where the other run has none, or not")
        diff = (a[ok] - b[ok]).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        worst = max(worst, err)
        bar = 0.0 if tol is None else tol[1] + tol[0] * b[ok].abs()
        if bool((diff > bar).any()):
            raise AssertionError(f"{what} {name}: max abs err {err:.3e}")
    log(f"  {what}: {len(got)} trajectories, max abs err {worst:.3e} "
        f"({'bit for bit' if tol is None else f'rtol {tol[0]:g}, atol {tol[1]:g}'})")


def phase_compat(smi):
    """The reference-API surface on the card, through its own names and
    with no ``device=`` given (the card is the default)."""
    import numpy as np
    import torch

    from rscm_tpu_torch.compat.calibrate import Optimizer, OptimizationResult
    from rscm_tpu_torch.compat.core import Model
    from rscm_tpu_torch.magicc.coupled import build_magicc_model

    t_phase = time.perf_counter()
    first, last = COMPAT["magicc_years"]
    years = np.arange(first, last + 1.0)
    n_steps = len(years) - 1

    cold, reference = compat_magicc(years), build_magicc_model(years=years)
    nodes = [type(c).__name__ for c in cold.graph.nodes]
    udeb = next(c for c in cold.graph.nodes if type(c).__name__ == "ClimateUDEB")
    if nodes != [type(c).__name__ for c in reference.graph.nodes] or udeb.n_layers != 50:
        raise AssertionError(f"compat MAGICC: nodes {nodes}, {udeb.n_layers} layers")
    reset_launches()
    t = time.perf_counter()
    cold.run()
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t
    expect_launches("compat MAGICC, cold run", n_steps)
    model = compat_magicc(years)
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    expect_launches("compat MAGICC, warm run", n_steps)
    log(f"  compat MAGICC (builders + with_rust_component), 1 member x {n_steps} years, "
        f"50 layers: warm run {wall:.3f} s (cold {cold_wall:.3f} s), launches {launches} "
        f"on {smi}")
    temperature = model.collection.get_data("Surface Temperature").values()
    if not np.isfinite(np.asarray(temperature)[1:]).all():
        raise AssertionError("compat MAGICC: non-finite surface temperature")
    reference.run()
    compare_runs("compat MAGICC vs build_magicc_model() on the card", model, reference, None)
    compare_runs("compat MAGICC, warm vs cold run", model, cold, None)

    tol = COMPAT["tol"]
    two_years = np.arange(2000.0, 2020.0)
    card, cpu = compat_two_layer(two_years), compat_two_layer(two_years)
    card.run()
    cpu.run(device="cpu")
    rise = card.timeseries().get_timeseries_by_name("Surface Temperature").latest_value()
    if not rise > 0.5:
        raise AssertionError(f"compat two-layer: surface temperature {rise} after 20 years")
    compare_runs("compat two-layer, card vs CPU", card, cpu, tol)

    runs = {}
    for device in (None, "cpu"):
        model_t = compat_toml_model()
        model_t.step(device=device)
        restored = Model.from_toml(model_t.to_toml())
        restored.run(device=device)
        model_t.run(device=device)
        compare_runs(f"compat TOML round trip on {device or 'the card'}, restored vs original",
                     restored, model_t, None)
        runs[device] = restored
    compare_runs("compat TOML round trip, card vs CPU", runs[None], runs["cpu"], tol)

    compat_windows_on_card()
    card, cpu = compat_typed_model(DEVICE), compat_typed_model("cpu")
    card.run()
    cpu.run(device="cpu")
    compare_runs("compat typed component (windows from CUDA tensors), card vs CPU",
                 card, cpu, tol)
    emissions = np.arange(1.0, 9.0) ** 1.5
    got = card.timeseries().get_timeseries_by_name("Concentrations|CO2").values()
    want = emissions[1] + emissions[0:3].mean()  # written at index 3 by step 2
    if abs(float(got[3]) - want) > 1e-12 * want:
        raise AssertionError(f"compat typed component at index 3: {float(got[3])} against {want}")

    t = time.perf_counter()
    estimator = compat_point_estimator(None)
    result = estimator.optimize(Optimizer.RandomSearch, COMPAT["random_search"])
    search_wall = time.perf_counter() - t
    lls = np.asarray(estimator.evaluated_log_likelihoods())
    if not (isinstance(result, OptimizationResult)
            and result.n_evaluations == COMPAT["random_search"]
            and abs(result.best_params[0] - 1.2) <= 0.25 and np.isfinite(lls).all()):
        raise AssertionError(f"compat RandomSearch: {result}, log likelihoods {lls}")
    on_cpu = compat_point_estimator("cpu")
    for theta in estimator.evaluated_params():
        on_cpu.evaluate(theta)
    check_close(f"compat RandomSearch, {len(lls)} log likelihoods: card vs CPU",
                torch.as_tensor(lls), torch.as_tensor(np.asarray(on_cpu.evaluated_log_likelihoods())),
                *tol)
    log(f"  compat PointEstimator.optimize(Optimizer.RandomSearch, {COMPAT['random_search']}): "
        f"best lambda0 {result.best_params[0]:.6f} in {search_wall:.3f} s on {smi}")
    log(f"  compat phase: {time.perf_counter() - t_phase:.3f} s of wall on {smi}")


PHASES = ("kernels", "main", "second", "magicc", "flagship", "scenarios", "fullmagicc", "host",
          "mesh", "calibrate", "compat")


def main(selected):
    unknown = set(selected) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phase(s) {sorted(unknown)}; phases: {', '.join(PHASES)}")
    run = set(selected or PHASES)
    kernels = None
    with Phase("device"):
        smi = phase_device()
    with Phase("build"):
        div_instr = phase_build(smi)
    jobs = [job for phase in PHASES if phase in run for job in REFERENCE_JOBS.get(phase, ())]
    with References(jobs) as refs:
        if "main" in run or "kernels" in run:
            with Phase("kernels"):
                errs, derivative_records = phase_kernels(smi, div_instr, refs)
        elif refs.pending:
            with Phase("references"):
                refs.collect()
        if "main" in run:
            with Phase("main"):
                runner, params, launches, n_steps = phase_main()
        if "second" in run:
            with Phase("second"):
                phase_second_path()
        if "main" in run:
            with Phase("timing"):
                kernels = phase_timing(smi, runner, params, launches, n_steps, errs, div_instr,
                                       derivative_records)
            del runner, params
        if "magicc" in run:
            with Phase("magicc"):
                phase_magicc(smi)
        if "flagship" in run:
            with Phase("flagship"):
                phase_flagship(smi)
        if "scenarios" in run:
            with Phase("scenarios"):
                phase_scenarios(smi)
        if "fullmagicc" in run:
            with Phase("fullmagicc"):
                phase_fullmagicc(smi)
        if "host" in run:
            with Phase("host"):
                _, _, config = read_golden("10_full_default")
                phase_host_executor(smi, {"ecs": config["core_climatesensitivity"],
                                          "rf_2xco2": config["core_delq2xco2"]})
        if "mesh" in run:
            with Phase("mesh"):
                phase_mesh(smi)
        if "calibrate" in run:
            with Phase("calibrate"):
                calib = phase_calibrate(smi)
            if kernels is not None:
                for record in kernels:
                    record.update(calib[record["name"]])
            else:
                log(f"  calibration records: {json.dumps(calib)}")
        if "compat" in run:
            with Phase("compat"):
                phase_compat(smi)

    import torch

    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except Exception as exc:  # report and fail: no phase failure ends in exit 0
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        raise
