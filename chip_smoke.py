#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rscm_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` on a machine with a CUDA card and ``nvcc``.

Phases, each printed with its elapsed time:

1. device  -- the card's name and power limit (``nvidia-smi``), torch versions;
2. build   -- both CUDA kernels built from ``rscm_tpu_torch/csrc`` (one ``nvcc``
              each, run together), with the ``-Xptxas -v`` register/spill report
              and ``udeb_year``'s launch configuration and occupancy; beside
              them a probe of one IEEE division per dtype, built with the same
              flags, whose SASS (``cuobjdump -sass``) gives the instructions a
              division takes;
3. kernels -- each kernel against its plain PyTorch version on the card, at
              B = 100,000 and a ragged B = 99,997, in float64 and float32, and
              ``udeb_year`` at B = 99,997 at n = 2, 3, 17, 50, 100 and its
              layer limit, and with a per-member initial profile at n = 3
              and 50; ``udeb_year`` must equal its plain version bit for bit
              and raise one layer past its limit;
4. main    -- the port's main path: a 100,000-member, 251-year ClimateUDEB
              ensemble driven by the 1pctCO2 forcing ramp, built with
              ``ModelBuilder`` and run by ``EnsembleRunner.run`` in float64;
              the launch counts of both kernels must be 250; 64 members re-run
              with the plain engine must agree; one member built as the golden
              10_full_default regression case must match the Fortran MAGICC7
              data at that test's tolerance; then a second path, 10,000
              members with 30 layers through ``month_engine="auto"``, whose
              ``udeb_year`` count must be 250 and whose first 16 members must
              agree with the plain engine;
5. timing  -- the main path's wall time and member-years/s, a torch.profiler
              breakdown of one main-path run (device activity: busy time,
              idle share), per kernel its device time per launch (profiler), the time per
              back-to-back call (CUDA events), the plain version's time and the
              least time the card could take: the larger of the bytes over
              3.35 TB/s and the operations over the issue rate without
              contraction (17e12 FP64 / 33.5e12 FP32 additions or
              multiplications a second: the kernels are built with
              ``-fmad=false``), a division counted at the FMA-pipe
              instructions it takes; and ``lamcalc``'s device time on a batch
              where every 64th member takes the fallback;
6. magicc  -- the ten-component emissions-driven MAGICC graph
              (``build_magicc_model``, 1850-2100, ``history_dtype="bfloat16"``,
              which resolves to the exp-sum ocean-carbon engine) at 100,000
              members in float64 through ``EnsembleRunner.run``, swept as the
              JAX package's bench sweeps it (ECS, kappa,
              ``TerrestrialCarbon.beta``, seed 3): both launch counts must be
              250 and every output finite; 64 members re-run with the plain
              engines must agree within 1e-10; the run streams (``out_vars``
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
              engines within 1e-10; wall, member-years/s, peak memory; over
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
              objective's reverse-mode gradient at the truth (50 forward
              launches each; walls, peak memory) and its checks: against the
              plain engines within rtol 1e-9, forward mode along a seeded
              direction at the JAX package's bfloat16 bar, and, with the flux
              history in float64, central differences of 16 perturbed
              walkers in one batched run within 1e-3 of its largest
              component; one Adam step from the prior midpoint at the cut;
              the device ensemble sampler, 1,024 walkers, two iterations
              under the stretch and the DE move, with a checkpoint round
              trip; NUTS, 64 chains, tree depth 2, one warmup iteration and
              one transition at 1850-1860; each kernel's backward (the plain
              version recomputed and differentiated) timed alone.

``python3 chip_smoke.py PHASE ...`` runs the device and build phases and the
named later phases only (``kernels`` and ``timing`` go with ``main``), e.g.
``python3 chip_smoke.py scenarios fullmagicc``.

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
#: the second main path: a narrower ocean through month_engine="auto"
SECOND = {"members": 10_000, "n_layers": 30, "checked": 16}
#: the MAGICC path: members, members re-run through the plain engines, and
#: the ring-engine check's members and last year
MAGICC = {"members": 100_000, "checked": 64, "ring_members": 10_000, "ring_last_year": 1950.0,
          "profile_years": 51}
MAGICC_OUT = ["Surface Temperature", "Atmospheric Concentration|CO2"]
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
DEVICE = "cuda"
#: kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|.  Both do
#: the same operations in the same order and the kernels are built with
#: -fmad=false, so they should agree exactly; the bound allows a few units in
#: the last place of each dtype.  udeb_year is held to exact equality.
KERNEL_TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5)}
EXACT = (0.0, 0.0)

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
    for dtype in (torch.float64, torch.float32):
        for n in (50, SECOND["n_layers"]):
            c = kernel_config(n, dtype)
            warps = c["threads"] * c["blocks_per_sm"] // 32
            log(f"  udeb_year occupancy, {str(dtype)[6:]}, n={n}: {c['threads']} threads a "
                f"block, {c['shared_bytes']} shared bytes a block, {c['blocks_per_sm']} blocks "
                f"({warps} warps) resident per SM [{smi}]")
    return div_instr


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


def phase_kernels():
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


def phase_main():
    import numpy as np
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    _, _, config = read_golden("10_full_default")
    base = {"ecs": config["core_climatesensitivity"], "rf_2xco2": config["core_delq2xco2"]}
    years = np.arange(1850.0, 2101.0)  # 251 years, 250 steps
    erf = ramp_forcing_1pct(years, base["rf_2xco2"], config["startyear"])
    rng = np.random.default_rng(3)
    sweep = {
        "ClimateUDEB.ecs": rng.uniform(1.8, 5.5, N_MEMBERS),
        "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, N_MEMBERS),
    }

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

    # 64 members again through the plain versions of both kernels.  Same
    # arithmetic per member; the 4-box sums may be reduced in another order
    # at another batch size, so allow the last bits to differ over 250 years.
    n_check = 64
    plain = EnsembleRunner(build_udeb_model(years, erf, {**base, "month_engine": "torch"}))
    plain_out = plain.run(
        plain.batched_params({k: v[:n_check] for k, v in sweep.items()}),
        out_vars=["Surface Temperature"],
    )["Surface Temperature"]
    check_close(f"{n_check} members, month_engine='torch' vs the kernels",
                temps[:n_check], plain_out, 1e-10, 1e-10)

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


def phase_second_path():
    """A narrower ocean (SECOND["n_layers"] layers) through month_engine="auto":
    the kernel takes the model's own layer count."""
    import numpy as np
    import torch

    from rscm_tpu_torch.ops.lamcalc_kernel import lamcalc
    from rscm_tpu_torch.ops.udeb_month import udeb_year
    from rscm_tpu_torch.parallel import EnsembleRunner

    _, _, config = read_golden("10_full_default")
    base = {"ecs": config["core_climatesensitivity"], "rf_2xco2": config["core_delq2xco2"],
            "n_layers": SECOND["n_layers"]}
    years = np.arange(1850.0, 2101.0)
    erf = ramp_forcing_1pct(years, base["rf_2xco2"], config["startyear"])
    rng = np.random.default_rng(4)
    b = SECOND["members"]
    sweep = {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, b),
             "ClimateUDEB.kappa": rng.uniform(0.4, 1.5, b)}
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
    plain = EnsembleRunner(build_udeb_model(years, erf, {**base, "month_engine": "torch"}))
    plain_out = plain.run(
        plain.batched_params({name: v[:k] for name, v in sweep.items()}),
        out_vars=["Surface Temperature"],
    )["Surface Temperature"]
    check_close(f"second path: {k} members, month_engine='torch' vs the kernels",
                temps[:k], plain_out, 1e-10, 1e-10)


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

    ocean_params = {"history_dtype": "bfloat16"}
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
    # per-member arithmetic; reductions may run in another order)
    k = MAGICC["checked"]
    plain = EnsembleRunner(build_magicc_model(
        ocean_params=ocean_params, udeb_params={"month_engine": "torch"}))
    plain_out = plain.run(plain.batched_params({n: v[:k] for n, v in sweep.items()}),
                          out_vars=MAGICC_OUT)
    for name in MAGICC_OUT:
        check_close(f"MAGICC {k} members {name}, month_engine='torch' vs the kernels",
                    out[name][:k], plain_out[name], 1e-10, 1e-10)
    del plain, plain_out

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

    options = {"include_permafrost": True, "include_slr": True,
               "ocean_params": {"history_dtype": "bfloat16"}}
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
    rng = np.random.default_rng(FULLMAGICC["seed"])
    sweep = {"ClimateUDEB.ecs": rng.uniform(1.8, 5.5, b),
             "Permafrost.arctic_amplification": rng.uniform(1.5, 2.5, b)}
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

    # the plain versions of both kernels on the first members
    k = FULLMAGICC["checked"]
    plain = EnsembleRunner(build_magicc_model(
        **options, udeb_params={"month_engine": "torch"}))
    plain_out = plain.run(plain.batched_params({n: v[:k] for n, v in sweep.items()}),
                          out_vars=FULLMAGICC_OUT)
    for name in FULLMAGICC_OUT:
        check_close(f"full-options {k} members {name}, month_engine='torch' vs the kernels",
                    out[name][:k, 1:], plain_out[name][:, 1:], 1e-10, 1e-10)
    del plain, plain_out

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


def phase_timing(smi, runner, params, launches, n_steps, errs, div_instr):
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
        div_total, div_pipe = div_instr[dn]
        ops = other + divs * div_pipe
        t_ops = ops / ISSUE_RATE[dn] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        earlier = max((other + divs) / PEAK_FLOPS[dn] * 1e3, t_bytes)
        log(f"  {name}: {ms:.4f} ms/launch on the device ({call_ms:.4f} ms a call back to "
            f"back, host launch included), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by} ({other:.4e} add/mul-class operations + {divs:.4e} divisions x "
            f"{div_pipe} FMA-pipe instructions, {nbytes:.4e} B; the kernel at "
            f"{bound_ms / ms:.1%} of its bound; {earlier:.4f} ms by the earlier rule, every "
            f"operation one at {PEAK_FLOPS[dn]:.3g}/s; "
            f"{(other + divs * div_total) / ISSUE_RATE[dn] * 1e3:.4f} ms with every "
            f"instruction of a division at the issue rate) at B={b} {dn} on {smi}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[(name, N_MEMBERS, "float64")],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    return kernels


def plain_backward_ms(fn, inputs, smi, what, reps=2):
    """One backward of a kernel's ``torch.autograd.Function`` (the plain
    version recomputed under autograd and differentiated), timed alone:
    ``(device ms, wall ms)`` a call, from torch.profiler (every device
    operation of the calls, over the calls) and from the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cot = [torch.ones_like(o) for o in outs]

    def backward():
        return torch.autograd.grad(outs, xs, cot, retain_graph=True)

    backward()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        backward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / reps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            backward()
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps
    log(f"  {what} backward: {device:.3f} ms of device time and {wall:.3f} ms of wall a call "
        f"on {smi}")
    return device, wall


def phase_calibrate(smi):
    """The MAGICC calibration at full width through the port's entry points."""
    import numpy as np
    import torch
    import torch.autograd.forward_ad as fwAD

    from rscm_tpu_torch.calibrate import (
        AdamOptimizer, Chain, CompiledModelRunner, DEMove, EnsembleSampler, EstimateKind,
        NUTSSampler, PointEstimator, SamplerState, StretchMove, WalkerInit,
    )
    from rscm_tpu_torch.calibrate.gradients import value_and_grad
    from rscm_tpu_torch.magicc.calibration import MAGICC_PARAM_SPECS, magicc_calibration
    from rscm_tpu_torch.magicc.coupled import build_magicc_model
    from rscm_tpu_torch.ops import build
    from rscm_tpu_torch.ops.lamcalc_kernel import LamcalcFunction, lamcalc
    from rscm_tpu_torch.ops.udeb_month import UdebYearFunction, udeb_year

    def reset():
        udeb_year.launches = 0
        lamcalc.launches = 0

    def expect(what, n):
        got = {"udeb_year": udeb_year.launches, "lamcalc": lamcalc.launches}
        log(f"  {what}: launches {got}")
        if got != {"udeb_year": n, "lamcalc": n}:
            raise AssertionError(f"{what}: launches {got}, expected {n} each")

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
    def plain_runner(c):
        """``c`` with its runner through the plain versions of both kernels."""
        years = np.asarray(c.runner.model.time_axis.values())
        return dataclasses.replace(c, runner=CompiledModelRunner(
            build_magicc_model(years=years, ocean_params={"history_dtype": "bfloat16"},
                               udeb_params={"month_engine": "torch"}),
            param_map={n: MAGICC_PARAM_SPECS[n][0] for n in c.param_names},
            output_variables=c.runner.output_variables))

    plain = plain_runner(calib)

    def objective(c, target):
        return PointEstimator(c.params, c.runner, c.likelihood, target)._traced_objective(
            EstimateKind.MAP)

    def log_prob(c, target):
        return EnsembleSampler(c.params, c.runner, c.likelihood, target)._build_device_log_prob()

    # 1. the log posterior of 1024 walkers as one batched run
    b = CALIB["walkers"]
    walkers = calib.runner.as_theta(calib.params.sample_random(b, np.random.default_rng(11)))
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
        # the first walkers with a finite posterior, through the plain engines
        k = CALIB["checked"]
        idx = torch.nonzero(finite)[:k, 0]
        check_close(f"log posterior of {k} walkers, month_engine='torch' vs the kernels",
                    lp[idx], log_prob(plain, calib.target)(walkers[idx]), 1e-10, 0.0)
        for i in torch.nonzero(~finite)[:, 0].tolist():
            log(f"  walker {i} (-inf): {dict(zip(calib.param_names, walkers[i].tolist()))}")

    # 2. the MAP objective's gradient at the truth, reverse mode, through the
    # kernels, and its checks, at the 1850-1900 cut (a 251-year gradient is
    # ~120-150 s of host-bound backward on the card): against the plain
    # engines, forward mode along a seeded unit direction, and central
    # differences
    cut_years = np.arange(1850.0, CALIB["cut_last_year"] + 1.0)
    cut = magicc_calibration(years=cut_years)
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
    expect(f"gradient at the truth, {cut_steps + 1} years (forward launches)", cut_steps)
    grad = cut_grad[0]
    log(f"  gradient at the truth, reverse mode, {cut_steps + 1} years: forward with the tape "
        f"{t_fwd:.3f} s, backward {t_bwd:.3f} s, peak device memory {peak / 2**30:.3f} GiB on "
        f"{smi}; objective {float(value[0].detach()):.10e}, gradient {grad.tolist()}")
    if not bool(torch.isfinite(grad).all()) or not bool((grad != 0).all()):
        raise AssertionError(f"gradient {grad.tolist()}")
    t = synced()
    _, plain_grad = value_and_grad(objective(plain_runner(cut), cut.target), cut_theta, "rev")
    log(f"  the same gradient through the plain engines: {synced() - t:.3f} s")
    check_close(f"gradient at {cut_steps + 1} years, month_engine='torch' vs the kernels",
                cut_grad[0], plain_grad[0], 1e-9, 0.0)

    v = np.random.default_rng(17).normal(size=d)
    v = cut.runner.as_theta(v / np.linalg.norm(v))
    reset()
    t = synced()
    with torch.no_grad(), fwAD.dual_level():
        jvp = fwAD.unpack_dual(cut_obj(fwAD.make_dual(cut_theta, v[None]))).tangent[0]
    t_jvp = synced() - t
    expect("forward-mode run at the cut", cut_steps)
    gv = (cut_grad[0] * v).sum()
    scale = float(cut_grad.abs().max())
    log(f"  forward mode along a seeded direction, {cut_steps + 1} years: jvp {float(jvp):.10e}, "
        f"grad . v {float(gv):.10e}, {t_jvp:.3f} s on {smi}")
    if not abs(float(jvp - gv)) <= 2e-2 * abs(float(gv)) + 1e-6 * scale:
        raise AssertionError("forward and reverse mode disagree beyond the bfloat16 bar")

    # central differences with the flux history in float64: through a
    # bfloat16 history the forward is flat between roundings at a step of
    # 1e-6 of a prior span (on the CPU at 1850-1890 such differences miss the
    # gradient by 0.33 of its largest component, by 1.1e-8 in float64)
    fine = magicc_calibration(years=cut_years,
                              model_kwargs={"ocean_params": {"history_dtype": "float32"}})
    fine_obj = objective(fine, fine.target)
    _, fine_grad = value_and_grad(fine_obj, cut_theta, "rev")
    fine_grad = fine_grad[0]
    lower, upper = map(np.asarray, fine.params.bounds())
    h = CALIB["fd_rel_step"] * (upper - lower)
    steps = np.diag(h)
    points = fine.runner.as_theta(np.concatenate([fine.theta_true + steps,
                                                  fine.theta_true - steps]))
    with torch.no_grad():
        vals = fine_obj(points)
    fd = (vals[:d] - vals[d:]) / (2.0 * torch.as_tensor(h, dtype=vals.dtype, device=vals.device))
    fd_err = float((fd - fine_grad).abs().max() / fine_grad.abs().max())
    log(f"  central differences, {cut_steps + 1} years, flux history in float64 ({2 * d} "
        f"walkers in one batched run, step {CALIB['fd_rel_step']:g} of each prior span): "
        f"max |fd - grad| / max |grad| {fd_err:.3e} (bound 1e-3)")
    if not fd_err < 1e-3:
        raise AssertionError(f"gradient disagrees with central differences ({fd_err:.3e})")
    del fine, fine_obj

    # each kernel's backward, alone, at the gradient's batch of one walker
    st, *udeb_args = udeb_inputs(1, torch.float64, seed=5)
    udeb_bwd = plain_backward_ms(lambda *a: UdebYearFunction.apply(st, *a), udeb_args, smi,
                                 "udeb_year (B=1, n=50)")
    lst, packed = lamcalc_inputs(1, torch.float64, seed=5, fallback_every=0)
    lam_bwd = plain_backward_ms(lambda p: LamcalcFunction.apply(lst, p), [packed], smi,
                                "lamcalc (B=1)")
    log(f"  the kernels' backwards in one gradient: {cut_steps} x ({udeb_bwd[1]:.3f} + "
        f"{lam_bwd[1]:.3f}) ms = {cut_steps * (udeb_bwd[1] + lam_bwd[1]) / 1e3:.3f} s of wall, "
        f"{cut_steps * udeb_bwd[1] / 1e3 / t_bwd:.1%} of the backward's {t_bwd:.3f} s in "
        f"udeb_year's (device time {cut_steps * udeb_bwd[0] / 1e3:.3f} s)")

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
    expect(f"Adam, {n_adam} step(s)", cut_steps * (n_adam + 1) + cut_steps)
    best = np.asarray(fit.best_params)
    with torch.no_grad():
        end = float(cut_obj(cut.runner.as_theta(best[None]))[0])
    log(f"  Adam, {n_adam} step(s) from the prior midpoint, {cut_steps + 1} years: objective "
        f"{start:.6e} -> {end:.6e}, "
        f"{wall:.3f} s ({wall / n_adam:.3f} s a step with the final objective and the "
        f"host evaluation) on {smi}")
    if not end <= start or not np.all((lower < best) & (best < upper)):
        raise AssertionError(f"Adam rose ({start} -> {end}) or left the support: {best}")

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
    nuts = NUTSSampler(nuts_cut.params, nuts_cut.runner, nuts_cut.likelihood, nuts_cut.target,
                       max_tree_depth=CALIB["nuts_depth"], grad_mode="rev")
    c = CALIB["nuts_chains"]
    reset()
    t = synced()
    # chains start around the truth, as the JAX package's NUTS test of the
    # MAGICC graph starts them (from prior draws the first trajectories of a
    # posterior this peaked diverge at once)
    init = nuts_cut.theta_true * (
        1.0 + 0.01 * np.random.default_rng(6).uniform(-1.0, 1.0, (c, d)))
    chain = nuts.run(n_iterations=1, n_chains=c, warmup=1, seed=5, init_positions=init,
                     step_size=CALIB["nuts_step_size"])
    wall = synced() - t
    diag = nuts.last_diagnostics
    expect("NUTS", nuts_steps * diag["n_gradient_evals"])
    samples = chain.flat_samples()
    log(f"  NUTS, {c} chains, depth {CALIB['nuts_depth']}, 1 warmup + 1 transition, "
        f"{nuts_steps + 1} years: wall {wall:.3f} s, {diag['n_gradient_evals']} batched "
        f"value-and-gradient evaluations ({wall / diag['n_gradient_evals']:.3f} s each, "
        f"{wall / (diag['n_gradient_evals'] * c) * 1e3:.1f} ms a chain), {diag['n_model_evals']} "
        f"chain leapfrog steps in growing trees, {diag['n_divergences']} divergences, step "
        f"sizes median {float(np.median(diag['step_sizes'])):.4f} on {smi}")
    if samples.shape != (c, d) or not np.all(np.isfinite(samples)):
        raise AssertionError(f"NUTS samples: shape {samples.shape}, or non-finite")
    if not 0 < diag["n_model_evals"] <= c * diag["n_leapfrog_steps"]:
        raise AssertionError(f"NUTS counted {diag['n_model_evals']} model evaluations in "
                             f"{diag['n_leapfrog_steps']} leapfrog steps of {c} chains")
    return {
        "udeb_year": {"launches_per_gradient": cut_steps, "backward_ms": udeb_bwd[0]},
        "lamcalc": {"launches_per_gradient": cut_steps, "backward_ms": lam_bwd[0]},
    }


PHASES = ("main", "second", "magicc", "flagship", "scenarios", "fullmagicc", "host", "mesh",
          "calibrate")


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
    if "main" in run:
        with Phase("kernels"):
            errs = phase_kernels()
        with Phase("main"):
            runner, params, launches, n_steps = phase_main()
    if "second" in run:
        with Phase("second"):
            phase_second_path()
    if "main" in run:
        with Phase("timing"):
            kernels = phase_timing(smi, runner, params, launches, n_steps, errs, div_instr)
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
