"""The CUDA sources themselves, compiled and run on the host.

``rscm_tpu_torch/csrc/*.cu`` build only with ``nvcc`` on a card, but their
arithmetic is plain C++: compiled here with ``g++`` against a stand-in CUDA
runtime (``tests/host_cuda/cuda_runtime.h``: a block's threads as OS
threads, the pair's warp shuffle as a swap; ``cuda_pipeline.h``: each
``cp.async`` copy made only when the thread waits for its group), each
kernel runs through the
port's own wrappers (the ``ctypes`` calls, strides and work buffers) on CPU
tensors and is held against its plain version in float64: the forward
kernels against ``udeb_year_plain`` / ``lamcalc_plain``, the tangent kernels
against ``plain_jvp`` of them, the adjoint kernels against their explicit
twins.  On the CPU the plain versions divide by a host constant where the
kernels multiply by its reciprocal (as PyTorch's CUDA division does), so
the bar is 1e-12 and not bit equality; ``chip_smoke.py`` holds the kernels
built by ``nvcc`` to their plain versions on the card.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from rscm_tpu_torch.magicc import ClimateUDEB
from rscm_tpu_torch.magicc.climate.lamcalc import LamcalcParams
from rscm_tpu_torch.ops import build, lamcalc_kernel, udeb_month
from rscm_tpu_torch.ops.plain_grad import plain_jvp
from test_torch_kernels import STALL_MEMBERS, lamcalc_setup, udeb_inputs

TOL = 1e-12
HERE = Path(__file__).resolve().parent
B = 5  # two warps' pairs and a ragged edge: members 0-4 over blocks of 32 or 64 threads


def host_source(src: str) -> str:
    """The .cu source with its launches and its dynamic shared array
    rewritten for the stand-in runtime."""
    src = re.sub(r"(\w+<T[^<>]*>)<<<(grid_of\(B, c\)|blocks_of\(B\)), ([^,]+), [^>]*>>>\(",
                 r"launch_kernel(\2, \3, \1, ", src)
    return src.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                       "unsigned char* smem_raw = g_smem;")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA sources on the host")
    out = tmp_path_factory.mktemp("host_cuda")
    procs = {}
    for name in ("udeb_year", "lamcalc"):
        cpp = out / f"{name}.cpp"
        cpp.write_text(host_source((build.CSRC / f"{name}.cu").read_text()))
        cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
               f"-I{HERE / 'host_cuda'}", "-o", str(out / f"{name}.so"), str(cpp)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed on {name}.cu:\n{report}"
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' kernel paths, on CPU tensors, through the host build."""
    monkeypatch.setattr(build, "load", lambda name: host_libs[name])
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    # one SM (the stand-in runs one block at a time)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=1))
    udeb_month.max_kernel_layers.cache_clear()
    yield
    udeb_month.max_kernel_layers.cache_clear()


def close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("n_layers,land_heat,per_member", [
    (2, True, False), (3, False, True), (17, True, False), (17, True, True),
])
def test_udeb_kernels_on_host_match_their_plain_versions(on_host, n_layers, land_heat,
                                                          per_member):
    comp = ClimateUDEB(n_layers=n_layers, land_heat_capacity_enabled=land_heat)
    st = udeb_month.static_from_component(comp, 1.0)
    scal, ocean, init, vec = (torch.tensor(a) for a in udeb_inputs(comp, 4, b=B))
    rng = np.random.default_rng(5)
    if per_member:
        init = init + torch.tensor(rng.uniform(-0.2, 0.2, init.shape))
    else:
        init = init[:, :1].expand(2 * n_layers, B)
    primals = (scal, ocean, init, vec)
    tangents = [torch.tensor(rng.normal(size=x.shape)) for x in primals]
    if not per_member:
        tangents[2] = torch.tensor(rng.normal(size=(2 * n_layers, 1))).expand(2 * n_layers, B)
    cot = (torch.tensor(rng.normal(size=(2 * n_layers, B))), torch.tensor(rng.normal(size=(8, B))))

    launches = (udeb_month.udeb_year.launches, udeb_month.udeb_year_jvp.launches,
                udeb_month.udeb_year_vjp.launches)
    close(udeb_month._udeb_year_launch(st, *primals),
          udeb_month.udeb_year_plain(st, *primals), "forward")
    close(udeb_month._udeb_year_jvp_launch(st, primals, tangents),
          plain_jvp(lambda *a: udeb_month.udeb_year_plain(st, *a), primals, tangents), "jvp")
    close(udeb_month._udeb_year_vjp_launch(st, *primals, *cot),
          udeb_month.udeb_year_vjp_plain(st, *primals, *cot), "vjp")
    assert (udeb_month.udeb_year.launches, udeb_month.udeb_year_jvp.launches,
            udeb_month.udeb_year_vjp.launches) == tuple(n + 1 for n in launches)


@pytest.mark.parametrize("n_layers", [3, 17])
def test_udeb_tangent_kernel_layouts_on_host_agree(on_host, n_layers):
    """The tangent kernel's library keeps its dual c' in shared memory while
    one wave of that layout holds the batch (here one SM of one block of 64
    threads: 32 members) and in device memory, read back through its ring,
    beyond; both run the same arithmetic, so the first 32 members of a
    launch in each agree bit for bit."""
    b = 40
    comp = ClimateUDEB(n_layers=n_layers)
    st = udeb_month.static_from_component(comp, 1.0)
    primals = tuple(torch.tensor(a) for a in udeb_inputs(comp, 9, b=b))
    rng = np.random.default_rng(10)
    tangents = [torch.tensor(rng.normal(size=x.shape)) for x in primals]

    def scratch(members):
        return udeb_month.kernel_config(n_layers, torch.float64, "cpu", "udeb_year_jvp",
                                        b=members, steps=st.steps)["scratch"]

    assert scratch(b) == (n_layers - 1) * 2 * b * 2  # the ring layout's dual c'
    assert scratch(32) == 0  # c' in shared memory
    ring = udeb_month._udeb_year_jvp_launch(st, primals, tangents)
    close(ring, plain_jvp(lambda *a: udeb_month.udeb_year_plain(st, *a), primals, tangents),
          "jvp")

    def first(xs):
        return tuple(x[:, :32].contiguous() for x in xs)

    shared = udeb_month._udeb_year_jvp_launch(st, first(primals), first(tangents))
    for r, sh in zip(ring, shared):
        assert torch.equal(r[:, :32], sh)


def test_udeb_layer_limits_of_the_host_build(on_host):
    kernels = ("udeb_year", "udeb_year_jvp", "udeb_year_vjp")
    # a block of one warp in the 227 KB a block may use: the forward keeps
    # 2n - 1 values a thread, the tangent n + 4 dual numbers (its column and
    # the ring of its c'), the adjoint 2n + 12 (the cotangents and the ring
    # of its tape's three planes)
    assert [udeb_month.max_kernel_layers(torch.float64, k) for k in kernels] == [409, 394, 403]
    assert [udeb_month.max_kernel_layers(torch.float32, k) for k in kernels] == [818, 792, 813]
    with pytest.raises(ValueError, match="at most 403 layers"):
        udeb_month._check_layers(404, torch.float64, "udeb_year_vjp")


@pytest.mark.parametrize("with_fallback", [True, False])
def test_lamcalc_kernels_on_host_match_their_plain_versions(on_host, with_fallback):
    b = 8
    kwargs, fallback, packed = lamcalc_setup(b=b, seed=7)
    if not with_fallback:
        packed[4] = kwargs["rlo"]
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    x = torch.tensor(packed)
    rng = np.random.default_rng(8)
    tangent, g_out = torch.tensor(rng.normal(size=x.shape)), torch.tensor(rng.normal(size=(3, b)))
    out = torch.empty((3, b), dtype=x.dtype)
    lamcalc_kernel._launch("lamcalc", st, x, out, x)
    close([out], [lamcalc_kernel.lamcalc_plain(st, x)], "forward")
    got_t = torch.empty((3, b), dtype=x.dtype)
    lamcalc_kernel._launch("lamcalc_jvp", st, x, got_t, x, tangent)
    close([got_t], [plain_jvp(lambda p: lamcalc_kernel.lamcalc_plain(st, p), (x,), (tangent,))],
          "jvp")
    got_g = torch.empty_like(x)
    lamcalc_kernel._launch("lamcalc_vjp", st, x, got_g, x, g_out)
    close([got_g], [lamcalc_kernel.lamcalc_vjp_plain(st, x, g_out)], "vjp")
    if with_fallback:
        assert np.all(got_t.numpy()[:, ::4] == 0.0) and np.all(got_g.numpy()[:, ::4] == 0.0)


def test_lamcalc_adjoint_on_host_reverses_every_branch(on_host):
    """The adjoint kernel against its twin over every branch it reverses
    (steps, both secants, the stalled members' vanished denominator), on
    37 members: a ragged warp whose members stop after different
    iterations, with fallback members."""
    b = 37
    kwargs, fallback, packed = lamcalc_setup(b=b, seed=11)
    packed[:, 1:1 + len(STALL_MEMBERS)] = np.array(STALL_MEMBERS).T
    st = lamcalc_kernel.lam_static(LamcalcParams(**kwargs), fallback)
    x = torch.tensor(packed)
    _, iterations = lamcalc_kernel.lamcalc_plain_with_iterations(st, x)
    assert lamcalc_kernel.branch_codes(st, x) == {0, 1, 2, 3}
    assert len(set(iterations[32:].tolist())) > 1
    g_out = torch.tensor(np.random.default_rng(12).normal(size=(3, b)))
    got = torch.empty_like(x)
    lamcalc_kernel._launch("lamcalc_vjp", st, x, got, x, g_out)
    close([got], [lamcalc_kernel.lamcalc_vjp_plain(st, x, g_out)], "vjp")
    fallen = (iterations == lamcalc_kernel.MAX_ITERATIONS - 1).numpy()
    assert fallen.any() and np.all(got.numpy()[:, fallen] == 0.0)
