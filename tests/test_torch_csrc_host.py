"""The CUDA sources of the port run on the CPU: `csrc/*.cu` compiled with the
host C++ compiler against the stand-in headers of `tests/data/cuda_host/`
(each `kernel<<<grid, block, ...>>>` rewritten into a loop over every block
and thread), loaded in place of the card's library, and driven through the
port's own wrappers on CPU tensors. Each kernel's result is held bitwise
against its plain version: K10 on both routes and the K4s Stokes modes,
K9 and the K4s wave and step modes (whose sources share `exchange_slabs`
and `wave.cuh` with the Stokes code), and whole `run_stokes` runs.

The card's compiler, its float units and its launch limits are not tested
here (`chip_smoke.py` does that on a GPU); the kernels' index arithmetic,
masks, carried registers, routes and delivery order are. Skips without a
C++ compiler.
"""

import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.models import init_stokes3d, run_stokes
from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw
from implicitglobalgrid_tpu_torch.ops.halo import exchange_recv_slabs_multi
from torch_port_util import clean_torch_grid  # noqa: F401

SHIM = pathlib.Path(__file__).resolve().parent / "data" / "cuda_host"
LAUNCH = re.compile(r"([A-Za-z_0-9]+(?:<[^;{}]*?>)?)<<<(.*?)>>>", re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel library built for the host, with the card's signatures."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/ for the CPU")
    d = tmp_path_factory.mktemp("csrc_host")
    for h in cb.HEADERS:
        shutil.copy(cb.CSRC / h, d / h)
    srcs = []
    for s in cb.SOURCES:
        text = LAUNCH.sub(r"IGG_LAUNCH(\2) \1", (cb.CSRC / s).read_text())
        (d / (pathlib.Path(s).stem + ".cpp")).write_text(text)
        srcs.append(str(d / (pathlib.Path(s).stem + ".cpp")))
    so = d / "libigg_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-w",
                        f"-I{SHIM}", f"-I{d}", *srcs, "-o", str(so)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name, argtypes in cb._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrappers take CPU tensors for the card's: they launch the host
    build of their kernels (and count the launches)."""
    monkeypatch.setattr(cb, "_lib", host_lib)
    for m in (cs, cw, cst):
        monkeypatch.setattr(m, "_on_card", lambda t: True)
        monkeypatch.setattr(m, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    cb.reset_launch_counts()
    yield


def _plain(monkeypatch):
    for m in (cs, cw, cst):
        monkeypatch.setattr(m, "_on_card", lambda t: False)


def _equal(got, ref):
    return all(torch.equal(a, b) for a, b in zip(got, ref))


K = dict(mu=1.3, dt_v=0.021, dt_p=0.7, damp=0.9, dx=0.31, dy=0.27, dz=0.35)
GRIDS = [((1, 1, 1), (1, 1, 1)), ((2, 2, 2), (1, 1, 1)), ((2, 2, 2), (0, 0, 0)),
         ((1, 2, 4), (1, 0, 1)), ((1, 1, 1), (0, 0, 0)), ((2, 1, 2), (0, 1, 0))]


def _grid(n, dims, periods):
    kw = {f"dim{a}": d for a, d in zip("xyz", dims)}
    kw.update({f"period{a}": q for a, q in zip("xyz", periods)})
    tg.init_global_grid(*n, quiet=True, device_type="cpu", nranks=int(np.prod(dims)), **kw)
    return tg.global_grid()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [(6, 5, 7), (3, 3, 3)])
@pytest.mark.parametrize("dims,periods", GRIDS)
def test_k10_and_stokes_slabs_match_plain(on_host, dims, periods, n, dtype):
    """K10 (the route the grid takes) with a random state and rhog, the
    received slabs from the K4s Stokes modes, each launch bitwise."""
    gg = _grid(n, dims, periods)
    rng = np.random.default_rng(1)
    st = tuple(torch.from_numpy(rng.standard_normal(
        tuple(c * s for c, s in zip(dims, shp))).astype(dtype))
        for shp in cst.stokes_shapes(n).values())
    modes = cst.stokes_exchange_modes(gg, [cst.stokes_shapes(n)[f] for f in cst.STATE])
    if cst.all_self_exchange(gg, modes):
        ols = cst.self_ols(gg, n)
        got = cst.stokes_step_self(st, modes, ols, block=n, consts=K)
        ref = cst.stokes_step_self_plain(st, modes, ols, block=n, consts=K)
    else:
        def slab_fn(field):
            def get(dim, hw, moves, periodic, earlier):
                kw = dict(block=n, periodic=periodic, earlier=earlier, consts=K)
                out = cst.stokes_slabs(st, field, dim, hw, moves, **kw)
                assert _equal(out, cst.stokes_slabs_plain(st, field, dim, hw, moves, **kw))
                return out
            return get

        recvs = exchange_recv_slabs_multi(gg, cst.wave_shapes(n), (1, 1, 1), modes,
                                          {f: slab_fn(f) for f in cst.FIELDS})
        got = cst.stokes_step_recv(st, recvs, block=n, consts=K)
        ref = cst.stokes_step_recv_plain(st, recvs, block=n, consts=K)
    assert cb.launch_counts()["stokes_step_exchange"] == 1
    for name, a, b in zip(cst.STATE, got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stokes_slabs_every_start_match_plain(on_host, dtype):
    block = (5, 4, 6)
    rng = np.random.default_rng(2)
    st = tuple(torch.from_numpy(rng.standard_normal(tuple(2 * s for s in shp)).astype(dtype))
               for shp in cst.stokes_shapes(block).values())
    for f, m in cst.wave_shapes(block).items():
        for dim in range(3):
            starts = list(range(m[dim]))
            got = cst.stokes_update_slab(st, f, dim, starts, 1, block=block, consts=K)
            for s0, g in zip(starts, got):
                ref = cst.stokes_slabs_plain(st, f, dim, 1, (cs.Move(s0, s0, 0),), block=block,
                                             periodic=True, consts=K)[0]
                assert torch.equal(g, ref), (f, dim, s0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wave_and_step_slabs_and_k9_match_plain(on_host, dtype):
    """The kernels beside the Stokes code in `stencil.cu` and `wave.cuh`:
    K4s copy, step and wave modes, and K9's multi-rank route."""
    block = (5, 4, 6)
    rng = np.random.default_rng(3)
    st = tuple(torch.from_numpy(rng.standard_normal(tuple(2 * s for s in shp)).astype(dtype))
               for shp in cw.wave_shapes(block).values())
    k = cw.wave_consts(rho=1.0, K=1.0, dt=0.05, dx=0.3, dy=0.2, dz=0.4)
    for f, m in cw.wave_shapes(block).items():
        for dim in range(3):
            starts = list(range(m[dim]))
            got = cw.wave_update_slab(st, f, dim, starts, 1, block=block, consts=k)
            for s0, g in zip(starts, got):
                ref = cw.wave_slabs_plain(st, f, dim, 1, (cs.Move(s0, s0, 0),), block=block,
                                          periodic=True, consts=k)[0]
                assert torch.equal(g, ref), (f, dim, s0)
    T = torch.from_numpy(rng.standard_normal((10, 8, 12)).astype(dtype))
    Cp = 1 + torch.from_numpy(rng.random((10, 8, 12)).astype(dtype))
    c = dict(lam=1.0, dt=0.01, dx=0.3, dy=0.2, dz=0.4)
    moves = (cs.Move(3, 0, -1), cs.Move(1, 4, 1))
    for step in (False, True):
        kw = dict(block=(5, 4, 6), periodic=False, Cp=Cp if step else None,
                  consts=c if step else None)
        assert _equal(cs.exchange_slabs(T, 0, 1, moves, **kw),
                      cs.exchange_slabs_plain(T, 0, 1, moves, **kw))
    recvs = {f: {d: tuple(torch.from_numpy(rng.standard_normal(
        [2 if e == d else 2 * s for e, s in enumerate(shp)]).astype(dtype)) for _ in range(2))
        for d in range(3)} for f, shp in cw.wave_shapes(block).items()}
    assert _equal(cw.acoustic_step_recv(st, recvs, block=block, consts=k),
                  cw.acoustic_step_recv_plain(st, recvs, block=block, consts=k))


@pytest.mark.parametrize("dims,periods", [((2, 2, 2), (1, 0, 1)), ((1, 1, 1), (1, 1, 1)),
                                          ((1, 1, 1), (0, 0, 0))])
def test_run_stokes_on_host_kernels_matches_plain(on_host, monkeypatch, dims, periods):
    """Six iterations through the host build of K4s and K10 equal the plain
    versions' run bitwise, with one K10 and 12 K4s launches (multi-rank) or
    one K10 alone an iteration."""
    _grid((9, 8, 10), dims, periods)
    s0, p = init_stokes3d(dtype=torch.float64)
    rng = np.random.default_rng(4)
    s0 = s0[:7] + (torch.from_numpy(rng.standard_normal(s0[7].shape)),)
    a = run_stokes(s0, p, 6, nt_chunk=3)
    counts = cb.launch_counts()
    _plain(monkeypatch)
    b = run_stokes(s0, p, 6, nt_chunk=3)
    assert counts["stokes_step_exchange"] == 6
    assert counts["exchange_slabs"] == (72 if dims == (2, 2, 2) else 0)
    for name, x, y in zip(cst.STATE, a, b):
        assert torch.equal(x, y), name
