"""The CUDA sources of the port run on the CPU: `csrc/*.cu` compiled with the
host C++ compiler against the stand-in headers of `tests/data/cuda_host/`
(each `kernel<<<grid, block, ...>>>(args)` rewritten into a host launch
that runs a block's threads concurrently, with barriers for
`__syncthreads` and the warp shuffles), loaded in place of the card's
library, and driven through the port's own wrappers on CPU tensors. Each
kernel's result is held bitwise against its plain version: K10 on both
routes and the K4s Stokes modes, K9 on both routes (tile, chunk and block
edges, mixed magnitudes, float32, float64 and bfloat16) and the K4s wave
and step modes (whose sources share `exchange_slabs` and `wave.cuh` with
the Stokes code), the batched K4s launch of every field of a dim, the
diffusion kernels K1 (every fuse combination), K4 (every received-mode
combination) and K5 (its four) on stacked blocks with tile and chunk edges
and mixed magnitudes in three dtypes, and whole `run_stokes`,
`run_acoustic` and `run_diffusion` runs with their launch counts; the halo
copies K8 and K7 (every dim, both wire layouts, per-field halowidths, 2-D
fields, periodic and PROC_NULL edges, four dtypes, groups of 16 and 17
fields, an ensemble's members at E = 1, 3 and 16) and K2, K3 and K6; the division helper of `cdiv.cuh` bitwise
against IEEE division.

The card's compiler, its float units and its launch limits are not tested
here (`chip_smoke.py` does that on a GPU); the kernels' index arithmetic,
masks, carried registers, shared-memory tiles, barriers, routes and
delivery order are. Skips without a C++ compiler.
"""

import contextlib
import ctypes
import itertools
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.models import (
    init_diffusion2d, init_diffusion3d, init_stokes3d, run_diffusion, run_stokes,
)
from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
from implicitglobalgrid_tpu_torch.ops import cuda_halo as ch
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw
from implicitglobalgrid_tpu_torch.ops.halo import exchange_recv_slabs_multi
from implicitglobalgrid_tpu_torch.ops.wire import schema_for_fields
from torch_port_util import clean_torch_grid  # noqa: F401

SHIM = pathlib.Path(__file__).resolve().parent / "data" / "cuda_host"
LAUNCH = re.compile(r"([A-Za-z_0-9]+(?:<[^;{}]*?>)?)<<<(.*?)>>>\s*\(", re.S)


def _host_source(text):
    """Each ``kernel<<<cfg>>>(args)`` of a CUDA source as the stand-in's
    ``igg_launch([&] { kernel(args); }, cfg)``."""
    out, pos = [], 0
    for m in LAUNCH.finditer(text):
        depth, e = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[e], 0)
            e += 1
        out += [text[pos:m.start()],
                f"igg_launch([&] {{ {m[1]}({text[m.end():e - 1]}); }}, {m[2]})"]
        pos = e
    return "".join(out) + text[pos:]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel library built for the host, with the card's signatures."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/ for the CPU")
    d = tmp_path_factory.mktemp("csrc_host")
    for h in cb.HEADERS:
        shutil.copy(cb.CSRC / h, d / h)
    flags = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-w", "-pthread", f"-I{SHIM}",
             f"-I{d}"]
    procs = []
    for s in cb.SOURCES:
        src = d / (pathlib.Path(s).stem + ".cpp")
        src.write_text(_host_source((cb.CSRC / s).read_text()))
        procs.append(subprocess.Popen([cxx, *flags, "-c", str(src), "-o", str(src) + ".o"],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    so = d / "libigg_host.so"
    r = subprocess.run([cxx, "-shared", "-pthread", *(str(p.args[-1]) for p in procs), "-o",
                        str(so)], capture_output=True, text=True, timeout=600)
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
    for m in (cs, cw, cst, ch):
        monkeypatch.setattr(m, "_on_card", lambda t: True)
        monkeypatch.setattr(m, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    cb.reset_launch_counts()
    yield


def _plain(monkeypatch):
    for m in (cs, cw, cst, ch):
        monkeypatch.setattr(m, "_on_card", lambda t: False)


def _equal(got, ref):
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def _same_bits(a, b):
    """Bitwise equal, two NaNs agreeing whatever their payloads."""
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(((a.view(ints) == b.view(ints)) | (a.isnan() & b.isnan())).all())


def _scales(dtype):
    """Per-plane scales of the mixed-magnitude states: zero, tiny, subnormal
    and near overflow beside 1 (every path of the division)."""
    return np.array([1, 0, 1e-30, 1e-41, 1e38] if dtype == np.float32
                    else [1, 0, 1e-300, 1e-310, 1e307], dtype=dtype)


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
        def dim_fn(dim, hw, periodic, per_field):
            got = {}
            for f, (moves, earlier) in per_field.items():
                kw = dict(block=n, periodic=periodic, earlier=earlier, consts=K)
                got[f] = cst.stokes_slabs(st, f, dim, hw, moves, **kw)
                assert _equal(got[f], cst.stokes_slabs_plain(st, f, dim, hw, moves, **kw))
            return got

        recvs = exchange_recv_slabs_multi(gg, cst.wave_shapes(n), (1, 1, 1), modes, dim_fn)
        got = cst.stokes_step_recv(st, recvs, block=n, consts=K)
        ref = cst.stokes_step_recv_plain(st, recvs, block=n, consts=K)
    assert cb.launch_counts()["stokes_step_exchange"] == 1
    for name, a, b in zip(cst.STATE, got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k10_tiles_and_chunks_match_plain(on_host, dtype):
    """K10's multi-rank route on one block of several tiles along y and z
    and two x chunks (tile and chunk edges, the halo warps' rows and lanes),
    bitwise: with random received slabs of every field on every dim (the
    tiled kernel) and with none (the per-column kernel), each on a random
    state and on one whose x planes are scaled at random to zero, tiny,
    subnormal or near-overflow values (the division's exact retry and IEEE
    fallback)."""
    block = (34, 10, 37)
    rng = np.random.default_rng(9)
    st = tuple(torch.from_numpy(rng.standard_normal(shp).astype(dtype))
               for shp in cst.stokes_shapes(block).values())
    recvs = {f: {d: tuple(torch.from_numpy(rng.standard_normal(
        [1 if e == d else s for e, s in enumerate(shp)]).astype(dtype)) for _ in range(2))
        for d in range(3)} for f, shp in cst.wave_shapes(block).items()}
    scales = _scales(dtype)
    mixed = tuple(a * torch.from_numpy(scales[rng.integers(0, 5, (a.shape[0], 1, 1))])
                  for a in st)  # one scale an x plane
    for state, r in ((st, {}), (st, recvs), (mixed, {}), (mixed, recvs)):
        got = cst.stokes_step_recv(state, r, block=block, consts=K)
        ref = cst.stokes_step_recv_plain(state, r, block=block, consts=K)
        for name, a, b in zip(cst.STATE, got, ref):
            assert _same_bits(a, b), name
    assert cb.launch_counts()["stokes_step_exchange"] == 4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k10_self_route_mixed_scales_match_plain(on_host, dtype):
    """K10's all-self route (the per-column kernel) on a state whose x
    planes are scaled at random to zero, tiny, subnormal or near-overflow
    values: the division's fast pass and its exact retry, bitwise."""
    n = (6, 5, 7)
    gg = _grid(n, (1, 1, 1), (1, 1, 1))
    rng = np.random.default_rng(10)
    scales = _scales(dtype)
    with np.errstate(over="ignore"):
        st = tuple(torch.from_numpy((rng.standard_normal(shp) * scales[rng.integers(
            0, 5, (shp[0], 1, 1))]).astype(dtype)) for shp in cst.stokes_shapes(n).values())
    modes = cst.stokes_exchange_modes(gg, [a.shape for a in st])
    ols = cst.self_ols(gg, n)
    got = cst.stokes_step_self(st, modes, ols, block=n, consts=K)
    ref = cst.stokes_step_self_plain(st, modes, ols, block=n, consts=K)
    for name, a, b in zip(cst.STATE, got, ref):
        assert _same_bits(a, b), name


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
    versions' run bitwise, with one K10 and 3 K4s launches (multi-rank: one
    a dim for the four fields) or one K10 alone an iteration."""
    _grid((9, 8, 10), dims, periods)
    s0, p = init_stokes3d(dtype=torch.float64)
    rng = np.random.default_rng(4)
    s0 = s0[:7] + (torch.from_numpy(rng.standard_normal(s0[7].shape)),)
    a = run_stokes(s0, p, 6, nt_chunk=3)
    counts = cb.launch_counts()
    _plain(monkeypatch)
    b = run_stokes(s0, p, 6, nt_chunk=3)
    assert counts["stokes_step_exchange"] == 6
    assert counts["exchange_slabs"] == (18 if dims == (2, 2, 2) else 0)
    for name, x, y in zip(cst.STATE, a, b):
        assert torch.equal(x, y), name


WAVE_K = cw.wave_consts(rho=1.0, K=1.0, dt=0.05, dx=0.3, dy=0.2, dz=0.4)
WAVE_DTYPES = [np.float32, np.float64, "bfloat16"]


def _wave_tensor(a, dtype):
    t = torch.from_numpy(a.astype(np.float32 if dtype == "bfloat16" else dtype))
    return t.bfloat16() if dtype == "bfloat16" else t


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k9_tiles_and_chunks_match_plain(on_host, dtype):
    """K9's multi-rank route on one block of several tiles along y and z
    and three x chunks (tile, chunk and block edges), bitwise: with random
    received slabs of every field on every dim and with none, each on a
    random state and on one whose x planes are scaled at random to zero,
    tiny, subnormal or large values (the division's exact retry)."""
    block = (34, 10, 37)
    rng = np.random.default_rng(11)
    st = tuple(_wave_tensor(rng.standard_normal(shp), dtype)
               for shp in cw.wave_shapes(block).values())
    recvs = {f: {d: tuple(_wave_tensor(rng.standard_normal(
        [1 if e == d else s for e, s in enumerate(shp)]), dtype) for _ in range(2))
        for d in range(3)} for f, shp in cw.wave_shapes(block).items()}
    scales = _scales(np.float64 if dtype == np.float64 else np.float32)[:4]
    mixed = tuple(a * torch.from_numpy(scales[rng.integers(0, 4, (a.shape[0], 1, 1))]).to(a.dtype)
                  for a in st)  # one scale an x plane
    for state, r in ((st, {}), (st, recvs), (mixed, {}), (mixed, recvs)):
        got = cw.acoustic_step_recv(state, r, block=block, consts=WAVE_K)
        ref = cw.acoustic_step_recv_plain(state, r, block=block, consts=WAVE_K)
        for name, a, b in zip(cw.FIELDS, got, ref):
            assert a.dtype == b.dtype and _same_bits(a.float(), b.float()), name
    assert cb.launch_counts()["acoustic_step_exchange"] == 4


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
@pytest.mark.parametrize("dims,periods", GRIDS)
def test_k9_and_batched_wave_slabs_match_plain(on_host, dims, periods, dtype):
    """K9 on the route the grid takes (all-self, or the multi-rank route
    with the received slabs of the pipeline), each batched K4s wave-mode
    launch (every field of a dim in one) bitwise against its plain version."""
    n = (6, 5, 7)
    gg = _grid(n, dims, periods)
    rng = np.random.default_rng(12)
    st = tuple(_wave_tensor(rng.standard_normal(tuple(c * s for c, s in zip(dims, shp))), dtype)
               for shp in cw.wave_shapes(n).values())
    modes = cw.wave_exchange_modes(gg, list(cw.wave_shapes(n).values()))
    if cw.all_self_exchange(gg, modes):
        ols = cw.self_ols(gg, n)
        got = cw.acoustic_step_self(st, modes, ols, block=n, consts=WAVE_K)
        ref = cw.acoustic_step_self_plain(st, modes, ols, block=n, consts=WAVE_K)
    else:
        def dim_fn(dim, hw, periodic, per_field):
            kw = dict(block=n, periodic=periodic, consts=WAVE_K)
            out = cw.wave_slabs_multi(st, dim, hw, per_field, **kw)
            ref = cw.wave_slabs_multi_plain(st, dim, hw, per_field, **kw)
            assert set(out) == set(per_field)
            for f in per_field:
                assert _equal(out[f], ref[f]), (f, dim)
            return out

        recvs = exchange_recv_slabs_multi(gg, cw.wave_shapes(n), (1, 1, 1), modes,
                                          dim_fn=dim_fn)
        got = cw.acoustic_step_recv(st, recvs, block=n, consts=WAVE_K)
        ref = cw.acoustic_step_recv_plain(st, recvs, block=n, consts=WAVE_K)
    counts = cb.launch_counts()
    assert counts["acoustic_step_exchange"] == 1
    assert counts["exchange_slabs"] == sum(any(m[d] for m in modes.values()) for d in range(3)) \
        * (not cw.all_self_exchange(gg, modes))
    for name, a, b in zip(cw.FIELDS, got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_stokes_slabs_match_plain(on_host, dtype):
    """One K4s Stokes-mode launch for the four fields of a dim, with moves,
    PROC_NULL edges and two earlier dims' slabs, bitwise against the plain
    version; a launch for two fields of the four."""
    block = (5, 4, 6)
    rng = np.random.default_rng(13)
    st = tuple(torch.from_numpy(rng.standard_normal(tuple(2 * s for s in shp)).astype(dtype))
               for shp in cst.stokes_shapes(block).values())
    per_field = {}
    for f, m in cst.wave_shapes(block).items():
        A = st[cst.FIELDS.index(f)]
        earlier = tuple((d, 1, tuple(torch.from_numpy(rng.standard_normal(
            [2 if e == d else s for e, s in enumerate(A.shape)]).astype(dtype))
            for _ in range(2))) for d in (2, 0))
        per_field[f] = ((cs.Move(m[1] - 2, 0, -1), cs.Move(1, m[1] - 1, 1)), earlier)
    for fields in (cst.FIELDS, ("Vy", "P")):
        sub = {f: per_field[f] for f in fields}
        for periodic in (True, False):
            kw = dict(block=block, periodic=periodic, consts=K)
            got = cst.stokes_slabs_multi(st, 1, 1, sub, **kw)
            ref = cst.stokes_slabs_multi_plain(st, 1, 1, sub, **kw)
            for f in fields:
                assert _equal(got[f], ref[f]), (fields, periodic, f)
    assert cb.launch_counts()["exchange_slabs"] == 4


# blocks of K4s's tile tests: none of the extents a multiple of its tiles
# (8 rows or planes by 32 lanes, 8 planes by 32 rows for the z slabs)
K4S_BLOCK = (11, 70, 37)
K4S_STAGGERED_BLOCK = (11, 40, 37)


def _moves(n, hw):
    """The pipeline's two moves of a dim of n cells: the left slab from the
    block before (PROC_NULL: the own block's first halo), the right from the
    block after."""
    return (cs.Move(n - 2 * hw, 0, -1), cs.Move(hw, n - hw, 1))


def _earlier(rng, shape, block, dims, hws, dtype):
    """Random received slabs of earlier dims (K2's layout) of a stacked
    field."""
    return tuple((e, h, tuple(_wave_tensor(rng.standard_normal(
        [s // b * h if a == e else s for a, (s, b) in enumerate(zip(shape, block))]), dtype)
        for _ in range(2))) for e, h in zip(dims, hws))


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4s_copy_and_step_every_dim_match_plain(on_host, dtype):
    """K4s copy and 3-D step modes on a 2x2x2 stack of blocks whose extents
    are no multiple of the tiles, every dim and both sides, periodic and
    not (PROC_NULL edges), without and with two earlier dims' corners
    (halowidths 1 and 2), a copy of halowidth 2 too, bitwise; mixed
    magnitudes in the step's state."""
    rng = np.random.default_rng(31)
    shape = tuple(2 * n for n in K4S_BLOCK)
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 32)
    launches = 0
    for dim in range(3):
        others = tuple(e for e in (2, 0, 1) if e != dim)
        ear = _earlier(rng, shape, K4S_BLOCK, others, (1, 2), dtype)
        for periodic, earlier, step, hw in itertools.product(
                (True, False), ((), ear), (False, True), (1, 2)):
            if step and hw == 2:
                continue
            kw = dict(block=K4S_BLOCK, periodic=periodic, earlier=earlier,
                      Cp=Cp if step else None, consts=DIFF_K if step else None)
            moves = _moves(K4S_BLOCK[dim], hw)
            got = cs.exchange_slabs(T, dim, hw, moves, **kw)
            ref = cs.exchange_slabs_plain(T, dim, hw, moves, **kw)
            launches += 1
            assert all(_bits_equal(a, b) for a, b in zip(got, ref)), \
                (dim, periodic, len(earlier), step, hw)
    assert cb.launch_counts()["exchange_slabs"] == launches


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4s_2d_modes_match_plain(on_host, dtype):
    """K4s on a 2x2 stack of 2-D blocks (laid out as (S0, 1, S1): a tile of
    one row along y), x rows and y lanes, halowidths 1 and 2 (the per-dim
    tier's 2-D case), the copy and the 2-D step, with the other dim's
    corners, periodic and not, bitwise."""
    rng = np.random.default_rng(33)
    block = (37, 70)
    shape = tuple(2 * n for n in block)
    c2 = {k: v for k, v in DIFF_K.items() if k != "dz"}
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 34)
    for dim, hw, step, periodic in itertools.product((0, 1), (1, 2), (False, True),
                                                     (True, False)):
        earlier = _earlier(rng, shape, block, (1 - dim,), (hw,), dtype)
        kw = dict(block=block, periodic=periodic, earlier=earlier, Cp=Cp if step else None,
                  consts=c2 if step else None)
        moves = _moves(block[dim], hw)
        got = cs.exchange_slabs(T, dim, hw, moves, **kw)
        ref = cs.exchange_slabs_plain(T, dim, hw, moves, **kw)
        assert all(_bits_equal(a, b) for a, b in zip(got, ref)), (dim, hw, step, periodic)
    assert cb.launch_counts()["exchange_slabs"] == 16


def _batches(rng, state, fields, block, shapes, dtype):
    """The per-field arguments of a batched K4s launch along each dim for
    ``fields`` (the other field left out), with the pipeline's moves and
    the earlier dims' corners (z, then x, then y)."""
    out = {}
    for dim in range(3):
        earlier = tuple(e for e in (2, 0, 1)[:(2, 0, 1).index(dim)])
        per_field = {}
        for f in fields:
            A = state[cw.FIELDS.index(f)]
            m = shapes[f]
            per_field[f] = (_moves(m[dim], 1), _earlier(rng, A.shape, m, earlier,
                                                        (1,) * len(earlier), dtype))
        out[dim] = per_field
    return out


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4s_batched_wave_every_dim_match_plain(on_host, dtype, periodic):
    """The K4s wave modes' batched launch along each dim on 2x2x2 blocks
    whose extents are no multiple of the tiles, with Vy left out of the
    batch (it gets no thread blocks), earlier dims' corners, bitwise."""
    rng = np.random.default_rng(35)
    n = K4S_STAGGERED_BLOCK
    shapes = cw.wave_shapes(n)
    st = tuple(_wave_tensor(rng.standard_normal(tuple(2 * s for s in shp)), dtype)
               for shp in shapes.values())
    for dim, per_field in _batches(rng, st, ("P", "Vx", "Vz"), n, shapes, dtype).items():
        kw = dict(block=n, periodic=periodic, consts=WAVE_K)
        got = cw.wave_slabs_multi(st, dim, 1, per_field, **kw)
        ref = cw.wave_slabs_multi_plain(st, dim, 1, per_field, **kw)
        assert sorted(got) == sorted(per_field)
        for f in per_field:
            assert all(_bits_equal(a, b) for a, b in zip(got[f], ref[f])), (dim, f)
    assert cb.launch_counts()["exchange_slabs"] == 3


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k4s_batched_stokes_every_dim_match_plain(on_host, dtype, periodic):
    """The K4s Stokes modes' batched launch along each dim on 2x2x2 blocks
    whose extents are no multiple of the tiles, with Vx left out of the
    batch, earlier dims' corners, on a state whose x planes are scaled to
    zero, tiny, subnormal and near-overflow values (every path of the
    division), bitwise."""
    rng = np.random.default_rng(36)
    n = K4S_STAGGERED_BLOCK
    scales = _scales(dtype)
    with np.errstate(over="ignore"):
        st = tuple(torch.from_numpy((rng.standard_normal(tuple(2 * s for s in shp)) * scales[
            rng.integers(0, 5, (2 * shp[0], 1, 1))]).astype(dtype))
            for shp in cst.stokes_shapes(n).values())
    shapes = cst.wave_shapes(n)
    for dim, per_field in _batches(rng, st, ("P", "Vy", "Vz"), n, shapes, dtype).items():
        kw = dict(block=n, periodic=periodic, consts=K)
        got = cst.stokes_slabs_multi(st, dim, 1, per_field, **kw)
        ref = cst.stokes_slabs_multi_plain(st, dim, 1, per_field, **kw)
        assert sorted(got) == sorted(per_field)
        for f in per_field:
            assert all(_bits_equal(a, b) for a, b in zip(got[f], ref[f])), (dim, f)
    assert cb.launch_counts()["exchange_slabs"] == 3


K4S_WALK_BLOCK = (35, 70, 21)


@pytest.mark.parametrize("mode,dtype", [("copy", np.float32), ("step", np.float64),
                                        ("wave", np.float32), ("stokes", np.float64)])
def test_k4s_z_launch_long_blocks_match_plain(on_host, mode, dtype):
    """The K4s z launch on blocks of 35 x 70 x 21, long enough along x for
    several chunks of the wave modes' walk (and its ring slots reused
    across them) and rows in two tiles, both sides periodic and not, with
    earlier dims' corners, bitwise: the copy at halowidths 1, 3 and 8, the
    3-D step at 1 and on two ranges of one block (update_slab), the wave
    and Stokes batches of every field, and each wave field on two ranges of
    8 (shift 0: two groups, slab positions in two tiles)."""
    rng = np.random.default_rng(37)
    n = K4S_WALK_BLOCK
    launches = 0
    if mode in ("copy", "step"):
        shape = tuple(2 * b for b in n)
        with np.errstate(over="ignore"):
            T, Cp = _diffusion_state(shape, dtype, 38)
        step = mode == "step"
        for periodic, hw in itertools.product((True, False), (1,) if step else (1, 3, 8)):
            earlier = _earlier(rng, shape, n, (0, 1), (1, hw), dtype)
            kw = dict(block=n, periodic=periodic, earlier=earlier, Cp=Cp if step else None,
                      consts=DIFF_K if step else None)
            got = cs.exchange_slabs(T, 2, hw, _moves(n[2], hw), **kw)
            ref = cs.exchange_slabs_plain(T, 2, hw, _moves(n[2], hw), **kw)
            launches += 1
            assert all(_bits_equal(a, b) for a, b in zip(got, ref)), (periodic, hw)
        if step:
            starts = [n[2] - 2, 1]
            got = cs.update_slab(T, Cp, 2, starts, 1, block=n, **DIFF_K)
            launches += 1
            for s0, g in zip(starts, got):
                assert _bits_equal(g, cs.update_slab_plain(T, Cp, 2, s0, 1, block=n, **DIFF_K))
        assert cb.launch_counts()["exchange_slabs"] == launches
        return
    mod = cw if mode == "wave" else cst
    shapes = mod.wave_shapes(n)
    all_shapes = shapes if mode == "wave" else cst.stokes_shapes(n)
    st = tuple(_wave_tensor(rng.standard_normal(tuple(2 * s for s in shp)), dtype)
               for shp in all_shapes.values())
    multi, plain, k = ((cw.wave_slabs_multi, cw.wave_slabs_multi_plain, WAVE_K)
                       if mode == "wave" else
                       (cst.stokes_slabs_multi, cst.stokes_slabs_multi_plain, K))
    per_field = _batches(rng, st, cw.FIELDS, n, shapes, dtype)[2]
    for periodic in (True, False):
        kw = dict(block=n, periodic=periodic, consts=k)
        got = multi(st, 2, 1, per_field, **kw)
        ref = plain(st, 2, 1, per_field, **kw)
        for f in per_field:
            assert all(_bits_equal(a, b) for a, b in zip(got[f], ref[f])), (periodic, f)
    if mode == "wave":
        for f, m in shapes.items():
            starts = [m[2] - 9, 1]
            got = cw.wave_update_slab(st, f, 2, starts, 8, block=n, consts=k)
            for s0, g in zip(starts, got):
                ref = cw.wave_slabs_plain(st, f, 2, 8, (cs.Move(s0, s0, 0),), block=n,
                                          periodic=True, consts=k)[0]
                assert _bits_equal(g, ref), (f, s0)
    assert cb.launch_counts()["exchange_slabs"] == (6 if mode == "wave" else 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,periods", [((2, 2, 2), (1, 0, 1)), ((1, 1, 1), (1, 1, 1))])
def test_run_acoustic_on_host_kernels_matches_plain(on_host, monkeypatch, dims, periods, dtype):
    """Four steps through the host build of K4s and K9 equal the plain
    versions' run bitwise, with one K9 and 3 K4s launches a step on the
    mesh (one a dim for the four fields) or K9 alone."""
    from implicitglobalgrid_tpu_torch.models import init_acoustic3d, run_acoustic

    _grid((9, 8, 10), dims, periods)
    s0, p = init_acoustic3d(dtype=dtype)
    a = run_acoustic(s0, p, 4, nt_chunk=2)
    counts = cb.launch_counts()
    _plain(monkeypatch)
    b = run_acoustic(s0, p, 4, nt_chunk=2)
    assert counts["acoustic_step_exchange"] == 4
    assert counts["exchange_slabs"] == (12 if dims == (2, 2, 2) else 0)
    for name, x, y in zip(cw.FIELDS, a, b):
        assert torch.equal(x, y), name


def test_bf16_stokes_takes_the_plain_route_by_the_counters(on_host):
    """On the same mesh a float32 Stokes run launches K10 and 3 K4s
    Stokes-mode launches an iteration, a bfloat16 one neither (the gate
    gives it the plain route); the kernels' wrappers refuse a bfloat16
    state on the card."""
    _grid((9, 8, 10), (2, 2, 2), (1, 0, 1))
    for dtype, k10, k4s in ((torch.float32, 2, 6), (torch.bfloat16, 0, 0)):
        cb.reset_launch_counts()
        s0, p = init_stokes3d(dtype=dtype)
        run_stokes(s0, p, 2, nt_chunk=2)
        counts = cb.launch_counts()
        assert (counts["stokes_step_exchange"], counts["exchange_slabs"]) == (k10, k4s), dtype
    E = tg.exceptions.InvalidArgumentError
    n = (9, 8, 10)
    st = tuple(a.contiguous() for a in s0)
    with pytest.raises(E):
        cst.stokes_step_recv(st, {}, block=n, consts=K)
    with pytest.raises(E):
        cst.stokes_slabs(st, "P", 0, 1, (cs.Move(7, 0, -1),), block=n, periodic=True,
                         consts=K)


@pytest.mark.parametrize("model", ["acoustic", "stokes"])
def test_one_runner_on_states_of_every_dtype_matches_plain(on_host, monkeypatch, model):
    """One runner of the mesh (its route and the K4s slabs it keeps) given
    float32, then float64, then bfloat16 states of the same shapes, and one
    `AcousticStep` given float32 then float64: each result equals the plain
    route's bitwise, and the bfloat16 Stokes state takes the plain route."""
    from implicitglobalgrid_tpu_torch.models import (
        init_acoustic3d, make_acoustic_run, make_stokes_run,
    )

    _grid((9, 8, 10), (2, 2, 2), (1, 0, 1))
    init, make = (init_acoustic3d, make_acoustic_run) if model == "acoustic" \
        else (init_stokes3d, make_stokes_run)
    dtypes = (torch.float32, torch.float64, torch.bfloat16)
    states = [init(dtype=dt) for dt in dtypes]
    run = make(states[0][1], 2)
    got = []
    for dt, (st, _) in zip(dtypes, states):
        cb.reset_launch_counts()
        got.append(run(*st))
        fused = model == "acoustic" or dt != torch.bfloat16
        assert cb.launch_counts()["exchange_slabs"] == (6 if fused else 0), dt
    if model == "acoustic":
        gg = tg.global_grid()
        n = (9, 8, 10)
        step = cw.AcousticStep(gg, cw.wave_exchange_modes(gg, list(cw.wave_shapes(n).values())),
                               rho=1.0, K=1.0, dt=0.05, dx=0.3, dy=0.2, dz=0.4, block=n)
        one = [step(states[i][0]) for i in (0, 1)]
    _plain(monkeypatch)
    run = make(states[0][1], 2)
    for dt, (st, _), a in zip(dtypes, states, got):
        b = run(*st)
        assert all(x.dtype == dt for x in a), dt
        for x, y in zip(a, b):
            assert torch.equal(x, y), dt
    if model == "acoustic":
        for i in (0, 1):
            assert _equal(one[i], step(states[i][0])), dtypes[i]


DIFF_K = dict(lam=1.0, dt=0.0123, dx=0.037, dy=0.041, dz=0.029)
# a block of several tiles along y and z and two x chunks (none a multiple),
# 2 blocks along each dim of the stack
DIFF_BLOCK = (35, 10, 34)


def _diffusion_state(shape, dtype, seed):
    """T with its x planes scaled at random to 1, zero, tiny, subnormal or
    near-overflow values (every path of the division), and Cp in [1, 2)."""
    rng = np.random.default_rng(seed)
    scales = _scales(np.float64 if dtype == np.float64 else np.float32)
    a = rng.standard_normal(shape) * scales[rng.integers(0, 5, (shape[0],) + (1,) * (len(shape) - 1))]
    c = 1 + rng.random(shape)
    return _wave_tensor(a, dtype), _wave_tensor(c, dtype)


def _bits_equal(a, b):
    return a.dtype == b.dtype and _same_bits(a.float() if a.dtype == torch.bfloat16 else a,
                                             b.float() if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k1_every_fuse_matches_plain(on_host, dtype):
    """K1 on a 2x2x2 stack of blocks with tile and chunk edges, with each
    of the 8 fuse combinations (the halo cells of a fused dim take the
    source cells n-2 and 1, corners composed), bitwise; and one 3^3 block,
    every dim fused (a source read by three output cells a dim)."""
    shape = tuple(2 * n for n in DIFF_BLOCK)
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 21)
        t3, c3 = _diffusion_state((3, 3, 3), dtype, 22)
    for fuse in itertools.product((False, True), repeat=3):
        got = cs.diffusion3d_step_halo(T, Cp, fuse=fuse, block=DIFF_BLOCK, **DIFF_K)
        ref = cs.diffusion3d_step_halo_plain(T, Cp, fuse=fuse, block=DIFF_BLOCK, **DIFF_K)
        assert _bits_equal(got, ref), fuse
    fuse = (True, True, True)
    assert _bits_equal(cs.diffusion3d_step_halo(t3, c3, fuse=fuse, **DIFF_K),
                       cs.diffusion3d_step_halo_plain(t3, c3, fuse=fuse, **DIFF_K))
    assert cb.launch_counts()["diffusion3d_step_halo"] == 9


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k4_every_mode_matches_plain(on_host, dtype):
    """K4 on a 2x2x2 stack of blocks with tile and chunk edges, receiving
    random slabs on each of the 8 combinations of dims (y rows over x
    planes over z lanes), bitwise."""
    shape = tuple(2 * n for n in DIFF_BLOCK)
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 23)
    rng = np.random.default_rng(24)
    for modes in itertools.product((False, True), repeat=3):
        recvs = {d: tuple(_wave_tensor(rng.standard_normal(
            [2 if e == d else s for e, s in enumerate(shape)]), dtype) for _ in range(2))
            for d in range(3) if modes[d]}
        got = cs.diffusion3d_step_recv(T, Cp, recvs, block=DIFF_BLOCK, **DIFF_K)
        ref = cs.diffusion3d_step_recv_plain(T, Cp, recvs, block=DIFF_BLOCK, **DIFF_K)
        assert _bits_equal(got, ref), modes
    assert cb.launch_counts()["diffusion3d_step_exchange"] == 8


@pytest.mark.parametrize("dtype", WAVE_DTYPES)
def test_k5_every_mode_matches_plain(on_host, dtype):
    """K5 on a 2x2 stack of 2-D blocks (several x chunks, rows not a
    multiple of its thread block), receiving random slabs on each of its 4
    combinations of dims (y lanes over x rows), bitwise."""
    block = (37, 70)
    shape = tuple(2 * n for n in block)
    c2 = {k: v for k, v in DIFF_K.items() if k != "dz"}
    with np.errstate(over="ignore"):
        T, Cp = _diffusion_state(shape, dtype, 25)
    rng = np.random.default_rng(26)
    for modes in itertools.product((False, True), repeat=2):
        recvs = {d: tuple(_wave_tensor(rng.standard_normal(
            [2 if e == d else s for e, s in enumerate(shape)]), dtype) for _ in range(2))
            for d in range(2) if modes[d]}
        got = cs.diffusion2d_step_recv(T, Cp, recvs, block=block, **c2)
        ref = cs.diffusion2d_step_recv_plain(T, Cp, recvs, block=block, **c2)
        assert _bits_equal(got, ref), modes
    assert cb.launch_counts()["diffusion2d_step_exchange"] == 4


@pytest.mark.parametrize("ndim", [3, 2])
def test_run_diffusion_on_host_kernels_matches_plain(on_host, monkeypatch, ndim):
    """Four steps through the host build of K4s and K4 (a 2x2x2 mesh: one
    K4 and 3 K4s launches a step) or K4s and K5 (a 2x2 mesh: one K5 and 2
    K4s launches a step) equal the plain versions' run bitwise."""
    if ndim == 3:
        _grid((10, 9, 35), (2, 2, 2), (1, 0, 1))
        T0, Cp, p = init_diffusion3d(dtype=torch.float32)
    else:
        _grid((19, 37, 1), (2, 2, 1), (1, 1, 0))
        T0, Cp, p = init_diffusion2d(dtype=torch.float32)
    a = run_diffusion(T0, Cp, p, 4, nt_chunk=2)
    counts = cb.launch_counts()
    _plain(monkeypatch)
    b = run_diffusion(T0, Cp, p, 4, nt_chunk=2)
    if ndim == 3:
        assert (counts["diffusion3d_step_exchange"], counts["exchange_slabs"]) == (4, 12)
    else:
        assert (counts["diffusion2d_step_exchange"], counts["exchange_slabs"]) == (4, 8)
    assert not torch.equal(a, T0)
    assert torch.equal(a, b)


# config 5's dx on one 128^3 block and on the 2x2x2 mesh, the 3 of divV/3 and
# chip_smoke's spacing (the full sample each), and random divisors of either
# sign (a tenth of it)
DIVISORS = [10 / 127, 10 / 253, 3.0, 0.079]
RANDOM_DIVISORS = [float(s * 10 ** e) for s, e in zip(
    np.random.default_rng(6).uniform(-2, 2, 4), np.random.default_rng(7).uniform(-4, 4, 4))]


def _numerators(dtype, n, seed):
    """``n`` random bit patterns (every exponent alike: subnormals, infs and
    NaNs included), then both signs of the least and greatest significand
    of every exponent, so both edges of every guard window, and the
    specials."""
    f = np.dtype(dtype)
    ui = np.uint32 if f.itemsize == 4 else np.uint64
    bits = np.random.default_rng(seed).integers(0, 2 ** (8 * f.itemsize), n, dtype=np.uint64,
                                                endpoint=False).astype(ui)
    mant = 23 if f.itemsize == 4 else 52
    e = np.arange(2 ** (8 * f.itemsize - 1 - mant), dtype=np.uint64) << np.uint64(mant)
    top = (np.uint64(1) << np.uint64(mant)) - np.uint64(1)
    edges = np.concatenate([e, e | top, e | np.uint64(1), e | (top - np.uint64(1))]).astype(ui)
    sign = ui(1) << ui(8 * f.itemsize - 1)
    a = np.concatenate([bits, edges, edges | sign]).view(f)
    return np.concatenate([a, np.array([0.0, -0.0, np.inf, -np.inf, np.nan], dtype=f)])


def _near_least_normal_quotient(dtype, b):
    """Both signs of the 2^16 numerators on either side of b times the least
    normal number and of b times twice it: quotients at the edge of the
    scaled path."""
    f = np.dtype(dtype)
    ui = np.dtype(f"u{f.itemsize}")
    tiny = np.finfo(f).tiny
    centre = np.array([abs(dtype(b)) * tiny, abs(dtype(b)) * 2 * tiny], dtype=f).view(ui)
    steps = np.arange(-2 ** 15, 2 ** 15).astype(ui)
    a = (centre[:, None] + steps[None, :]).ravel().view(f)
    return np.concatenate([a, -a])


@pytest.mark.parametrize("dtype,n", [(np.float32, 10 ** 7), (np.float64, 2 * 10 ** 6)])
def test_cdiv_equals_ieee_division(host_lib, dtype, n):
    """cdiv.cuh's quotient by a constant, and the passes K10's tiles divide
    with (fast, then exact), is the IEEE quotient bit for bit (two NaNs
    agree), on the host build of `igg_cdiv`."""
    full = _numerators(dtype, n, 8)
    for b, a in [(b, full) for b in DIVISORS] + [(b, full[-n // 10:]) for b in RANDOM_DIVISORS]:
        a = np.concatenate([a, _near_least_normal_quotient(dtype, b)])
        with np.errstate(all="ignore"):
            ref = a / dtype(b)
        for mode in (0, 2):  # cdiv; the tiles' passes (fast, then exact)
            q = np.empty_like(a)
            rc = host_lib.igg_cdiv(0 if dtype == np.float32 else 1, a.ctypes.data,
                                   q.ctypes.data, a.size, b, mode, None)
            assert rc == 0
            same = (q.view(f"u{a.itemsize}") == ref.view(f"u{a.itemsize}")) | (
                np.isnan(q) & np.isnan(ref))
            assert same.all(), (b, mode, a[~same][:5], q[~same][:5], ref[~same][:5])


# K8 and K7: blocks that no tile divides (8 rows or planes of a tile, 32 rows
# of a z tile), and one whose rows copy in 16-byte words along x and y
K78_BLOCK = (11, 70, 37)
K78_VEC_BLOCK = (11, 70, 40)
K78_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": "bfloat16",
              "int8": np.int8}


def _k78_field(rng, shape, dtype):
    if dtype == np.int8:
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    return _wave_tensor(rng.standard_normal(shape), dtype)


def _staggered(n, names):
    return [tuple(m + (f == f"V{a}") for a, m in zip("xyz", n)) for f in names]


# (block shapes, halowidths, block counts, dtype): the slab layout (every
# field the same cross extents) with a shared and with per-field
# halowidths, and the flat layout (the staggered fields); grids of 2x2x2
# and 3x1x2 blocks
K78_CASES = {
    "slab-hw1-vec-f32": ([K78_VEC_BLOCK] * 3, [1, 1, 1], (2, 2, 2), "float32"),
    "slab-per-field-bf16": ([K78_BLOCK] * 3, [1, 2, 3], (2, 2, 2), "bfloat16"),
    "flat-hw2-f64": (_staggered(K78_BLOCK, ("P", "Vx", "Vy", "Vz")), [2] * 4, (3, 1, 2),
                     "float64"),
    "flat-per-field-int8": (_staggered(K78_BLOCK, ("Vx", "Vy", "Vz", "P")), [1, 2, 1, 3],
                            (3, 1, 2), "int8"),
}


@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(K78_CASES))
def test_k8_k7_match_plain(on_host, monkeypatch, case, dim):
    """K8 (both directions, send starts inside the block) and then K7
    (periodic and PROC_NULL edges, disp 1 and 2) along each dim on a group
    of stacked fields, each launch bitwise against its plain version: both
    wire layouts, shared and per-field halowidths, blocks no tile divides
    and a 3x1x2 grid (a single block along y, disp 2 past the 2 blocks
    along z); rows in 16-byte words where the slabs align."""
    blocks, hws, counts, dname = K78_CASES[case]
    dtype = K78_DTYPES[dname]
    monkeypatch.setattr(ch, "_GROUPS", {})  # this test's groups only
    rng = np.random.default_rng(71 + dim)
    fs = [_k78_field(rng, tuple(c * m for c, m in zip(counts, blk)), dtype) for blk in blocks]
    sch = schema_for_fields(dim, blocks, hws, fs[0].dtype)
    assert sch.layout == case.split("-")[0]
    kw = dict(starts_r=[blk[dim] - 2 * h for blk, h in zip(blocks, hws)],
              starts_l=[h for h in hws], blocks=blocks)
    bufs = ch.wire_pack(fs, sch, **kw)
    assert _equal(bufs, ch.wire_pack_plain(fs, sch, **kw)), "K8"
    launches = 1
    for periodic, disp in itertools.product((True, False), (1, 2)):
        got, want = [f.clone() for f in fs], [f.clone() for f in fs]
        wk = dict(blocks=blocks, periodic=periodic, disp=disp)
        ch.halo_write_multi(got, *bufs, sch, **wk)
        ch.halo_write_multi_plain(want, *bufs, sch, **wk)
        launches += 1
        assert _equal(got, want), ("K7", periodic, disp)
    counts = cb.launch_counts()
    assert (counts["wire_pack"], counts["halo_write_multi"]) == (1, launches - 1)
    vec = [g[5][k * ch._SLAB_DESC + 13] for g in ch._GROUPS.values() for k in range(len(fs))]
    if dim == 2:
        assert not any(vec)  # a z slab is hw cells a row
    elif case.startswith("slab-hw1-vec"):
        assert all(vec)


@pytest.mark.parametrize("dim", [0, 1])
def test_k8_k7_2d_fields_match_plain(on_host, dim):
    """K8 and K7 on 2-D fields (rows of one cell: the trailing dim padded),
    slab and flat layouts, periodic and PROC_NULL, bitwise."""
    rng = np.random.default_rng(75)
    for blocks, hws in (([(37, 70)] * 2, [1, 2]), ([(37, 70), (38, 70), (37, 71)], [1, 1, 2])):
        fs = [_k78_field(rng, (2 * b[0], 2 * b[1]), np.float32) for b in blocks]
        sch = schema_for_fields(dim, blocks, hws, fs[0].dtype)
        kw = dict(starts_r=[b[dim] - 2 * h for b, h in zip(blocks, hws)], starts_l=hws,
                  blocks=blocks)
        bufs = ch.wire_pack(fs, sch, **kw)
        assert _equal(bufs, ch.wire_pack_plain(fs, sch, **kw)), (sch.layout, "K8")
        for periodic in (True, False):
            got, want = [f.clone() for f in fs], [f.clone() for f in fs]
            ch.halo_write_multi(got, *bufs, sch, blocks=blocks, periodic=periodic, disp=1)
            ch.halo_write_multi_plain(want, *bufs, sch, blocks=blocks, periodic=periodic,
                                      disp=1)
            assert _equal(got, want), (sch.layout, periodic)


@pytest.mark.parametrize("nfields", [4, 16, 17])
def test_coalesced_update_halo_on_host_kernels(on_host, monkeypatch, nfields):
    """`update_halo` of a group through the host build of K8 and K7, with
    their launch counts, bitwise against the plain versions' call: (P, Vx,
    Vy, Vz) on a 2x2x2 periodic grid (one K8 and one K7 a dim), and 16 and
    17 fields on a 2x1x2 grid with y not periodic (17 take two launches a
    dim)."""
    if nfields == 4:
        n, dims, periods = (9, 8, 10), (2, 2, 2), (1, 1, 1)
        shapes = _staggered(n, ("P", "Vx", "Vy", "Vz"))
    else:
        n, dims, periods = (6, 5, 7), (2, 1, 2), (1, 0, 0)
        shapes = [n] * nfields
    _grid(n, dims, periods)
    rng = np.random.default_rng(77)
    fs = [_k78_field(rng, tuple(d * m for d, m in zip(dims, s)), np.float32) for s in shapes]
    got = tg.update_halo(*[f.clone() for f in fs])
    counts = cb.launch_counts()
    _plain(monkeypatch)
    want = tg.update_halo(*[f.clone() for f in fs])
    ndims = sum(d > 1 or p for d, p in zip(dims, periods))
    per_dim = 1 if nfields <= ch.MAX_SLABS else 2
    assert (counts["wire_pack"], counts["halo_write_multi"]) == (ndims * per_dim,) * 2
    assert sum(counts.values()) == 2 * ndims * per_dim
    assert _equal(got, want)


# an ensemble's group: the four staggered fields (the flat layout) on blocks
# of (5, 9, 37) (a z tile's 32 rows and an x or y tile's 8 rows cut short),
# 2x2x1 blocks; one vec case: slab layout, rows of whole 16-byte words
K78_MEMBER_CASES = {"flat-f32": (_staggered((5, 9, 37), ("P", "Vx", "Vy", "Vz")), np.float32),
                    "slab-vec-f64": ([(5, 9, 38)] * 4, np.float64)}


@pytest.mark.parametrize("members", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(K78_MEMBER_CASES))
def test_k8_k7_members_match_plain(on_host, monkeypatch, case, members):
    """K8 and K7 with a member count and stride (an ensemble's fields lead
    with E members, every member in the launch), along every dim, periodic
    and PROC_NULL, bitwise against their plain versions at E = 1, 3 and
    16; member m's part of each row is member m's own solo K8 row, and at E
    = 1 the launch is the solo launch, bit for bit."""
    blocks, dtype = K78_MEMBER_CASES[case]
    counts, hws = (2, 2, 1), [1] * len(blocks)
    monkeypatch.setattr(ch, "_GROUPS", {})
    rng = np.random.default_rng(80 + members)
    fs = [_k78_field(rng, (members,) + tuple(c * m for c, m in zip(counts, blk)), dtype)
          for blk in blocks]
    for dim in range(3):
        sch = schema_for_fields(dim, blocks, hws, fs[0].dtype, members=members)
        solo = schema_for_fields(dim, blocks, hws, fs[0].dtype)
        kw = dict(starts_r=[blk[dim] - 2 for blk in blocks], starts_l=hws, blocks=blocks)
        bufs = ch.wire_pack(fs, sch, **kw)
        assert _equal(bufs, ch.wire_pack_plain(fs, sch, **kw)), (dim, "K8")
        for m in range(members):
            own = ch.wire_pack([f[m].contiguous() for f in fs], solo, **kw)
            rows = [b.view(b.shape[0], members, -1)[:, m] for b in bufs]
            assert _equal(rows, own), (dim, m)
        for periodic in (True, False):
            got, want = [f.clone() for f in fs], [f.clone() for f in fs]
            wk = dict(blocks=blocks, periodic=periodic, disp=1)
            ch.halo_write_multi(got, *bufs, sch, **wk)
            ch.halo_write_multi_plain(want, *bufs, sch, **wk)
            assert _equal(got, want), (dim, periodic, "K7")
            if members == 1:
                alone = [f[0].clone() for f in fs]
                ch.halo_write_multi(alone, *bufs, solo, **wk)
                assert _equal([g[0] for g in got], alone), (dim, periodic)
    desc = [g[5] for g in ch._GROUPS.values() if g[5] is not None]
    assert desc and all(d[k * ch._SLAB_DESC + 14] in (1, members) for d in desc
                        for k in range(len(blocks)))


# K2, K3 and K6 on a 2x2x2 stack of blocks that no thread block divides; the
# new cases also on blocks whose rows are whole 16-byte words in every
# element size (K2: 1-D fields of 4 blocks, 2-D and 3-D of 2 a dim)
HALO_BLOCK = (6, 5, 37)
HALO_VEC_BLOCK = (6, 10, 64)
K2_BLOCKS = {(1, False): (37,), (1, True): (32,), (2, False): (37, 70), (2, True): (37, 64),
             (3, False): HALO_BLOCK, (3, True): HALO_VEC_BLOCK}
# every element size
HALO_DTYPES = (np.int8, np.int16, np.float32, np.float64)


def _halo_field(rng, shape, dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return torch.from_numpy(rng.integers(info.min, info.max, shape).astype(dtype))
    return _k78_field(rng, shape, dtype)


def _halo_case(kernel, arg, rng, dtype):
    """One K2, K3 or K6 call and its plain version's on a random field:
    ``arg`` is (dim, hw) or (dim, hw, block) for K2, the modes for K3, the
    modes or (modes, hw_x, block) for K6."""
    if kernel == "k2":
        dim, hw, block = arg if len(arg) == 3 else (*arg, HALO_BLOCK)
        counts = (4,) if len(block) == 1 else (2,) * len(block)
        shape = tuple(c * b for c, b in zip(counts, block))
        A = _halo_field(rng, shape, dtype)
        ss = [c * hw if a == dim else s for a, (c, s) in enumerate(zip(counts, shape))]
        sl, sr = (_halo_field(rng, tuple(ss), dtype) for _ in range(2))
        kw = dict(dim=dim, hw=hw, block=block[dim])
        return ch.halo_write(A.clone(), sl, sr, **kw), ch.halo_write_plain(A.clone(), sl, sr, **kw)
    if kernel == "k3":
        A = _halo_field(rng, tuple(2 * b for b in HALO_BLOCK), dtype)
        kw = dict(modes=arg, ols=(2, 2, 3), block=HALO_BLOCK)
        return ch.halo_self_exchange(A, **kw), ch.halo_self_exchange_plain(A, **kw)
    modes, hws, block = (arg, (2, 1, 1), HALO_BLOCK) if len(arg) == 3 and isinstance(arg[0], bool) \
        else (arg[0], (arg[1], 1, 1), arg[2])
    shape = tuple(2 * b for b in block)
    A = _halo_field(rng, shape, dtype)
    recvs = {d: tuple(_halo_field(rng, tuple(2 * hws[d] if a == d else s for a, s in
                                              enumerate(shape)), dtype) for _ in range(2))
             for d in range(3) if modes[d]}
    kw = dict(modes=modes, hws=hws, block=block)
    return (ch.halo_write_combined(A.clone(), recvs, **kw),
            ch.halo_write_combined_plain(A.clone(), recvs, **kw))


K6_MODES = [(False, False, True), (True, False, True), (False, True, True), (True, True, True)]
HALO_CASES = ([("k2", (0, 1)), ("k2", (1, 2)), ("k2", (2, 1)), ("k3", (True, False, True)),
               ("k3", (True, True, True)), ("k6", (True, True, True)), ("k6", (False, True, True))]
              + [("k2", (dim, hw, K2_BLOCKS[nd, vec])) for nd in (1, 2, 3) for vec in (False, True)
                 for dim in range(nd) for hw in (1, 2)]
              + [("k6", (modes, hwx, block)) for block in (HALO_BLOCK, HALO_VEC_BLOCK)
                 for modes in K6_MODES for hwx in (1, 2)])


@pytest.mark.parametrize("kernel,arg", HALO_CASES)
def test_k2_k3_k6_match_plain(on_host, kernel, arg):
    """The host build of K2 (a dim and halowidth), K3 (self-exchange modes)
    and K6 (combined delivery of the dims flagged) bitwise against their
    plain versions: the first seven cases in float64 and int8 on 2x2x2
    stacks of (6, 5, 37) blocks; then K2 on every dim, halowidths 1 and 2,
    1-D, 2-D and 3-D fields, and K6 on every mode combination its gate
    admits with x halowidths 1 and 2, each on blocks whose rows are and are
    not whole 16-byte words, in every element size (1, 2, 4 and 8 bytes)."""
    rng = np.random.default_rng(79)
    dtypes = (np.float64, np.int8) if HALO_CASES.index((kernel, arg)) < 7 else HALO_DTYPES
    for dtype in dtypes:
        got, want = _halo_case(kernel, arg, rng, dtype)
        assert torch.equal(got, want), dtype
    name = {"k2": "halo_write", "k3": "halo_self_exchange", "k6": "halo_write_combined"}[kernel]
    assert cb.launch_counts()[name] == len(dtypes)


def test_k2_k6_check_once_a_signature(on_host, monkeypatch):
    """K2's and K6's wrappers check a call once a signature: a second call
    with the same shapes, dtypes and arguments reuses the first's result
    and still launches (and matches the plain version); a new shape is
    checked again; a slab that aliases the field raises on every call."""
    monkeypatch.setattr(ch, "_CALLS", {})
    checks = []
    for name in ("_check_write", "_check_combined"):
        real = getattr(ch, name)
        monkeypatch.setattr(ch, name, lambda *a, real=real, name=name: (checks.append(name),
                                                                          real(*a))[1])
    rng = np.random.default_rng(80)
    for k in range(2):
        got, want = _halo_case("k2", (2, 1), rng, np.float32)
        assert torch.equal(got, want), k
        got, want = _halo_case("k6", (True, True, True), rng, np.float32)
        assert torch.equal(got, want), k
    assert checks == ["_check_write", "_check_combined"]
    assert (cb.launch_counts()["halo_write"], cb.launch_counts()["halo_write_combined"]) == (2, 2)
    _halo_case("k2", (2, 1, HALO_VEC_BLOCK), rng, np.float32)
    assert checks[-1] == "_check_write" and len(checks) == 3
    shape = tuple(2 * b for b in HALO_BLOCK)
    whole = torch.zeros(int(np.prod(shape)) + 2 * 2 * shape[0] * shape[1], dtype=torch.float32)
    A = whole[:int(np.prod(shape))].view(shape)
    sl = whole[int(np.prod(shape)):].view(shape[0], shape[1], 4)[..., :2].contiguous()
    alias = whole[int(np.prod(shape)):int(np.prod(shape)) + sl.numel()].view(sl.shape)
    E = tg.exceptions.InvalidArgumentError
    for _ in range(2):
        with pytest.raises(E, match="alias"):
            ch.halo_write(A, alias, sl, dim=2, hw=1, block=HALO_BLOCK[2])
        with pytest.raises(E, match="alias"):
            ch.halo_write_combined(A, {2: (sl, alias)}, modes=(False, False, True),
                                   hws=(1, 1, 1), block=HALO_BLOCK)
    assert checks[3:] == ["_check_combined"]  # the aliased calls' one new signature
    assert cb.launch_counts()["halo_write"] == 3


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_fma_chain_matches_plain(on_host, monkeypatch, iters):
    """The calibration kernel (`csrc/calibrate.cu`): every element's chain
    of single-rounding multiply-adds equals the plain version's (which
    rounds through float64: equal but where a float64 sum lands on a
    float32 midpoint, which these inputs do not meet), a ragged last block
    included; one launch counted a call."""
    from implicitglobalgrid_tpu_torch.ops import cuda_calibrate as cc

    monkeypatch.setattr(cc, "_on_card", lambda t: True)
    monkeypatch.setattr(cc, "_stream", lambda t: None)
    g = torch.Generator().manual_seed(iters)
    x = torch.rand(3 * 256 + 17, generator=g) * 4 - 2
    got = cc.fma_chain(x.clone(), iters, 1.000001, 1e-9)
    ref = cc.fma_chain_plain(x.clone(), iters, 1.000001, 1e-9)
    assert torch.equal(got, ref)
    assert cb.launch_counts()["fma_chain"] == 1
    big = cc.fma_chain(x.clone(), iters, 0.75, 0.25)
    assert torch.equal(big, cc.fma_chain_plain(x.clone(), iters, 0.75, 0.25))
