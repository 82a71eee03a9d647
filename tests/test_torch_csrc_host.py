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
the Stokes code), the batched K4s launch of every field of a dim, and whole
`run_stokes` and `run_acoustic` runs with their launch counts; the
division helper of `cdiv.cuh` bitwise against IEEE division.

The card's compiler, its float units and its launch limits are not tested
here (`chip_smoke.py` does that on a GPU); the kernels' index arithmetic,
masks, carried registers, shared-memory tiles, barriers, routes and
delivery order are. Skips without a C++ compiler.
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
