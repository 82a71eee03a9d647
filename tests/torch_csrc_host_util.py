"""Shared pieces of the host-build tests of the port's CUDA sources
(`tests/test_torch_csrc_host*.py`): `csrc/*.cu` compiled with the host C++
compiler against the stand-in headers of `tests/data/cuda_host/` (each
`kernel<<<grid, block, ...>>>(args)` rewritten into a host launch that runs
a block's threads concurrently, with barriers for `__syncthreads` and the
warp shuffles), loaded in place of the card's library (`host_lib`, built
once a test module) and driven through the port's own wrappers on CPU
tensors (`on_host`), with the states, grids and constants the tests share.
The tests are split over several files so that the test runner's workers
take them in parallel (each file builds the library once).
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
from implicitglobalgrid_tpu_torch.ops import cuda_build as cb
from implicitglobalgrid_tpu_torch.ops import cuda_halo as ch
from implicitglobalgrid_tpu_torch.ops import cuda_stencil as cs
from implicitglobalgrid_tpu_torch.ops import cuda_stokes as cst
from implicitglobalgrid_tpu_torch.ops import cuda_wave as cw


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


WAVE_K = cw.wave_consts(rho=1.0, K=1.0, dt=0.05, dx=0.3, dy=0.2, dz=0.4)


WAVE_DTYPES = [np.float32, np.float64, "bfloat16"]


def _wave_tensor(a, dtype):
    t = torch.from_numpy(a.astype(np.float32 if dtype == "bfloat16" else dtype))
    return t.bfloat16() if dtype == "bfloat16" else t


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


K4S_WALK_BLOCK = (35, 70, 21)


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


# an ensemble's group: the four staggered fields (the flat layout) on blocks
# of (5, 9, 37) (a z tile's 32 rows and an x or y tile's 8 rows cut short),
# 2x2x1 blocks; one vec case: slab layout, rows of whole 16-byte words
K78_MEMBER_CASES = {"flat-f32": (_staggered((5, 9, 37), ("P", "Vx", "Vy", "Vz")), np.float32),
                    "slab-vec-f64": ([(5, 9, 38)] * 4, np.float64)}


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
