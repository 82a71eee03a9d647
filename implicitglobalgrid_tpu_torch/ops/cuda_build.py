"""Build, load and count the hand-written CUDA kernels.

The sources in ``csrc/`` are compiled at first use for ``sm_90a`` (Hopper)
with `nvcc`: one `nvcc -c` per source, all started together, then one link
into a shared library with a plain C interface, loaded with `ctypes`. The
library is named by a hash of the sources and flags and kept in ``_build/``
beside the package (git-ignored), so a changed source rebuilds and an
unchanged one loads at once.

Every wrapper counts its launches here (`count_launch`); `launch_counts`
reads the counts, `k4s_launch_counts` K4s's by mode and dim, and
`reset_launch_counts` sets them all to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ..utils.exceptions import KernelError, NotLoadedError

__all__ = ["build_kernels", "library", "count_launch", "launch_counts",
           "k4s_launch_counts", "reset_launch_counts", "check_rc", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("stencil.cu", "halo.cu", "wave.cu", "stokes.cu", "calibrate.cu")
HEADERS = ("cdiv.cuh", "wave.cuh", "stokes.cuh")
# -fmad=false: no multiply-add contraction, so the stencil stays at ulp
# distance from its plain PyTorch version; -Xptxas -v reports registers,
# shared memory and spills of every kernel (kept in `build_info`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_C_VOID = ctypes.c_void_p
_C_LL = ctypes.c_longlong
_C_INT = ctypes.c_int
_C_DBL = ctypes.c_double
_SIGNATURES = {
    "igg_diffusion3d_step_halo": [_C_INT, _C_VOID, _C_VOID, _C_VOID]
    + [_C_LL] * 6 + [_C_DBL] * 5 + [_C_INT] * 3 + [_C_VOID],
    "igg_halo_write": [_C_INT, _C_VOID, _C_VOID, _C_VOID, _C_LL, _C_LL, _C_LL,
                       _C_INT, _C_LL, _C_LL, _C_VOID],
    "igg_halo_self_exchange": [_C_INT, _C_VOID, _C_VOID] + [_C_LL] * 6
    + [_C_INT] * 3 + [_C_LL] * 3 + [_C_VOID],
    "igg_diffusion3d_step_exchange": [_C_INT, _C_VOID, _C_VOID, _C_VOID]
    + [_C_LL] * 6 + [_C_DBL] * 5 + [_C_VOID] * 7,
    "igg_diffusion2d_step_exchange": [_C_INT, _C_VOID, _C_VOID, _C_VOID]
    + [_C_LL] * 4 + [_C_DBL] * 4 + [_C_VOID] * 5,
    "igg_exchange_slabs": [_C_INT] * 3 + [_C_VOID] * 4 + [_C_LL] * 6
    + [_C_INT, _C_LL, _C_INT] + [_C_LL] * 6
    + [_C_INT, _C_LL, _C_VOID, _C_VOID] * 2 + [_C_DBL] * 5 + [_C_VOID],
    "igg_halo_write_combined": [_C_INT] + [_C_VOID] * 7 + [_C_LL] * 7 + [_C_VOID],
    "igg_coalesced_plan": [_C_INT, _C_INT, _C_VOID] + [_C_LL] * 4 + [_C_INT],
    "igg_wire_pack": [_C_INT, _C_INT] + [_C_VOID] * 3 + [_C_LL] * 4 + [_C_INT, _C_VOID],
    "igg_halo_write_multi": [_C_INT, _C_INT] + [_C_VOID] * 3 + [_C_LL] * 4
    + [_C_INT, _C_INT, _C_LL, _C_VOID],
    "igg_exchange_slabs_wave": [_C_INT] + [_C_VOID] * 4,
    "igg_acoustic_step_exchange": [_C_INT, _C_INT] + [_C_VOID] * 4,
    "igg_exchange_slabs_stokes": [_C_INT] + [_C_VOID] * 4,
    "igg_stokes_step_exchange": [_C_INT, _C_INT] + [_C_VOID] * 4,
    "igg_cdiv": [_C_INT, _C_VOID, _C_VOID, _C_LL, _C_DBL, _C_INT, _C_VOID],
    "igg_cdiv_sweep": [_C_DBL, _C_VOID, _C_VOID],
    "igg_fma_chain": [_C_VOID, _C_LL, _C_INT, _C_DBL, _C_DBL, _C_VOID],
}

_lib = None
build_info: dict = {}
_launches: dict = {"diffusion3d_step_halo": 0, "halo_write": 0,
                   "halo_self_exchange": 0, "diffusion3d_step_exchange": 0,
                   "diffusion2d_step_exchange": 0, "halo_write_combined": 0,
                   "exchange_slabs": 0, "wire_pack": 0, "halo_write_multi": 0,
                   "acoustic_step_exchange": 0, "stokes_step_exchange": 0,
                   "fma_chain": 0}
_k4s_launches: dict = {}


def count_launch(name: str, detail: str = "") -> None:
    """One launch of kernel ``name``; ``detail`` (a K4s launch's mode and
    dim, as ``"wave/2"``) also counts it in `k4s_launch_counts`."""
    _launches[name] += 1
    if detail:
        _k4s_launches[detail] = _k4s_launches.get(detail, 0) + 1


def launch_counts() -> dict:
    return dict(_launches)


def k4s_launch_counts() -> dict:
    """The K4s launches by mode and dim (``"step/2"``, ``"stokes/0"``)."""
    return dict(_k4s_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
    _k4s_launches.clear()


def check_rc(rc: int, name: str) -> None:
    """Raise `KernelError` for a nonzero CUDA error code of a launch."""
    if rc != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: cudaError {rc}.")


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
            or "/usr/local/cuda"
        p = Path(home) / "bin" / "nvcc"
        cand = str(p) if p.exists() else None
    if cand is None:
        raise NotLoadedError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                             "to build the CUDA kernels.")
    return cand


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES + HEADERS:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"libigg_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> dict:
    """Compile the kernels unless the library for these sources exists.
    Returns `build_info`: ``{"path", "seconds", "built", "ptxas"}`` (the
    ptxas report is kept beside the library)."""
    so = _library_path()
    log = so.with_suffix(".ptxas.txt")
    if so.exists():
        if build_info.get("path") != str(so):
            build_info.update(path=str(so), seconds=0.0, built=False,
                              ptxas=log.read_text() if log.exists() else "")
        return dict(build_info)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in SOURCES:
            obj = Path(tmp) / (Path(s).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(obj)]
            procs.append((s, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, objs, failed = [], [], []
        for s, obj, p in procs:
            out, err = p.communicate()
            logs.append(f"== {s}\n{out}{err}")
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(s)
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *objs, "-o", str(tmp_so)], capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        log.write_text("\n".join(logs))
        os.replace(tmp_so, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      built=True, ptxas="\n".join(logs))
    return dict(build_info)


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernels()["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
