"""The port's checkpoints (`implicitglobalgrid_tpu_torch.utils.checkpoint`)
against the JAX package's, on the CPU: the cases of `tests/test_checkpoint.py`
on the port's 8-rank virtual mesh, then each package restoring the other's
single-file, sharded and elastic containers bitwise (float64, float32, int,
staggered fields, an E = 2 ensemble with ``lead__`` recorded), and bfloat16
one way (JAX writes, the port reads: the JAX package's own bfloat16 restore
fails on numpy's ``V2`` member)."""

import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu_torch.utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError,
)

from torch_port_util import clean_torch_grid, init_both  # noqa: F401


def _init(**kw):
    tg.init_global_grid(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1, quiet=True,
                        nranks=8, device_type="cpu", **kw)


def _arange():
    return tg.device_put_g(np.arange(1000, dtype=np.float64).reshape(10, 10, 10))


def _bitwise(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# `tests/test_checkpoint.py`, on the port
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    _init()
    p = str(tmp_path / "ckpt.npz")
    T = _arange()
    Cp = tg.ones_g(dtype=torch.float64)
    tg.save_checkpoint(p, {"T": T, "Cp": Cp}, step=42)
    state, step = tg.restore_checkpoint(p)
    assert step == 42
    assert torch.equal(state["T"], T) and torch.equal(state["Cp"], Cp)
    r = tg.update_halo(state["T"])  # a restored tensor is a field of the grid
    assert tuple(r.shape) == (10, 10, 10)


def test_resume_continues_simulation(tmp_path):
    from implicitglobalgrid_tpu_torch.models import init_diffusion3d, run_diffusion

    _init()
    p = str(tmp_path / "ckpt.npz")
    T, Cp, prm = init_diffusion3d(dtype=torch.float64)
    T10 = run_diffusion(T, Cp, prm, 10, nt_chunk=5)
    tg.save_checkpoint(p, {"T": T10, "Cp": Cp}, step=10)
    state, step = tg.restore_checkpoint(p)
    resumed = run_diffusion(state["T"], state["Cp"], prm, 5, nt_chunk=5)
    straight = run_diffusion(T10, Cp, prm, 5, nt_chunk=5)
    assert torch.equal(resumed, straight)


def test_sharded_save_restore_roundtrip(tmp_path):
    _init()
    d = str(tmp_path / "ckpt_dir")
    T = _arange()
    Cp = tg.ones_g(dtype=torch.float32)
    tg.save_checkpoint_sharded(d, {"T": T, "Cp": Cp}, step=7)
    assert os.path.exists(os.path.join(d, "meta.npz"))
    assert os.path.exists(os.path.join(d, "shards_p0.npz"))
    state, step = tg.restore_checkpoint_sharded(d)
    assert step == 7
    assert torch.equal(state["T"], T)
    assert state["Cp"].dtype == torch.float32 and torch.equal(state["Cp"], Cp)
    assert tuple(tg.update_halo(state["T"]).shape) == (10, 10, 10)
    # one member a block, keyed by the block's starts: 8 blocks of 5^3
    with np.load(os.path.join(d, "shards_p0.npz")) as z:
        tkeys = [k for k in z.files if k.startswith("__igg_arr__T__")]
        assert len(tkeys) == 8
        assert all(z[k].shape == (5, 5, 5) for k in tkeys)


def test_sharded_topology_mismatch_and_missing(tmp_path):
    _init()
    d = str(tmp_path / "ckpt_dir")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()})
    tg.finalize_global_grid()
    tg.init_global_grid(5, 5, 5, dimx=4, dimy=2, dimz=1, periodx=1, quiet=True,
                        nranks=8, device_type="cpu")
    with pytest.raises(IncoherentArgumentError, match="topology mismatch"):
        tg.restore_checkpoint_sharded(d)
    with pytest.raises(IncoherentArgumentError, match="cannot reshard"):
        tg.restore_checkpoint_sharded(d, strict=False)
    with pytest.raises(InvalidArgumentError, match="meta not found"):
        tg.restore_checkpoint_sharded(str(tmp_path / "nope"))
    tg.finalize_global_grid()
    _init()
    with pytest.raises(InvalidArgumentError, match="'__'"):
        tg.save_checkpoint_sharded(d, {"bad__key": tg.ones_g()})


def test_sharded_stale_files_cleaned_and_ignored(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()})
    stale = os.path.join(d, "shards_p7.npz")
    np.savez(stale, junk=np.zeros(3))
    st, _ = tg.restore_checkpoint_sharded(d)  # the meta's file count rules
    assert torch.equal(st["A"], torch.ones(10, 10, 10))
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()})  # a re-save replaces the set
    assert not os.path.exists(stale)
    os.remove(os.path.join(d, "shards_p0.npz"))
    with pytest.raises(InvalidArgumentError, match="incomplete"):
        tg.restore_checkpoint_sharded(d)


def test_sharded_interrupted_save_detected(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()}, step=1)
    old_shard = str(tmp_path / "old_shard.npz")
    shutil.copy(os.path.join(d, "shards_p0.npz"), old_shard)
    tg.save_checkpoint_sharded(d, {"A": tg.zeros_g()}, step=2)
    st, sp = tg.restore_checkpoint_sharded(d)
    assert sp == 2 and float(st["A"].max()) == 0.0
    shutil.copy(old_shard, os.path.join(d, "shards_p0.npz"))  # meta of save 2, shards of 1
    with pytest.raises(IncoherentArgumentError, match="save-token"):
        tg.restore_checkpoint_sharded(d)


def test_sharded_checksum_detects_bitflip(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()}, step=1)
    assert os.path.exists(os.path.join(d, "shards_p0.npz.sha256"))
    tg.corrupt_checkpoint(d, kind="bitflip", target="shard")
    with pytest.raises(IncoherentArgumentError, match="corrupt"):
        tg.restore_checkpoint_sharded(d)


def test_sharded_checksum_detects_truncation_and_meta_flip(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()}, step=1)
    tg.corrupt_checkpoint(d, kind="truncate", target="shard")
    with pytest.raises(IncoherentArgumentError, match="corrupt"):
        tg.restore_checkpoint_sharded(d)
    tg.finalize_global_grid()
    _init()
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()}, step=2)
    st, sp = tg.restore_checkpoint_sharded(d)
    assert sp == 2
    tg.corrupt_checkpoint(d, kind="bitflip", target="meta")
    with pytest.raises(IncoherentArgumentError, match="corrupt"):
        tg.restore_checkpoint_sharded(d)


def test_sharded_save_leaves_no_staging_dirs(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()}, step=1)
    tg.save_checkpoint_sharded(d, {"A": tg.zeros_g()}, step=2)
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    st, sp = tg.restore_checkpoint_sharded(d)
    assert sp == 2 and float(st["A"].max()) == 0.0


NG = (10, 10, 6)  # x, y non-periodic (interior 8 divides 1/2/4), z periodic


def _local_size(dims):
    return ((NG[0] - 2) // dims[0] + 2, (NG[1] - 2) // dims[1] + 2, NG[2] // dims[2] + 2)


def _stacked_from_phys(P):
    """The stacked layout of physical field ``P`` on the port's live grid
    (the inverse of `gather_interior`), built independently."""
    gg = tg.global_grid()
    dims, n, ol, per = ([int(x) for x in v] for v in (gg.dims, gg.nxyz, gg.overlaps,
                                                        gg.periods))
    out = np.empty([dims[k] * n[k] for k in range(3)], P.dtype)
    for c in np.ndindex(*dims):
        idx = []
        for k in range(3):
            i = np.arange(n[k])
            g = c[k] * (n[k] - ol[k]) + i
            idx.append((g - 1) % P.shape[k] if per[k] else g)
        out[tuple(slice(c[k] * n[k], (c[k] + 1) * n[k]) for k in range(3))] = P[np.ix_(*idx)]
    return out


ELASTIC = [((2, 1, 1), (1, 2, 1)), ((2, 2, 1), (4, 1, 1)), ((2, 2, 2), (1, 1, 1))]


@pytest.mark.parametrize("dims_a,dims_b", ELASTIC)
def test_elastic_restore_bit_identical_across_dims(tmp_path, dims_a, dims_b):
    na = _local_size(dims_a)
    tg.init_global_grid(*na, dimx=dims_a[0], dimy=dims_a[1], dimz=dims_a[2], periodz=1,
                        quiet=True, nranks=int(np.prod(dims_a)), device_type="cpu")
    assert tuple(int(x) for x in tg.global_grid().nxyz_g) == NG
    rng = np.random.default_rng(7)
    P = rng.standard_normal(NG)
    Q = rng.standard_normal(NG).astype(np.float32)
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.device_put_g(_stacked_from_phys(P)),
                                   "B": tg.device_put_g(_stacked_from_phys(Q))}, step=9)
    tg.finalize_global_grid()
    topo = tg.saved_topology(d)
    assert topo["step"] == 9
    nb = tg.elastic_local_size(topo, dims_b)
    assert nb == _local_size(dims_b)
    tg.init_global_grid(*nb, dimx=dims_b[0], dimy=dims_b[1], dimz=dims_b[2], periodz=1,
                        quiet=True, nranks=int(np.prod(dims_b)), device_type="cpu")
    state, step = tg.restore_checkpoint_elastic(d)
    assert step == 9 and state["B"].dtype == torch.float32
    assert np.array_equal(state["A"].numpy(), _stacked_from_phys(P))
    assert np.array_equal(state["B"].numpy(), _stacked_from_phys(Q))
    assert np.array_equal(tg.gather_interior(state["A"]), P)


def test_elastic_restore_same_dims_delegates(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    T = _arange()
    tg.save_checkpoint_sharded(d, {"T": T}, step=3)
    state, step = tg.restore_checkpoint_elastic(d)
    assert step == 3 and torch.equal(state["T"], T)


def test_elastic_restore_rejects_incompatible(tmp_path):
    _init()
    d = str(tmp_path / "ck")
    tg.save_checkpoint_sharded(d, {"A": tg.ones_g()})
    topo = tg.saved_topology(d)
    with pytest.raises(IncoherentArgumentError, match="divide"):
        tg.elastic_local_size(topo, (4, 1, 1))
    tg.finalize_global_grid()
    tg.init_global_grid(7, 7, 7, dimx=2, dimy=2, dimz=2, periodx=1, overlaps=(4, 4, 4),
                        halowidths=(2, 2, 2), quiet=True, nranks=8, device_type="cpu")
    with pytest.raises(IncoherentArgumentError, match="overlaps"):
        tg.restore_checkpoint_elastic(d)


def test_load_without_grid(tmp_path):
    _init()
    p = str(tmp_path / "ckpt.npz")
    tg.save_checkpoint(p, {"A": tg.ones_g()})
    tg.finalize_global_grid()
    state, meta = tg.load_checkpoint(p)
    assert state["A"].shape == (10, 10, 10)
    assert list(meta["dims"]) == [2, 2, 2] and meta["step"] is None


def test_topology_mismatch_rejected(tmp_path):
    _init()
    p = str(tmp_path / "ckpt.npz")
    tg.save_checkpoint(p, {"A": tg.ones_g()}, step=1)
    tg.finalize_global_grid()
    tg.init_global_grid(5, 5, 5, dimx=2, dimy=2, dimz=2, quiet=True, nranks=8,
                        device_type="cpu")
    with pytest.raises(IncoherentArgumentError):
        tg.restore_checkpoint(p)
    state, step = tg.restore_checkpoint(p, strict=False)
    assert step == 1 and tuple(state["A"].shape) == (10, 10, 10)


def test_atomic_overwrite_and_errors(tmp_path):
    _init()
    p = str(tmp_path / "ckpt.npz")
    tg.save_checkpoint(p, {"A": tg.ones_g()}, step=1)
    tg.save_checkpoint(p, {"A": tg.ones_g() * 2}, step=2)
    state, step = tg.restore_checkpoint(p)
    assert step == 2 and float(state["A"][0, 0, 0]) == 2.0
    with pytest.raises(InvalidArgumentError):
        tg.save_checkpoint(p, {})
    with pytest.raises(InvalidArgumentError):
        tg.save_checkpoint(p, {"__igg_bad": tg.ones_g()})
    with pytest.raises(InvalidArgumentError):
        tg.restore_checkpoint(str(tmp_path / "missing.npz"))


# ---------------------------------------------------------------------------
# Cross-reading: each package restores the other's containers, bitwise
# ---------------------------------------------------------------------------

def _fields(kind):
    """Whole-grid stacked numpy fields of ``kind`` on the 2x2x2 x 5^3 grid."""
    g = np.random.default_rng(11)
    if kind == "float64":
        return {"T": g.standard_normal((10, 10, 10))}
    if kind == "float32":
        return {"T": g.standard_normal((10, 10, 10)).astype(np.float32),
                "Cp": (1 + g.random((10, 10, 10))).astype(np.float32)}
    if kind == "int":
        return {"I": g.integers(-1000, 1000, (10, 10, 10)).astype(np.int32),
                "L": g.integers(0, 1 << 40, (10, 10, 10)).astype(np.int64)}
    # staggered: local (6,5,5), (5,6,5), (5,5,6), and a 2-D field
    return {"Vx": g.standard_normal((12, 10, 10)), "Vy": g.standard_normal((10, 12, 10)),
            "Vz": g.standard_normal((10, 10, 12)).astype(np.float32),
            "S": g.standard_normal((10, 10))}


KINDS = ["float64", "float32", "int", "staggered"]


def _save(pkg, fmt, path, fields, step):
    dev = {k: (igg if pkg == "jax" else tg).device_put_g(v) for k, v in fields.items()}
    if pkg == "jax":
        (igg.save_checkpoint if fmt == "file" else igg.save_checkpoint_sharded)(
            path, dev, step=step)
    else:
        (tg.save_checkpoint if fmt == "file" else tg.save_checkpoint_sharded)(
            path, dev, step=step)


def _members(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("__igg_arr__")}


@pytest.mark.parametrize("fmt", ["file", "sharded"])
@pytest.mark.parametrize("kind", KINDS)
def test_port_restores_jax_checkpoint(tmp_path, kind, fmt):
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1)
    f = _fields(kind)
    path = str(tmp_path / ("ck.npz" if fmt == "file" else "ck"))
    _save("jax", fmt, path, f, 5)
    state, step = (tg.restore_checkpoint if fmt == "file" else tg.restore_checkpoint_sharded)(path)
    assert step == 5 and set(state) == set(f)
    for k, v in f.items():
        assert _bitwise(state[k], v), k
        assert str(state[k].dtype) == f"torch.{v.dtype}"


@pytest.mark.parametrize("fmt", ["file", "sharded"])
@pytest.mark.parametrize("kind", KINDS)
def test_jax_restores_port_checkpoint(tmp_path, kind, fmt):
    """The port's container restores through the JAX package, and its
    members are the JAX package's for the same state, byte for byte."""
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1)
    f = _fields(kind)
    mine = str(tmp_path / ("t.npz" if fmt == "file" else "t"))
    ref = str(tmp_path / ("j.npz" if fmt == "file" else "j"))
    _save("torch", fmt, mine, f, 6)
    _save("jax", fmt, ref, f, 6)
    state, step = (igg.restore_checkpoint if fmt == "file" else igg.restore_checkpoint_sharded)(mine)
    assert step == 6
    for k, v in f.items():
        assert _bitwise(np.asarray(state[k]), v), k
    if fmt == "sharded":
        mine, ref = os.path.join(mine, "shards_p0.npz"), os.path.join(ref, "shards_p0.npz")
    a, b = _members(mine), _members(ref)
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)
    if fmt == "sharded":
        with np.load(os.path.join(os.path.dirname(mine), "meta.npz")) as zm, \
                np.load(os.path.join(os.path.dirname(ref), "meta.npz")) as zr:
            assert sorted(zm.files) == sorted(zr.files)
            for k in zm.files:
                if not k.endswith("save_token"):
                    assert np.array_equal(zm[k], zr[k]), k


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("dims_a,dims_b", ELASTIC)
def test_elastic_cross_restore(tmp_path, writer, dims_a, dims_b):
    """A sharded checkpoint of one package restores elastically through the
    other onto another decomposition, bitwise the reader's own elastic
    restore of its own save."""
    na = _local_size(dims_a)
    kw = dict(dimx=dims_a[0], dimy=dims_a[1], dimz=dims_a[2], periodz=1)
    init_both(*na, nranks=int(np.prod(dims_a)), **kw)
    P = np.random.default_rng(3).standard_normal(NG)
    S = _stacked_from_phys(P)
    d_w, d_r = str(tmp_path / "w"), str(tmp_path / "r")
    writer_pkg, reader_pkg = (igg, tg) if writer == "jax" else (tg, igg)
    writer_pkg.save_checkpoint_sharded(d_w, {"A": writer_pkg.device_put_g(S)}, step=2)
    reader_pkg.save_checkpoint_sharded(d_r, {"A": reader_pkg.device_put_g(S)}, step=2)
    igg.finalize_global_grid()
    tg.finalize_global_grid()
    nb = tg.elastic_local_size(tg.saved_topology(d_w), dims_b)
    init_both(*nb, dimx=dims_b[0], dimy=dims_b[1], dimz=dims_b[2], periodz=1,
              nranks=int(np.prod(dims_b)))
    got, _ = reader_pkg.restore_checkpoint_elastic(d_w)
    own, _ = reader_pkg.restore_checkpoint_elastic(d_r)
    assert _bitwise(np.asarray(got["A"]), np.asarray(own["A"]))
    assert np.array_equal(np.asarray(tg.gather_interior(got["A"]) if writer == "jax"
                                     else igg.gather_interior(got["A"])), P)


def test_elastic_restart_matches_jax(tmp_path):
    """`elastic_restart` on each package's save: the same grid and state."""
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1)
    g = np.random.default_rng(5).standard_normal((10, 10, 10))
    d = str(tmp_path / "ck")
    igg.save_checkpoint_sharded(d, {"A": igg.update_halo(igg.device_put_g(g))}, step=4)
    js, jstep = igg.elastic_restart(d, (1, 2, 2))
    ts, tstep = tg.elastic_restart(d, (1, 2, 2))
    assert tstep == jstep == 4
    assert tg.global_grid().device_type == "cpu"
    assert tuple(int(v) for v in tg.global_grid().nxyz) == tuple(
        int(v) for v in igg.global_grid().nxyz)
    assert _bitwise(ts["A"], np.asarray(js["A"]))


def test_ensemble_checkpoint_records_member_axis(tmp_path):
    """An E = 2 ensemble state: the port writes ``lead__T`` as the JAX
    package does, JAX restores it with the member axis replicated, and each
    package restores the other's bitwise (sharded and elastic)."""
    from jax.sharding import PartitionSpec as P

    from implicitglobalgrid_tpu.models import ensemble_state as j_ens
    from implicitglobalgrid_tpu_torch.models import ensemble_state as t_ens

    init_both(6, 6, 6, dimx=2, dimy=2, dimz=2)
    base = np.random.default_rng(2).standard_normal((12, 12, 12)).astype(np.float32)
    ej = j_ens(igg.device_put_g(base), 2, perturb=0.5)
    et = t_ens(tg.device_put_g(base), 2, perturb=0.5)
    assert _bitwise(et, np.asarray(ej))
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    igg.save_checkpoint_sharded(dj, {"T": ej}, step=1)
    tg.save_checkpoint_sharded(dt, {"T": et}, step=1)
    with np.load(os.path.join(dt, "meta.npz")) as z:
        assert int(z["__igg_meta__lead__T"]) == 1
    a, b = _members(os.path.join(dt, "shards_p0.npz")), _members(os.path.join(dj, "shards_p0.npz"))
    assert sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in a)
    sj, _ = igg.restore_checkpoint_sharded(dt)
    assert sj["T"].sharding.spec == P(None, "gx", "gy", "gz")
    assert _bitwise(np.asarray(sj["T"]), np.asarray(ej))
    st, _ = tg.restore_checkpoint_sharded(dj)
    assert _bitwise(st["T"], np.asarray(ej))
    igg.finalize_global_grid()
    tg.finalize_global_grid()
    init_both(10, 6, 6, dimx=1, dimy=2, dimz=2)
    ge, _ = igg.restore_checkpoint_elastic(dt)
    te, _ = tg.restore_checkpoint_elastic(dj)
    assert te.keys() == ge.keys() and _bitwise(te["T"], np.asarray(ge["T"]))


def test_ensemble_2d_checkpoint_roundtrip(tmp_path):
    """`tests/test_ensemble.py`'s 2-D ensemble ``(E, x, y)`` on a 2-D grid:
    the member axis is read from the shape (the solo reading does not fit),
    restored bitwise, and re-blocked elastically with the members passed
    through."""
    tg.init_global_grid(6, 6, 1, dimx=4, dimy=2, dimz=1, quiet=True, nranks=8,
                        device_type="cpu")
    from implicitglobalgrid_tpu_torch.models import ensemble_state

    ET = ensemble_state(tg.ones_g((6, 6), torch.float32), 3, perturb=0.5)
    d = str(tmp_path / "ck2d")
    tg.save_checkpoint_sharded(d, {"T": ET}, step=5)
    st, step = tg.restore_checkpoint_sharded(d)
    assert step == 5 and torch.equal(st["T"], ET)
    tg.finalize_global_grid()
    tg.init_global_grid(10, 4, 1, dimx=2, dimy=4, dimz=1, quiet=True, nranks=8,
                        device_type="cpu")
    got, _ = tg.restore_checkpoint_elastic(d)
    assert tuple(got["T"].shape) == (3, 20, 16)
    for m in range(3):
        assert torch.equal(got["T"][m], torch.full((20, 16), 1 + 0.5 * m))


def test_member_axes_rule(tmp_path):
    """The rule that reads an ensemble's member axes from the shape: more
    than 3 axes lead with members; a solo field is never read as an
    ensemble; where both readings fit, or neither, it raises."""
    from implicitglobalgrid_tpu_torch.utils.checkpoint import member_axes

    tg.init_global_grid(8, 8, 8, dimx=2, dimy=2, dimz=2, quiet=True, nranks=8,
                        device_type="cpu")
    assert member_axes((16, 16, 16)) == 0           # a 3-D field
    assert member_axes((18, 16, 16)) == 0           # x-staggered (9 a block)
    assert member_axes((16, 16)) == 0               # a 2-D field of a 3-D grid
    assert member_axes((2, 16, 16, 16)) == 1        # an ensemble's 3-D field
    with pytest.raises(InvalidArgumentError, match="no stacked field"):
        member_axes((3, 16, 16))                    # no field of this grid
    with pytest.raises(InvalidArgumentError, match="no stacked field"):
        tg.save_checkpoint_sharded(str(tmp_path / "ck"), {"A": torch.zeros(3, 16, 16)})
    tg.finalize_global_grid()
    tg.init_global_grid(8, 8, 1, dimx=2, dimy=2, quiet=True, nranks=4, device_type="cpu")
    assert member_axes((16, 16)) == 0
    assert member_axes((16, 16, 1)) == 0
    assert member_axes((3, 16, 16)) == 1            # a 2-D grid's ensemble
    tg.finalize_global_grid()
    tg.init_global_grid(8, 2, 1, quiet=True, nranks=1, device_type="cpu")
    with pytest.raises(InvalidArgumentError, match="both"):
        member_axes((8, 5, 3))                      # (8, 5, 3) solo, or 8 x (5, 3)


@pytest.mark.parametrize("fmt", ["file", "sharded", "elastic", "snapshot"])
def test_port_reads_jax_bfloat16(tmp_path, fmt):
    """JAX writes bfloat16 blocks (numpy's ``V2`` member); the port reads
    them back by their bytes, bitwise (the JAX package's own restore of
    them fails: ROADMAP, reference-side failures)."""
    init_both(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1)
    B = np.random.default_rng(4).standard_normal((10, 10, 10)).astype(ml_dtypes.bfloat16)
    Bj = igg.update_halo(igg.device_put_g(B))
    want = np.asarray(Bj)
    if fmt == "file":
        p = str(tmp_path / "b.npz")
        igg.save_checkpoint(p, {"B": Bj}, step=1)
        got = tg.restore_checkpoint(p)[0]["B"]
    elif fmt == "snapshot":
        from implicitglobalgrid_tpu import io as jio

        path = jio.write_snapshot(tmp_path / "s", {"B": Bj}, step=1)
        r = tg.open_snapshot(path).read_global("B")
        assert r.dtype == ml_dtypes.bfloat16
        assert _bitwise(r, igg.gather_interior(Bj))
        return
    else:
        d = str(tmp_path / "b")
        igg.save_checkpoint_sharded(d, {"B": Bj}, step=1)
        got = (tg.restore_checkpoint_sharded if fmt == "sharded"
               else tg.restore_checkpoint_elastic)(d)[0]["B"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_bfloat16_without_ml_dtypes(tmp_path, monkeypatch):
    """Where `ml_dtypes` does not import (a machine with torch alone), the
    port still writes the bfloat16 block's bytes as a 2-byte member and
    restores them bitwise, and its reader widens bfloat16 exactly to
    float32, as `gather` then does."""
    import sys

    _init()
    B = tg.update_halo(tg.device_put_g(torch.randn(10, 10, 10).to(torch.bfloat16)))
    with_ml = str(tmp_path / "a")
    tg.save_checkpoint_sharded(with_ml, {"B": B})
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    without = str(tmp_path / "b")
    tg.save_checkpoint_sharded(without, {"B": B})
    a = _members(os.path.join(with_ml, "shards_p0.npz"))
    b = _members(os.path.join(without, "shards_p0.npz"))
    assert sorted(a) == sorted(b)
    assert all(b[k].dtype.itemsize == 2 and a[k].tobytes() == b[k].tobytes() for k in a)
    st, _ = tg.restore_checkpoint_sharded(without)
    assert st["B"].dtype == torch.bfloat16 and torch.equal(st["B"].view(torch.int16),
                                                           B.view(torch.int16))
    got = tg.open_snapshot(with_ml).read_global("B")
    want = tg.gather_interior(B)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
