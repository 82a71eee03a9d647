"""The port's snapshots, reader and in-situ reducers (`implicitglobalgrid_tpu_torch.io`)
against the JAX package's, on the CPU.

The cases of `tests/test_io.py` that need no `run_resilient` run on the
port's 8-rank virtual mesh; the two that reach the reducers through
`run_resilient` drive `make_state_runner(post_chunk=make_reduced_post_chunk(...))`
and `ReducerPlan.decode` instead, with the same checks against the gathered
analysis. Then: each package opens the other's snapshots bitwise, the
capture is a complete copy (the donating runner overwrites its input), and
the reducer vector equals the JAX package's on the same state (counts,
probes, slices, min and max bitwise; sums within ``SUM_RTOL``), solo and per
ensemble member.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as igg
import implicitglobalgrid_tpu_torch as tg
from implicitglobalgrid_tpu import io as jio
from implicitglobalgrid_tpu_torch import io as tio
from implicitglobalgrid_tpu_torch.utils.exceptions import (
    IncoherentArgumentError, InvalidArgumentError,
)

from torch_port_util import clean_torch_grid, init_both  # noqa: F401

pytestmark = pytest.mark.io

# float32 sums in another order than XLA's (the guard's norm2, Stats' sum
# and sum of squares): relative to the sum of the magnitudes
SUM_RTOL = 1e-6


def _init(*n, **kw):
    tg.init_global_grid(*n, quiet=True, nranks=8, device_type="cpu", **kw)


def _encoded(dtype=torch.float64):
    """Coordinate-encoded field: each cell's value names its global cell."""
    A = tg.zeros_g(dtype=dtype)
    cs = tg.coords_g(1.0, 1.0, 1.0, A)
    enc = sum(np.asarray(c) * 10.0 ** (3 * d) for d, c in enumerate(cs))
    return tg.device_put_g(torch.from_numpy(enc + np.zeros(tuple(A.shape))).to(dtype))


# ---------------------------------------------------------------------------
# `tests/test_io.py`: the reader against gather_interior
# ---------------------------------------------------------------------------

def test_read_global_bit_identical_nonperiodic(tmp_path):
    _init(5, 5, 5, dimx=2, dimy=2, dimz=2)
    P = tg.update_halo(_encoded())
    path = tio.write_snapshot(tmp_path / "snaps", {"T": P}, step=7)
    snap = tio.open_snapshot(path)
    assert snap.step == 7 and snap.names == ["T"]
    GI = tg.gather_interior(P)
    assert snap.global_shape("T") == GI.shape
    G = snap.read_global("T")
    assert G.dtype == GI.dtype and np.array_equal(G, GI)
    box = ((1, 4), (0, 8), (5, 8))
    assert np.array_equal(snap.read_global("T", box=box), GI[1:4, 0:8, 5:8])
    assert snap.read_point("T", (3, 4, 5)) == GI[3, 4, 5]


def test_read_global_bit_identical_periodic(tmp_path):
    _init(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    P = tg.update_halo(_encoded())
    snap = tio.open_snapshot(tio.write_snapshot(tmp_path / "snaps", {"T": P}, step=1))
    GI = tg.gather_interior(P)
    assert GI.shape == (6, 6, 6)
    assert np.array_equal(snap.read_global("T"), GI)
    assert np.array_equal(snap.read_global("T", box=((4, 6), None, (0, 1))), GI[4:6, :, 0:1])


def test_read_global_mixed_periodic_and_staggered(tmp_path):
    _init(5, 5, 5, dimx=2, dimy=2, dimz=2, periodx=1)
    T = tg.update_halo(_encoded(torch.float32))
    Vx = tg.device_put_g(np.random.default_rng(0).normal(size=(12, 10, 10)).astype(np.float32))
    snap = tio.open_snapshot(tio.write_snapshot(tmp_path / "s", {"T": T, "Vx": Vx}, step=0))
    for name, arr in (("T", T), ("Vx", Vx)):
        GI = tg.gather_interior(arr)
        assert snap.global_shape(name) == GI.shape
        assert np.array_equal(snap.read_global(name), GI)


def test_reader_is_host_only(tmp_path):
    _init(5, 5, 5, dimx=2, dimy=2, dimz=2)
    P = tg.update_halo(_encoded())
    GI = tg.gather_interior(P)
    path = tio.write_snapshot(tmp_path / "snaps", {"T": P}, step=3)
    tg.finalize_global_grid()
    snap = tio.open_snapshot(path)
    assert np.array_equal(snap.read_global("T"), GI)
    topo = snap.topology()
    assert list(topo["dims"]) == [2, 2, 2] and topo["step"] == 3


def test_reader_opens_checkpoint_dirs(tmp_path):
    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    T = tg.update_halo(_encoded())
    tg.save_checkpoint_sharded(str(tmp_path / "ckpt"), {"T": T}, step=9)
    snap = tio.open_snapshot(tmp_path / "ckpt")
    assert snap.step == 9 and np.array_equal(snap.read_global("T"), tg.gather_interior(T))


# ---------------------------------------------------------------------------
# Durability: the commit protocol and checksums
# ---------------------------------------------------------------------------

def test_interrupted_writer_leaves_no_committed_snapshot(tmp_path, monkeypatch):
    from implicitglobalgrid_tpu_torch.io import snapshot as snap_mod

    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    T = tg.ones_g()
    root = tmp_path / "snaps"
    orig = snap_mod.write_npz_synced

    def dying(path, payload):
        if os.path.basename(path) == "meta.npz":
            raise OSError("simulated crash before commit")
        return orig(path, payload)

    monkeypatch.setattr(snap_mod, "write_npz_synced", dying)
    with pytest.raises(OSError):
        tio.write_snapshot(root, {"T": T}, step=5)
    monkeypatch.setattr(snap_mod, "write_npz_synced", orig)
    assert tio.list_snapshots(root) == []
    with pytest.raises(InvalidArgumentError):
        tio.open_snapshot(root / "step_0000000005")
    assert any(".tmp-" in d for d in os.listdir(root))
    path = tio.write_snapshot(root, {"T": T}, step=5)
    assert tio.list_snapshots(root) == [(5, path)]


def test_corrupt_committed_snapshot_is_detected(tmp_path):
    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    path = tio.write_snapshot(tmp_path / "s", {"T": tg.ones_g()}, step=0)
    shard = os.path.join(path, "shards_p0.npz")
    data = bytearray(open(shard, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(data)
    snap = tio.open_snapshot(path)
    with pytest.raises(IncoherentArgumentError):
        snap.read_global("T")


def test_list_snapshots_skips_foreign_entries(tmp_path):
    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    root = tmp_path / "s"
    path = tio.write_snapshot(root, {"T": tg.ones_g()}, step=2)
    os.makedirs(root / "step_0000000009.tmp-x")
    os.makedirs(root / "step_0000000008")
    os.makedirs(root / "notasnap")
    assert tio.list_snapshots(root) == [(2, str(path))]


# ---------------------------------------------------------------------------
# The async writer: queue, backpressure, drain
# ---------------------------------------------------------------------------

def test_snapshot_writer_async_roundtrip(tmp_path):
    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    T = tg.update_halo(_encoded())
    with tio.SnapshotWriter(tmp_path / "s", queue_depth=2) as w:
        for step in (10, 20, 30):
            assert w.submit({"T": T}, step)
        assert w.flush(timeout=30.0)
    assert [s for s, _ in tio.list_snapshots(tmp_path / "s")] == [10, 20, 30]
    st = w.stats
    assert st["submitted"] == st["written"] == 3
    assert st["dropped"] == st["errors"] == 0 and st["bytes"] == 3 * T.numel() * 8
    snap = tio.open_snapshot(tio.list_snapshots(tmp_path / "s")[0][1])
    assert np.array_equal(snap.read_global("T"), tg.gather_interior(T))


def test_snapshot_writer_drop_oldest(tmp_path, monkeypatch):
    from implicitglobalgrid_tpu_torch.io import snapshot as snap_mod

    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    T = tg.ones_g()
    gate = threading.Event()
    orig = snap_mod._write_captured

    def slow(root, step, cap, **kw):
        gate.wait(timeout=30.0)
        return orig(root, step, cap, **kw)

    monkeypatch.setattr(snap_mod, "_write_captured", slow)
    w = tio.SnapshotWriter(tmp_path / "s", queue_depth=1, policy="drop_oldest")
    try:
        assert w.submit({"T": T}, 1)
        for _ in range(500):
            if w._busy:
                break
            time.sleep(0.01)
        assert w._busy
        assert w.submit({"T": T}, 2)
        assert not w.submit({"T": T}, 3)       # displaces step 2
        gate.set()
        assert w.flush(timeout=30.0)
    finally:
        gate.set()
        w.close(timeout=30.0)
    assert [s for s, _ in tio.list_snapshots(tmp_path / "s")] == [1, 3]
    st = w.stats
    assert st["dropped"] == 1 and st["written"] == 2


def test_snapshot_writer_block_policy_never_drops(tmp_path, monkeypatch):
    from implicitglobalgrid_tpu_torch.io import snapshot as snap_mod

    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    T = tg.ones_g()
    orig = snap_mod._write_captured

    def slow(root, step, cap, **kw):
        time.sleep(0.02)
        return orig(root, step, cap, **kw)

    monkeypatch.setattr(snap_mod, "_write_captured", slow)
    with tio.SnapshotWriter(tmp_path / "s", queue_depth=1, policy="block") as w:
        for step in range(5):
            assert w.submit({"T": T}, step)
        assert w.flush(timeout=30.0)
    assert w.stats["dropped"] == 0 and w.stats["written"] == 5
    assert len(tio.list_snapshots(tmp_path / "s")) == 5


def test_snapshot_writer_validation(tmp_path):
    _init(4, 4, 4, dimx=2, dimy=2, dimz=2)
    T = tg.ones_g()
    with pytest.raises(InvalidArgumentError):
        tio.SnapshotWriter(tmp_path / "s", policy="nope")
    with pytest.raises(InvalidArgumentError):
        tio.SnapshotWriter(tmp_path / "s", queue_depth=0)
    with pytest.raises(InvalidArgumentError):
        tio.write_snapshot(tmp_path / "s", {}, step=0)
    with pytest.raises(InvalidArgumentError):
        tio.write_snapshot(tmp_path / "s", {"T": T}, step=0, fields=("missing",))
    w = tio.SnapshotWriter(tmp_path / "s2")
    w.close()
    with pytest.raises(InvalidArgumentError):
        w.submit({"T": T}, 0)


# ---------------------------------------------------------------------------
# In-situ reducers (the JAX tests' run_resilient -> the runner's hook)
# ---------------------------------------------------------------------------

def _diffusion_setup():
    from implicitglobalgrid_tpu_torch.models import diffusion_step_local, init_diffusion3d

    T, Cp, p = init_diffusion3d(dtype=torch.float32)

    def step(s, spare):
        return (diffusion_step_local(s[0], s[1], p, "plain", out=spare), s[1]), s[0]

    return step, {"T": T, "Cp": Cp}


def _reduce(step, state, nt, nt_chunk, reducers):
    """Chunks of ``step`` with the guard-and-reducer hook: the final state
    and each chunk's ``(step, decoded reducers)`` (what `run_resilient`
    hands ``on_reduce``)."""
    from implicitglobalgrid_tpu_torch.io.reducers import make_reduced_post_chunk
    from implicitglobalgrid_tpu_torch.models.common import make_state_runner

    names = tuple(state)
    plan = tio.build_reducer_plan(reducers, names, state)
    run = make_state_runner(step, nt_chunk=nt_chunk,
                            post_chunk=make_reduced_post_chunk(names, plan))
    s, seen = tuple(state[k] for k in names), []
    for k in range(nt // nt_chunk):
        *s, vec = run(*s)
        seen.append(((k + 1) * nt_chunk, plan.decode(vec[2 * len(names):])))
    return dict(zip(names, s)), seen


def test_reducers_match_gather_analysis():
    _init(8, 8, 8, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    step, state = _diffusion_setup()
    st, seen = _reduce(step, state, 8, 4,
                       [tio.Probe("T", (3, 4, 5)), tio.AxisSlice("T", 1, (2, 0, 3), name="line"),
                        tio.Stats("T")])
    assert [s for s, _ in seen] == [4, 8]
    GI = tg.gather_interior(st["T"]).astype(np.float64)
    v = seen[-1][1]
    assert v["probe:T@3,4,5"] == np.float32(GI[3, 4, 5])
    assert np.allclose(v["line"], GI[2, :, 3], rtol=1e-6, atol=0)
    stats = v["stats:T"]
    assert stats["min"] == np.float32(GI.min()) and stats["max"] == np.float32(GI.max())
    assert abs(stats["mean"] - GI.mean()) < 1e-5 * max(1.0, abs(GI.mean()))
    assert abs(stats["rms"] - np.sqrt((GI ** 2).mean())) < 1e-5 * np.sqrt((GI ** 2).mean())


def test_reducers_on_replicated_low_rank_field():
    _init(6, 6, 6, dimx=2, dimy=2, dimz=2)
    A2 = tg.update_halo(tg.device_put_g(
        np.random.default_rng(1).normal(size=(12, 12)).astype(np.float32)))
    _, seen = _reduce(lambda s, spare: (s, None), {"A": A2}, 1, 1,
                      [tio.Probe("A", (5, 7)), tio.Stats("A", which=("min", "max", "mean"))])
    GI = tg.gather_interior(A2).astype(np.float64)
    v = seen[-1][1]
    assert v["probe:A@5,7"] == np.float32(GI[5, 7])
    assert v["stats:A"]["min"] == np.float32(GI.min())
    assert v["stats:A"]["max"] == np.float32(GI.max())
    assert abs(v["stats:A"]["mean"] - GI.mean()) < 1e-6


def test_reducer_validation():
    _init(6, 6, 6, dimx=2, dimy=2, dimz=2)
    T = tg.ones_g()
    build = tio.build_reducer_plan
    with pytest.raises(InvalidArgumentError):
        build([tio.Probe("missing", (0, 0, 0))], ["T"], {"T": T})
    with pytest.raises(InvalidArgumentError):
        build([tio.Probe("T", (0, 0))], ["T"], {"T": T})
    with pytest.raises(InvalidArgumentError):
        build([tio.Probe("T", (99, 0, 0))], ["T"], {"T": T})
    with pytest.raises(InvalidArgumentError):
        build([tio.AxisSlice("T", 5, (0, 0, 0))], ["T"], {"T": T})
    with pytest.raises(InvalidArgumentError):
        tio.Stats("T", which=("median",))
    with pytest.raises(InvalidArgumentError):
        build([tio.Probe("T", (0, 0, 0), name="x"), tio.Probe("T", (1, 1, 1), name="x")],
              ["T"], {"T": T})


# ---------------------------------------------------------------------------
# Cross-reading and the JAX package's vector
# ---------------------------------------------------------------------------

SNAP_GRIDS = {
    "nonperiodic": dict(dimx=2, dimy=2, dimz=2),
    "periodic": dict(dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1),
    "mixed": dict(dimx=2, dimy=2, dimz=2, periodx=1),
}


def _snap_state(pkg, dtype):
    g = np.random.default_rng(9)
    f = {"T": g.standard_normal((10, 10, 10)).astype(dtype),
         "Vx": g.standard_normal((12, 10, 10)).astype(dtype),
         "S": g.standard_normal((10, 10)).astype(dtype)}
    return {k: pkg.update_halo(pkg.device_put_g(v)) if k == "T" else pkg.device_put_g(v)
            for k, v in f.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("grid", list(SNAP_GRIDS))
def test_snapshots_cross_read(tmp_path, grid, dtype):
    """Each package opens the other's snapshot of the same state, and every
    read is bitwise the writer's `gather_interior`; the containers' members
    are equal byte for byte."""
    init_both(5, 5, 5, **SNAP_GRIDS[grid])
    sj, st = _snap_state(igg, dtype), _snap_state(tg, dtype)
    pj = jio.write_snapshot(tmp_path / "j", sj, step=3)
    pt = tio.write_snapshot(tmp_path / "t", st, step=3)
    with np.load(os.path.join(pj, "shards_p0.npz")) as a, \
            np.load(os.path.join(pt, "shards_p0.npz")) as b:
        keys = [k for k in a.files if k.startswith("__igg_arr__")]
        assert sorted(keys) == sorted(k for k in b.files if k.startswith("__igg_arr__"))
        assert all(a[k].tobytes() == b[k].tobytes() and a[k].dtype == b[k].dtype for k in keys)
    for name in sj:
        want = igg.gather_interior(sj[name])
        assert np.array_equal(tg.gather_interior(st[name]), want)
        for got in (tio.open_snapshot(pj).read_global(name),
                    jio.open_snapshot(pt).read_global(name)):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert tio.open_snapshot(pj).read_point("T", (1, 2, 3)) == \
        jio.open_snapshot(pt).read_point("T", (1, 2, 3))
    assert [s for s, _ in tio.list_snapshots(tmp_path / "j")] == [3]


def test_snapshot_capture_is_a_copy(tmp_path, monkeypatch):
    """A snapshot submitted between two chunks of a donating runner holds
    the state at submission: the capture is complete before `submit`
    returns, though the runner then writes the submitted tensor (its spare
    buffer) while the writer thread waits."""
    from implicitglobalgrid_tpu_torch.io import snapshot as snap_mod
    from implicitglobalgrid_tpu_torch.models.common import make_state_runner

    _init(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
    plain, state = _diffusion_setup()

    def step(s, spare):  # the kernel route's contract: the new state lands in ``spare``
        (new, Cp), old = plain(s, None)
        return ((new if spare is None else spare.copy_(new)), Cp), old

    run = make_state_runner(step, nt_chunk=2)
    s = run(state["T"], state["Cp"])
    gate = threading.Event()
    orig = snap_mod._write_captured
    monkeypatch.setattr(snap_mod, "_write_captured",
                        lambda *a, **kw: (gate.wait(30.0), orig(*a, **kw))[1])
    want = tg.gather_interior(s[0])
    with tio.SnapshotWriter(tmp_path / "s") as w:
        w.submit({"T": s[0]}, 2)
        T0 = s[0]
        s = run(*s, donate=True)            # writes T0 as its spare
        assert not np.array_equal(tg.gather_interior(T0), want)
        gate.set()
    assert np.array_equal(tio.open_snapshot(tio.list_snapshots(tmp_path / "s")[0][1])
                          .read_global("T"), want)


def _hook_vectors(reducers, state_np, ensemble=None):
    """The guard-and-reducer vector after a chunk of the identity step on
    both packages, from the same state (whole-grid stacked numpy)."""
    from implicitglobalgrid_tpu.io.reducers import (
        build_reducer_plan as j_plan, make_reduced_post_chunk as j_post,
    )
    from implicitglobalgrid_tpu.models.common import (
        ensemble_state as j_ens, make_state_runner as j_runner,
    )
    from implicitglobalgrid_tpu_torch.io.reducers import make_reduced_post_chunk as t_post
    from implicitglobalgrid_tpu_torch.models.common import (
        ensemble_state as t_ens, make_state_runner as t_runner,
    )

    names = tuple(state_np)
    sj = {k: igg.device_put_g(v) for k, v in state_np.items()}
    st = {k: tg.device_put_g(v) for k, v in state_np.items()}
    plan_j = j_plan([r[0] for r in reducers], names, sj)
    plan_t = tio.build_reducer_plan([r[1] for r in reducers], names, st)
    if ensemble:
        sj = {k: j_ens(v, ensemble, perturb=0.25) for k, v in sj.items()}
        st = {k: t_ens(v, ensemble, perturb=0.25) for k, v in st.items()}
    ndims = tuple(v.ndim for v in state_np.values())
    run_j = j_runner(lambda s: tuple(x * 1 for x in s), ndims, nt_chunk=1,
                     post_chunk=j_post(names, plan_j), ensemble=ensemble)
    run_t = t_runner(lambda s, spare: (tuple(x * 1 for x in s), None), nt_chunk=1,
                     post_chunk=t_post(names, plan_t), ensemble=ensemble)
    vj = np.asarray(run_j(*(sj[k] for k in names))[-1])
    vt = run_t(*(st[k] for k in names))[-1].numpy()
    return vj, vt, plan_t, names


def _assert_vectors_match(vj, vt, plan, names, scale):
    """Counts, probes, slices, min and max bitwise; the sums within
    ``SUM_RTOL`` of the field's magnitude (``scale``: per entry)."""
    sums = [2 * i + 1 for i in range(len(names))]
    off = 2 * len(names)
    for red, o, ln, _ in plan._entries:
        if type(red).__name__ == "Stats":
            sums += [off + o, off + o + 1]
    exact = [i for i in range(vj.shape[-1]) if i not in sums]
    assert vj.shape == vt.shape
    assert np.array_equal(vj[..., exact], vt[..., exact], equal_nan=True)
    a, b = vj[..., sums], vt[..., sums]
    assert np.all((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= SUM_RTOL * scale[..., sums]))


REDUCERS = [(jio.Probe("T", (3, 4, 5)), tio.Probe("T", (3, 4, 5))),
            (jio.Probe("Vx", (0, 7, 2)), tio.Probe("Vx", (0, 7, 2))),
            (jio.AxisSlice("T", 0, (0, 3, 1)), tio.AxisSlice("T", 0, (0, 3, 1))),
            (jio.AxisSlice("Vx", 2, (4, 0, 0)), tio.AxisSlice("Vx", 2, (4, 0, 0))),
            (jio.Stats("T"), tio.Stats("T")), (jio.Stats("Vx"), tio.Stats("Vx"))]


@pytest.mark.parametrize("grid", list(SNAP_GRIDS))
@pytest.mark.parametrize("ensemble", [None, 2])
def test_reducer_vector_matches_jax(grid, ensemble):
    init_both(6, 6, 6, **SNAP_GRIDS[grid])
    g = np.random.default_rng(21)
    state = {"T": g.standard_normal((12, 12, 12)).astype(np.float32) * 5,
             "Vx": g.standard_normal((14, 12, 12)).astype(np.float32)}
    state["T"][3, 3, 3] = np.nan                        # counted, and left out of Stats(Vx)
    vj, vt, plan, names = _hook_vectors(REDUCERS, state, ensemble)
    mag = sum(np.nansum(np.abs(v.astype(np.float64)) ** 2) + np.nansum(np.abs(v))
              for v in state.values()) * (1 + 0.25 * ((ensemble or 1) - 1)) ** 2
    _assert_vectors_match(vj, vt, plan, names, np.full(vj.shape, mag))
    assert np.isnan(vt[..., 1]).all() and (vt[..., 0] == 1).all()   # T: one NaN, norm2 NaN
    if ensemble:
        assert not np.array_equal(vt[0], vt[1])


def test_reducer_vector_matches_jax_low_rank():
    """A 2-D field on the 3-D grid: replicated over z, counted once by the
    reducers and once a z block by the guard, as the JAX package's psum
    counts its replica shards."""
    init_both(6, 6, 6, dimx=2, dimy=2, dimz=2)
    A = np.random.default_rng(1).normal(size=(12, 12)).astype(np.float32)
    red = [(jio.Probe("A", (5, 7)), tio.Probe("A", (5, 7))),
           (jio.AxisSlice("A", 1, (3, 0)), tio.AxisSlice("A", 1, (3, 0))),
           (jio.Stats("A"), tio.Stats("A"))]
    vj, vt, plan, names = _hook_vectors(red, {"A": A})
    mag = 4 * float(np.sum(A.astype(np.float64) ** 2) + np.sum(np.abs(A)))
    _assert_vectors_match(vj, vt, plan, names, np.full(vj.shape, mag))


def test_ensemble_snapshot_keeps_members(tmp_path):
    """An ensemble's snapshot: the JAX package's block keys (the member axis
    whole, at start 0), ``lead__`` recorded, and the reader keeping the
    member axis: each member bitwise its `gather_interior`, sub-boxes too."""
    from implicitglobalgrid_tpu_torch.models import ensemble_state

    _init(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1)
    T = tg.update_halo(tg.device_put_g(
        np.random.default_rng(5).standard_normal((12, 12, 12)).astype(np.float32)))
    ET = ensemble_state(T, 3, perturb=0.5)
    path = tio.write_snapshot(tmp_path / "s", {"T": ET}, step=1)
    with np.load(os.path.join(path, "shards_p0.npz")) as z:
        keys = sorted(k for k in z.files if k.startswith("__igg_arr__"))
        assert len(keys) == 8 and all(k.startswith("__igg_arr__T__0_") for k in keys)
        assert all(z[k].shape == (3, 6, 6, 6) for k in keys)
    snap = tio.open_snapshot(path)
    G = snap.read_global("T")
    assert G.shape == snap.global_shape("T") == (3, 8, 10, 10)
    for m in range(3):
        assert np.array_equal(G[m], tg.gather_interior(ET[m]))
    assert np.array_equal(snap.read_global("T", box=((1, 2), None, (3, 5))), G[1:2, :, 3:5])
