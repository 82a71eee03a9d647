"""The port across processes: spawned gloo processes on the CPU, the twin of
`tests/test_multiprocess.py`.

Each configuration spawns its processes once (`tests/torch_dist_child.py`;
each spawn has a timeout of its own, so a hang fails its tests only); every
process computes the cases on the
8-rank virtual mesh first, then with its box of ranks in the process group,
and holds its own box of every result bitwise against the same box of the
virtual mesh's. The tests read those results:

- 2 processes x 4 ranks in plain order and with ``IGG_TPU_DCN_AXES=z``, 4
  processes x 2 ranks with ``y,z``: ``me``, ``dims``, ``nprocs``,
  ``coords`` and the process grid as `tests/test_multiprocess.py` asserts
  them, and `node_local_rank`;
- the encoded field restored by `update_halo`;
- `gather`, `gather_interior` and `gather_sub` (roots 0 and 1, bfloat16, in
  place): None off root, bitwise equal to the virtual mesh's on root;
- `update_halo` on each route (combined, per dim, coalesced groups of 2 and
  4 fields), also with halowidth 2, ``disp`` 2 and a non-periodic dim;
- a few steps of diffusion (3-D and 2-D), acoustic and Stokes through the
  fused and the plain routes, and `stokes_residuals`;
- the plain routes with ``overlap=True`` (diffusion, acoustic, Stokes), and
  deep cadences (diffusion and acoustic at 2, diffusion at ``"z:2"``), whose
  masks take each block's global coordinate; with z split, ``"z:2"`` sends
  half the z messages of cadence 1;
- under a halo wire format: `update_halo` on the coalesced route (int8,
  bfloat16) and the per-dim route (bfloat16, float16), the fused diffusion
  route under int8, and a stochastic-rounding bfloat16 run, each bitwise
  the virtual mesh's; the transport's wire bytes are the payloads' (half
  the exact wire's under bfloat16 on float32 state);
- an ensemble's diffusion (E = 3), each member bitwise the virtual mesh's,
  with E = 1's transport messages and 3 times its wire bytes;
- a sharded checkpoint and a snapshot of every process's box (float64,
  float32 staggered, a 2-D field replicated over z, bfloat16), restored in
  the process group bitwise and, by the test, on the virtual mesh bitwise
  the virtual mesh's own; the guard-and-reducer vector after
  `transport.all_sum` equal to the virtual mesh's (its float32 sums within
  1e-6 of the largest);
- `run_resilient` with a shared checkpoint directory and a `NaNPoke` in one
  process's box: the guard's sum trips every process, all roll back, and
  each box of the final state is bitwise the virtual mesh's run; each
  process's flight stream carries its rank as ``proc`` and the rollback,
  and the directory of every process's stream aggregates (`aggregate_flight`,
  `straggler_report`, `run_report`'s ``mesh`` section);
- the communication audit and the resize: the recording of a two-field
  `update_halo` measures as the virtual mesh's on every process; a run
  with ``audit=True`` ends with clean chunk audits on each process,
  `reshard_state` refuses to move blocks across processes, and
  ``resize(via="auto")`` takes the checkpoint path, its state bitwise the
  virtual mesh's device-path resize;
- `tic`/`toc` spanning the processes.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest

from torch_port_util import child_env

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_dist_child.py"
CONFIGS = {"plain_2": (2, ""), "z_2": (2, "z"), "yz_4": (4, "y,z")}
TIMEOUT = 120  # seconds, for each configuration's processes together

# what each process of a configuration must report (`tests/test_multiprocess.py`)
COORDS = {"plain_2": lambda p: [p, 0, 0], "z_2": lambda p: [0, 0, p],
          "yz_4": lambda p: [0, p // 2, p % 2]}
DCN = {"plain_2": [[], [1, 1, 1]], "z_2": [["z"], [1, 1, 2]],
       "yz_4": [["y", "z"], [1, 2, 2]]}
PROCS = {"plain_2": [[[0]], [[1]]], "z_2": [[[0, 1]]], "yz_4": [[[0, 1], [2, 3]]]}

CHECKS = [
    "encoded/restored", "encoded/gather",
    "gather/gather_root0", "gather/gather_root1", "gather/gather_interior_root0",
    "gather/gather_interior_root1", "gather/gather_sub_root0", "gather/gather_sub_root1",
    "gather/gather_sub_corner", "gather/gather_bf16", "gather/gather_into",
    "halo_g1/combined", "halo_g1/per_dim_2d", "halo_g1/per_dim_3d", "halo_g1/coalesced_2",
    "halo_g1/coalesced_4", "halo_g2/per_dim_hw2", "halo_g2/coalesced_2_hw2",
    "halo_g2/coalesced_4_hw2", "halo_g2/per_dim_hw2_bfloat16", "halo_g2/coalesced_4_hw2_int4",
    "models/diffusion_fused", "models/diffusion_plain", "models/acoustic_fused",
    "models/acoustic_plain", "models/stokes_fused", "models/stokes_plain",
    "models/stokes_residuals", "models/stokes_interior",
    "models_2d/diffusion2d_fused", "models_2d/diffusion2d_plain",
    "overlap/diffusion", "overlap/acoustic", "overlap/stokes",
    "deep/diffusion", "deep/acoustic", "deep/diffusion_1", "deep/diffusion_z2",
    "wire/coalesced_int8", "wire/coalesced_bfloat16", "wire/per_dim_bfloat16",
    "wire/per_dim_float16", "wire/diffusion_fused_int8", "wire/diffusion_sr",
    "ensemble/diffusion_e3", "io/restored", "io/vector", "resilient/state",
    "audit/measure", "audit/resized",
]

_RESULTS: dict = {}
_OUTDIRS: dict = {}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def results(config, tmp_path_factory):
    """Every process's results of ``config`` (spawned once per module)."""
    if config not in _RESULTS:
        nproc, dcn = CONFIGS[config]
        out = _OUTDIRS[config] = tmp_path_factory.mktemp(config)
        env = child_env({k: v for k, v in os.environ.items()
                         if k not in ("IGG_TPU_DCN_AXES", "MASTER_ADDR", "WORLD_SIZE")})
        port = str(_free_port())
        procs = [subprocess.Popen([sys.executable, str(CHILD), str(p), str(nproc), port, dcn,
                                   str(out)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
                 for p in range(nproc)]
        logs, deadline = [], time.monotonic() + TIMEOUT
        try:
            for p in procs:
                try:
                    logs.append(p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))[0])
                except subprocess.TimeoutExpired:
                    logs.append(f"timed out after {TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        got = []
        for pid, log in enumerate(logs):
            f = out / f"{pid}.json"
            got.append(json.loads(f.read_text()) if f.exists() and f"DIST_OK {pid}" in log
                       else {"error": log[-3000:]})
        _RESULTS[config] = got
    return _RESULTS[config]


def _each(config, tmp_path_factory, key):
    got = results(config, tmp_path_factory)
    for pid, r in enumerate(got):
        assert "error" not in r, f"process {pid} of {config} failed:\n{r['error']}"
        assert key in r, f"process {pid} of {config} did not reach {key}: {list(r)[-3:]}"
        yield pid, r[key]


@pytest.mark.parametrize("key", CHECKS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_box_matches_virtual_mesh(config, key, tmp_path_factory):
    """Every process's box (or root's gather, None elsewhere) bitwise equal
    to the virtual mesh's."""
    for pid, v in _each(config, tmp_path_factory, key):
        assert v == "ok", f"process {pid} of {config}, {key}: {v}"


@pytest.mark.parametrize("config", list(CONFIGS))
def test_layout_matches_multiprocess(config, tmp_path_factory):
    """``me``, ``dims``, ``nprocs``, ``coords`` and which process owns each
    block, as `tests/test_multiprocess.py` asserts them for the JAX
    package."""
    nproc = CONFIGS[config][0]
    for pid, r in enumerate(results(config, tmp_path_factory)):
        assert "error" not in r, r.get("error")
        assert r["layout/me"] == pid
        assert r["layout/dims"] == [2, 2, 2] and r["layout/nprocs"] == 8
        assert r["layout/coords"] == COORDS[config](pid)
        assert r["layout/procs"] == PROCS[config]
        assert r["layout/node"][:2] == [pid, nproc]
        assert r["layout/dcn"] == DCN[config]  # the JAX package's dcn_axes, dcn_granules


@pytest.mark.parametrize("config", list(CONFIGS))
def test_node_local_rank_counts_devices(config, tmp_path_factory):
    import torch

    for pid, v in _each(config, tmp_path_factory, "layout/node"):
        assert v == [pid, CONFIGS[config][0], torch.cuda.device_count()]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_encoded_field_restored(config, tmp_path_factory):
    """The encoded field (x + 1e3 y + 1e6 z) is restored exactly on every
    process's box."""
    for pid, v in _each(config, tmp_path_factory, "encoded/matches_encoding"):
        assert v is True, pid


@pytest.mark.parametrize("config", list(CONFIGS))
def test_halos_went_over_the_transport(config, tmp_path_factory):
    for pid, v in _each(config, tmp_path_factory, "halo_g1/messages"):
        assert v > 0, pid


def test_per_axis_cadence_halves_z_messages(tmp_path_factory):
    """With z split across the processes (the "z" layout), 4 steps at
    ``comm_every="z:2"`` send half the transport's messages of cadence 1:
    only z crosses processes, and it exchanges every other step."""
    for pid, r in enumerate(results("z_2", tmp_path_factory)):
        assert "error" not in r, r.get("error")
        assert r["deep/messages_1"] > 0, pid
        assert 2 * r["deep/messages_z2"] == r["deep/messages_1"], (pid, r["deep/messages_z2"])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_wire_bytes_are_the_payloads(config, tmp_path_factory):
    """Under a wire format the transport sends the payloads: along each
    crossing dim a coalesced group's rows of `WireSchema.payload_bytes`
    (int8 slabs and their scales; bfloat16), a lone field's bfloat16 slabs
    (half the exact wire's bytes), and the fused diffusion route's int8
    slabs with their scales."""
    for pid, checks in _each(config, tmp_path_factory, "wire/wire_bytes"):
        assert {c[0] for c in checks} == {"coalesced", "per_dim", "fused"}, (pid, checks)
        for route, dim, fmt, got, want in checks:
            assert got > 0 and got == want, (pid, route, dim, fmt, got, want)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_ensemble_messages_flat_in_members(config, tmp_path_factory):
    """An ensemble's exchange sends one message a neighbour process and
    dim whatever E: 3 steps at E = 3 send E = 1's messages, with 3 times
    its wire bytes (every member in the row)."""
    got = {k: dict(_each(config, tmp_path_factory, f"ensemble/{k}"))
           for k in ("messages_1", "messages_3", "wire_bytes_1", "wire_bytes_3")}
    for pid in got["messages_1"]:
        assert got["messages_1"][pid] > 0, pid
        assert got["messages_3"][pid] == got["messages_1"][pid], pid
        assert got["wire_bytes_3"][pid] == 3 * got["wire_bytes_1"][pid], pid


@pytest.mark.parametrize("config", list(CONFIGS))
def test_io_containers_restore_on_the_virtual_mesh(config, tmp_path_factory):
    """The processes' sharded checkpoint (one file a process) restores on the
    8-rank virtual mesh bitwise the virtual mesh's own checkpoint of the same
    state, and their snapshot reads bitwise the virtual mesh's snapshot."""
    import numpy as np
    import torch

    import implicitglobalgrid_tpu_torch as tg

    for pid, v in _each(config, tmp_path_factory, "io/restored"):
        assert v == "ok", (pid, v)
    out = _OUTDIRS[config]
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, quiet=True,
                        nranks=8, device_type="cpu")
    try:
        got, step = tg.restore_checkpoint_sharded(str(out / "io" / "ckpt"))
        ref, _ = tg.restore_checkpoint_sharded(str(out / "io_ref0" / "ckpt"))
        assert step == 3 and got.keys() == ref.keys() == {"A", "V", "S", "B"}
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
        with np.load(out / "io" / "ckpt" / "meta.npz") as z:
            assert int(z["__igg_meta__nprocs_files"]) == CONFIGS[config][0]
        [(s_got, p_got)] = tg.list_snapshots(out / "io" / "snaps")
        [(s_ref, p_ref)] = tg.list_snapshots(out / "io_ref0" / "snaps")
        assert s_got == s_ref == 3
        a, b = tg.open_snapshot(p_got), tg.open_snapshot(p_ref)
        for k in ref:
            ga, gb = a.read_global(k), b.read_global(k)
            assert ga.dtype == gb.dtype and ga.tobytes() == gb.tobytes(), k
            assert ga.tobytes() == tg.gather_interior(ref[k]).tobytes(), k
    finally:
        tg.finalize_global_grid()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_resilient_rollback_in_every_process_stream(config, tmp_path_factory):
    """The poke lands in process 1's box alone, yet every process's guard
    trips (the summed vector), rolls back once, and writes its own flight
    stream with its rank as ``proc``."""
    for pid, v in _each(config, tmp_path_factory, "resilient/flight"):
        assert v["procs"] == [pid], (pid, v)
        assert v["rollbacks"] == 1 and v["trips"] == 1, (pid, v)
        assert v["tripped_at"] == [[4, 6]], (pid, v)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_resilient_flight_directory_aggregates_every_process(config, tmp_path_factory):
    """The processes' streams of one run in one directory: `aggregate_flight`
    finds every process (offsets finite, aligned at the chunk barriers),
    `straggler_report` pairs their chunks and `run_report` of the directory
    carries the ``mesh`` section over all of them."""
    nproc = CONFIGS[config][0]
    for pid, v in _each(config, tmp_path_factory, "resilient/mesh"):
        assert v["processes"] == list(range(nproc)), (pid, v)
        assert v["mesh_processes"] == list(range(nproc)), (pid, v)
        assert v["offsets_finite"] and v["methods"] == ["anchor", "chunk-barrier"], (pid, v)
        assert v["report_chunks"] == v["stragglers_chunks"] >= 4, (pid, v)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_audit_and_resize_across_processes(config, tmp_path_factory):
    """Each process's ``audit=True`` run ends with clean chunk audits (one
    before the resize, one after it: fresh budgets), `reshard_state`
    refuses to move blocks across processes, and ``resize(via="auto")``
    takes the checkpoint path onto 1x2x4 (its state bitwise the virtual
    mesh's: ``audit/resized``)."""
    for pid, r in _each(config, tmp_path_factory, "audit/run"):
        assert r["audits"] == [["chunk", True], ["chunk", True]], (pid, r)
        assert r["reshard_raised"] == "InvalidArgumentError", (pid, r)
        assert r["via"] == "checkpoint" and r["dims"] == [1, 2, 4], (pid, r)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_release_returns_on_every_process_together(config, tmp_path_factory):
    """The last process comes to `transport.release` 0.2 s late: the
    release returns on no process before it came (the processes share one
    host's monotonic clock), and each process holds a release link to
    every other."""
    nproc = CONFIGS[config][0]
    got = dict(_each(config, tmp_path_factory, "release/timing"))
    came = got[nproc - 1]["came"]
    for pid, v in got.items():
        assert v["returned"] >= came, (pid, v["returned"] - came)
        assert v["links"] == nproc - 1, (pid, v)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tic_toc_span_the_processes(config, tmp_path_factory):
    """Process 1 sleeps 0.3 s between `tic` and `toc`: every process's span
    covers it."""
    for pid, v in _each(config, tmp_path_factory, "timing/toc_spans_processes"):
        assert v >= 0.3, (pid, v)


@pytest.mark.parametrize("dims,world,dcn,box", [
    ((2, 2, 2), 2, (), (1, 2, 2)), ((2, 2, 2), 2, ("z",), (2, 2, 1)),
    ((2, 2, 2), 4, ("y", "z"), (2, 1, 1)), ((4, 1, 2), 2, (), (2, 1, 2)),
    ((4, 1, 2), 4, ("x",), (1, 1, 2)), ((4, 2, 1), 2, (), (2, 2, 1)),
])
def test_process_boxes(dims, world, dcn, box):
    """Each process's box and first rank, as the JAX package lays devices
    out (plain order; `_dcn_factorization` over the named axes)."""
    import numpy as np

    from implicitglobalgrid_tpu.parallel.mesh import _dcn_factorization as j_dcn
    from implicitglobalgrid_tpu_torch.parallel.mesh import process_boxes

    got, firsts = process_boxes(dims, world, dcn)
    assert tuple(got) == box
    if dcn:
        assert tuple(got) == j_dcn(dims, dcn, world)[1]
    starts = {tuple(int(c) for c in f) for f in firsts}
    assert len(starts) == world
    owned = np.zeros(dims, dtype=int)
    for f in firsts:
        owned[tuple(slice(int(c), int(c) + int(b)) for c, b in zip(f, got))] += 1
    assert (owned == 1).all()  # the boxes tile the grid


def test_plain_order_chunk_that_is_no_box_raises():
    from implicitglobalgrid_tpu_torch.parallel.mesh import process_boxes
    from implicitglobalgrid_tpu_torch.utils.exceptions import NotSupportedError

    with pytest.raises(NotSupportedError):
        process_boxes((2, 3, 1), 3, ())


@pytest.mark.parametrize("env", [
    {}, {"IGG_TPU_DCN_AXES": "z"}, {"IGG_TPU_DCN_AXES": "y, z"},
    {"IGG_TPU_DCN_GRANULES": "z:2"}, {"IGG_TPU_DCN_GRANULES": "x:2, y:4"},
    {"IGG_TPU_DCN_AXES": "w"}, {"IGG_TPU_DCN_AXES": "z,z"},
    {"IGG_TPU_DCN_GRANULES": "z2"}, {"IGG_TPU_DCN_GRANULES": "z:0"},
    {"IGG_TPU_DCN_GRANULES": "q:2"}, {"IGG_TPU_DCN_GRANULES": "z:2,z:2"},
])
def test_dcn_environment_read_as_jax_reads_it(env, monkeypatch):
    from implicitglobalgrid_tpu.utils.config import read_env_config as j_read
    from implicitglobalgrid_tpu_torch.utils.config import read_env_config as t_read

    for k in ("IGG_TPU_DCN_AXES", "IGG_TPU_DCN_GRANULES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        want = j_read()
    except Exception as e:  # noqa: BLE001 - the port must raise the same kind
        with pytest.raises(Exception) as got:
            t_read()
        assert type(got.value).__name__ == type(e).__name__
        return
    cfg = t_read()
    assert (cfg.dcn_axes, cfg.dcn_granules) == (tuple(want.dcn_axes), tuple(want.dcn_granules))


def test_grid_takes_the_declared_granules(monkeypatch):
    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch.utils.exceptions import IncoherentArgumentError

    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "z:2")
    tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, device_type="cpu", quiet=True)
    try:
        gg = tg.global_grid()
        assert gg.dcn_granules == (1, 1, 2) and gg.dcn_axes == ()
        assert tuple(gg.box) == (2, 2, 2) and gg.me == 0
    finally:
        tg.finalize_global_grid()
    monkeypatch.setenv("IGG_TPU_DCN_GRANULES", "z:3")
    with pytest.raises(IncoherentArgumentError):
        tg.init_global_grid(6, 6, 6, dimx=2, dimy=2, dimz=2, device_type="cpu", quiet=True)
