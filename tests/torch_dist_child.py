"""One process of the port's multi-process check (`tests/test_torch_dist.py`).

Run as ``python tests/torch_dist_child.py <pid> <nproc> <port> <dcn> <outdir>``:
computes every case on the 8-rank virtual mesh (one process, CPU), then
joins a gloo process group of ``nproc`` processes on localhost and runs the
same cases with each process owning its box of ranks. Each process holds its
own box of every result bitwise against the same box of the virtual mesh's,
and the gathers' results on root against the virtual mesh's gathers; it
writes ``{case: "ok" | reason}`` to ``<outdir>/<pid>.json``.
"""

import dataclasses
import json
import os
import pathlib
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import implicitglobalgrid_tpu_torch as tg  # noqa: E402
from implicitglobalgrid_tpu_torch import models  # noqa: E402

PID, NPROC, PORT, DCN, OUT = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                              pathlib.Path(sys.argv[5]))

# The grid of the JAX package's multi-process test: 2x2x2 blocks of 5^3,
# all periodic, split by the configuration's layout (plain order, "z" or
# "y,z").
G0 = dict(nx=5, ny=5, nz=5, dimx=2, dimy=2, dimz=2, periodx=1, periody=1, periodz=1)
# 2x2x2 blocks of 6^3, z non-periodic, split as G0.
G1 = dict(nx=6, ny=6, nz=6, dimx=2, dimy=2, dimz=2, periodx=1, periody=1)
# 4x1x2 ranks, halowidth 2 with disp 2: x non-periodic (blocks two apart
# exchange, PROC_NULL at both ends), y self-neighbour, z periodic with two
# ranks (each block is its own neighbour two away). Split along x (plain
# order, or "x" for four processes) or z (the "z" configuration: the
# neighbour of a process is itself).
G2 = dict(nx=10, ny=10, nz=10, dimx=4, dimy=1, dimz=2, periody=1, periodz=1,
          overlaps=(4, 4, 4), halowidths=(2, 2, 2), disp=2)
# a 2-D grid of 4x2 ranks (plain order)
G3 = dict(nx=8, ny=8, nz=1, periodx=1)
# 2x2x2 blocks of 8^3, z non-periodic, split as G0: blocks thick enough for
# the shells of the interior-first steps (overlap 2, radius 1)
G4 = dict(nx=8, ny=8, nz=8, dimx=2, dimy=2, dimz=2, periodx=1, periody=1)
# 2x2x2 blocks of 9^3, halowidth 2 and overlap 4 (a cadence of 2), z
# non-periodic, split as G0: the deep-halo runs, whose masks need each
# block's global coordinate (a process's box need not start at 0)
G5 = dict(nx=9, ny=9, nz=9, dimx=2, dimy=2, dimz=2, periodx=1, periody=1,
          overlaps=(4, 4, 4), halowidths=(2, 2, 2))
DCN_G2 = {"": "", "z": "z", "y,z": "x"}[DCN]


def seeded(shape, seed, dtype=torch.float64):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape)).to(dtype)


def global_input(loc, seed, dtype=torch.float64):
    """A random whole-grid stacked array of ``loc`` blocks: every process
    builds the same one and `device_put_g` keeps its box."""
    gg = tg.global_grid()
    shape = tuple(int(d) * int(n) for d, n in zip(gg.dims, loc))
    return tg.device_put_g(seeded(shape, seed, dtype))


def case_layout():
    gg = tg.global_grid()
    from implicitglobalgrid_tpu_torch.parallel.grid import node_local_rank

    return {"me": ("proc", int(gg.me)), "dims": ("same", tuple(int(d) for d in gg.dims)),
            "nprocs": ("same", int(gg.nprocs)), "coords": ("proc", tuple(int(c) for c in gg.coords)),
            "node": ("proc", tuple(node_local_rank())),
            "procs": ("proc", gg.procs.tolist()),
            "dcn": ("proc", [list(gg.dcn_axes), list(gg.dcn_granules)])}


def case_encoded():
    """The JAX package's encoded field: every cell holds x + 1e3 y + 1e6 z;
    the halos zeroed and restored by `update_halo`."""
    A = tg.zeros_g(dtype=torch.float32)
    x, y, z = tg.coords_g(1.0, 1.0, 1.0, A)
    enc = np.broadcast_to((x + 1e3 * y + 1e6 * z).astype(np.float32), tuple(A.shape)).copy()
    zeroed = enc.copy()
    gg = tg.global_grid()
    for d in range(3):
        for c in range(int(gg.box[d])):
            sl = [slice(None)] * 3
            sl[d] = slice(c * 5, c * 5 + 1)
            zeroed[tuple(sl)] = 0
            sl[d] = slice((c + 1) * 5 - 1, (c + 1) * 5)
            zeroed[tuple(sl)] = 0
    res = tg.update_halo(tg.device_put_g(zeroed))
    return {"restored": ("box", res), "matches_encoding": ("proc", bool(np.array_equal(
        res.numpy(), enc))), "gather": ("root", tg.gather(res, root=0))}


def case_gather():
    A = global_input((6, 6, 6), 1)
    V = global_input((7, 6, 6), 2)
    B = global_input((6, 6, 6), 3, torch.bfloat16)
    out = {}
    for root in (0, 1):
        r = root if tg.global_grid().transport.world > 1 else 0  # the virtual mesh's root is 0
        out[f"gather_root{root}"] = ("root", tg.gather(A, root=r), root)
        out[f"gather_interior_root{root}"] = ("root", tg.gather_interior(V, root=r), root)
        out[f"gather_sub_root{root}"] = ("root", tg.gather_sub(A, ((0, 1), (1, 2), None),
                                                               root=r), root)
    out["gather_sub_corner"] = ("root", tg.gather_sub(V, ((1, 2), (1, 2), (1, 2))))
    out["gather_bf16"] = ("root", tg.gather(B))
    A_g = np.zeros((12, 12, 12)) if tg.global_grid().me == 0 else None
    out["gather_into"] = ("root", tg.gather(A, A_g))
    return out


def wave_fields(loc, seed, dtype=torch.float32):
    nx, ny, nz = loc
    return [global_input(s, seed + k, dtype) for k, s in enumerate(
        [(nx, ny, nz), (nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)])]


def case_halo_g1():
    from implicitglobalgrid_tpu_torch.ops.halo import halo_routes

    gg = tg.global_grid()
    A = global_input((6, 6, 6), 4)
    P, Vx, Vy, Vz = wave_fields((6, 6, 6), 5)
    T2 = global_input((6, 6), 6)
    tiers = halo_routes(gg, [(6, 6, 6)], [A.dtype], [(1, 1, 1)])[0]
    assert tiers == ["combined"], tiers
    out = {"combined": ("box", tg.update_halo(A.clone())),
           "per_dim_2d": ("box", tg.update_halo(T2.clone())),
           "coalesced_2": ("boxes", tg.update_halo(P.clone(), Vx.clone())),
           "coalesced_4": ("boxes", tg.update_halo(P.clone(), Vx.clone(), Vy.clone(),
                                                   Vz.clone())),
           "per_dim_3d": ("box", tg.update_halo(A.clone(), coalesce=False,
                                                dims=(0, 1, 2)))}
    out["messages"] = ("proc", gg.transport.stats["messages"])
    return out


def case_halo_g2():
    P, Vx, Vy, Vz = wave_fields((10, 10, 10), 7, torch.float64)
    A = global_input((10, 10, 10), 8)
    return {"per_dim_hw2": ("box", tg.update_halo(A.clone())),
            "coalesced_2_hw2": ("boxes", tg.update_halo(P.clone(), Vz.clone())),
            "coalesced_4_hw2": ("boxes", tg.update_halo(P.clone(), Vx.clone(), Vy.clone(),
                                                        Vz.clone())),
            # under a wire format, also where a process is its own neighbour
            "per_dim_hw2_bfloat16": ("box", tg.update_halo(A.clone(), wire_dtype="bfloat16")),
            "coalesced_4_hw2_int4": ("boxes", tg.update_halo(
                P.clone(), Vx.clone(), Vy.clone(), Vz.clone(), wire_dtype="int4"))}


def case_models():
    out = {}
    T, Cp, p = models.init_diffusion3d(dtype=torch.float64)
    out["diffusion_fused"] = ("box", models.run_diffusion(T, Cp, p, 3, nt_chunk=3))
    out["diffusion_plain"] = ("box", models.run_diffusion(T, Cp, p, 2, nt_chunk=2,
                                                          impl="plain"))
    s, q = models.init_acoustic3d(dtype=torch.float64)
    out["acoustic_fused"] = ("boxes", models.run_acoustic(s, q, 3, nt_chunk=3))
    out["acoustic_plain"] = ("boxes", models.run_acoustic(s, q, 2, nt_chunk=2, impl="plain"))
    st, sp = models.init_stokes3d(dtype=torch.float64)
    fused = models.run_stokes(st, sp, 3, nt_chunk=3)
    out["stokes_fused"] = ("boxes", fused[:7])
    out["stokes_plain"] = ("boxes", models.run_stokes(st, sp, 2, nt_chunk=2, impl="plain")[:7])
    out["stokes_residuals"] = ("same", models.stokes_residuals(fused, sp))
    out["stokes_interior"] = ("root", tg.gather_interior(fused[3]))
    return out


def case_models_2d():
    T, Cp, p = models.init_diffusion2d(dtype=torch.float64)
    return {"diffusion2d_fused": ("box", models.run_diffusion(T, Cp, p, 3, nt_chunk=3)),
            "diffusion2d_plain": ("box", models.run_diffusion(T, Cp, p, 2, nt_chunk=2,
                                                              impl="plain"))}


def case_overlap():
    """The three models' plain routes with ``overlap=True``."""
    T, Cp, p = models.init_diffusion3d(dtype=torch.float64, overlap=True)
    s, q = models.init_acoustic3d(dtype=torch.float64, overlap=True)
    st, sp = models.init_stokes3d(dtype=torch.float64, overlap=True)
    return {"diffusion": ("box", models.run_diffusion(T, Cp, p, 3, nt_chunk=3, impl="plain")),
            "acoustic": ("boxes", models.run_acoustic(s, q, 2, nt_chunk=2, impl="plain")),
            "stokes": ("boxes", models.run_stokes(st, sp, 2, nt_chunk=2, impl="plain")[:7])}


def case_deep():
    """Diffusion and acoustic at ``comm_every=2``; diffusion at cadence 1 and
    ``"z:2"`` on the same grid, with the transport's messages of each."""
    tr = tg.global_grid().transport
    T, Cp, p = models.init_diffusion3d(dtype=torch.float64, comm_every=2)
    s, q = models.init_acoustic3d(dtype=torch.float64, comm_every=2)
    out = {"diffusion": ("box", models.run_diffusion(T, Cp, p, 4, nt_chunk=4)),
           "acoustic": ("boxes", models.run_acoustic(s, q, 4, nt_chunk=4))}
    for name, ce in (("1", 1), ("z2", "z:2")):
        tr.reset_stats()
        out[f"diffusion_{name}"] = ("box", models.run_diffusion(
            T, Cp, dataclasses.replace(p, comm_every=ce), 4, nt_chunk=4, impl="plain"))
        out[f"messages_{name}"] = ("proc", tr.stats["messages"])
    return out


def _wire_bytes(fn):
    """``fn()`` and the bytes the transport sent for it."""
    tr = tg.global_grid().transport
    tr.reset_stats()
    out = fn()
    return out, tr.stats["wire_bytes"]


def case_wire():
    """`update_halo` under int8 and bfloat16 on the coalesced and per-dim
    routes, the fused diffusion route under int8, and a stochastic-rounding
    run; the wire bytes of each exchange along the crossing dims against
    `WireSchema.payload_bytes` a slab (a row), and bfloat16's against half
    the exact wire's."""
    from implicitglobalgrid_tpu_torch.ops.halo import crosses
    from implicitglobalgrid_tpu_torch.ops.wire import schema_for_fields

    gg = tg.global_grid()
    out = {}
    P, Vx, Vy, Vz = wave_fields((6, 6, 6), 9)
    A = global_input((6, 6, 6), 10, torch.float32)
    group = [(P, (6, 6, 6)), (Vx, (7, 6, 6)), (Vy, (6, 7, 6)), (Vz, (6, 6, 7))]
    for fmt in ("int8", "bfloat16"):
        out[f"coalesced_{fmt}"] = ("boxes", tg.update_halo(
            *[f.clone() for f, _ in group], wire_dtype=fmt))
    out["per_dim_bfloat16"] = ("box", tg.update_halo(A.clone(), wire_dtype="bfloat16"))
    out["per_dim_float16"] = ("box", tg.update_halo(A.clone(), wire_dtype="float16"))
    T, Cp, p = models.init_diffusion3d(dtype=torch.float32)
    os.environ["IGG_HALO_WIRE_DTYPE"] = "int8"
    try:
        out["diffusion_fused_int8"] = ("box", models.run_diffusion(T, Cp, p, 3, nt_chunk=3))
    finally:
        os.environ.pop("IGG_HALO_WIRE_DTYPE")
    Tb, Cb, pb = models.init_diffusion3d(dtype=torch.bfloat16, sr=True, sr_seed=4)
    out["diffusion_sr"] = ("box", models.run_diffusion(Tb, Cb, pb, 3, nt_chunk=2))
    checks = []
    for d in range(3):
        if not crosses(gg, d):
            continue
        locs = [loc for _, loc in group]
        rows = schema_for_fields(d, locs, [1] * 4, torch.float32)
        _, exact = _wire_bytes(lambda: tg.update_halo(*[f.clone() for f, _ in group],
                                                      dims=(d,)))
        for fmt in ("int8", "bfloat16"):
            wired = schema_for_fields(d, locs, [1] * 4, torch.float32, fmt)
            _, got = _wire_bytes(lambda: tg.update_halo(*[f.clone() for f, _ in group],
                                                        dims=(d,), wire_dtype=fmt))
            checks.append(("coalesced", d, fmt, got,
                           exact // rows.payload_bytes * wired.payload_bytes))
        _, exact = _wire_bytes(lambda: tg.update_halo(A.clone(), dims=(d,)))
        _, got = _wire_bytes(lambda: tg.update_halo(A.clone(), dims=(d,),
                                                    wire_dtype="bfloat16"))
        checks.append(("per_dim", d, "bfloat16", got, exact // 2))
    # the fused route: every crossing dim's slabs (blocks of 6^3: 36 cells
    # each, whatever the dim) cross as int8 payloads with their scales
    one = schema_for_fields(0, [(6, 6, 6)], [1], torch.float32)
    wired = schema_for_fields(0, [(6, 6, 6)], [1], torch.float32, "int8")
    _, exact = _wire_bytes(lambda: models.run_diffusion(T, Cp, p, 1, nt_chunk=1))
    os.environ["IGG_HALO_WIRE_DTYPE"] = "int8"
    try:
        _, got = _wire_bytes(lambda: models.run_diffusion(T, Cp, p, 1, nt_chunk=1))
    finally:
        os.environ.pop("IGG_HALO_WIRE_DTYPE")
    checks.append(("fused", -1, "int8", got, exact // one.payload_bytes * wired.payload_bytes))
    out["wire_bytes"] = ("proc", checks)
    return out


def case_ensemble():
    """Diffusion at E = 3 (each member's box against the virtual mesh's)
    and the transport's messages and wire bytes at E = 1 and E = 3."""
    tr = tg.global_grid().transport
    T, Cp, p = models.init_diffusion3d(dtype=torch.float64)
    out = {}
    for E in (1, 3):
        ET, EC = models.ensemble_state((T, Cp), E, perturb=0.01)
        tr.reset_stats()
        got = models.run_diffusion(ET, EC, p, 3, nt_chunk=3, ensemble=E)
        out[f"messages_{E}"] = ("proc", tr.stats["messages"])
        out[f"wire_bytes_{E}"] = ("proc", tr.stats["wire_bytes"])
    out["diffusion_e3"] = ("boxes", tuple(got[m] for m in range(3)))
    return out


def case_io():
    """A sharded checkpoint and a `SnapshotWriter` snapshot of each process's
    box (process 0 commits both; the virtual mesh writes its own under
    ``io_ref<pid>``), the checkpoint restored in the process group, and the
    guard-and-reducer vector after `transport.all_sum`."""
    from implicitglobalgrid_tpu_torch.io.reducers import make_reduced_post_chunk
    from implicitglobalgrid_tpu_torch.models.common import make_state_runner

    gg = tg.global_grid()
    where = OUT / ("io" if gg.transport.world > 1 else f"io_ref{PID}")
    state = {"A": tg.update_halo(global_input((6, 6, 6), 20)),
             "V": global_input((7, 6, 6), 21, torch.float32),
             "S": global_input((6, 6), 22),
             "B": global_input((6, 6, 6), 23, torch.bfloat16)}
    tg.save_checkpoint_sharded(str(where / "ckpt"), state, step=3)
    with tg.SnapshotWriter(where / "snaps") as w:
        w.submit(state, 3)
    restored, step = tg.restore_checkpoint_sharded(str(where / "ckpt"))
    assert step == 3
    names = ("A", "V", "S")
    plan = tg.io.build_reducer_plan(
        [tg.Probe("A", (3, 4, 5)), tg.AxisSlice("V", 0, (0, 2, 7)), tg.Stats("A"),
         tg.Stats("S"), tg.Probe("S", (4, 7)), tg.AxisSlice("S", 1, (6, 0))], names, state)
    run = make_state_runner(lambda s, spare: (s, None), nt_chunk=1,
                            post_chunk=make_reduced_post_chunk(names, plan))
    vec = run(*(state[k] for k in names))[-1]
    sums = [1, 3, 5] + [2 * len(names) + o + j for red, o, _, _ in plan._entries
                        if isinstance(red, tg.Stats) for j in (0, 1)]
    return {"restored": ("boxes", tuple(restored[k] for k in state)),
            "vector": ("vec", (vec.tolist(), sums))}


def case_resilient():
    """`run_resilient` with a checkpoint directory every process shares (the
    virtual mesh: its own under ``resil_ref<pid>``), a `NaNPoke` in process
    1's box (x-block 1, y-block 0, z-block 1 in every layout) and a flight
    recorder a process, started with the run's directory (one
    ``flight_p<rank>.jsonl`` each, one run id); the final state, and this
    process's stream: its ``proc`` values, its rollbacks and guard trips;
    across processes, `aggregate_flight` and `run_report` of the directory
    (every process present, finite offsets, the ``mesh`` section)."""
    gg = tg.global_grid()
    where = OUT / ("resil" if gg.transport.world > 1 else f"resil_ref{PID}")
    T, Cp, p = models.init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": models.diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    where.mkdir(parents=True, exist_ok=True)
    tg.start_flight_recorder(str(where), run_id="resil")  # flight_p<rank>.jsonl
    try:
        out, reports = tg.run_resilient(step, {"T": T, "Cp": Cp}, 10, nt_chunk=3,
                                        checkpoint_dir=str(where / "ckpt"),
                                        faults=[tg.NaNPoke(step=4, name="T", index=(8, 3, 9))])
    finally:
        fr = tg.stop_flight_recorder()
    evs = tg.read_flight_events(str(fr))
    rep = tg.run_report(str(fr), include_metrics=False)
    mesh = None
    if gg.transport.world > 1:
        # every stream closed: the directory of both processes' streams
        tg.barrier()
        agg = tg.aggregate_flight(str(where))
        mrep = tg.run_report(str(where), include_metrics=False)
        mesh = {"processes": agg["processes"],
                "offsets_finite": all(v == v and abs(v) < 1e9 for v in agg["offsets"].values()),
                "methods": sorted(set(agg["align"]["method"].values())),
                "mesh_processes": mrep["mesh"]["processes"],
                "stragglers_chunks": tg.straggler_report(agg)["summary"]["chunks"],
                "report_chunks": mrep["chunks"]["count"]}
    return {"state": ("boxes", (out["T"], out["Cp"])),
            "mesh": ("proc", mesh),
            "flight": ("proc", {"procs": sorted({e["proc"] for e in evs}),
                                "rollbacks": rep["checkpoints"]["rollbacks"],
                                "trips": rep["guards"]["trips"],
                                "tripped_at": [(r.step_begin, r.step_end)
                                               for r in reports if not r.ok]})}


def case_audit():
    """The communication audit and the resize across processes: the
    recording of a two-field `update_halo` (the whole mesh's logical
    exchange, the same on every process and on the virtual mesh); a
    supervised run with ``audit=True`` resized to 1x2x4 at step 3 with
    ``via="auto"``: the final state (bitwise the virtual mesh's, which
    resized on the device path), and this process's audit events, the
    path the resize took and what `reshard_state` raised (across
    processes: `InvalidArgumentError`, so the checkpoint path)."""
    from implicitglobalgrid_tpu_torch.analysis import axis_routes, measure_axes, record_program
    from implicitglobalgrid_tpu_torch.utils.exceptions import InvalidArgumentError

    gg = tg.global_grid()
    multi = gg.transport.world > 1
    where = OUT / ("audit" if multi else f"audit_ref{PID}")
    A, B = global_input((6, 6, 6), 41, torch.float32), global_input((6, 6, 6), 42, torch.float32)
    ir = record_program(lambda a, b: tg.update_halo(a, b), A, B).program()
    measure = {str(k): v for k, v in measure_axes(ir, axis_routes()).items()}
    T, Cp, p = models.init_diffusion3d(dtype=torch.float64)

    def step(s):
        return {"T": models.diffusion_step_local(s["T"], s["Cp"], p, "plain"), "Cp": s["Cp"]}

    where.mkdir(parents=True, exist_ok=True)
    tg.start_flight_recorder(str(where), run_id="audit")
    raised, via = None, None
    run = tg.ResilientRun(step, {"T": T, "Cp": Cp}, 9, tg.RunSpec(
        nt_chunk=3, audit=True, checkpoint_dir=str(where / "ckpt")))
    try:
        while run.advance():
            if run.step == 3 and via is None:
                if multi:
                    try:
                        tg.reshard_state(run.state, (1, 2, 4))
                        raised = "nothing"
                    except InvalidArgumentError:
                        raised = "InvalidArgumentError"
                via = run.resize((1, 2, 4))["via"]
    finally:
        run.close()
        fr = tg.stop_flight_recorder()
    audits = [(e["program"], e["ok"]) for e in tg.read_flight_events(str(fr))
              if e.get("kind") == "audit"]
    return {"measure": ("same", measure),
            "resized": ("boxes", (run.state["T"],)),
            "run": ("proc", {"audits": audits, "via": via, "reshard_raised": raised,
                             "dims": [int(d) for d in tg.global_grid().dims]})}


def case_stage():
    """The staged wire across processes: `update_halo` with
    ``wire_stage="z:staged"`` (its box bitwise the virtual mesh's flat
    halos), and the staged audit of diffusion's plain and fused steps: its
    verdict, the canonical stage in its meta and crosscheck, and the
    transport's messages along each staged dim that crosses processes."""
    A = global_input((6, 6, 6), 43, torch.float32)
    out = {"halo": ("box", tg.update_halo(A, wire_stage="z:staged"))}
    for impl in ("plain", "cuda"):
        rep = tg.audit_model("diffusion3d", impl=impl, wire_stage="z:staged")
        out[f"audit_{impl}"] = ("proc", {
            "ok": rep.ok, "rules": sorted(rep.by_rule()), "wire_stage": rep.meta["wire_stage"],
            "crosscheck_wire_stage": rep.crosscheck["wire_stage"],
            "staged_messages": rep.meta.get("staged_messages")})
    return out


def case_pool():
    """``devices=`` across the processes: the whole grid's pool, so
    ``["cpu"] * 8`` lays the grid out as ``nranks=8`` does; a list naming
    cuda:0 for ranks 0-3 and cuda:1 for ranks 4-7 raises on every process
    together, with the first process's reason (its box's entries span both
    cards, or name CUDA on a host without it); a pool no multiple of the
    processes raises."""
    def layout():
        gg = tg.global_grid()
        return [int(gg.me), gg.dims.tolist(), gg.coords.tolist(), gg.box.tolist(),
                gg.procs.tolist(), str(gg.device)]

    want = layout()
    kw = {k: v for k, v in G0.items() if k not in ("nx", "ny", "nz")}
    tg.finalize_global_grid()
    errors = {}
    for name, devs in (("cards", ["cuda:0"] * 4 + ["cuda:1"] * 4), ("odd", ["cpu"] * 9)):
        try:
            tg.init_global_grid(5, 5, 5, devices=devs, init_dist=False, quiet=True, **kw)
            errors[name] = "nothing"
            tg.finalize_global_grid()
        except Exception as e:  # noqa: BLE001 - the kind and reason are the result
            errors[name] = f"{type(e).__name__}: {e}"
    tg.init_global_grid(5, 5, 5, devices=["cpu"] * 8, init_dist=False, quiet=True, **kw)
    return {"layout": ("proc", layout() == want), "errors": ("proc", errors)}


def case_release():
    """`transport.release` returns on every process together: the last
    process comes to it 0.2 s late, and no process's release returns
    before that (one host, one monotonic clock). This process's return
    time, the late process's arrival and the number of release links."""
    tr = tg.global_grid().transport
    if tr.world == 1:
        return {}
    tr.release()  # the links, made by the first release
    came = None
    if tr.rank == tr.world - 1:
        time.sleep(0.2)
        came = time.monotonic()
    tr.release()
    return {"timing": ("proc", {"returned": time.monotonic(), "came": came,
                                "links": len(tr._links)})}


def case_timing():
    tg.tic()
    if tg.global_grid().me == 1:
        time.sleep(0.3)
    return {"toc_spans_processes": ("min", tg.toc())}


CASES = [("layout", G0, DCN, case_layout), ("encoded", G0, DCN, case_encoded),
         ("gather", G1, DCN, case_gather), ("halo_g1", G1, DCN, case_halo_g1),
         ("halo_g2", G2, DCN_G2, case_halo_g2), ("models", G1, DCN, case_models),
         ("models_2d", G3, "", case_models_2d), ("overlap", G4, DCN, case_overlap),
         ("deep", G5, DCN, case_deep), ("wire", G1, DCN, case_wire),
         ("ensemble", G1, DCN, case_ensemble), ("io", G1, DCN, case_io),
         ("resilient", G1, DCN, case_resilient), ("audit", G1, DCN, case_audit),
         ("stage", G1, DCN, case_stage), ("pool", G0, DCN, case_pool),
         ("release", G1, DCN, case_release), ("timing", G1, DCN, case_timing)]


def run(grid_kw, dcn, fn, **init):
    if dcn:
        os.environ["IGG_TPU_DCN_AXES"] = dcn
    else:
        os.environ.pop("IGG_TPU_DCN_AXES", None)
    kw = dict(grid_kw)
    n = (kw.pop("nx"), kw.pop("ny"), kw.pop("nz"))
    tg.init_global_grid(*n, device_type="cpu", quiet=True, nranks=8, **kw, **init)
    try:
        got = fn()
        gg = tg.global_grid()  # the layout the case ended on (a resize changes it)
        return got, (gg.coords.copy(), gg.box.copy(), gg.dims.copy())
    finally:
        tg.finalize_global_grid()


def box_of(ref, layout):
    coords, box, dims = layout
    sl = []
    for d in range(ref.dim()):
        n = ref.shape[d] // int(dims[d])
        sl.append(slice(int(coords[d]) * n, (int(coords[d]) + int(box[d])) * n))
    return ref[tuple(sl)]


def compare(kind, got, ref, layout, me):
    """"ok" or why a result of ``kind`` differs from the virtual mesh's."""
    if kind in ("box", "boxes"):
        got, ref = (got, ref) if kind == "boxes" else ((got,), (ref,))
        for k, (g, r) in enumerate(zip(got, ref)):
            r = box_of(r, layout)
            if tuple(g.shape) != tuple(r.shape) or not torch.equal(g, r):
                err = (g.double() - r.double()).abs().max().item() \
                    if g.shape == r.shape else (tuple(g.shape), tuple(r.shape))
                return f"field {k} of the box differs ({err})"
        return "ok"
    if kind == "root":
        root = ref[2] if len(ref) > 2 else 0
        if me != root:
            return "ok" if got[1] is None else f"process {me} got an array off root"
        if got[1] is None or got[1].dtype != ref[1].dtype or got[1].shape != ref[1].shape:
            return f"root got {None if got[1] is None else (got[1].dtype, got[1].shape)}"
        return "ok" if np.array_equal(got[1].view(np.uint8), ref[1].view(np.uint8)) \
            else "root's array differs"
    if kind == "same":
        return "ok" if got == ref else f"{got} != {ref}"
    if kind == "vec":
        # bitwise but for the float32 sums (``sums``), summed in another
        # order across processes: within 1e-6 of the largest norm2
        (g, sums), (r, _) = got, ref
        tol = 1e-6 * max(abs(r[i]) for i in sums if i < 6)
        bad = [i for i, (a, b) in enumerate(zip(g, r))
               if not (a == b or (a != a and b != b) or (i in sums and abs(a - b) <= tol))]
        return "ok" if len(g) == len(r) and not bad else f"entries {bad} differ"
    return "ok"


def main():
    refs = {name: run(grid_kw, "", fn)[0] for name, grid_kw, _, fn in CASES
            if name not in ("layout", "release", "timing")}
    refs["layout"] = None
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                                         world_size=NPROC, rank=PID)
    results = {}
    for name, grid_kw, dcn, fn in CASES:
        try:
            got, layout = run(grid_kw, dcn, fn, init_dist=False)
        except Exception:  # noqa: BLE001 - recorded, then every process stops
            results[name] = traceback.format_exc()[-2000:]
            break
        for key, val in got.items():
            kind = val[0]
            if kind in ("proc", "min") or refs.get(name) is None:
                results[f"{name}/{key}"] = val[1]
                continue
            ref = refs[name][key]
            if kind == "root":
                results[f"{name}/{key}"] = compare(kind, val, ref, layout, PID)
            else:
                results[f"{name}/{key}"] = compare(kind, val[1], ref[1], layout, PID)
    (OUT / f"{PID}.json").write_text(json.dumps(results, default=list))
    torch.distributed.destroy_process_group()
    print(f"DIST_OK {PID}", flush=True)


if __name__ == "__main__":
    main()
