"""The collectives a call moves, recorded as a `ProgramIR`.

The JAX package audits the program XLA compiles from a jitted function.
PyTorch compiles no program, so the port records what its exchange routes
move while a callable runs under `recording()` (`record_program` wraps the
two), and hands the record to the same contracts and lints as a
``"record"``-dialect `ProgramIR`:

- one ``collective-permute`` op a (exchange group, dim, direction), as
  the JAX package emits one ``ppermute`` a group and direction: its
  ``source_target_pairs`` are the LOGICAL exchange's, in linearized mesh
  positions (row-major over ``gg.dims``: the ids `contracts.axis_routes`
  builds from `parallel.topology.axis_perm_pairs`), self pairs dropped,
  so a self-neighbour dim records nothing; its payload is one block's
  slab, or the group's packed row, in the wire format (`ops.wire.
  WireSchema`: its dtype, its bytes, ``members`` members of an ensemble).
  The sites are `ops.halo`'s: the per-dim route, the slab pipeline of the
  combined route and of the models' fused routes
  (`exchange_recv_slabs_multi`), and the coalesced route (ensembles
  included). Across processes each process records the whole mesh's
  logical exchange, not the transport's messages;
- one ``all-reduce`` a `transport.all_sum` (the guard's and reducers'
  vector), one ``all-gather`` a gather to the host, and an ``outfeed``
  where a value reaches the host (the gather's result,
  `transport.all_max`'s floats);
- a ``copy`` where a non-contiguous field is copied dense before it is
  exchanged; the permutes of that field name it as their operand.

Ops carry the step index the runner (`models.common.make_state_runner`)
or `record_program` marked when they were recorded; the ops after the
last step (the guard's sum) carry none. `Recording.program` keeps one
step's ops and the step-less ones: the counterpart of the JAX chunk
program, whose step body is compiled once. `Recording.step_findings`
reports steps whose ops differ from the first step's.

Off by default: each site tests the module attribute `ACTIVE` (None
outside a recording) before doing anything else.
"""

from __future__ import annotations

import functools
import itertools
from contextlib import contextmanager

import numpy as np

from ..utils.exceptions import InvalidArgumentError
from .hlo import HloOp, ProgramIR, Shape

__all__ = ["Recording", "recording", "record_program", "linear_pairs",
           "hlo_dtype", "schema_payload"]

# the open recording, or None: the one test every hook site makes
ACTIVE = None

_NP_TO_HLO = {
    "float64": "f64", "float32": "f32", "float16": "f16",
    "bfloat16": "bf16", "bool": "pred",
    "int8": "s8", "int16": "s16", "int32": "s32", "int64": "s64",
    "uint8": "u8", "uint16": "u16", "uint32": "u32", "uint64": "u64",
    "complex64": "c64", "complex128": "c128",
    # quantized wire payloads (bit-packed int4 included) ship as s8 bytes
    "int4": "s8",
}


def hlo_dtype(name) -> str:
    """Numpy / torch dtype spelling -> HLO spelling (``float32`` ->
    ``f32``, ``torch.bfloat16`` -> ``bf16``); HLO spellings pass through
    unchanged."""
    s = str(name)
    if s.startswith("torch."):
        s = s[len("torch."):]
    return _NP_TO_HLO.get(s, s)


@functools.lru_cache(maxsize=256)
def _linear_pairs(dims: tuple, dim: int, perm: tuple) -> tuple:
    pairs = []
    spaces = [range(dims[k]) if k != dim else (0,) for k in range(len(dims))]
    for base in itertools.product(*spaces):
        for s, t in perm:
            if s == t:  # periodic self-neighbour: a local copy, no wire
                continue
            src, dst = list(base), list(base)
            src[dim], dst[dim] = s, t
            pairs.append((int(np.ravel_multi_index(src, dims)),
                          int(np.ravel_multi_index(dst, dims))))
    return tuple(sorted(pairs))


def linear_pairs(dims, dim: int, perm) -> tuple:
    """The directed ``(source, target)`` pairs of one exchange direction
    along ``dim`` over every line of the mesh, in linearized positions
    (row-major over ``dims``), self pairs dropped; ``perm`` is one list of
    `parallel.topology.axis_perm_pairs`."""
    return _linear_pairs(tuple(int(d) for d in dims), int(dim),
                         tuple((int(s), int(t)) for s, t in perm))


def schema_payload(schema) -> Shape:
    """The wire payload of one direction of an `ops.wire.WireSchema`: the
    packed staging row (or one slab) in the wire dtype, the quantized
    bytes and scales as ``s8``; with ``members`` members a leading member
    axis. Its bytes are `WireSchema.payload_bytes`."""
    E = max(1, int(schema.members))
    if schema.is_quant:
        dims = (int(schema.member_payload),)
        dtype = "s8"
    else:
        dims = tuple(int(v) for v in schema.buffer_shape)
        dtype = hlo_dtype(schema.wire_dtype)
    return Shape(dtype, ((E,) if E > 1 else ()) + dims)


def _tensor_shape(t) -> Shape:
    return Shape(hlo_dtype(t.dtype), tuple(int(s) for s in t.shape))


class Recording:
    """The collectives recorded by one `recording()`: ``ops`` in order, each
    a ``"record"``-dialect `HloOp` whose ``metadata`` holds its ``site``
    and ``step``."""

    def __init__(self):
        self.ops = []
        self.step = None       # the step being recorded, or None
        self._copies = {}      # data_ptr of a dense copy -> (its op's name, it)

    # -- steps ---------------------------------------------------------------
    def begin_step(self, k: int) -> None:
        self.step = int(k)

    def end_steps(self) -> None:
        self.step = None

    def steps(self) -> list:
        return sorted({o.metadata["step"] for o in self.ops
                       if o.metadata["step"] is not None})

    def _sig(self, op) -> tuple:
        return (op.op, op.shapes, op.operand_shapes, op.metadata["site"],
                op.attrs.get("source_target_pairs"))

    def step_findings(self) -> list:
        """An error finding (``recorded-steps-differ``) for each step whose
        ops differ from the first step's: the JAX chunk program holds one
        step body, so a recording whose steps disagree has no single
        program to audit."""
        from .contracts import SEV_ERROR, AuditFinding

        steps = self.steps()
        if len(steps) < 2:
            return []
        ref = [self._sig(o) for o in self.ops if o.metadata["step"] == steps[0]]
        out = []
        for k in steps[1:]:
            got = [self._sig(o) for o in self.ops if o.metadata["step"] == k]
            if got != ref:
                out.append(AuditFinding(
                    "recorded-steps-differ", SEV_ERROR,
                    f"step {k} moved {len(got)} collective op(s) that differ from "
                    f"step {steps[0]}'s {len(ref)}: the chunk has no single step "
                    "program.",
                    details={"step": k, "ops": len(got), "first_step": steps[0],
                             "first_step_ops": len(ref)}))
        return out

    def program(self, step: int | None = None) -> ProgramIR:
        """The recording as a ``"record"``-dialect `ProgramIR`: the ops of
        ``step`` (default: the first step recorded; every op where no step
        was marked) and the ops recorded outside any step."""
        steps = self.steps()
        if step is None and steps:
            step = steps[0]
        ops = tuple(o for o in self.ops
                    if o.metadata["step"] is None or o.metadata["step"] == step)
        return ProgramIR(dialect="record", module="recording", ops=ops,
                         computations={"main": ops}, entry="main",
                         attrs={"steps": len(steps), "step": step})

    # -- emission -------------------------------------------------------------
    def _add(self, kind, result, operand=None, *, site, attrs=None, operands=()):
        n = len(self.ops)
        name = f"{kind.replace('-', '_')}.{n}"
        attrs = dict(attrs or {})
        pairs = attrs.get("source_target_pairs")
        line = f"%{name} = {result} {kind}({operand if operand else ''})"
        if pairs is not None:
            line += ", source_target_pairs={" + ",".join(
                f"{{{s},{t}}}" for s, t in pairs) + "}"
        op = HloOp(name=name, op=kind, computation="main", shapes=(result,),
                   operands=tuple(operands),
                   operand_shapes=(operand,) if operand is not None else (),
                   attrs=attrs, metadata={"site": site, "step": self.step},
                   line_no=n + 1, line=line)
        self.ops.append(op)
        return op

    def _sources(self, tensors) -> tuple:
        out = []
        for t in tensors:
            hit = self._copies.get(t.data_ptr()) if t is not None else None
            if hit is not None:
                out.append(hit[0])
        return tuple(out)

    def copy(self, t, *, site: str) -> None:
        """A dense copy ``t`` of a non-contiguous field, made to be
        exchanged."""
        op = self._add("copy", _tensor_shape(t), _tensor_shape(t), site=site)
        # the copy stays referenced while the recording lasts, so that no
        # later tensor reuses its address
        self._copies[t.data_ptr()] = (op.name, t)

    def exchange(self, gg, dim: int, schema, *, site: str, sources=()) -> None:
        """The two directions of one exchange along ``dim`` of a group (or a
        lone field) whose wire schema is ``schema``; ``sources`` are the
        tensors the payload is cut from (a dense copy among them becomes an
        operand)."""
        from ..parallel.topology import axis_perm_pairs

        D = int(gg.dims[dim])
        perm_p, perm_m = axis_perm_pairs(D, bool(gg.periods[dim]), int(gg.disp))
        payload = schema_payload(schema)
        operands = self._sources(sources)
        for perm in (perm_p, perm_m):
            pairs = linear_pairs(gg.dims, dim, perm)
            if pairs:
                self._add("collective-permute", payload, payload, site=site,
                          attrs={"source_target_pairs": pairs, "dim": int(dim)},
                          operands=operands)

    def permute(self, pairs, payload: Shape, *, site: str) -> None:
        """One collective-permute of ``payload`` over the directed ``pairs``
        (flat positions; a reshard round, `reshard.program`)."""
        pairs = tuple(sorted((int(a), int(b)) for a, b in pairs if a != b))
        if pairs:
            self._add("collective-permute", payload, payload, site=site,
                      attrs={"source_target_pairs": pairs})

    def exchange_slabs(self, gg, dim: int, shapes: dict, hw: int, dtypes: dict, wire,
                       *, site: str, sources=None) -> None:
        """One dim of the slab pipeline (`ops.halo.exchange_recv_slabs_multi`):
        the fields of LOCAL ``shapes`` and ``dtypes`` that exchanged along
        ``dim``, one packed group a dtype (one group a field with
        ``IGG_HALO_COALESCE`` off), as the JAX package's pipeline packs
        them; ``sources`` (by field) the tensors the slabs are cut from."""
        from ..ops.halo import resolve_halo_coalesce
        from ..ops.precision import wire_format_for
        from ..ops.wire import dtype_name, schema_for_fields

        by_dt = {}
        for f in shapes:
            by_dt.setdefault(dtype_name(dtypes[f]), []).append(f)
        coalesce = resolve_halo_coalesce(None)
        for dt, fs in by_dt.items():
            for g in ([fs] if coalesce else [[f] for f in fs]):
                schema = schema_for_fields(dim, [shapes[f] for f in g], [hw] * len(g), dt,
                                           wire_format_for(dt, wire, dim))
                self.exchange(gg, dim, schema, site=site,
                              sources=[sources[f] for f in g if f in (sources or {})])

    def all_reduce(self, t, *, site: str) -> None:
        shape = _tensor_shape(t)
        self._add("all-reduce", shape, shape, site=site)

    def all_gather(self, t, result_shape, *, site: str) -> None:
        self._add("all-gather", Shape(hlo_dtype(t.dtype), tuple(int(s) for s in result_shape)),
                  _tensor_shape(t), site=site)

    def host_transfer(self, shape: Shape, *, site: str) -> None:
        """A value that reaches the host inside the recorded call."""
        self._add("outfeed", shape, shape, site=site)


@contextmanager
def recording():
    """Record the collectives of the code in the block::

        with recording() as rec:
            out = run(*state)
        ir = rec.program()

    Recordings do not nest."""
    global ACTIVE
    if ACTIVE is not None:
        raise InvalidArgumentError("recording(): a recording is already open.")
    rec = Recording()
    ACTIVE = rec
    try:
        yield rec
    finally:
        ACTIVE = None


def record_program(fn, *args, steps: int = 1) -> Recording:
    """Run ``fn(*args)`` ``steps`` times under `recording()`, each call a
    step fed the previous call's output (a tuple is unpacked), and return
    the `Recording`. The runner's own step marks, where ``fn`` is a chunk
    runner, take precedence inside a call."""
    steps = int(steps)
    if steps < 1:
        raise InvalidArgumentError(f"record_program: steps must be >= 1; got {steps}.")
    with recording() as rec:
        cur = args
        for k in range(steps):
            rec.begin_step(k)
            res = fn(*cur)
            rec.end_steps()
            cur = res if isinstance(res, tuple) else (res,)
    return rec
