"""Implicit-global-grid lint rules over a `ProgramIR`.

The port's copy of `implicitglobalgrid_tpu/analysis/lints.py`, with the
same seven rule names (`LINT_RULES`, which `RunSpec.audit_lints` is
validated against). Where `contracts` checks the PLANNED collective shape,
these rules hunt for the hazards no plan mentions. On a parsed dump
(``"hlo"`` / ``"stablehlo"``) each rule runs as the JAX package's; on the
port's recording (``"record"``, `analysis.record`) a rule reads the
recorded ops, their payloads first:

- ``global-materialization`` — an op shaped like the IMPLICIT GLOBAL grid
  (``nxyz_g``), the array whose whole point is to never exist (optimized
  HLO and recordings: a payload or a gather's result; the pre-partitioning
  StableHLO module legitimately carries stacked arrays).
- ``wire-downcast-missing`` — a reduced-precision wire format was
  requested but some float permute payload still crosses wider than its
  axis allows. Per-axis aware: under ``"z:int8,x:f32"`` a full-width
  payload on the exact x axis is legal while a stale f32 payload on the
  quantized z axis flags; integer (quantized s8) payloads are never stale.
- ``donation-unaliased`` — fewer input-output aliases in an HLO module
  header than donated inputs.
- ``host-transfer`` — infeed/outfeed/send/recv/host callbacks inside the
  program; in a recording, a value that reached the host inside the
  recorded call (a gather's result, `transport.all_max`'s floats).
- ``custom-call`` — opaque custom-calls (partitioner markers and other
  benign targets excluded).
- ``f64-leakage`` — f64 buffers in a program whose state dtypes don't
  include f64 (an unintended promotion: on a TPU every f64 op is
  emulated; on the H100 float64 runs at a fraction of float32's rate).
- ``copy-feeds-collective`` — a ``copy`` op feeding a collective operand:
  the payload is staged through an extra buffer (in a recording: a field
  copied dense before its exchange).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.exceptions import InvalidArgumentError
from .contracts import AuditFinding, SEV_ERROR, SEV_WARNING, sort_findings
from .hlo import ProgramIR, Shape
from .record import hlo_dtype

__all__ = ["LintConfig", "default_lint_config", "run_lints", "LINT_RULES",
           "DEFAULT_LINTS"]

# custom-call targets that are partitioning/sharding machinery, not opaque
# compute — present in every shard_map program by construction
_BENIGN_CUSTOM_CALLS = {
    "Sharding", "SPMDFullToShardShape", "SPMDShardToFullShape",
    "MoveToHost", "MoveToDevice", "AllocateBuffer", "xla.sdy.FuncResultSharding",
}
# host-callback custom-call targets: a device->host round trip per call
_HOST_CALLBACK_TARGETS = {
    "xla_python_cpu_callback", "xla_python_gpu_callback",
    "xla_ffi_python_cpu_callback", "xla_ffi_python_gpu_callback",
    "xla_ffi_partitioned_python_cpu_callback", "tpu_host_callback",
}
_HOST_TRANSFER_OPS = {"infeed", "outfeed", "send", "recv", "send-done",
                      "recv-done"}


@dataclass(frozen=True)
class LintConfig:
    """What the linter should consider legitimate for this program.

    ``global_shape``/``local_shape`` come from the live grid (see
    `default_lint_config`); ``state_dtypes`` are the dtypes the program's
    state legitimately holds (f64 presence beyond these flags);
    ``wire_dtype`` is the REQUESTED reduced-precision wire format (HLO
    spelling, e.g. ``"bf16"``) whose absence from the wire should flag.
    Under a PER-AXIS wire policy, ``wire_axes`` maps mesh axis names to
    the HLO spelling of that axis's on-wire dtype (axes missing from the
    map are exact — any payload width legal there) and ``routes`` (the
    `contracts.axis_routes` table) attributes each permute to its axis,
    so an exact-by-policy axis's full-width payload no longer false-flags.
    With ``wire_axes`` set, a permute that cannot be attributed (missing
    routes, unknown pair set) is never flagged and ``wire_dtype`` is NOT
    consulted — it only feeds the finding message (see
    `_allowed_wire_width`). ``expect_donation`` is the number of donated
    inputs that must appear as input-output aliases."""

    global_shape: tuple | None = None
    local_shape: tuple | None = None
    state_dtypes: tuple = ()
    wire_dtype: str | None = None
    wire_axes: dict | None = None
    routes: dict | None = None
    expect_donation: int | None = None


_WIRE_NAMES = {"bfloat16": "bf16", "float16": "f16", "float32": "f32",
               "float64": "f64",
               # quantized payloads (incl. bit-packed int4) ship as s8
               "int8": "s8", "int4": "s8"}


def default_lint_config(grid=None, *, state_dtypes=(), wire_dtype=None,
                        expect_donation=None) -> LintConfig:
    """Build a config from the LIVE grid: the forbidden global shape is
    ``nxyz_g``, the legitimate block shape ``nxyz``. ``wire_dtype``
    accepts numpy/torch spellings (``bfloat16``), HLO ones (``bf16``),
    quantized formats (``int8``/``int4``), a per-axis policy spec
    (``"z:int8,x:f32"``), or a resolved `ops.precision.WirePolicy` — a
    per-axis policy additionally fills ``wire_axes``/``routes`` from the
    live grid so the wire-downcast lint judges each permute against ITS
    axis's width."""
    from ..parallel.topology import global_grid, grid_is_initialized

    gshape = lshape = None
    if grid is not None or grid_is_initialized():
        gg = grid if grid is not None else global_grid()
        gshape = tuple(int(n) for n in gg.nxyz_g)
        lshape = tuple(int(n) for n in gg.nxyz)
    wd, wire_axes, routes = None, None, None
    if wire_dtype is not None:
        policy = _maybe_policy(wire_dtype)
        if policy is not None and policy.uniform is None:
            # per-axis policy: widths judged per attributed axis only
            # (unattributable permutes are never flagged — see
            # `_allowed_wire_width`); `wire_dtype` records the WIDEST
            # requested format purely for display in messages
            from ..parallel.topology import AXIS_NAMES

            wire_axes = {}
            widest = None
            for d, axis in enumerate(AXIS_NAMES):
                fmt = policy.for_dim(d)
                if fmt is None:
                    continue
                name = _WIRE_NAMES.get(str(fmt), str(fmt))
                wire_axes[axis] = name
                w = Shape(name, ()).itemsize
                if widest is None or w > widest[0]:
                    widest = (w, name)
            wd = widest[1] if widest else None
            if grid is not None or grid_is_initialized():
                from .contracts import axis_routes

                routes = axis_routes(grid if grid is not None
                                     else global_grid())
        elif policy is not None:
            wd = _WIRE_NAMES.get(str(policy.uniform), str(policy.uniform))
        else:
            wd = str(wire_dtype)
            wd = _WIRE_NAMES.get(wd, wd)
    return LintConfig(
        global_shape=gshape, local_shape=lshape,
        state_dtypes=tuple(hlo_dtype(d) for d in state_dtypes),
        wire_dtype=wd, wire_axes=wire_axes, routes=routes,
        expect_donation=expect_donation)


def _maybe_policy(wire_dtype):
    """`ops.precision.WirePolicy` for the argument when it parses as one.
    Callers also pass raw HLO spellings the policy parser doesn't know
    (``"f64"``) — ONLY those recognized dtype spellings keep the legacy
    string path; anything else that fails to parse (a typo'd axis
    ``"w:int8"``, a bad format ``"int3"``) re-raises, because silently
    falling through would hand `_lint_wire_downcast` a width-4 fallback
    that never flags anything — a disabled lint disguised as a clean
    audit."""
    from ..ops.precision import WirePolicy, resolve_wire_dtype

    if isinstance(wire_dtype, WirePolicy):
        return wire_dtype
    try:
        return resolve_wire_dtype(wire_dtype)
    except InvalidArgumentError:
        from .hlo import _ITEMSIZE

        s = str(wire_dtype)
        if s in _WIRE_NAMES or s in _ITEMSIZE:
            return None
        raise


# ---------------------------------------------------------------------------
# rules: each fn(ir, cfg) -> list[AuditFinding]

def _lint_global_materialization(ir: ProgramIR, cfg: LintConfig) -> list:
    if ir.dialect not in ("hlo", "record") or cfg.global_shape is None:
        return []  # pre-SPMD modules legitimately hold stacked arrays
    if cfg.global_shape == cfg.local_shape:
        return []  # single-shard grid: the block IS the global array
    out = []
    for op in ir.ops:
        for s in op.shapes:
            if s.dims == cfg.global_shape:
                out.append(AuditFinding(
                    "global-materialization", SEV_ERROR,
                    f"op materializes the implicit GLOBAL grid shape {s} "
                    "— the array this framework exists to never build.",
                    op=op.name, computation=op.computation,
                    details={"shape": str(s)}))
                break
    return out


def _is_float_payload(pay) -> bool:
    return pay is not None and pay.dtype.lstrip("b").startswith("f") \
        and not pay.dtype.startswith("f8")


def _allowed_wire_width(cfg: LintConfig, op) -> int | None:
    """The widest payload the policy allows for this permute: its
    attributed axis's configured width under a per-axis policy (an axis
    the policy leaves exact allows any width -> None), else the global
    wire width. Under a PER-AXIS policy a permute that cannot be
    attributed (no routes table — e.g. a host-only dump audit — or a
    pair set matching no axis) is NEVER flagged: without attribution a
    full-width payload may legally belong to an exact-by-policy axis,
    and unplanned routes are the contract checker's `permute-route`
    finding, not this lint's. Integer payloads never reach this (the
    quantized s8 buffer IS the narrowing — only float payloads can be
    stale)."""
    # truthiness, matching `_lint_wire_downcast`'s guard: an EMPTY
    # wire_axes map must fall through to the global width, not disable
    # the lint
    if cfg.wire_axes:
        if cfg.routes is not None:
            from .contracts import attribute_axis

            pairs = op.attrs.get("source_target_pairs") or ()
            axis = attribute_axis(cfg.routes, pairs) if pairs else None
            if axis is not None:
                name = cfg.wire_axes.get(axis)
                return None if name is None else Shape(name, ()).itemsize
        return None
    if cfg.wire_dtype is None:
        return None
    return Shape(cfg.wire_dtype, ()).itemsize


def _lint_wire_downcast(ir: ProgramIR, cfg: LintConfig) -> list:
    if cfg.wire_dtype is None and not cfg.wire_axes:
        return []
    permutes = ir.permutes
    if not permutes:
        return []
    # EVERY float payload must be at or below ITS AXIS's wire width — a
    # partial regression (one axis narrowed, the others still full
    # precision) is as real a bandwidth loss as a total one, while a
    # full-width payload on an axis the per-axis policy leaves exact is
    # legal (the pre-policy global check flagged those). Width, not
    # equality: an f16 field under bf16 wire legitimately ships as f16,
    # and integer (quantized) payloads are always at or below any
    # configured width (`wire_format_for` never widens a payload).
    stale = []
    for p in permutes:
        pay = ir.payload_of(p)
        if not _is_float_payload(pay):
            continue
        allowed = _allowed_wire_width(cfg, p)
        if allowed is not None and pay.itemsize > allowed:
            stale.append(p)
    if not stale:
        return []
    n_float = sum(1 for p in permutes if _is_float_payload(ir.payload_of(p)))
    got = sorted({str(ir.payload_of(p)) for p in stale})
    wire_desc = (",".join(f"{a}:{d}" for a, d in sorted(cfg.wire_axes.items()))
                 if cfg.wire_axes else cfg.wire_dtype)
    return [AuditFinding(
        "wire-downcast-missing", SEV_ERROR,
        f"wire dtype {wire_desc!r} requested but {len(stale)} of "
        f"{n_float} float collective-permute payload(s) still cross the "
        f"link wider than it allows (stale payloads: {got}) — the "
        "narrowing did not reach (all of) the wire. (Audit the LOWERED "
        "module on CPU: its backend normalizes bf16 payloads back to "
        "f32.)",
        details={"wire_dtype": wire_desc, "payloads": got,
                 "stale": len(stale), "float_permutes": n_float})]


def _lint_donation(ir: ProgramIR, cfg: LintConfig) -> list:
    """Read from an HLO module header's input-output aliases. A recording
    has no counterpart and gets no finding: eager PyTorch donates nothing
    (the port's runners ping-pong two buffers a chunk,
    `models.common.make_state_runner`), so no alias can be missing."""
    if cfg.expect_donation is None or ir.dialect != "hlo":
        return []
    n = int(ir.attrs.get("n_aliases", 0))
    if n >= int(cfg.expect_donation):
        return []
    return [AuditFinding(
        "donation-unaliased", SEV_WARNING,
        f"{cfg.expect_donation} donated input(s) but only {n} input-"
        "output alias(es) in the module header: each missing alias is a "
        "hidden full-block copy per dispatch.",
        details={"expected": int(cfg.expect_donation), "aliased": n})]


def _lint_host_transfer(ir: ProgramIR, cfg: LintConfig) -> list:
    out = []
    for op in ir.ops:
        hostile = op.op in _HOST_TRANSFER_OPS \
            or op.attrs.get("is_host_transfer") \
            or (op.op == "custom-call"
                and op.attrs.get("custom_call_target")
                in _HOST_CALLBACK_TARGETS)
        if hostile:
            out.append(AuditFinding(
                "host-transfer", SEV_ERROR,
                f"{op.op} inside the compiled body "
                f"({op.attrs.get('custom_call_target') or op.name}): a "
                "host round-trip serializes the step loop.",
                op=op.name, computation=op.computation))
    return out


def _lint_custom_call(ir: ProgramIR, cfg: LintConfig) -> list:
    """Opaque custom-calls of a dump. A recording has no counterpart and
    gets no finding: every kernel of the port is a hand-written CUDA
    kernel launched outside any compiler, so an opaque kernel is the
    port's design, not a hazard, and the recorder records collectives,
    not launches."""
    if ir.dialect == "record":
        return []
    out = []
    for op in ir.ops:
        if op.op != "custom-call":
            continue
        target = op.attrs.get("custom_call_target")
        if target in _BENIGN_CUSTOM_CALLS \
                or target in _HOST_CALLBACK_TARGETS:
            continue  # host callbacks are the host-transfer rule's job
        out.append(AuditFinding(
            "custom-call", SEV_WARNING,
            f"opaque custom-call {target!r}: the compiler cannot fuse or "
            "reason across it.",
            op=op.name, computation=op.computation,
            details={"target": target}))
    return out


def _lint_f64(ir: ProgramIR, cfg: LintConfig) -> list:
    if "f64" in cfg.state_dtypes:
        return []
    leaks = [op for op in ir.ops if op.has_shape("f64")]
    if not leaks:
        return []
    return [AuditFinding(
        "f64-leakage", SEV_WARNING,
        f"{len(leaks)} op(s) carry f64 buffers in a program whose state "
        "dtypes are "
        f"{sorted(cfg.state_dtypes) or '(unspecified)'} — an unintended "
        "promotion is a silent perf cliff (emulated on a TPU, a fraction "
        "of float32's rate on a GPU).",
        op=leaks[0].name, computation=leaks[0].computation,
        details={"ops": len(leaks), "first": leaks[0].op})]


def _lint_copy_feeds_collective(ir: ProgramIR, cfg: LintConfig) -> list:
    out = []
    for op in ir.collectives():
        for name in op.operands:
            prod = ir.resolve(op.computation, name)
            if prod is not None and prod.op == "copy":
                out.append(AuditFinding(
                    "copy-feeds-collective", SEV_WARNING,
                    f"{op.op} payload is staged through a copy "
                    f"({prod.shapes[0] if prod.shapes else '?'}): the "
                    "slab slicing failed to fuse into the collective.",
                    op=op.name, computation=op.computation,
                    details={"copy": prod.name}))
    return out


LINT_RULES = {
    "global-materialization": _lint_global_materialization,
    "wire-downcast-missing": _lint_wire_downcast,
    "donation-unaliased": _lint_donation,
    "host-transfer": _lint_host_transfer,
    "custom-call": _lint_custom_call,
    "f64-leakage": _lint_f64,
    "copy-feeds-collective": _lint_copy_feeds_collective,
}
DEFAULT_LINTS = tuple(LINT_RULES)


def run_lints(ir: ProgramIR, *, config: LintConfig | None = None,
              rules=None) -> list:
    """Run the lint ``rules`` (names from `LINT_RULES`; default all) over
    a parsed program. Returns findings sorted most-severe first."""
    if not isinstance(ir, ProgramIR):
        raise InvalidArgumentError(
            "run_lints expects a ProgramIR (use parse_program).")
    config = config if config is not None else default_lint_config()
    out: list = []
    for name in (rules if rules is not None else DEFAULT_LINTS):
        fn = LINT_RULES.get(name)
        if fn is None:
            raise InvalidArgumentError(
                f"unknown lint rule {name!r} (have {sorted(LINT_RULES)}).")
        out.extend(fn(ir, config))
    return sort_findings(out)
