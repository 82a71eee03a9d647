"""Structured parsing of program dumps: HLO / StableHLO text -> `ProgramIR`.

The port's own copy of the JAX package's parser
(`implicitglobalgrid_tpu/analysis/hlo.py`): stdlib + numpy, so the JAX
package's golden dumps (tests/data/hlo/) and any HLO or StableHLO text
parse here too. `parse_text` / `parse_program` turn a dump into a
`ProgramIR`: a full op inventory where every collective carries its
operand/result shapes, dtype, bytes on the wire and source-target /
replica-group metadata, plus the def-use graph (`ProgramIR.closure`).

Two text dialects and one recorded one share the IR:

- **optimized HLO** (``HloModule ...``): post-SPMD, collectives name their
  ``source_target_pairs`` over linearized mesh positions;
- **StableHLO** (``module @...``): the pre-backend module;
- **record** (`analysis.record`): the collectives the port's exchange
  routes moved while a callable ran under `record.recording()`, one op a
  logical collective in the same linearized positions. PyTorch compiles
  no program, so this is the port's counterpart of lowering a jitted
  function; `parse_program(fn, *args)` records one call.

Opcode names are canonicalised to HLO spelling (underscores -> dashes,
dialect prefixes stripped): ``stablehlo.collective_permute`` and
``collective-permute-start`` both answer to ``"collective-permute"`` in
`ProgramIR.permutes`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field

from ..utils.exceptions import InvalidArgumentError

__all__ = ["Shape", "HloOp", "ProgramIR", "parse_text", "parse_program"]


_ITEMSIZE = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f16": 2, "bf16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}


@dataclass(frozen=True)
class Shape:
    """One array shape in a program: element dtype (HLO spelling) + dims."""

    dtype: str
    dims: tuple

    @property
    def cells(self) -> int:
        n = 1
        for d in self.dims:
            n *= int(d)
        return n

    @property
    def itemsize(self) -> int:
        if self.dtype in _ITEMSIZE:
            return _ITEMSIZE[self.dtype]
        return 1 if self.dtype.startswith("f8") else 4

    @property
    def nbytes(self) -> int:
        return self.cells * self.itemsize

    def __str__(self) -> str:
        return f"{self.dtype}[{','.join(str(d) for d in self.dims)}]"


@dataclass(frozen=True, eq=False)  # identity hash: ops are graph nodes
class HloOp:
    """One parsed instruction (either dialect, canonical opcode spelling)."""

    name: str                 # SSA name without the leading %
    op: str                   # canonical opcode, e.g. "collective-permute"
    computation: str          # owning computation / func name
    shapes: tuple             # result Shape(s)
    operands: tuple           # operand SSA names (computation-scoped)
    operand_shapes: tuple     # operand Shape(s) when the text carries them
    attrs: dict = dc_field(default_factory=dict)
    metadata: dict = dc_field(default_factory=dict)
    line_no: int = 0
    line: str = ""

    @property
    def uid(self) -> str:
        """Module-unique id (StableHLO reuses %0.. per func)."""
        return f"{self.computation}:{self.name}"

    def has_shape(self, dtype: str, dims=None) -> bool:
        """Whether any result/operand shape matches (dims=None: dtype only)."""
        for s in self.shapes + self.operand_shapes:
            if s.dtype == dtype and (dims is None or s.dims == tuple(dims)):
                return True
        return False


# ---------------------------------------------------------------------------
# shared text helpers

_HLO_SHAPE = re.compile(
    r"\b(pred|token|opaque|bf16|f16|f32|f64|f8e\w+|[suc]\d+)"
    r"\[([0-9,]*)\](?:\{[^}]*\})?")
_TENSOR = re.compile(r"tensor<((?:\d+x)*)([A-Za-z]\w*)>")
_MLIR_DTYPE = {"i1": "pred"}


def _mlir_dtype(dt: str) -> str:
    if dt in _MLIR_DTYPE:
        return _MLIR_DTYPE[dt]
    if dt.startswith("ui"):
        return "u" + dt[2:]
    if dt.startswith("i") and dt[1:].isdigit():
        return "s" + dt[1:]
    return dt


def _hlo_shapes(s: str) -> tuple:
    return tuple(Shape(m.group(1),
                       tuple(int(x) for x in m.group(2).split(",") if x))
                 for m in _HLO_SHAPE.finditer(s))


def _tensor_shapes(s: str) -> tuple:
    return tuple(Shape(_mlir_dtype(m.group(2)),
                       tuple(int(x) for x in m.group(1).split("x") if x))
                 for m in _TENSOR.finditer(s))


def _match_paren(s: str, i: int) -> int:
    """Index of the paren closing the one at ``i`` (quote-aware)."""
    depth, in_str = 0, False
    for j in range(i, len(s)):
        c = s[j]
        if in_str:
            if c == '"' and s[j - 1] != "\\":
                in_str = False
            continue
        if c == '"':
            in_str = True
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return j
    raise InvalidArgumentError(f"unbalanced parentheses in HLO line: {s!r}")


def _split_top(s: str) -> list:
    """Split on top-level commas (outside (), {}, [], "")."""
    out, depth, in_str, start = [], 0, False, 0
    for j, c in enumerate(s):
        if in_str:
            if c == '"' and s[j - 1] != "\\":
                in_str = False
            continue
        if c == '"':
            in_str = True
        elif c in "({[":
            depth += 1
        elif c in ")}]":
            depth -= 1
        elif c == "," and depth == 0:
            out.append(s[start:j])
            start = j + 1
    out.append(s[start:])
    return [p.strip() for p in out if p.strip()]


_PAIRS = re.compile(r"\{(\d+),(\d+)\}")
_GROUP = re.compile(r"\{([0-9, ]*)\}")


def _parse_hlo_attrs(rest: str) -> dict:
    attrs: dict = {}
    for part in _split_top(rest):
        if "=" not in part:
            continue
        key, val = part.split("=", 1)
        key, val = key.strip(), val.strip()
        if key == "channel_id":
            attrs[key] = int(val)
        elif key == "source_target_pairs":
            attrs[key] = tuple((int(a), int(b))
                               for a, b in _PAIRS.findall(val))
        elif key == "replica_groups":
            attrs["replica_groups_raw"] = val
            if val.startswith("{"):
                attrs[key] = tuple(
                    tuple(int(x) for x in g.split(",") if x.strip())
                    for g in _GROUP.findall(val[1:-1]))
        elif key == "custom_call_target":
            attrs[key] = val.strip('"')
        elif key == "is_host_transfer":
            attrs[key] = val == "true"
        elif key in ("calls", "to_apply", "body", "condition"):
            attrs[key] = val.lstrip("%")
        elif key == "metadata":
            md = {}
            for mk in ("op_name", "source_file"):
                m = re.search(mk + r'="([^"]*)"', val)
                if m:
                    md[mk] = m.group(1)
            m = re.search(r"source_line=(\d+)", val)
            if m:
                md["source_line"] = int(m.group(1))
            attrs[key] = md
        else:
            attrs.setdefault("raw", {})[key] = val
    return attrs


# ---------------------------------------------------------------------------
# optimized-HLO dialect

_HLO_COMP = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$")
_HLO_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+)$")
_HLO_TYPE_ONE = re.compile(
    r"(pred|token|opaque|bf16|f16|f32|f64|f8e\w+|[suc]\d+)"
    r"\[[0-9,]*\](?:\{[^}]*\})?")
_HLO_OPCODE = re.compile(r"([\w\-]+)\(")


def _parse_hlo(text: str) -> "ProgramIR":
    ops, computations, entry = [], {}, None
    module, module_attrs = "", {}
    comp = None
    for ln, line in enumerate(text.splitlines(), 1):
        if line.startswith("HloModule"):
            head = line.split(None, 1)[1] if " " in line else ""
            parts = _split_top(head)
            module = parts[0].rstrip(",") if parts else ""
            for p in parts[1:]:
                if "=" in p:
                    k, v = p.split("=", 1)
                    module_attrs[k.strip()] = v.strip()
            alias = module_attrs.get("input_output_alias", "")
            module_attrs["n_aliases"] = len(
                re.findall(r"\{[0-9, ]*\}\s*:", alias))
            continue
        m = _HLO_COMP.match(line.strip()) if line.rstrip().endswith("{") \
            else None
        if m:
            comp = m.group(2)
            computations[comp] = []
            if m.group(1):
                entry = comp
            continue
        if comp is None:
            continue
        m = _HLO_INSTR.match(line)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2)
        # result type: a tuple "(...)" or one shape token
        if rhs.startswith("("):
            close = _match_paren(rhs, 0)
            type_str, rest = rhs[:close + 1], rhs[close + 1:].lstrip()
        else:
            tm = _HLO_TYPE_ONE.match(rhs)
            if not tm:
                continue
            type_str, rest = tm.group(0), rhs[tm.end():].lstrip()
        om = _HLO_OPCODE.match(rest)
        if not om:
            continue
        opcode = om.group(1)
        close = _match_paren(rest, om.end() - 1)
        operand_str = rest[om.end():close]
        attr_str = rest[close + 1:].lstrip(", ")
        attrs = _parse_hlo_attrs(attr_str)
        op = HloOp(
            name=name, op=opcode, computation=comp,
            shapes=_hlo_shapes(type_str),
            operands=tuple(n.lstrip("%") for n in
                           re.findall(r"%[\w.\-]+", operand_str)),
            operand_shapes=_hlo_shapes(operand_str),
            attrs=attrs,
            metadata=attrs.get("metadata", {}),
            line_no=ln, line=line.strip())
        ops.append(op)
        computations[comp].append(op)
    return ProgramIR(dialect="hlo", module=module, ops=tuple(ops),
                     computations={k: tuple(v)
                                   for k, v in computations.items()},
                     entry=entry, attrs=module_attrs)


# ---------------------------------------------------------------------------
# StableHLO dialect

_SH_FUNC = re.compile(r"^\s*func\.func\s+(?:public\s+|private\s+)?@(\w+)")
_SH_INSTR = re.compile(r"^\s*%([\w]+)(?::\d+)?\s*=\s*(.+)$")
_SH_OPNAME = re.compile(r'^"?(?:[a-z]\w*\.)?([\w.]+?)"?[\s(<]')
_SH_DENSE_PAIRS = re.compile(r"\[\s*(\d+)\s*,\s*(\d+)\s*\]")


def _parse_stablehlo(text: str) -> "ProgramIR":
    ops, computations, entry = [], {}, None
    module, module_attrs = "", {}
    comp = None
    for ln, line in enumerate(text.splitlines(), 1):
        s = line.strip()
        if s.startswith("module"):
            m = re.match(r"module\s+@(\S+)", s)
            module = m.group(1) if m else ""
            m = re.search(r"mhlo\.num_partitions\s*=\s*(\d+)", s)
            if m:
                module_attrs["num_partitions"] = m.group(1)
            continue
        m = _SH_FUNC.match(line)
        if m:
            comp = m.group(1)
            computations[comp] = []
            if comp == "main":
                entry = comp
            continue
        if comp is None:
            continue
        m = _SH_INSTR.match(line)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2)
        om = _SH_OPNAME.match(rhs)
        if om:
            opcode = om.group(1).replace("_", "-").replace(".", "-")
        elif rhs.startswith("call"):
            opcode = "call"
        else:
            continue
        if opcode.startswith("call"):
            opcode = "call"
        # final type signature: the last top-level " : " of the line
        before, sig = (rhs.rsplit(" : ", 1) + [""])[:2] \
            if " : " in rhs else (rhs, "")
        if "->" in sig:
            opnd_sig, res_sig = sig.rsplit("->", 1)
        else:
            opnd_sig, res_sig = "", sig
        attrs: dict = {}
        m = re.search(r"channel_handle<handle\s*=\s*(\d+)", rhs)
        if m:
            attrs["channel_id"] = int(m.group(1))
        m = re.search(r"source_target_pairs\s*=\s*dense<(.*?)>\s*:", rhs)
        if m:
            attrs["source_target_pairs"] = tuple(
                (int(a), int(b))
                for a, b in _SH_DENSE_PAIRS.findall(m.group(1)))
        m = re.search(r"replica_groups\s*=\s*dense<(.*?)>\s*:", rhs)
        if m:
            attrs["replica_groups_raw"] = m.group(1)
        if opcode == "custom-call":
            # dotted symbol names are real (@xla.sdy.FuncResultSharding)
            cm = re.search(r"@([\w.]+)", rhs)
            if cm:
                attrs["custom_call_target"] = cm.group(1).rstrip(".")
        if opcode == "call":
            cm = re.search(r"@([\w.]+)", rhs)
            if cm:
                attrs["calls"] = cm.group(1).rstrip(".")
        op = HloOp(
            name=name, op=opcode, computation=comp,
            shapes=_tensor_shapes(res_sig),
            operands=tuple(n.lstrip("%")
                           for n in re.findall(r"%[\w]+", before)),
            operand_shapes=_tensor_shapes(opnd_sig),
            attrs=attrs, line_no=ln, line=s)
        ops.append(op)
        computations[comp].append(op)
    return ProgramIR(dialect="stablehlo", module=module, ops=tuple(ops),
                     computations={k: tuple(v)
                                   for k, v in computations.items()},
                     entry=entry, attrs=module_attrs)


# ---------------------------------------------------------------------------
# the IR

_COLLECTIVE_BASES = ("collective-permute", "all-reduce", "all-gather",
                     "all-to-all", "reduce-scatter")


@dataclass(frozen=True)
class ProgramIR:
    """A parsed program: op inventory + def-use graph over all computations.

    Collective accessors follow the counting semantics the regex audits
    used: async pairs count by their ``-start`` op (``-done`` ignored);
    when no start form is present the synchronous ops count."""

    dialect: str              # "hlo" | "stablehlo" | "record"
    module: str
    ops: tuple
    computations: dict
    entry: str | None
    attrs: dict = dc_field(default_factory=dict)

    # -- inventory ----------------------------------------------------------
    def find(self, op: str | None = None, *, dtype: str | None = None,
             computation: str | None = None) -> list:
        out = []
        for o in self.ops:
            if op is not None and o.op != op:
                continue
            if computation is not None and o.computation != computation:
                continue
            if dtype is not None and not o.has_shape(dtype):
                continue
            out.append(o)
        return out

    def count(self, op: str) -> int:
        return sum(1 for o in self.ops if o.op == op)

    def inventory(self) -> dict:
        inv: dict = {}
        for o in self.ops:
            inv[o.op] = inv.get(o.op, 0) + 1
        return dict(sorted(inv.items()))

    def _kind(self, base: str) -> list:
        starts = [o for o in self.ops if o.op == base + "-start"]
        return starts if starts else [o for o in self.ops if o.op == base]

    @property
    def permutes(self) -> list:
        return self._kind("collective-permute")

    @property
    def all_reduces(self) -> list:
        return self._kind("all-reduce")

    @property
    def all_gathers(self) -> list:
        return self._kind("all-gather")

    @property
    def all_to_alls(self) -> list:
        return self._kind("all-to-all")

    def collectives(self) -> list:
        out = []
        for base in _COLLECTIVE_BASES:
            out.extend(self._kind(base))
        return sorted(out, key=lambda o: o.line_no)

    def parameters(self, computation: str | None = None) -> list:
        comp = computation or self.entry
        return [o for o in self.computations.get(comp, ())
                if o.op == "parameter"]

    # -- payloads -----------------------------------------------------------
    def resolve(self, computation: str, name: str) -> HloOp | None:
        for o in self.computations.get(computation, ()):
            if o.name == name:
                return o
        return None

    def payload_of(self, op: HloOp) -> Shape | None:
        """The on-wire payload shape of a collective: its first operand
        (resolved through the def-use graph when the text doesn't carry
        operand types inline, e.g. StableHLO region ops)."""
        if op.operand_shapes:
            return op.operand_shapes[0]
        for name in op.operands:
            prod = self.resolve(op.computation, name)
            if prod is not None and prod.shapes:
                return prod.shapes[0]
        if op.shapes:
            return op.shapes[0]
        return None

    def wire_bytes_of(self, op: HloOp) -> int:
        """Payload bytes summed over every directed link the op drives."""
        pay = self.payload_of(op)
        pairs = op.attrs.get("source_target_pairs") or ()
        return (pay.nbytes if pay else 0) * len(pairs)

    # -- def-use ------------------------------------------------------------
    def closure(self, seeds, direction: str = "up") -> set:
        """Transitive producers (``"up"``) or consumers (``"down"``) of the
        given ops, within their computations. Returns a set of `HloOp`."""
        if direction not in ("up", "down"):
            raise InvalidArgumentError(
                f"closure direction must be 'up' or 'down', got {direction!r}")
        by_comp: dict = {}
        for o in self.ops:
            by_comp.setdefault(o.computation, {})[o.name] = o
        rev: dict = {}
        if direction == "down":
            for o in self.ops:
                for name in o.operands:
                    rev.setdefault((o.computation, name), []).append(o)
        out: set = set()
        seen = {o.uid for o in seeds}
        stack = list(seeds)
        while stack:
            o = stack.pop()
            if direction == "up":
                nbrs = [by_comp.get(o.computation, {}).get(n)
                        for n in o.operands]
            else:
                nbrs = rev.get((o.computation, o.name), [])
            for nb in nbrs:
                if nb is not None and nb.uid not in seen:
                    seen.add(nb.uid)
                    out.add(nb)
                    stack.append(nb)
        return out


# ---------------------------------------------------------------------------
# entry points

def parse_text(text: str) -> ProgramIR:
    """Parse a program dump (optimized HLO or StableHLO, auto-detected)."""
    if not isinstance(text, str) or not text.strip():
        raise InvalidArgumentError("parse_text expects a non-empty program "
                                   "text.")
    head = text.lstrip()
    if head.startswith("HloModule"):
        return _parse_hlo(text)
    if head.startswith("module") or "stablehlo." in head[:4096]:
        return _parse_stablehlo(text)
    raise InvalidArgumentError(
        "parse_text: not recognizably HLO (expected a leading 'HloModule') "
        "or StableHLO (a leading 'module @...') dump.")


def parse_program(src, *args) -> ProgramIR:
    """Parse ``src`` into a `ProgramIR`.

    ``src`` may be program text (either dialect), a path to a file of it,
    an already-parsed `ProgramIR` (returned as-is), a `record.Recording`
    (its `program`), anything with ``as_text()``, or a callable: that one
    runs once on ``*args`` under the recorder (`record.record_program`)
    and the IR holds the collectives of its first step and those outside
    any step (the port's counterpart of lowering a jitted function; the
    JAX package's ``optimized`` switch has no meaning here)."""
    import os

    if isinstance(src, ProgramIR):
        return src
    if isinstance(src, (str, os.PathLike)):
        text = os.fspath(src)
        head = text.lstrip()[:64]
        if not head.startswith(("HloModule", "module")) and "\n" not in text \
                and os.path.isfile(text):
            with open(text, encoding="utf-8") as f:
                text = f.read()
        return parse_text(text)
    if hasattr(src, "as_text"):
        return parse_text(src.as_text())
    from .record import Recording, record_program

    if isinstance(src, Recording):
        return src.program()
    if callable(src):
        return record_program(src, *args).program()
    raise InvalidArgumentError(
        f"parse_program: cannot parse {type(src).__name__} (want text, a path "
        "to a dump, a ProgramIR, a Recording, or a callable plus example args).")
