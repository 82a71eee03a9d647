"""Shared helpers of the fused staggered-field steps (the acoustic K9,
`cuda_wave.py`, and the Stokes K10, `cuda_stokes.py`): the four exchanged
fields (P, Vx, Vy, Vz) and their shapes, the gate and the index map of the
all-self route, the checks of a stacked state, its outputs and received
slabs, the constants as 0-d tensors, and the staggered modes of K4s (one
launch a dim for every field of the group, `SlabBatch`, and its plain
version `slab_batch_plain`).

Counterpart of the parts of `implicitglobalgrid_tpu/ops/pallas_common.py`
that the plain versions need (`all_self_exchange`, the overlaps of
`self_recvs_and_ols`); the rest of that module is TPU operand wiring.
"""

from __future__ import annotations

import ctypes

from ..utils.exceptions import InvalidArgumentError

__all__ = ["FIELDS", "FLOATS", "wave_shapes", "self_ols", "all_self_exchange", "self_index",
           "check_state", "check_out", "check_recvs", "check_self", "const_tensors", "into",
           "check_slab_batch", "slab_batch_plain", "SlabBatch", "dtype_code", "step_args",
           "slab_ptrs", "NO_MODES", "NO_OLS"]

FIELDS = ("P", "Vx", "Vy", "Vz")
# the state dtypes of the Stokes kernels; the acoustic ones add bfloat16
FLOATS = ("float32", "float64")


def dtype_code(dtype) -> int:
    """The kernels' dtype argument: 0 float32, 1 float64, 2 bfloat16."""
    return ("float32", "float64", "bfloat16").index(str(dtype).replace("torch.", ""))


def wave_shapes(block):
    """LOCAL (P, Vx, Vy, Vz) shapes for P's block (nx, ny, nz)."""
    nx, ny, nz = (int(b) for b in block)
    return {"P": (nx, ny, nz), "Vx": (nx + 1, ny, nz), "Vy": (nx, ny + 1, nz),
            "Vz": (nx, ny, nz + 1)}


def all_self_exchange(gg, modes) -> bool:
    """Whether every exchanging dim of the fields is self-neighbour (one
    rank, periodic): the gate of the fused steps' all-self route."""
    exch = [d for d in range(3) if any(m[d] for m in modes.values())]
    return bool(exch) and all(int(gg.dims[d]) == 1 and bool(gg.periods[d]) for d in exch)


def self_ols(gg, block):
    """Each field's overlap per dim (`ol`, grown by its staggering): the
    self-exchange of dim d maps index 0 to n-ol and n-1 to ol-1."""
    return {f: tuple(int(gg.overlaps[d]) + s[d] - int(gg.nxyz[d]) for d in range(3))
            for f, s in wave_shapes(block).items()}


def self_index(n_stack, n, ol, device):
    """Source index of every stacked index along a self-exchanging dim of
    blocks of length ``n``: 0 reads n-ol, n-1 reads ol-1, the rest itself."""
    import torch

    i = torch.arange(n_stack, device=device)
    loc = i % n
    src = torch.where(loc == 0, n - ol, torch.where(loc == n - 1, ol - 1, loc))
    return i - loc + src


NO_MODES = {f: (False, False, False) for f in FIELDS}  # the multi-rank route's self map
NO_OLS = {f: (0, 0, 0) for f in FIELDS}


def step_args(block, counts, consts, const_order, modes=NO_MODES, ols=NO_OLS):
    """The geometry and constant arrays of a fused staggered step (K9,
    K10): P's block, the block counts, the self map's modes and overlaps
    [field][dim], and the constants in ``const_order``."""
    g = (ctypes.c_longlong * 30)(
        *block, *counts, *(int(bool(modes[f][d])) for f in FIELDS for d in range(3)),
        *(int(ols[f][d]) for f in FIELDS for d in range(3)))
    return g, (ctypes.c_double * 7)(*(float(consts[k]) for k in const_order))


def slab_ptrs(recvs):
    """The 24 received-slab pointers of a fused staggered step, [field][dim]
    [left, right], None where a field takes none along a dim."""
    ptrs = []
    for f in FIELDS:
        for d in range(3):
            pair = recvs.get(f, {}).get(d)
            ptrs += [None, None] if pair is None else [p.data_ptr() for p in pair]
    return ptrs


def check_state(state, block, shapes_of, name, dtypes=FLOATS, members=False):
    """Validate a stacked state whose fields have the LOCAL shapes
    ``shapes_of(block)`` (``{field: shape}``, P first, for P's block
    ``block``): contiguous stacked blocks of P's dtype (one of ``dtypes``,
    by name) and device; with ``members``, each may lead with the same
    member axis (an ensemble's). Returns (P block, block counts)."""
    import torch

    state = tuple(state)
    if not state or not all(isinstance(a, torch.Tensor) for a in state):
        raise InvalidArgumentError(f"{name} takes the state's tensors.")
    P = state[0]
    if str(P.dtype).replace("torch.", "") not in dtypes:
        raise InvalidArgumentError(f"{name} takes {' or '.join(dtypes)} states; got {P.dtype}.")
    block = tuple(int(b) for b in block)
    lead = P.dim() - 3
    if len(block) != 3 or block[0] < 3 or min(block) < 1 or lead not in ((0, 1) if members
                                                                          else (0,)) \
            or any(s % b for s, b in zip(P.shape[lead:], block)):
        raise InvalidArgumentError(
            f"{name}: P block {block} (>= 3 planes) does not tile {tuple(P.shape)}.")
    shapes = shapes_of(block)
    if len(state) != len(shapes):
        raise InvalidArgumentError(f"{name} takes the {len(shapes)} tensors {tuple(shapes)}.")
    counts = tuple(int(s) // b for s, b in zip(P.shape[lead:], block))
    for a, (f, shp) in zip(state, shapes.items()):
        want = tuple(P.shape[:lead]) + tuple(c * s for c, s in zip(counts, shp))
        if tuple(a.shape) != want or a.dtype != P.dtype or a.device != P.device \
                or not a.is_contiguous():
            raise InvalidArgumentError(
                f"{name}: {f} must be the contiguous stacked blocks {shp} ({counts} of "
                f"them) of P's dtype and device; got {tuple(a.shape)}.")
    return block, counts


def check_out(state, out, n, name):
    """``out``: the buffers of the first ``n`` fields of ``state`` (an entry
    for each field may be given; the rest are ignored), distinct, like the
    state and not aliasing it. Returns them as a tuple, or None."""
    if out is None:
        return None
    out = tuple(out)
    if len(out) not in (n, len(state)):
        raise InvalidArgumentError(f"{name}: out must hold {n} tensors.")
    out = out[:n]
    if len({o.untyped_storage().data_ptr() for o in out}) != n:
        raise InvalidArgumentError(f"{name}: the {n} outputs must not share storage.")
    stores = {a.untyped_storage().data_ptr() for a in state}
    for a, o in zip(state, out):
        if (tuple(o.shape) != tuple(a.shape) or o.dtype != a.dtype or o.device != a.device
                or not o.is_contiguous()):
            raise InvalidArgumentError(f"{name}: out must be contiguous tensors like the "
                                       "state.")
        if o.untyped_storage().data_ptr() in stores:
            raise InvalidArgumentError(f"{name}: out must not alias the state: the step "
                                       "reads it at its neighbours.")
    return out


# const_tensors' results by values, dtype and device (never written)
_CONSTS: dict = {}


def const_tensors(consts, like):
    """The constants ``{name: value}`` as 0-d tensors of ``like``'s dtype and
    device, so every operation of a plain version rounds as the kernel's.
    Made once per values, dtype and device, then shared (callers only read
    them): a blocking copy to the card in every step would stall the host."""
    import torch

    key = (tuple((k, float(v)) for k, v in consts.items()), like.dtype, like.device)
    got = _CONSTS.get(key)
    if got is None:
        if len(_CONSTS) >= 64:
            _CONSTS.clear()
        got = _CONSTS[key] = {k: torch.tensor(float(v), dtype=like.dtype, device=like.device)
                              for k, v in consts.items()}
    return got


def check_recvs(state, recvs, counts, out, name):
    """Received slabs ``{field: {dim: (recv_l, recv_r)}}`` of halowidth 1 in
    K2's layout for the fields (P, Vx, Vy, Vz) = ``state[:4]``; none may
    alias the state or ``out``."""
    stores = {a.untyped_storage().data_ptr() for a in tuple(state) + tuple(out or ())}
    for f, per_dim in recvs.items():
        if f not in FIELDS:
            raise InvalidArgumentError(f"{name}: unknown field {f!r} in recvs.")
        a = state[FIELDS.index(f)]
        for d, pair in per_dim.items():
            if not 0 <= int(d) < 3 or len(pair) != 2:
                raise InvalidArgumentError(f"{name}: no dim {d}.")
            want = list(a.shape)
            want[d] = counts[d]
            for s in pair:
                if (list(s.shape) != want or s.dtype != a.dtype or s.device != a.device
                        or not s.is_contiguous()):
                    raise InvalidArgumentError(
                        f"{name}: the slabs of {f} along dim {d} must be contiguous "
                        f"{tuple(want)} {a.dtype}; got {tuple(s.shape)} {s.dtype}.")
                if s.untyped_storage().data_ptr() in stores:
                    raise InvalidArgumentError(
                        f"{name}: a slab must not alias the state or the output.")


def check_self(modes, ols, block, name):
    """The overlaps of the self-exchanging dims fit their fields."""
    shp = wave_shapes(block)
    for f in FIELDS:
        for d in range(3):
            n = shp[f][d]
            if modes[f][d] and not 2 <= int(ols[f][d]) <= n - 1:
                raise InvalidArgumentError(
                    f"{name}: overlap {ols[f][d]} of {f} along dim {d} must lie in "
                    f"[2, {n - 1}].")


def into(out, new):
    """``new`` copied into ``out`` (returned), or ``new`` itself when
    ``out`` is None."""
    if out is None:
        return tuple(new)
    for o, n in zip(out, new):
        o.copy_(n)
    return tuple(out)


# ---------------------------------------------------------------------------
# K4s staggered modes: the received slabs of one dim for every field.
# ---------------------------------------------------------------------------

def check_slab_batch(state, dim, hw, per_field, block, name):
    """Validate one batched K4s call: ``per_field`` maps some of the fields
    (P, Vx, Vy, Vz) to ``(moves, earlier)`` as `cuda_stencil.exchange_slabs`
    takes them, for 3-D fields of the stacked ``state`` (P blocks
    ``block``). Returns (dim, hw)."""
    from .cuda_stencil import _check_slabs

    if not per_field or any(f not in FIELDS for f in per_field):
        raise InvalidArgumentError(f"{name}: the fields must be some of {FIELDS}; got "
                                   f"{tuple(per_field)}.")
    shp = wave_shapes(block)
    for f, (moves, earlier) in per_field.items():
        A = state[FIELDS.index(f)]
        if A.dim() != 3:
            raise InvalidArgumentError(f"{name}: 3-D fields only.")
        d, h, _ = _check_slabs(A, dim, hw, moves, shp[f], earlier, None, None)
    return d, h


def slab_batch_plain(new, dim, hw, per_field, *, block, periodic):
    """Plain PyTorch version of a batched K4s launch: the received slabs
    ``{field: (recv_l, recv_r)}`` of each field of ``per_field`` (``(moves,
    earlier)``), its send slabs cut from ``new`` (the updated fields, P, Vx,
    Vy, Vz first), patched and moved as `cuda_stencil.move_slabs_plain`
    does."""
    import torch

    from .cuda_stencil import _slab_view, move_slabs_plain

    out = {}
    for f, (moves, earlier) in per_field.items():
        U = new[FIELDS.index(f)]
        m = wave_shapes(block)[f]

        def get_slab(start, U=U, n=m[dim]):
            return _slab_view(U, dim, n, start, hw).flatten(dim, dim + 1).clone(
                memory_format=torch.contiguous_format)

        out[f] = move_slabs_plain(get_slab, tuple(U.shape), U.device, dim, hw, moves, block=m,
                                  periodic=periodic, earlier=earlier)
    return out


class SlabBatch:
    """The staggered modes of K4s for one state layout: one launch of the C
    entry point ``entry`` (``igg_exchange_slabs_wave`` or
    ``igg_exchange_slabs_stokes``) computes the received slabs of one dim
    for every field of a group. The argument arrays of a dim are built at
    its first launch and reused; with ``keep``, so are its output slabs (a
    launch overwrites the slabs of the one before, which the step that read
    them has consumed on the same stream). Arguments are checked by the
    caller."""

    def __init__(self, entry, *, block, counts, consts, const_order, keep=False):
        self.entry, self.keep = entry, keep
        self.block = tuple(int(b) for b in block)
        self.counts = tuple(int(c) for c in counts)
        self.consts = (ctypes.c_double * 7)(*(float(consts[k]) for k in const_order))
        self._g, self._outs = {}, {}

    def _args(self, dim, hw, periodic, per_field):
        key = (dim, hw, bool(periodic),
               tuple((f, tuple(tuple(m) for m in mv)) for f, (mv, _) in per_field.items()))
        g = self._g.get(key)
        if g is None:
            vals = [*self.block, *self.counts, dim, hw, int(bool(periodic))]
            for f in FIELDS:
                if f not in per_field:
                    vals += [0] * 6 + [-1, 0, -1, 0]
                    continue
                moves, earlier = per_field[f]
                mv = [tuple(int(x) for x in m) for m in moves] + [(0, 0, 0)] * (2 - len(moves))
                ear = [int(x) for e, hw_e, _ in earlier for x in (e, hw_e)]
                vals += [*mv[0], *mv[1], *ear, *[-1, 0] * (2 - len(earlier))]
            g = self._g[key] = (ctypes.c_longlong * 49)(*vals)
        return key, g

    def _out_slabs(self, key, state, dim, hw, per_field):
        import torch

        key = (key, state[0].dtype, state[0].device)  # kept slabs match the state's
        outs = self._outs.get(key) if self.keep else None
        if outs is None:
            outs = {}
            for f, (moves, _) in per_field.items():
                A = state[FIELDS.index(f)]
                shape = list(A.shape)
                shape[dim] = self.counts[dim] * hw
                outs[f] = tuple(torch.empty(shape, dtype=A.dtype, device=A.device)
                                for _ in moves)
            if self.keep:
                self._outs[key] = outs
        return outs

    def __call__(self, state, dim, hw, periodic, per_field):
        import torch

        from .cuda_build import check_rc, count_launch, library
        from .cuda_stencil import _stream  # looked up at the call, as the other wrappers do

        key, g = self._args(dim, hw, periodic, per_field)
        outs = self._out_slabs(key, state, dim, hw, per_field)
        ptrs = [a.data_ptr() for a in state]
        for f in FIELDS:
            if f not in per_field:
                ptrs += [None] * 6
                continue
            o, earlier = outs[f], per_field[f][1]
            ptrs += [t.data_ptr() for t in o] + [None] * (2 - len(o))
            ptrs += [t.data_ptr() for _, _, pair in earlier for t in pair]
            ptrs += [None, None] * (2 - len(earlier))
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        P = state[0]
        with torch.cuda.device(P.device):
            rc = getattr(library(), self.entry)(dtype_code(P.dtype), ctypes.addressof(arr),
                                                ctypes.addressof(g),
                                                ctypes.addressof(self.consts), _stream(P))
        check_rc(rc, self.entry)
        count_launch("exchange_slabs", f"{self.entry.rsplit('_', 1)[1]}/{dim}")
        return outs
