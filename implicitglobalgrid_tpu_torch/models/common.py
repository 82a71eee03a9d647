"""Shared model machinery: the step loop and the chunked runner.

Counterpart of `implicitglobalgrid_tpu/models/common.py`. The JAX package
compiles a chunk of steps into one program (`lax.fori_loop`); PyTorch runs
eagerly, so a chunk is a Python loop over the step, and the runner
ping-pongs two buffers: a step writes its new state into the buffer the
step before last wrote, so a run allocates two buffers at most and never
writes the caller's input.
"""

from __future__ import annotations

from ..parallel.topology import check_initialized

__all__ = ["make_state_runner", "run_chunked"]


def make_state_runner(step_local, *, nt_chunk: int):
    """A runner ``run(*state, donate=False) -> state`` advancing
    ``nt_chunk`` steps.

    ``step_local(state, spare) -> (state, old)`` advances one step: it may
    write the new state into ``spare`` (a buffer it may overwrite, or None
    to allocate) and returns the new state and the buffer it no longer needs
    (which becomes the next step's ``spare``). The caller's input is used as
    a spare only with ``donate=True``."""
    check_initialized()
    nt_chunk = int(nt_chunk)

    def run(*state, donate: bool = False):
        state = tuple(state)
        spare = None
        for k in range(nt_chunk):
            state, old = step_local(state, spare)
            spare = old if (k > 0 or donate) else None
        return state

    return run


def run_chunked(runner_factory, state, nt: int, nt_chunk: int):
    """Advance ``nt`` steps with ``runner_factory(chunk_size)``, in chunks
    of ``nt_chunk`` (the JAX package's compile boundary; kept for API
    parity). Returns after the device has drained."""
    from ..utils.timing import sync

    full, rem = divmod(int(nt), int(nt_chunk))
    donate = False
    if full:
        run = runner_factory(nt_chunk)
        for _ in range(full):
            state = run(*state, donate=donate)
            donate = True
    if rem:
        state = runner_factory(rem)(*state, donate=donate)
    return sync(state)
