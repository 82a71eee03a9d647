"""diffusion3d: drives implicitglobalgrid_tpu_torch's 3-D heat diffusion.

The grid is ``init_global_grid`` over one card's virtual mesh (every block
on the run's device); the state is the benchmark's seed-made ``T`` and
``Cp`` (`reference/diffusion3d.py`) in the program's stacked layout; a call
is ``run_diffusion(T, Cp, params, steps, nt_chunk=steps)`` (with
``ensemble=`` for members), which returns once the device has drained.
Every call starts from the seed-made state. An answer is judged against
the plain reference on every stored cell, halos included.
"""

from __future__ import annotations

import math

import torch
from benchlib.layout import Grid

# Operations a cell of the update, counted from its equations: three fluxes
# (difference, product by -lam, division by the spacing: 9), the
# divergence (three differences, three divisions, a negation and two
# subtractions: 9), the division by Cp, the product by dt and the sum.
FLOPS_PER_CELL = 21


def step_bytes(cfg, traffic) -> int:
    """A step's bytes: T and Cp read once and T written once, as stored
    (every block's cells, halos included), for every member."""
    g = Grid(cfg["local"], cfg["dims"], cfg["overlaps"])
    item = torch.empty(0, dtype=getattr(torch, cfg["dtype"])).element_size()
    return 3 * math.prod(g.stacked_of(g.local)) * item * (traffic.get("members") or 1)


def step_flops(cfg, traffic) -> int:
    """A step's operations: `FLOPS_PER_CELL` a block's interior cell."""
    g = Grid(cfg["local"], cfg["dims"], cfg["overlaps"])
    inner = math.prod(n - 2 for n in g.local) * g.blocks
    return FLOPS_PER_CELL * inner * (traffic.get("members") or 1)


class Model:
    """The program's grid and seed-made state for one run."""

    def __init__(self, cfg, traffic, consts, inputs, device):
        import implicitglobalgrid_tpu_torch as igg
        from implicitglobalgrid_tpu_torch.models import DiffusionParams

        if any(cfg["periods"]):
            raise ValueError("diffusion3d: the layout here is non-periodic")
        self.igg = igg
        self.dtype = cfg["dtype"]
        self.step_bytes = step_bytes(cfg, traffic)
        self.step_flops = step_flops(cfg, traffic)
        self.members = traffic.get("members")
        self.grid = g = Grid(cfg["local"], cfg["dims"], cfg["overlaps"])
        dev = torch.device(device)
        name = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu"
        n, d = cfg["local"], cfg["dims"]
        igg.init_global_grid(n[0], n[1], n[2], dimx=d[0], dimy=d[1], dimz=d[2],
                             overlaps=tuple(cfg["overlaps"]), devices=[name] * g.blocks,
                             quiet=True)
        got = (igg.nx_g(), igg.ny_g(), igg.nz_g())
        if got != g.global_shape:
            raise RuntimeError(f"the program's global grid is {got}; the layout here "
                               f"{g.global_shape}")
        self.params = DiffusionParams(**consts)
        self.state = (g.stack(inputs["T"]), g.stack(inputs["Cp"]))
        self.cells_per_step = math.prod(g.global_shape) * (self.members or 1)

    def advance(self, state, steps):
        from implicitglobalgrid_tpu_torch.models import run_diffusion

        T = run_diffusion(state[0], state[1], self.params, steps, nt_chunk=steps,
                          ensemble=self.members)
        return (T, state[1])

    def answer_state(self, ref_at):
        """A reference snapshot in the program's layout (the control)."""
        return (self.grid.stack(ref_at["T"]), None)

    def judge(self, answer, ref) -> dict:
        """The largest gap of any stored cell to the reference, over the
        reference's largest magnitude."""
        r = self.grid.stack(ref["at"][answer.steps]["T"].double())
        scale = float(r.abs().max())
        return {"T_rel_err": float((answer.state[0].double() - r).abs().max()) / scale}

    def close(self):
        self.state = None
        self.igg.finalize_global_grid()
