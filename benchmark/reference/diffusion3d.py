"""Plain reference of 3-D heat diffusion on the whole global grid.

The reference example's hot loop (ImplicitGlobalGrid.jl, ``diffusion3D``)
on one global field, with no blocks, halos or kernels::

    qx = -lam * dT/dx  (on the x faces of the inner y, z rows; likewise y, z)
    T[inner] += dt * (-(dqx/dx + dqy/dy + dqz/dz)) / Cp[inner]

The global boundary cells keep their values (non-periodic). Plain PyTorch;
it imports nothing of the measured program. Also here: the constants of the
configuration and the seed-made initial state, which the benchmark hands to
the program and to this reference alike.
"""

from __future__ import annotations

import random

import torch

DTYPE = "float64"  # the precision the reference computes in


def global_shape(cfg) -> tuple:
    """``dims`` non-periodic blocks of ``local`` cells overlapping by
    ``overlaps``: ``D*n - (D-1)*ol`` cells a dim."""
    return tuple(d * (n - o) + o for n, d, o in zip(cfg["local"], cfg["dims"], cfg["overlaps"]))


def consts(cfg) -> dict:
    """The example's constants: ``dx = lx/(nx_g-1)``, ``dt = min(dx^2, dy^2,
    dz^2) * cp_min / lam / 8.1``."""
    N = global_shape(cfg)
    dx, dy, dz = (cfg[k] / (n - 1) for k, n in zip(("lx", "ly", "lz"), N))
    dt = min(dx * dx, dy * dy, dz * dz) * cfg["cp_min"] / cfg["lam"] / 8.1
    return {"lam": float(cfg["lam"]), "dt": dt, "dx": dx, "dy": dy, "dz": dz}


def inputs(cfg, members, seed, device) -> dict:
    """The initial ``T`` and ``Cp`` of ``members`` runs (None: one, with no
    member axis) on ``device`` in the configuration's dtype, from ``seed``:
    the example's two Gaussian anomalies of each, their centres moved by
    up to ``centre_jitter`` and their amplitudes scaled by a factor in
    ``amplitude_range`` (host draws), plus Gaussian noise of
    ``T_noise`` on ``T`` (drawn on the device)."""
    a = cfg["assumed"]
    dtype = getattr(torch, cfg["dtype"])
    rng = random.Random(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    N = global_shape(cfg)
    c = consts(cfg)
    ax = [torch.arange(n, dtype=torch.float64, device=device) * h
          for n, h in zip(N, (c["dx"], c["dy"], c["dz"]))]
    x, y, z = ax[0].view(-1, 1, 1), ax[1].view(1, -1, 1), ax[2].view(1, 1, -1)
    lx, ly, lz = cfg["lx"], cfg["ly"], cfg["lz"]

    def jit():
        return rng.uniform(-a["centre_jitter"], a["centre_jitter"])

    def amp():
        return rng.uniform(*a["amplitude_range"])

    def gauss(cx, cy, cz, w):
        return torch.exp(-((x - cx) / w) ** 2 - ((y - cy) / w) ** 2 - ((z - cz) / w) ** 2)

    Ts, Cps = [], []
    for _ in range(members or 1):
        Cp = cfg["cp_min"] \
            + 5 * amp() * gauss(lx / 1.5 + jit(), ly / 2 + jit(), lz / 1.5 + jit(), 1.0) \
            + 5 * amp() * gauss(lx / 3.0 + jit(), ly / 2 + jit(), lz / 1.5 + jit(), 1.0)
        T = 100 * amp() * gauss(lx / 2 + jit(), ly / 2 + jit(), lz / 3.0 + jit(), 2.0) \
            + 50 * amp() * gauss(lx / 2 + jit(), ly / 2 + jit(), lz / 1.5 + jit(), 2.0)
        T = T.to(dtype) + a["T_noise"] * torch.randn(N, generator=gen, device=device,
                                                     dtype=dtype)
        Ts.append(T)
        Cps.append(Cp.to(dtype))
    if members is None:
        return {"T": Ts[0], "Cp": Cps[0]}
    return {"T": torch.stack(Ts), "Cp": torch.stack(Cps)}


def step(T, Cp, c):
    """One step of global ``T`` in place (the reference example's flux form,
    in its operation order)."""
    i = slice(1, -1)
    qx = (-c["lam"]) * (T[1:, i, i] - T[:-1, i, i]) / c["dx"]
    qy = (-c["lam"]) * (T[i, 1:, i] - T[i, :-1, i]) / c["dy"]
    qz = (-c["lam"]) * (T[i, i, 1:] - T[i, i, :-1]) / c["dz"]
    dTdt = (-(qx[1:] - qx[:-1]) / c["dx"] - (qy[:, 1:] - qy[:, :-1]) / c["dy"]
            - (qz[:, :, 1:] - qz[:, :, :-1]) / c["dz"]) / Cp[i, i, i]
    T[i, i, i] += c["dt"] * dTdt
    return T


def run(inp, c, request, dtype) -> dict:
    """``T`` after each step count of ``request["steps"]``, from ``inp``, in
    ``dtype`` (a name): ``{"at": {steps: {"T": tensor}}}``, one member at a
    time."""
    dt = getattr(torch, dtype)
    targets = sorted(set(request["steps"]))
    T0, Cp0 = inp["T"], inp["Cp"]
    solo = T0.dim() == 3
    at = {s: [] for s in targets}
    for m in range(1 if solo else T0.shape[0]):
        T = (T0 if solo else T0[m]).to(dt).clone()
        Cp = (Cp0 if solo else Cp0[m]).to(dt)
        done = 0
        for s in targets:
            for _ in range(s - done):
                step(T, Cp, c)
            done = s
            at[s].append(T.clone())
    return {"at": {s: {"T": v[0] if solo else torch.stack(v)} for s, v in at.items()}}
