"""Plain SPH step of the upstream project, particle by particle.

The step of ``rookieCookies/gpu-fluid-simulation`` (src/simulation.rs:502-538,
shaders/compute.wgsl, shaders/funcs.wgsl) with the scene's physics and no
obstacle, mouse or variant: predict, find every pair within h of the
predicted positions, poly6 density, linear pressure, spiky pressure force
and viscosity, integrate, clamp the speed, bounce off the walls. Written
from the equations alone: no slot grid, no cell capacity, no packing
order; neighbours come from a cell list built here. Computed in float64 by
default; ``dtype`` lowers it (the bf16 control rounds every intermediate).

Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

MAX_SPEED = 500.0  # compute.wgsl:118-122
EPSILON = 1.19209290e-07  # funcs.wgsl:55
DENSITY_FLOOR = 0.1  # compute.wgsl:70


def physics(config: dict) -> dict:
    """The scene's physics from a configuration file's ``physics`` and
    ``domain`` groups, as plain floats."""
    ph, dom = config["physics"], config["domain"]
    return dict(dt=float(ph["dt"]), gravity=tuple(map(float, ph["gravity"])),
                mass=float(ph["mass"]), k=float(ph["pressure_constant"]),
                rho0=float(ph["rest_density"]),
                damping=float(ph["damping_factor"]),
                viscosity=float(ph["viscosity_coefficient"]),
                h=float(dom["smoothing_radius"]),
                size=tuple(map(float, dom["size"])))


def pairs_within(points: torch.Tensor, radius: float, size, *,
                 with_self: bool, block: int = 1 << 22):
    """(i, j) int64 of every ordered pair with |p_i - p_j| < radius, from a
    cell list of cells ``radius`` wide over the box ``size`` (centred on
    the origin; points lie inside it). ``with_self`` keeps i == j.
    Candidates are made in blocks of about ``block`` pairs."""
    n = points.shape[0]
    dev = points.device
    half = torch.tensor(size, dtype=points.dtype, device=dev) * 0.5
    ncx = int(math.ceil(size[0] / radius)) + 1
    ncy = int(math.ceil(size[1] / radius)) + 1
    cxy = torch.floor((points + half) / radius).long()
    cx = cxy[:, 0].clamp(0, ncx - 1)
    cy = cxy[:, 1].clamp(0, ncy - 1)
    cell = cy * ncx + cx
    order = torch.argsort(cell)
    count = torch.bincount(cell, minlength=ncx * ncy)
    start = torch.cumsum(count, 0) - count
    r2max = radius * radius
    out_i, out_j = [], []
    per = max(1, block // max(1, 9 * int(count.max())))
    for lo in range(0, n, per):
        i0 = torch.arange(lo, min(n, lo + per), device=dev)
        for oy in (-1, 0, 1):
            for ox in (-1, 0, 1):
                nx, ny = cx[i0] + ox, cy[i0] + oy
                ok = (nx >= 0) & (nx < ncx) & (ny >= 0) & (ny < ncy)
                nc = (ny.clamp(0, ncy - 1) * ncx + nx.clamp(0, ncx - 1))
                cnt = torch.where(ok, count[nc], 0)
                ii = torch.repeat_interleave(i0, cnt)
                first = torch.repeat_interleave(start[nc], cnt)
                offs = torch.arange(ii.shape[0], device=dev) - \
                    torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
                jj = order[first + offs]
                d = points[jj] - points[ii]
                keep = (d * d).sum(1) < r2max
                if not with_self:
                    keep &= ii != jj
                out_i.append(ii[keep])
                out_j.append(jj[keep])
    return torch.cat(out_i), torch.cat(out_j)


def step(pos: torch.Tensor, vel: torch.Tensor, ph: dict,
         dtype=torch.float64):
    """One step of N particles: (pos, vel) [N, 2] -> (pos, vel) [N, 2] in
    ``dtype``. Particle i of the output is particle i of the input."""
    r = lambda x: x.to(dtype)
    pos, vel = r(pos), r(vel)
    dev = pos.device
    h, dt, m = ph["h"], ph["dt"], ph["mass"]
    # the walls at float32's half extents, as the upstream shader holds them
    half = r(torch.tensor(ph["size"], dtype=torch.float32, device=dev) * 0.5)
    pred = torch.maximum(torch.minimum(pos + vel * dt, half), -half)

    # density over every pair within h, self included (funcs.wgsl:157-203)
    i, j = pairs_within(pred, h, ph["size"], with_self=True)
    d = pred[j] - pred[i]
    r2 = (d * d).sum(1)
    w = (h * h - r2).clamp(min=0) ** 3
    acc = torch.zeros(pos.shape[0], dtype=dtype, device=dev).index_add_(
        0, i, w)
    rho = m * (4.0 / (math.pi * h ** 8)) * acc
    rho = rho.clamp(min=EPSILON).clamp(min=DENSITY_FLOOR)
    pres = ph["k"] * (rho - ph["rho0"])

    # pressure (spiky) and viscosity forces over pairs, self excluded
    # (compute.wgsl:160-299)
    other = i != j
    i, j, d, r2 = i[other], j[other], d[other], r2[other]
    dst = torch.sqrt(r2)
    safe = torch.where(dst == 0, torch.ones_like(dst), dst)
    spiky = -(h - dst) * (12.0 / (math.pi * h ** 4))
    fp = (spiky * (pres[i] + pres[j]) * 0.5 / rho[j] / safe)[:, None] * d
    kv = (-(r2 * safe) / (2.0 * h ** 3) + r2 / (h * h) + h / (2.0 * safe)
          - 1.0) * (15.0 / (2.0 * math.pi * h ** 3))
    fv = (kv / rho[j])[:, None] * (vel[j] - vel[i]) * ph["viscosity"]
    accel = torch.zeros_like(pos).index_add_(0, i, fp + fv)

    # integrate (compute.wgsl:95-155); no mouse, no obstacle
    g = r(torch.tensor(ph["gravity"], dtype=torch.float64, device=dev))
    vel = vel + accel / rho[:, None] * dt + g * dt
    vel = torch.where(torch.isnan(vel).any(1, keepdim=True),
                      torch.zeros_like(vel), vel)
    speed = torch.sqrt((vel * vel).sum(1, keepdim=True))
    vel = torch.where(speed > MAX_SPEED, vel / speed * MAX_SPEED, vel)
    pos = pos + vel * dt
    out = pos.abs() > half
    pos = torch.where(out, half * torch.sign(pos), pos)
    vel = torch.where(out, vel * -ph["damping"], vel)
    return pos, vel


def run(pos, vel, ph: dict, n_steps: int, dtype=torch.float64):
    """``n_steps`` steps from (pos, vel); the same particle order out."""
    for _ in range(n_steps):
        pos, vel = step(pos, vel, ph, dtype)
    return pos, vel
