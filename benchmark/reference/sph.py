"""Plain SPH step of the upstream project, particle by particle.

The step of ``rookieCookies/gpu-fluid-simulation`` (src/simulation.rs:502-538,
shaders/compute.wgsl, shaders/funcs.wgsl) with the scene's physics and no
obstacle, mouse or variant: predict, find every pair within h of the
predicted positions, poly6 density, linear pressure, spiky pressure force
and viscosity, integrate, clamp the speed, bounce off the walls. Written
from the equations alone: no slot grid, no cell capacity, no packing
order; neighbours come from a cell list built here. Computed in float64 by
default; ``dtype`` lowers it (the bf16 control rounds every intermediate).

Where it rounds or departs from plain float64 equations, and why:

* The predicted positions are float32, in the upstream's order
  (``predict``: position + velocity * dt, then the clamp to the walls):
  the upstream's predict kernel stores them in a float32 buffer that the
  density and force kernels read (compute.wgsl:8-30), so every float32
  program sees them so. Computed in float64 instead, a pair a few float32
  ulps apart sees another distance, and the viscosity kernel's h / (2 r)
  term, singular as r -> 0, amplifies that at an impact past any limit.
* The walls test the new position as the upstream's integrate kernel
  writes it to its float32 position buffer (position + velocity * dt,
  compute.wgsl:95-155); the position itself stays in ``dtype``. Tested in
  float64, a particle sliding along a wall, or landing within a float32
  rounding of it, bounces on one side and not on the other: a velocity
  gap of 1.1 times its speed into the wall.
  Nothing else is rounded; a ``dtype`` narrower than float32 computes both
  in ``dtype``.
* Coincident predicted pairs (r = 0) take the upstream's special cases:
  the viscosity kernel is its norm (funcs.wgsl:112-123), and the pressure
  pushes the pair apart along a drawn unit direction (compute.wgsl:
  211-215). The direction follows the resident engine's rule, that of
  ``tpufluid_torch``'s ``csrc/resident_math.cuh`` and of the JAX
  package's Pallas kernels: a base direction d0 from the xorshift32 chain
  seeded by the float32 predicted position's bits and the frame (tick + 1)
  times 69 (in place of the upstream's post-sort index, an accident of
  its buffer layout), turned by a four-entry table of whether the partner
  comes earlier in the engine's visit order and whether it is the
  target's first coincident partner. The visit order is ``visit``'s
  (``resident_visit`` derives it from a resident state's slots); without
  one, the particles' own order. The dense engine draws its directions
  another way (tpufluid_torch/ops/dense.py); its cells hold no coincident
  predicted pair.

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


_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 of uint32 values held in int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def _xorshift32(x: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (funcs.wgsl:129-149) on uint32 values in int64."""
    x = x ^ ((x << 13) & _U32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & _U32)


def predict(pos: torch.Tensor, vel: torch.Tensor, ph: dict,
            dtype=torch.float32) -> torch.Tensor:
    """[N, 2] in ``dtype``: the predicted positions as the upstream's
    predict kernel stores them: position + velocity * dt, each operation
    rounded, clamped to the walls at float32's half extents."""
    half = (torch.tensor(ph["size"], dtype=torch.float32, device=pos.device)
            * 0.5).to(dtype)
    q = pos.to(dtype) + vel.to(dtype) * ph["dt"]
    return torch.maximum(torch.minimum(q, half), -half)


def _base_direction(pred32: torch.Tensor, frame: int) -> torch.Tensor:
    """f64[M, 2]: the unit direction d0 each predicted point (f32[M, 2])
    draws at ``frame``: the xorshift32 chain seeded by the point's bits
    (x * 0x9E3779B1 ^ y * 0x85EBCA6B) plus frame * 69, its first two draws
    as floats in [0, 1), normalised."""
    bits = pred32.contiguous().view(torch.int32).to(torch.int64) & _U32
    seed = _mul32(bits[:, 0], 0x9E3779B1) ^ _mul32(bits[:, 1], 0x85EBCA6B)
    seed = (seed + _mul32(torch.full_like(seed, int(frame) & _U32), 69)) \
        & _U32
    s1 = _xorshift32(seed)
    s2 = _xorshift32(s1)
    u = torch.stack([s1, s2], 1).to(torch.float32) / 4294967296.0
    u = u.to(torch.float64)
    return u / torch.sqrt((u * u).sum(1, keepdim=True)).clamp(min=1e-15)


def resident_visit(slots: torch.Tensor, pred32: torch.Tensor, ph: dict):
    """i64[N]: the order in which the resident engine's forces kernel visits
    the particles of one predicted cell, from each particle's slot
    (y, k, x) [N, 3] in the state before the step and its predicted
    position (f32[N, 2]). The rebin walks a cell's 3 x 3 source cells in
    (row, column, slot) order; a far mover, whose predicted cell lies
    beyond its slot's 3 x 3, comes after them, in (row, slot, column)
    order of its slot. Cells are the upstream's: h wide, one sentinel ring
    (src/simulation.rs:140), interior cells 1 .. ceil(size / h)."""
    dev = pred32.device
    half = torch.tensor(ph["size"], dtype=torch.float32, device=dev) * 0.5
    h_inv = torch.tensor(1.0 / ph["h"], dtype=torch.float32, device=dev)
    cmax = torch.tensor([math.ceil(s / ph["h"]) for s in ph["size"]],
                        device=dev)
    cell = torch.floor((pred32 + half) * h_inv).to(torch.int64) + 1
    cell = torch.minimum(cell.clamp(min=1), cmax)  # (x, y)
    y, k, x = slots.to(dev).unbind(1)
    far = ((cell[:, 1] - y).abs() > 1) | ((cell[:, 0] - x).abs() > 1)
    big = int(slots.max()) + 1 if slots.numel() else 1
    near_key = (y * big + x) * big + k
    far_key = (y * big + k) * big + x
    return torch.where(far, far_key + big ** 3, near_key)


def _coincident_directions(i, j, pred32, visit, frame):
    """f64[P, 2]: the direction of each coincident pair (i, j) (target i,
    partner j), in the resident engine's four-entry table over d0: a
    partner earlier in the visit order ("salted") or not, the target's
    first coincident partner in that order or a later one."""
    n = pred32.shape[0]
    members = torch.unique(torch.cat([i, j]))
    if visit is None:
        visit = torch.arange(n, device=i.device)
    # each member's rank in its point's group, by the visit order
    _, group = torch.unique(pred32[members], dim=0, return_inverse=True)
    order = torch.argsort(visit[members], stable=True)
    order = order[torch.argsort(group[order], stable=True)]
    g = group[order]
    rank = torch.zeros(n, dtype=torch.int64, device=i.device)
    rank[members[order]] = (torch.arange(len(order), device=i.device)
                            - torch.searchsorted(g, g))
    ri, rj = rank[i], rank[j]
    salted = rj < ri
    first = rj == torch.where(ri == 0, 1, 0)
    d0 = _base_direction(pred32[i], frame)
    perp = torch.stack([-d0[:, 1], d0[:, 0]], 1)
    return torch.where(first[:, None], torch.where(salted[:, None], -d0, d0),
                       torch.where(salted[:, None], -perp, perp))


def step(pos: torch.Tensor, vel: torch.Tensor, ph: dict,
         dtype=torch.float64, tick: int = 0, visit=None):
    """One step of N particles: (pos, vel) [N, 2] -> (pos, vel) [N, 2] in
    ``dtype``. Particle i of the output is particle i of the input.
    ``tick``: the state's tick before the step (the step is frame
    tick + 1); ``visit``: i64[N], the engine's visit order of the
    particles of one predicted point (default: their order here)."""
    r = lambda x: x.to(dtype)
    dev = pos.device
    h, dt, m = ph["h"], ph["dt"], ph["mass"]
    # the upstream's float32 position buffers, or dtype where narrower
    buf = dtype if torch.finfo(dtype).bits < 32 else torch.float32
    pos_buf = pos.to(buf)
    pred_buf = predict(pos, vel, ph, buf)
    pos, vel = r(pos), r(vel)
    # the walls at float32's half extents, as the upstream shader holds them
    half = r(torch.tensor(ph["size"], dtype=torch.float32, device=dev) * 0.5)
    pred = r(pred_buf)

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
    zero = dst == 0
    safe = torch.where(zero, torch.ones_like(dst), dst)
    spiky = -(h - dst) * (12.0 / (math.pi * h ** 4))
    fp = (spiky * (pres[i] + pres[j]) * 0.5 / rho[j] / safe)[:, None] * d
    norm = 15.0 / (2.0 * math.pi * h ** 3)
    kv = (-(r2 * safe) / (2.0 * h ** 3) + r2 / (h * h) + h / (2.0 * safe)
          - 1.0) * norm
    if bool(zero.any()):  # coincident pairs: the upstream's special cases
        ci, cj = i[zero], j[zero]
        dirs = r(_coincident_directions(ci, cj, pred_buf.float(), visit,
                                        tick + 1))
        fp[zero] = (spiky[zero] * (pres[ci] + pres[cj]) * 0.5
                    / rho[cj])[:, None] * dirs
        kv = torch.where(zero, torch.full_like(kv, norm), kv)
    fv = (kv / rho[j])[:, None] * (vel[j] - vel[i]) * ph["viscosity"]
    accel = torch.zeros_like(pos).index_add_(0, i, fp + fv)

    # integrate (compute.wgsl:95-155); no mouse, no obstacle
    g = r(torch.tensor(ph["gravity"], dtype=torch.float64, device=dev))
    vel = vel + accel / rho[:, None] * dt + g * dt
    vel = torch.where(torch.isnan(vel).any(1, keepdim=True),
                      torch.zeros_like(vel), vel)
    speed = torch.sqrt((vel * vel).sum(1, keepdim=True))
    vel = torch.where(speed > MAX_SPEED, vel / speed * MAX_SPEED, vel)
    moved = pos + vel * dt
    # the walls take what lies outside them in the upstream's float32
    # position buffer
    out = (pos_buf + vel.to(buf) * dt).abs() > half.to(buf)
    pos = torch.where(out, half * torch.sign(moved), moved)
    vel = torch.where(out, vel * -ph["damping"], vel)
    return pos, vel


def run(pos, vel, ph: dict, n_steps: int, dtype=torch.float64):
    """``n_steps`` steps from (pos, vel) at tick 0; the same particle order
    out."""
    for t in range(n_steps):
        pos, vel = step(pos, vel, ph, dtype, t)
    return pos, vel
