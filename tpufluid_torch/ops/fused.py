"""The resident engine's three kernels: rebin, density, forces + integrate.

Port of ``tpufluid.ops.pallas.fused`` (``rebin``, ``density``,
``forces_integrate`` with the base flags and the obstacle ``has_ff``). Each function keeps the JAX
signature and layout: slot grids f32[Gy, K, Gxp] (empty slots hold
``pos = SENTINEL``), ``occ_row`` i32[Gy] = the per-row max packed
occupancy. Arrivals fill slots 0..count-1 of a cell, so every slot at or
beyond ``occ_row[y]`` in row y is empty; the kernels bound their loops by
it, as the TPU kernels do.

Each wrapper dispatches on where its tensors lie. On the CPU it runs the
plain PyTorch version beside it (``rebin_plain``, ...). On a CUDA device it
launches the hand-written kernel from ``tpufluid_torch/csrc`` and counts
the launch in ``LAUNCHES``, or raises; it never falls back.

Plain versions and kernels share one reduction order, which is also the
TPU kernels': candidates by slot (ascending, below ``occ3``), and for each
candidate the nine (row, dx) blocks summed into a partial that is then
added to the running total. Every f32 operation rounds on its own (the
kernels build with ``-fmad=false``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _build
from ..params import EPSILON, SimSettings
from . import prng

PI = math.pi
# Empty grid slots hold this position; anything beyond SENTINEL_HALF is
# "not a particle". Real positions are bounded by the world half-extent.
SENTINEL = 1.0e9
SENTINEL_HALF = 5.0e8
MAX_SPEED = 500.0  # compute.wgsl:118-122

# kernel launches per wrapper (CUDA tensors only); forces_integrate_has_ff
# counts the forces_integrate launches that took the obstacle epilogue
LAUNCHES = {"rebin": 0, "density": 0, "forces_integrate": 0,
            "forces_integrate_has_ff": 0}


def _f32(x: float) -> float:
    """A Python float rounded to f32: how the JAX kernels see constants."""
    return float(np.float32(x))


def occ3_of(occ_row: torch.Tensor) -> torch.Tensor:
    """occ3[y] = max(occ_row[y-1], occ_row[y], occ_row[y+1]), out-of-range
    rows empty."""
    occ = occ_row.reshape(-1)
    z = torch.zeros_like(occ[:1])
    lo = torch.cat([z, occ[:-1]])
    hi = torch.cat([occ[1:], z])
    return torch.maximum(torch.maximum(lo, occ), hi)


def _pred(p, v, dt, half):
    """Clamped predicted coordinate (compute.wgsl:8-30), product and sum
    rounded separately."""
    return torch.clamp(p + v * dt, -half, half)


def _pad(a: torch.Tensor, value) -> torch.Tensor:
    """[Gy, K, Gx] -> [Gy+2, K, Gx+2] with a ring of ``value``, so the
    (row, dx) neighbour block of target (y, x) is a plain slice."""
    return torch.nn.functional.pad(a, (1, 1, 0, 0, 1, 1), value=value)


def _block(a_pad: torch.Tensor, r: int, dx: int, gy: int, gx: int):
    """Neighbour block (source row y+r-1, column x+dx) of a padded grid."""
    return a_pad[r:r + gy, ..., 1 + dx:1 + dx + gx]


def _slot_bound(occ_row: torch.Tensor) -> torch.Tensor:
    """Padded per-row occupancy, shaped to broadcast against [Gy, Gx]."""
    return torch.nn.functional.pad(occ_row.to(torch.int64), (1, 1))[:, None]


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


# ----------------------------------------------------------------- checks

def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise NotImplementedError(f"no kernel for device {dev}")
    return True


def _check_grids(shape, *grids):
    for g in grids:
        if g.shape != shape or g.dtype != torch.float32 or not g.is_contiguous():
            raise ValueError(
                f"expected contiguous f32{list(shape)}, got "
                f"{g.dtype}{list(g.shape)} contiguous={g.is_contiguous()}")
    if shape[2] % 128 != 0:
        raise ValueError(f"grid width {shape[2]} is not a multiple of 128")


def _check_occ(occ_row: torch.Tensor, gy: int):
    if (occ_row.shape != (gy,) or occ_row.dtype != torch.int32
            or not occ_row.is_contiguous()):
        raise ValueError(f"occ_row must be contiguous i32[{gy}], got "
                         f"{occ_row.dtype}{list(occ_row.shape)}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launched(name: str, err: int, launches=LAUNCHES) -> None:
    """Raise on a nonzero CUDA error of a launch, else count it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_build.error_string(err)}")
    launches[name] += 1


# ----------------------------------------------------------------- rebin

def _rebin_consts(settings: SimSettings):
    return (_f32(1.0 / float(settings.smoothing_radius)),
            _f32(float(settings.size[0]) * 0.5),
            _f32(float(settings.size[1]) * 0.5),
            settings.grid_w - 2, settings.grid_h - 2)


def _live_slots(pos_x, occ_row):
    """Live slots: a particle, below its row's occupancy."""
    k = pos_x.shape[1]
    in_occ = (torch.arange(k, device=pos_x.device)[None, :, None]
              < occ_row.to(torch.int64)[:, None, None])
    return (pos_x < SENTINEL_HALF) & in_occ


def _cells(px, py, vx, vy, dt, settings: SimSettings):
    """Clamped predicted cell (x, y) of every slot, i64. Multiplies by
    1/h like the TPU rebin (the boundary conversion divides by h)."""
    h_inv, half_x, half_y, cx_max, cy_max = _rebin_consts(settings)
    prx = _pred(px, vx, dt, half_x)
    pry = _pred(py, vy, dt, half_y)
    ncx = torch.floor((prx + half_x) * h_inv).to(torch.int64) + 1
    ncy = torch.floor((pry + half_y) * h_inv).to(torch.int64) + 1
    return ncx.clamp(1, cx_max), ncy.clamp(1, cy_max)


def rebin_plain(pos_x, pos_y, vel_x, vel_y, occ_row, dt,
                settings: SimSettings):
    """Plain PyTorch version of :func:`rebin`: the same walk, vectorised
    over all targets (y, x) at once."""
    gy, k, gx = pos_x.shape
    dev = pos_x.device
    dt = _as_f32(dt, dev)
    live = pos_x < SENTINEL_HALF
    ncx, ncy = _cells(pos_x, pos_y, vel_x, vel_y, dt, settings)
    ty = torch.arange(gy, device=dev)[:, None]
    tx = torch.arange(gx, device=dev)[None, :]
    occ = occ_row.to(torch.int64)

    # far movers of each source row (target beyond the 3x3 neighbourhood)
    far = _live_slots(pos_x, occ_row) & (((ncy - ty[:, None]).abs() > 1)
                                         | ((ncx - tx[:, None]).abs() > 1))
    far_n = far.sum(dim=(1, 2)).to(torch.int32)

    src = [_pad(a, v) for a, v in ((pos_x, SENTINEL), (pos_y, SENTINEL),
                                   (vel_x, 0.0), (vel_y, 0.0))]
    live_p = _pad(live, False)
    ncx_p = _pad(ncx, 0)
    ncy_p = _pad(ncy, 0)
    occ_p = _slot_bound(occ)
    # one spare slot (index k) takes every non-arrival and every overflow
    out = [torch.full((gy, k + 1, gx), SENTINEL, dtype=torch.float32, device=dev),
           torch.full((gy, k + 1, gx), SENTINEL, dtype=torch.float32, device=dev),
           torch.zeros((gy, k + 1, gx), dtype=torch.float32, device=dev),
           torch.zeros((gy, k + 1, gx), dtype=torch.float32, device=dev)]
    count = torch.zeros((gy, gx), dtype=torch.int64, device=dev)
    n_src = min(int(occ.max()), k) if gy else 0
    for r in range(3):
        bound = occ_p[r:r + gy]
        for dx in (-1, 0, 1):
            blk = lambda a: _block(a, r, dx, gy, gx)
            lv, cx, cy = blk(live_p), blk(ncx_p), blk(ncy_p)
            vals = [blk(a) for a in src]
            for s in range(n_src):
                hit = (lv[:, s] & (cy[:, s] == ty) & (cx[:, s] == tx)
                       & (s < bound))
                dest = torch.where(hit & (count < k), count, k)[:, None]
                for f in range(4):
                    out[f].scatter_(1, dest, vals[f][:, s][:, None])
                count = count + hit
    occ_out = torch.clamp(count, max=k).amax(dim=1).to(torch.int32)
    over_n = torch.clamp(count - k, min=0).sum(dim=1).to(torch.int32)
    px, py, vx, vy = (o[:, :k].contiguous() for o in out)
    return px, py, vx, vy, occ_out, far_n, over_n


def rebin(pos_x, pos_y, vel_x, vel_y, occ_row, dt, settings: SimSettings):
    """Re-pack grid slots by next-step predicted cell.

    Returns (pos_x', pos_y', vel_x', vel_y', occ_row', far_n[Gy],
    over_n[Gy]). Arrivals pack in (source row, dx, slot) order. Far
    movers (beyond the 3x3 neighbourhood) are left out of the output and
    counted per source row in ``far_n``; arrivals beyond capacity are
    dropped and counted per target row in ``over_n``.
    """
    if not _on_cuda(pos_x, pos_y, vel_x, vel_y, occ_row):
        return rebin_plain(pos_x, pos_y, vel_x, vel_y, occ_row, dt, settings)
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y)
    _check_occ(occ_row, gy)
    dev = pos_x.device
    dt = _as_f32(dt, dev).reshape(1)
    outs = [torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
            for _ in range(4)]
    counts = torch.zeros((3, gy), dtype=torch.int32, device=dev)
    h_inv, half_x, half_y, cx_max, cy_max = _rebin_consts(settings)
    lib = _build.load()
    err = lib.tf_rebin(
        _ptr(pos_x), _ptr(pos_y), _ptr(vel_x), _ptr(vel_y), _ptr(occ_row),
        _ptr(dt), *(_ptr(o) for o in outs),
        _ptr(counts[0]), _ptr(counts[1]), _ptr(counts[2]),
        gy, k, gx, h_inv, half_x, half_y, cx_max, cy_max, _stream(dev))
    _launched("rebin", err)
    return (*outs, counts[0], counts[1], counts[2])


# --------------------------------------------------------------- density

def _density_consts(settings: SimSettings):
    h = float(settings.smoothing_radius)
    return (_f32(h * h), _f32(4.0 / (PI * h**8)),
            _f32(float(settings.size[0]) * 0.5),
            _f32(float(settings.size[1]) * 0.5))


def density_plain(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
                  pressure_constant, rest_density, settings: SimSettings):
    """Plain PyTorch version of :func:`density`."""
    gy, k, gx = pos_x.shape
    dev = pos_x.device
    mass, dt, kp_c, rho0 = (_as_f32(v, dev) for v in
                            (mass, dt, pressure_constant, rest_density))
    h2, norm, half_x, half_y = _density_consts(settings)
    live = pos_x < SENTINEL_HALF
    prx = _pred(pos_x, vel_x, dt, half_x)
    pry = _pred(pos_y, vel_y, dt, half_y)
    prx_p, pry_p = _pad(prx, SENTINEL), _pad(pry, SENTINEL)
    live_p = _pad(live, False)
    occ_p = _slot_bound(occ_row)
    acc = torch.zeros_like(pos_x)
    n3 = int(occ3_of(occ_row).max()) if gy else 0
    for kp in range(n3):
        part = torch.zeros_like(pos_x)
        for r in range(3):
            ok_row = (kp < occ_p[r:r + gy])[:, None]
            for dx in (-1, 0, 1):
                ok = _block(live_p, r, dx, gy, gx)[:, kp:kp + 1] & ok_row
                ddx = _block(prx_p, r, dx, gy, gx)[:, kp:kp + 1] - prx
                ddy = _block(pry_p, r, dx, gy, gx)[:, kp:kp + 1] - pry
                r2 = ddx * ddx + ddy * ddy
                diff = torch.clamp(h2 - r2, min=0.0)
                part = torch.where(ok, part + diff * diff * diff, part)
        acc = acc + part
    rho = mass * (norm * acc)
    rho = torch.clamp(torch.clamp(rho, min=EPSILON), min=0.1)
    act = _live_slots(pos_x, occ_row)
    pres = torch.where(act, kp_c * (rho - rho0), kp_c * (0.1 - rho0))
    invr = torch.where(act, torch.reciprocal(rho), 10.0)
    return pres, invr


def density(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
            pressure_constant, rest_density, settings: SimSettings):
    """(pres, inv_rho)[Gy, K, Gxp]: poly6 density over the 3x3 cell
    stencil of predicted positions (funcs.wgsl:157-203), then
    ``pres = k (rho - rho0)`` and ``1/rho`` after the EPSILON and 0.1
    floors. Empty slots get the floor-density defaults."""
    if not _on_cuda(pos_x, pos_y, vel_x, vel_y, occ_row):
        return density_plain(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
                             pressure_constant, rest_density, settings)
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y)
    _check_occ(occ_row, gy)
    dev = pos_x.device
    sc = torch.stack([_as_f32(v, dev).reshape(()) for v in
                      (mass, dt, pressure_constant, rest_density)])
    pres = torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
    invr = torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
    h2, norm, half_x, half_y = _density_consts(settings)
    lib = _build.load()
    err = lib.tf_density(
        _ptr(pos_x), _ptr(pos_y), _ptr(vel_x), _ptr(vel_y), _ptr(occ_row),
        _ptr(sc), _ptr(pres), _ptr(invr), gy, k, gx,
        h2, norm, half_x, half_y, _stream(dev))
    _launched("density", err)
    return pres, invr


# ----------------------------------------------- forces + integration

def _forces_consts(settings: SimSettings):
    h = float(settings.smoothing_radius)
    h2 = h * h
    h3 = h * h2
    norms = settings.kernel_norms()
    return dict(
        h=_f32(h), sqr_radius=_f32(settings.sqr_radius),
        c_spiky=_f32(0.5 * norms.spiky_derivative),
        visc_norm=_f32(norms.viscosity),
        c_r3=_f32(-1.0 / (2.0 * h3)), c_r2=_f32(1.0 / h2),
        c_inv=_f32(h / 2.0),
        half_x=_f32(float(settings.size[0]) * 0.5),
        half_y=_f32(float(settings.size[1]) * 0.5),
        # obstacle push: pixel -> world scale, (bounds * 2) / texture size
        ff_sx=_f32(2.0 * settings.size[0] / settings.texture_size[0]),
        ff_sy=_f32(2.0 * settings.size[1] / settings.texture_size[1]),
    )


def _check_variant(x_boundary, surface_tension, adaptive_subsampling):
    for on, flag in ((x_boundary != "bounce", "wrap_x"),
                     (surface_tension, "surface_tension"),
                     (adaptive_subsampling, "adaptive")):
        if on:
            raise NotImplementedError(
                f"forces_integrate {flag} is not ported yet: ROADMAP.md "
                f"queue 2")


def _tie_directions(prx, pry, frame):
    """Per-target base direction for coincident pairs
    (compute.wgsl:211-215): two xorshift32 draws seeded from the bits of
    the predicted position and the frame, normalised with rsqrt."""
    seed = prng.position_seed(torch.stack([prx, pry], dim=-1))
    seed = (seed + prng.u32(frame) * 69) & prng.U32
    s1 = prng.xorshift32(seed)
    s2 = prng.xorshift32(s1)
    rx = prng.u32_to_uniform01(s1)
    ry = prng.u32_to_uniform01(s2)
    inv = torch.rsqrt(torch.clamp(rx * rx + ry * ry, min=1e-30))
    return rx * inv, ry * inv


def _check_ff(ff_cells, gy: int, gx: int):
    for f in ff_cells:
        if (f.shape != (gy, gx) or f.dtype != torch.float32
                or not f.is_contiguous()):
            raise ValueError(f"ff_cells must be contiguous f32[{gy}, {gx}], "
                             f"got {f.dtype}{list(f.shape)}")


def forces_integrate_plain(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row,
                           params, settings: SimSettings, frame,
                           ff_cells=None):
    """Plain PyTorch version of :func:`forces_integrate` (base flags and
    ``has_ff``)."""
    gy, k, gx = pos_x.shape
    dev = pos_x.device
    c = _forces_consts(settings)
    h, sqr_radius, c_sp = c["h"], c["sqr_radius"], c["c_spiky"]
    c_r3, c_r2, c_inv = c["c_r3"], c["c_r2"], c["c_inv"]
    dt = params.delta
    half_x, half_y = c["half_x"], c["half_y"]
    live = pos_x < SENTINEL_HALF
    prx = _pred(pos_x, vel_x, dt, half_x)
    pry = _pred(pos_y, vel_y, dt, half_y)
    d0x, d0y = _tie_directions(prx, pry, torch.as_tensor(frame, device=dev))

    cand = dict(px=_pad(prx, SENTINEL), py=_pad(pry, SENTINEL),
                vx=_pad(vel_x, 0.0), vy=_pad(vel_y, 0.0),
                p=_pad(pres, 0.0), ir=_pad(invr, 0.0))
    live_p = _pad(live, False)
    occ_p = _slot_bound(occ_row)
    k_self = torch.arange(k, device=dev)[None, :, None]
    zero = torch.zeros_like(pos_x)
    sfx, sfy, sgx, sgy = zero, zero, zero, zero
    scc = torch.zeros(pos_x.shape, dtype=torch.int64, device=dev)
    n3 = int(occ3_of(occ_row).max()) if gy else 0
    for kp in range(n3):
        fx, fy, gx_, gy_ = zero, zero, zero, zero
        for r in range(3):
            ok_row = (kp < occ_p[r:r + gy])[:, None]
            for dx in (-1, 0, 1):
                nb = {n: _block(a, r, dx, gy, gx)[:, kp:kp + 1]
                      for n, a in cand.items()}
                ok = _block(live_p, r, dx, gy, gx)[:, kp:kp + 1] & ok_row
                ddx = nb["px"] - prx
                ddy = nb["py"] - pry
                r2 = ddx * ddx + ddy * ddy
                inv_dst = torch.rsqrt(torch.clamp(r2, min=1e-35))
                dst = r2 * inv_dst
                if (r, dx) != (1, 0):
                    # off-centre: the kernel-value clamps are the range gates
                    kern_p = torch.clamp(dst - h, max=0.0) * c_sp
                    wp = kern_p * (pres + nb["p"]) * nb["ir"]
                    s = wp * inv_dst
                    kv = torch.clamp(r2 * dst * c_r3 + r2 * c_r2
                                     + inv_dst * c_inv - 1.0, min=0.0)
                    wv = kv * nb["ir"]
                    fx = torch.where(ok, fx + ddx * s, fx)
                    fy = torch.where(ok, fy + ddy * s, fy)
                    gx_ = torch.where(ok, gx_ + (nb["vx"] - vel_x) * wv, gx_)
                    gy_ = torch.where(ok, gy_ + (nb["vy"] - vel_y) * wv, gy_)
                    continue
                # centre block: explicit range test, self excluded, and the
                # tie-break direction for coincident pairs
                in_range = ok & (r2 <= sqr_radius) & (k_self != kp)
                dirx = ddx * inv_dst
                diry = ddy * inv_dst
                coincident = in_range & (dst == 0.0)
                has_prior = scc >= 1
                salted = kp < k_self
                tx = torch.where(salted, torch.where(has_prior, d0y, -d0x),
                                 torch.where(has_prior, -d0y, d0x))
                ty = torch.where(salted, torch.where(has_prior, -d0x, -d0y),
                                 torch.where(has_prior, d0x, d0y))
                dirx = torch.where(coincident, tx, dirx)
                diry = torch.where(coincident, ty, diry)
                scc = scc + coincident
                kern_p = (dst - h) * c_sp
                wp = torch.where(in_range, kern_p * (pres + nb["p"]) * nb["ir"],
                                 0.0)
                fx = fx + dirx * wp
                fy = fy + diry * wp
                kv = r2 * dst * c_r3 + r2 * c_r2 + inv_dst * c_inv - 1.0
                kv = torch.where(dst == 0.0, 1.0, kv)
                wv = torch.where(in_range, kv * nb["ir"], 0.0)
                gx_ = gx_ + (nb["vx"] - vel_x) * wv
                gy_ = gy_ + (nb["vy"] - vel_y) * wv
        sfx, sfy = sfx + fx, sfy + fy
        sgx, sgy = sgx + gx_, sgy + gy_

    # integration (compute.wgsl:95-155)
    f32 = torch.float32
    mu = params.viscosity_coefficient
    visc_mu = c["visc_norm"] * mu
    grav = params.gravity.reshape(2)
    accel_x = sfx + sgx * visc_mu
    accel_y = sfy + sgy * visc_mu
    vx = vel_x + accel_x * invr * dt + grav[0] * dt
    vy = vel_y + accel_y * invr * dt + grav[1] * dt

    # mouse impulse (compute.wgsl:99-108); dist 0 under a press is the
    # reference's 0/0 = NaN, which the NaN reset below zeroes
    mouse = params.mouse_pos.reshape(2)
    mstate = params.mouse_state.to(f32)
    diffx = mouse[0] - prx
    diffy = mouse[1] - pry
    dist = torch.sqrt(diffx * diffx + diffy * diffy)
    msafe = torch.where(dist == 0.0, 1.0, dist)
    iscale = (params.mouse_force_power * mstate
              * (dist / params.mouse_force_radius) / (msafe * msafe))
    iscale = torch.where(dist == 0.0, float("nan"), iscale)
    apply_m = (mstate != 0.0) & (dist <= params.mouse_force_radius)
    vx = torch.where(apply_m, vx + diffx * iscale, vx)
    vy = torch.where(apply_m, vy + diffy * iscale, vy)

    nan_any = torch.isnan(vx) | torch.isnan(vy)
    vx = torch.where(nan_any, 0.0, vx)
    vy = torch.where(nan_any, 0.0, vy)

    sp = torch.sqrt(vx * vx + vy * vy)
    fast = sp > MAX_SPEED
    # a tensor numerator: scalar / tensor is reciprocal-then-multiply in
    # torch, which rounds twice
    scl = torch.full_like(sp, MAX_SPEED) / torch.where(fast, sp, 1.0)
    vx = torch.where(fast, vx * scl, vx)
    vy = torch.where(fast, vy * scl, vy)

    px = pos_x + vx * dt
    py = pos_y + vy * dt
    damping = params.damping_factor
    if ff_cells is not None:
        # obstacle push-out per target cell (fused.py:1000-1023): the
        # field is in pixels; the normal is normalised in pixel space, the
        # push scaled to world units per axis, the normal velocity
        # reflected with (1 - damping)
        ffx, ffy = (f[:, None, :] for f in ff_cells)
        hit = (ffx != 0.0) | (ffy != 0.0)
        fn = torch.sqrt(ffx * ffx + ffy * ffy)
        fsafe = torch.where(fn == 0.0, 1.0, fn)
        nhx = ffx / fsafe
        nhy = ffy / fsafe
        px = torch.where(hit, px + ffx * c["ff_sx"], px)
        py = torch.where(hit, py + ffy * c["ff_sy"], py)
        vn = vx * nhx + vy * nhy
        refl = 1.0 - damping
        vx = torch.where(hit, vx - refl * vn * nhx, vx)
        vy = torch.where(hit, vy - refl * vn * nhy, vy)
    outx = torch.abs(px) > half_x
    outy = torch.abs(py) > half_y
    px = torch.where(outx, half_x * torch.sign(px), px)
    vx = torch.where(outx, vx * -damping, vx)
    py = torch.where(outy, half_y * torch.sign(py), py)
    vy = torch.where(outy, vy * -damping, vy)

    act = _live_slots(pos_x, occ_row)
    return (torch.where(act, px, SENTINEL), torch.where(act, py, SENTINEL),
            torch.where(act, vx, 0.0), torch.where(act, vy, 0.0))


def forces_integrate(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row,
                     params, settings: SimSettings, frame, ff_cells=None,
                     x_boundary="bounce", surface_tension: bool = False,
                     adaptive_subsampling: bool = False):
    """Symmetrised spiky pressure and viscosity over the 3x3 stencil,
    fused with the full integration (gravity, mouse impulse, NaN reset,
    speed clamp, bounce). Returns (pos_x', pos_y', vel_x', vel_y').
    ``frame`` seeds the coincident-pair tie-break. ``ff_cells``: optional
    (ffx, ffy) f32[Gy, Gxp] pixel-space obstacle push-out per target cell
    (``resident.forcefield_cells``). The base flags and ``has_ff`` are
    ported; the other variants raise ``NotImplementedError``."""
    _check_variant(x_boundary, surface_tension, adaptive_subsampling)
    ffs = () if ff_cells is None else tuple(ff_cells)
    if not _on_cuda(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row, *ffs):
        return forces_integrate_plain(pos_x, pos_y, vel_x, vel_y, pres, invr,
                                      occ_row, params, settings, frame,
                                      ff_cells)
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y, pres, invr)
    _check_occ(occ_row, gy)
    if ffs:
        _check_ff(ffs, gy, gx)
    dev = pos_x.device
    f32 = torch.float32
    sc = torch.cat([
        params.delta.reshape(1), params.viscosity_coefficient.reshape(1),
        params.gravity.reshape(2), params.damping_factor.reshape(1),
        params.mouse_pos.reshape(2), params.mouse_force_radius.reshape(1),
        params.mouse_force_power.reshape(1),
        params.mouse_state.reshape(1).to(f32)]).to(dev)
    fr = torch.as_tensor(frame, dtype=torch.int64, device=dev).reshape(1)
    outs = [torch.empty((gy, k, gx), dtype=f32, device=dev) for _ in range(4)]
    c = _forces_consts(settings)
    lib = _build.load()
    err = lib.tf_forces(
        _ptr(pos_x), _ptr(pos_y), _ptr(vel_x), _ptr(vel_y), _ptr(pres),
        _ptr(invr), _ptr(occ_row), _ptr(sc), _ptr(fr),
        *([_ptr(f) for f in ffs] if ffs else [None, None]),
        *(_ptr(o) for o in outs), gy, k, gx,
        c["h"], c["sqr_radius"], c["c_spiky"], c["visc_norm"],
        c["c_r3"], c["c_r2"], c["c_inv"], c["half_x"], c["half_y"],
        c["ff_sx"], c["ff_sy"], _stream(dev))
    _launched("forces_integrate", err)
    if ffs:
        LAUNCHES["forces_integrate_has_ff"] += 1
    return tuple(outs)
