"""The dense engine's two stencil kernels (port of
``tpufluid.ops.pallas.sph``): density and the pressure / viscosity forces
over a ``[Gy, K, Gxp]`` slot grid of ``ops.dense.build_grid_cols``.

Each wrapper dispatches on where its tensors lie. On the CPU it runs the
plain PyTorch version beside it (``density_plain``, ``forces_plain``). On a
CUDA device it launches the hand-written kernel from
``tpufluid_torch/csrc`` (``sph_density.cu``, ``sph_forces.cu``) and counts
the launch in ``_build.LAUNCHES``, or raises; it never falls back. The kernels
stage a tile of cells with all K slots in shared memory, so each takes K
up to a limit (``max_capacity``); above it the wrapper raises.

Both follow the semantics of the TPU kernels, not their layout: the three
rows y-1, y, y+1 of a target row are clamped to [0, Gy-1] (rows 0 and Gy-1
are the empty sentinel ring), columns wrap modulo Gxp, and the candidates
are summed in the order row, dx in (-1, 0, +1), slot kp ascending, each
added to the running sum on its own. Every f32 operation rounds on its own
(the kernels build with ``-fmad=false``); divisions and reciprocals are
the TPU kernels' (``1/dst`` and ``1/rho`` multiplied in), which is why
these are not ``ops.dense``'s passes at the ulp level. Every output slot
gets a value: density has no self mask, so an empty slot sums the
candidates around the world origin (its zero position). The kernels take
any grid whose valid slots form a prefix of each cell, as
``build_grid_cols`` makes them.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from . import prng
from .._build import launched, on_cuda, ptr, stream
from .fused import _check_grids
from .kernels import _f32, div
from .pairs import ORDINAL_SALT, PAIR_ORDER_SALT

PI = math.pi


def _rows3(a: torch.Tensor):
    """The row blocks y-1, y, y+1 of every target row y, clamped."""
    gy = a.shape[0]
    ys = torch.arange(gy, device=a.device)
    return [a.index_select(0, torch.clamp(ys + r, 0, gy - 1))
            for r in (-1, 0, 1)]


def _roll_x(a: torch.Tensor, dx: int) -> torch.Tensor:
    """nb[..., x] = a[..., x + dx], wrapping modulo the width."""
    return a if dx == 0 else torch.roll(a, -dx, dims=a.dim() - 1)


def _check_valid(valid: torch.Tensor, shape):
    if (valid.shape != shape or valid.dtype != torch.bool
            or not valid.is_contiguous()):
        raise ValueError(f"valid must be contiguous bool{list(shape)}, got "
                         f"{valid.dtype}{list(valid.shape)}")


def max_capacity(name: str) -> int:
    """The largest cell capacity K the kernel ``name`` ("sph_density",
    "sph_forces", or ``ops.dense``'s "dense_density", "dense_forces")
    takes: the largest whose 1 x 1 tile fits a block's shared memory
    (builds the kernels if needed). The dense pair shares its sph twin's
    tile, so its limit."""
    return getattr(_build.load(),
                   f"tf_sph_{name.split('_', 1)[1]}_max_k")()


def _above_limit(name: str, k: int) -> ValueError:
    return ValueError(f"{name}: cell_capacity {k} is above the largest the "
                      f"kernel stages in shared memory, {max_capacity(name)}")


def _tile(name: str, k: int):
    """(rows, columns) of the tile the kernel ``name`` runs at capacity
    ``k``; raises, naming the largest K it takes, if none fits."""
    packed = getattr(_build.load(), f"tf_{name}_tile")(k)
    if packed == 0:
        raise _above_limit(name, k)
    return packed >> 8, packed & 255


def check_capacity(name: str, err: int, k: int) -> None:
    """Where a launch of ``name`` at capacity ``k`` failed and ``k`` is
    above the largest K the kernel takes (the launcher finds no tile
    then), raise naming that K."""
    if err != 0 and k > max_capacity(name):
        raise _above_limit(name, k)


def density_tile(k: int):
    """(rows, columns) of ``csrc/sph_density.cu``'s tile at capacity
    ``k``."""
    return _tile("sph_density", k)


def forces_tile(k: int):
    """(rows, columns) of ``csrc/sph_forces.cu``'s tile at capacity
    ``k``."""
    return _tile("sph_forces", k)


# --------------------------------------------------------------- density

def _density_consts(h: float):
    return _f32(h * h), _f32(4.0 / (PI * h**8))


def density_plain(grid, mass, h: float):
    """Plain PyTorch version of :func:`density`."""
    h2, norm = _density_consts(float(h))
    k = grid.px.shape[1]
    acc = torch.zeros_like(grid.px)
    for nx_r, ny_r, nv_r in zip(_rows3(grid.px), _rows3(grid.py),
                                _rows3(grid.valid)):
        for dx in (-1, 0, 1):
            nx, ny, nv = (_roll_x(a, dx) for a in (nx_r, ny_r, nv_r))
            for kp in range(k):
                ddx = nx[:, kp:kp + 1] - grid.px
                ddy = ny[:, kp:kp + 1] - grid.py
                r2 = ddx * ddx + ddy * ddy
                diff = torch.clamp(h2 - r2, min=0.0)
                w = norm * (diff * diff * diff)
                acc = acc + torch.where(nv[:, kp:kp + 1], mass * w, 0.0)
    return acc


def density(grid, mass, h: float) -> torch.Tensor:
    """rho f32[Gy, K, Gxp] = sum of mass * poly6 over the 3x3 cell stencil,
    self included (funcs.wgsl:157-203), from a ``DenseGrid``. ``mass``: a
    0-d tensor on the grid's device (read there, no host sync)."""
    if not isinstance(mass, torch.Tensor):
        mass = torch.as_tensor(mass, dtype=torch.float32,
                               device=grid.px.device)
    if not on_cuda(grid.px, grid.py, grid.valid, mass):
        return density_plain(grid, mass, h)
    gy, k, gx = grid.px.shape
    _check_grids((gy, k, gx), grid.px, grid.py)
    _check_valid(grid.valid, grid.px.shape)
    dev = grid.px.device
    m = mass.to(torch.float32).reshape(1)
    out = torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
    h2, norm = _density_consts(float(h))
    err = _build.load().tf_sph_density(
        ptr(grid.px), ptr(grid.py), ptr(grid.valid), ptr(m), ptr(out),
        gy, k, gx, h2, norm, stream(dev))
    check_capacity("sph_density", err, k)
    launched("sph_density", err)
    return out


# ---------------------------------------------------------------- forces

def _forces_consts(h: float, sqr_radius: float, spiky_norm: float,
                   visc_norm: float):
    """The TPU kernel's static constants, each rounded to f32 once."""
    h2 = h * h
    h3 = h * h2
    return dict(h=_f32(h), h2=_f32(h2), sqr_radius=_f32(sqr_radius),
                spiky_norm=_f32(spiky_norm), visc_norm=_f32(visc_norm),
                c_r3=_f32(-1.0 / (2.0 * h3)), c_r2=_f32(1.0 / h2),
                c_half_h=_f32(h / 2.0),
                st_grad_norm=_f32(-24.0 / (PI * h**8)),
                st_lap_norm=_f32(8.0 / (PI * h**8)), c_3h2=_f32(3.0 * h2))


def _unit(s1: torch.Tensor):
    """The unit direction (x, y) of the draws s1 and s2 = xorshift(s1):
    (u01(s1), u01(s2)) over its length."""
    s2 = prng.xorshift32(s1)
    rx = prng.u32_to_uniform01(s1)
    ry = prng.u32_to_uniform01(s2)
    rn = torch.sqrt(rx * rx + ry * ry)
    rn = torch.where(rn == 0.0, 1.0, rn)
    return rx / rn, ry / rn


def _tabled(tie: dict, i: int, salted, has_prior: torch.Tensor):
    """Component i of the tie-break direction for a pair-order salt (a
    bool, or a bool tensor per target) and whether the target drew
    before."""
    def pick(salt):
        return torch.where(has_prior, tie[(salt, 1)][i], tie[(salt, 0)][i])
    if isinstance(salted, bool):
        return pick(int(salted))
    return torch.where(salted, pick(1), pick(0))


def _scalars(params) -> torch.Tensor:
    """f32[6] = (pressure_constant, rest_density, mu, mass,
    st_threshold, st_coefficient), on the params' device."""
    return torch.stack([
        params.pressure_constant, params.rest_density,
        params.viscosity_coefficient, params.mass,
        params.surface_tension_threshold,
        params.surface_tension_coefficient]).to(torch.float32)


def forces_plain(grid, dens_g, params, h: float, sqr_radius: float,
                 spiky_norm: float, visc_norm: float, frame,
                 surface_tension: bool = False,
                 adaptive_subsampling: bool = False):
    """Plain PyTorch version of :func:`forces`."""
    c = _forces_consts(float(h), float(sqr_radius), float(spiky_norm),
                       float(visc_norm))
    hf, h2, sq = c["h"], c["h2"], c["sqr_radius"]
    k_pressure, rest_density, mu, mass, st_thr, st_coef = _scalars(params)
    dev = grid.px.device
    k = grid.px.shape[1]
    px0, py0, vx0, vy0, d0 = grid.px, grid.py, grid.vx, grid.vy, dens_g
    v0_live = grid.valid
    frame = torch.as_tensor(frame, device=dev).to(torch.int64)

    p_self = k_pressure * (d0 - rest_density)
    seed_self = (prng.position_seed(torch.stack([px0, py0], dim=-1))
                 + frame * 69) & prng.U32
    k_self = torch.arange(k, device=dev)[None, :, None]
    # the tie-break direction for each (pair-order salt, draw ordinal)
    tie = {}
    for s_salt in (0, 1):
        for c_ord in (0, 1):
            eff = (seed_self + c_ord * ORDINAL_SALT
                   + s_salt * PAIR_ORDER_SALT) & prng.U32
            tie[(s_salt, c_ord)] = _unit(prng.xorshift32(eff))

    zero = torch.zeros_like(px0)
    fx, fy, gx_, gy_ = zero, zero, zero, zero
    coinc_count = torch.zeros(px0.shape, dtype=torch.int64, device=dev)
    if surface_tension:
        st_i = torch.clamp(px0, min=0.0).to(torch.int32).to(torch.int64)
        st_seed = (st_i * 324 + frame * 5632) & prng.U32
        st_dx, st_dy = _unit(prng.xorshift32(st_seed))
        cgx, cgy, clap = zero, zero, zero
    if adaptive_subsampling:
        stride = torch.where(d0 >= 200.0, 13,
                             torch.where(d0 >= 150.0, 5, 1))

    rows = zip(*(_rows3(a) for a in (grid.px, grid.py, grid.vx, grid.vy,
                                      grid.valid, dens_g)))
    for row, fields in enumerate(rows):
        for dx in (-1, 0, 1):
            nx, ny, nvx, nvy, nv, nd = (_roll_x(a, dx) for a in fields)
            is_center = row == 1 and dx == 0
            before = row == 0 or (row == 1 and dx == -1)
            for kp in range(k):
                sl = slice(kp, kp + 1)
                ddx = nx[:, sl] - px0
                ddy = ny[:, sl] - py0
                r2 = ddx * ddx + ddy * ddy
                dst = torch.sqrt(r2)
                ok = nv[:, sl] & v0_live
                if is_center:
                    ok = ok & (k_self != kp)
                in_range = ok & (r2 <= sq)
                safe = torch.where(dst == 0.0, 1.0, dst)
                inv_dst = div(1.0, safe)
                dirx = ddx * inv_dst
                diry = ddy * inv_dst

                # coincident pairs take the tabled direction of their
                # pair-order salt and draw ordinal
                coincident = in_range & (dst == 0.0)
                has_prior = coinc_count >= 1
                salted = (kp < k_self) if is_center else before
                dirx = torch.where(coincident,
                                   _tabled(tie, 0, salted, has_prior), dirx)
                diry = torch.where(coincident,
                                   _tabled(tie, 1, salted, has_prior), diry)
                coinc_count = coinc_count + coincident

                ndk = nd[:, sl]
                p_nb = k_pressure * (ndk - rest_density)
                shared_p = (p_self + p_nb) * 0.5
                kern_p = torch.where(dst <= hf,
                                     -(hf - dst) * c["spiky_norm"], 0.0)
                inv_rho = div(1.0, torch.where(ndk == 0.0, 1.0, ndk))
                in_range_p = in_range
                if adaptive_subsampling:
                    in_range_p = in_range & (kp % stride == 0)
                wp = torch.where(in_range_p, kern_p * shared_p * inv_rho, 0.0)
                fx = fx + dirx * wp
                fy = fy + diry * wp

                # the viscosity kernel, division-free (sph.py:303-307)
                kv = c["visc_norm"] * (r2 * safe * c["c_r3"] + r2 * c["c_r2"]
                                       + inv_dst * c["c_half_h"] - 1.0)
                kv = torch.where(dst == 0.0, c["visc_norm"], kv)
                kv = torch.where(dst <= hf, kv, 0.0)
                wv = torch.where(in_range, kv * inv_rho, 0.0)
                gx_ = gx_ + (nvx[:, sl] - vx0) * wv
                gy_ = gy_ + (nvy[:, sl] - vy0) * wv

                if surface_tension:
                    # self pair INCLUDED (pairs.color_field_* contract)
                    ok_st = nv[:, sl] & v0_live & (r2 <= sq)
                    co_st = ok_st & (dst == 0.0)
                    sdx = torch.where(co_st, st_dx, dirx)
                    sdy = torch.where(co_st, st_dy, diry)
                    rlen2 = sdx * sdx + sdy * sdy
                    rlen = torch.sqrt(rlen2)
                    gdiff = h2 - rlen2
                    gsc = torch.where((rlen >= hf) | (rlen == 0.0), 0.0,
                                      c["st_grad_norm"] * gdiff * gdiff)
                    m_rho = mass * inv_rho
                    cgx = cgx + torch.where(ok_st, m_rho * gsc * sdx, 0.0)
                    cgy = cgy + torch.where(ok_st, m_rho * gsc * sdy, 0.0)
                    lap = torch.where(dst > hf, 0.0,
                                      c["st_lap_norm"] * (h2 - r2)
                                      * (c["c_3h2"] - 4.0 * r2))
                    clap = clap + torch.where(ok_st, m_rho * lap, 0.0)

    if surface_tension:
        # pairs.surface_tension composition (compute.wgsl:303-315)
        n_len = torch.sqrt(cgx * cgx + cgy * cgy)
        safe_len = torch.where(n_len == 0.0, 1.0, n_len)
        k_st = (-clap) / (n_len + 1e-6)
        apply_st = n_len > st_thr
        fx = fx + torch.where(apply_st, -st_coef * k_st * (cgx / safe_len),
                              0.0)
        fy = fy + torch.where(apply_st, -st_coef * k_st * (cgy / safe_len),
                              0.0)
    return fx, fy, gx_ * mu, gy_ * mu


def forces(grid, dens_g, params, h: float, sqr_radius: float,
           spiky_norm: float, visc_norm: float, frame,
           surface_tension: bool = False,
           adaptive_subsampling: bool = False):
    """(fx, fy, gx, gy) f32[Gy, K, Gxp]: the symmetrised pressure force f
    and the viscosity force g (times mu) over the 3x3 cell stencil
    (compute.wgsl:160-299), from a ``DenseGrid`` and its floored density.
    ``frame`` (a tensor) seeds the coincident-pair tie-break. Flags:
    ``surface_tension`` folds the colour-field force into f;
    ``adaptive_subsampling`` strides each cell's pressure candidates by
    1/5/13 as the target's density crosses 150/200."""
    if not on_cuda(grid.px, grid.py, grid.vx, grid.vy, grid.valid, dens_g,
                   params.mass):
        return forces_plain(grid, dens_g, params, h, sqr_radius, spiky_norm,
                            visc_norm, frame, surface_tension,
                            adaptive_subsampling)
    gy, k, gx = grid.px.shape
    _check_grids((gy, k, gx), grid.px, grid.py, grid.vx, grid.vy, dens_g)
    _check_valid(grid.valid, grid.px.shape)
    dev = grid.px.device
    sc = _scalars(params)
    fr = torch.as_tensor(frame, device=dev).to(torch.int64).reshape(1)
    outs = [torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
            for _ in range(4)]
    c = _forces_consts(float(h), float(sqr_radius), float(spiky_norm),
                       float(visc_norm))
    err = _build.load().tf_sph_forces(
        ptr(grid.px), ptr(grid.py), ptr(grid.vx), ptr(grid.vy),
        ptr(grid.valid), ptr(dens_g), ptr(sc), ptr(fr),
        *(ptr(o) for o in outs), gy, k, gx,
        int(surface_tension), int(adaptive_subsampling),
        c["h"], c["h2"], c["sqr_radius"], c["spiky_norm"], c["visc_norm"],
        c["c_r3"], c["c_r2"], c["c_half_h"], c["st_grad_norm"],
        c["st_lap_norm"], c["c_3h2"], stream(dev))
    check_capacity("sph_forces", err, k)
    launched("sph_forces", err)
    return tuple(outs)
