"""Dense cell-grid neighbour passes (port of ``tpufluid.ops.dense``).

Particles sorted by cell are scattered into a ``[Gy, K, Gxp]`` slot grid
(K = cell_capacity, Gxp = grid width padded to a multiple of 128), slot =
the particle's rank within its cell, so each cell's particles fill a prefix
of its K slots. Scatters go into a buffer one element longer than the grid:
particles beyond capacity all land on that spare slot, which is sliced off,
so every kept index is unique and the result is deterministic.

The stencil passes (``density_pass``, ``force_pass``) are the XLA roll
formulation of the JAX package: each of the nine (dy, dx) neighbour blocks
is the whole grid rolled, and each candidate slot kp is a [Gy, 1, Gxp]
slice broadcast against the [Gy, K, Gxp] targets. Rolls wrap through the
empty sentinel ring and pad columns. They are the CPU path and the
reference. ``density`` and ``forces`` dispatch on where the grid lies: on
the CPU they run the passes; on a CUDA device they launch the hand-written
kernels ``dense_density`` (``csrc/sph_density.cu``) and ``dense_forces``
(``csrc/sph_forces.cu``), bitwise the passes over the whole grid, counted
in ``_build.LAUNCHES``, or raise; they never fall back. Those are the pallas
engine's tile kernels with the roll's semantics: rows wrap, and each pair
term rounds as the passes round it. Each stages a tile of cells with all K
slots in shared memory, so takes K up to ``ops.sph.max_capacity``.
``dense_forces_cols(pallas=True)`` runs the two passes as the kernels of
``ops.sph`` instead (the TPU kernels' rounding). Particles beyond capacity
keep their state but leave the neighbour sums for the step, and read back
the density floor and zero force.

The slot grid's build and read-back around the passes dispatch the same
way: ``build`` and ``readback`` launch ``dense_build`` and
``dense_readback`` (``csrc/dense_glue.cu``) on a CUDA device, bitwise
their plain versions ``build_grid_cols`` and ``readback_cols``, which run
on the CPU. ``dense_forces_cols`` takes the plain versions wherever it is
given ``passes``, so a step on plain passes stays plain end to end.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..params import SimSettings
from . import kernels, sph
from .._build import launched, on_cuda, ptr, stream
from .fused import _check_grids
from .prng import U32, position_seed, rand_unit_vector
from .pairs import ORDINAL_SALT, PAIR_ORDER_SALT


class DenseGrid(NamedTuple):
    flat: torch.Tensor       # i64[N] slot of each sorted particle (=size -> dropped)
    px: torch.Tensor         # f32[Gy, K, Gxp]
    py: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    valid: torch.Tensor      # bool[Gy, K, Gxp]
    n_dropped: torch.Tensor  # i32 particles beyond cell capacity


def ranks(sorted_cells: torch.Tensor) -> torch.Tensor:
    """Rank of each particle within its cell run, from ascending
    ``sorted_cells``: its index less the index of the run's first entry,
    found by a binary search of each key (one launch, no scan)."""
    iota = torch.arange(sorted_cells.shape[0], dtype=torch.int64,
                        device=sorted_cells.device)
    return iota - torch.searchsorted(sorted_cells, sorted_cells, side="left")


def build_grid_cols(pxs, pys, vxs, vys, sorted_cells: torch.Tensor,
                    settings: SimSettings, dims=None) -> DenseGrid:
    """Scatter cell-sorted columns into the slot grid. ``dims``: optional
    (rows, grid_w) override of (grid_h, grid_w)."""
    k = settings.cell_capacity
    gy, gx = dims if dims is not None else (settings.grid_h, settings.grid_w)
    gx_pad = -(-gx // 128) * 128
    rank = ranks(sorted_cells)
    keep = rank < k
    cells = sorted_cells.to(torch.int64)
    cy = cells // gx
    cx = cells % gx
    size = gy * k * gx_pad
    # a cell past the last row (the slab step's id for a slot outside the
    # slab) lands on the spare slot too, as JAX's scatter drops it
    flat = torch.clamp(torch.where(keep, (cy * k + rank) * gx_pad + cx,
                                   size), max=size)
    shape = (gy, k, gx_pad)
    dev = sorted_cells.device

    def scat(vals, dtype=torch.float32):
        buf = torch.zeros(size + 1, dtype=dtype, device=dev)
        buf.index_put_((flat,), vals.to(dtype))
        return buf[:size].reshape(shape)

    return DenseGrid(
        flat=flat,
        px=scat(pxs), py=scat(pys), vx=scat(vxs), vy=scat(vys),
        valid=scat(torch.ones_like(keep), torch.bool),
        n_dropped=(~keep).sum().to(torch.int32),
    )


def build_grid(pred_s, vel_s, sorted_cells, settings: SimSettings,
               dims=None) -> DenseGrid:
    """``build_grid_cols`` from [N, 2] predicted positions and velocities."""
    return build_grid_cols(pred_s[:, 0], pred_s[:, 1], vel_s[:, 0],
                           vel_s[:, 1], sorted_cells, settings, dims=dims)


def build(pxs, pys, vxs, vys, sorted_cells: torch.Tensor,
          settings: SimSettings, dims=None) -> DenseGrid:
    """``build_grid_cols``: on a CUDA device the kernel ``dense_build``,
    bitwise it. The columns are f32 [N] at any stride, ``sorted_cells``
    contiguous i32 or i64 in ascending order. The four grids are views of
    one [4, Gy, K, Gxp] buffer, ``valid`` and ``n_dropped`` of one byte
    buffer behind it (``csrc/dense_glue.cu`` zeroes it with one memset)."""
    cols = (pxs, pys, vxs, vys)
    if not on_cuda(*cols, sorted_cells):
        return build_grid_cols(*cols, sorted_cells, settings, dims=dims)
    n = sorted_cells.shape[0]
    if (sorted_cells.dtype not in (torch.int32, torch.int64)
            or sorted_cells.dim() != 1 or not sorted_cells.is_contiguous()):
        raise ValueError(f"sorted_cells must be contiguous i32 or i64 [N], "
                         f"got {sorted_cells.dtype}"
                         f"{list(sorted_cells.shape)}")
    for c in cols:
        if c.dtype != torch.float32 or c.shape != (n,):
            raise ValueError(f"columns must be f32[{n}], got "
                             f"{c.dtype}{list(c.shape)}")
    k = settings.cell_capacity
    gy, gx = dims if dims is not None else (settings.grid_h, settings.grid_w)
    gx_pad = -(-gx // 128) * 128
    size = gy * k * gx_pad
    dev = sorted_cells.device
    flat = torch.empty(n, dtype=torch.int64, device=dev)
    # csrc/dense_glue.cu's layout: f32[4][size], u8[size] valid, i32 count
    buf = torch.empty(17 * size + 4, dtype=torch.uint8, device=dev)
    err = _build.load().tf_dense_build(
        *(ptr(c) for c in cols), *(c.stride(0) for c in cols),
        ptr(sorted_cells), sorted_cells.element_size(), n, gy, k, gx,
        gx_pad, ptr(flat), ptr(buf), stream(dev))
    launched("dense_build", err)
    shape = (gy, k, gx_pad)
    grids = buf[:16 * size].view(torch.float32).view(4, *shape)
    return DenseGrid(
        flat=flat, px=grids[0], py=grids[1], vx=grids[2], vy=grids[3],
        valid=buf[16 * size:17 * size].view(torch.bool).view(shape),
        n_dropped=buf[17 * size:].view(torch.int32).view(()))


def readback_cols(flat: torch.Tensor, fields):
    """Each sorted particle's values of the five slot-grid ``fields``
    (density, fx, fy, gx, gy) at its slot ``flat``, as five [N] columns; a
    particle beyond capacity (slot = size) reads (0.1, 0, 0, 0, 0)."""
    stack = torch.stack([a.reshape(-1) for a in fields], dim=1)
    fill = torch.zeros((1, 5), dtype=torch.float32, device=stack.device)
    fill[:, 0] = 0.1  # what a particle beyond capacity reads back
    stack = torch.cat([stack, fill])
    out = stack[torch.clamp(flat, max=stack.shape[0] - 1)]
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4]


def readback(flat: torch.Tensor, fields):
    """``readback_cols``: on a CUDA device the kernel ``dense_readback``,
    bitwise it; the columns are the rows of one [5, N] buffer."""
    if not on_cuda(flat, *fields):
        return readback_cols(flat, fields)
    _check_grids(fields[0].shape, *fields)
    if (flat.dtype != torch.int64 or flat.dim() != 1
            or not flat.is_contiguous()):
        raise ValueError(f"flat must be contiguous i64 [N], got "
                         f"{flat.dtype}{list(flat.shape)}")
    n = flat.shape[0]
    out = torch.empty((5, n), dtype=torch.float32, device=flat.device)
    err = _build.load().tf_dense_readback(
        ptr(flat), n, fields[0].numel(), *(ptr(a) for a in fields),
        ptr(out), stream(flat.device))
    launched("dense_readback", err)
    return tuple(out)


_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _roll(a, dy: int, dx: int):
    """nb[y, :, x] = a[y + dy, :, x + dx], wrapping."""
    return torch.roll(a, (-dy, -dx), dims=(0, 2))


def density_pass(grid: DenseGrid, mass, h: float):
    """rho[Gy, K, Gxp]: m * poly6 summed over the 3x3 stencil, self
    included (funcs.wgsl:157-203); every slot gets a value."""
    k = grid.px.shape[1]
    dens = torch.zeros_like(grid.px)
    for dy, dx in _OFFSETS:
        nx = _roll(grid.px, dy, dx)
        ny = _roll(grid.py, dy, dx)
        nv = _roll(grid.valid, dy, dx)
        for kp in range(k):
            ddx = nx[:, kp:kp + 1] - grid.px
            ddy = ny[:, kp:kp + 1] - grid.py
            w = kernels.poly6(h, ddx * ddx + ddy * ddy)
            dens = dens + torch.where(nv[:, kp:kp + 1], mass * w, 0.0)
    return dens


def force_pass(grid: DenseGrid, dens_g, params, h: float, sqr_radius: float,
               spiky_norm: float, visc_norm: float, frame,
               surface_tension: bool = False,
               adaptive_subsampling: bool = False):
    """(fx, fy, gx, gy)[Gy, K, Gxp]: the pressure force f and the viscosity
    force g (compute.wgsl:160-299), with the tie-break contract of
    ``ops.pairs.pressure_force``.

    * ``surface_tension``: the colour-field force (self pair included, as
      ``pairs.surface_tension``) folded into (fx, fy).
    * ``adaptive_subsampling``: pressure candidates strided by 1/5/13 as
      the target's density crosses 150/200; the slot index is the rank in
      the cell run, so the stride is ``kp % inc == 0``
      (shaders/compute.wgsl:170-174,195).
    """
    k = grid.px.shape[1]
    dev = grid.px.device
    sq = kernels._f32(sqr_radius)
    p_self = kernels.pressure_eos(dens_g, params.pressure_constant,
                                  params.rest_density)
    frame = frame.to(torch.int64)
    seed_self = (position_seed(torch.stack([grid.px, grid.py], dim=-1))
                 + frame * 69) & U32
    k_self = torch.arange(k, device=dev)[None, :, None]
    zero = torch.zeros_like(grid.px)
    fx, fy, gx_, gy_ = zero, zero, zero, zero
    coinc_count = torch.zeros(grid.px.shape, dtype=torch.int64, device=dev)
    if adaptive_subsampling:
        inc = (1 + torch.where(dens_g >= 150.0, 4, 0)
               + torch.where(dens_g >= 200.0, 8, 0))
    if surface_tension:
        # seed per compute.wgsl:406 (WGSL u32(f32) saturates negatives to 0)
        st_i = torch.clamp(grid.px, min=0.0).to(torch.int32).to(torch.int64)
        st_dir = rand_unit_vector((st_i * 324 + frame * 5632) & U32)
        cgx, cgy, clap = zero, zero, zero
    mass = params.mass

    for dy, dx in _OFFSETS:
        nx, ny, nvx, nvy, nv, ndens = (
            _roll(a, dy, dx) for a in (grid.px, grid.py, grid.vx, grid.vy,
                                       grid.valid, dens_g))
        np_nb = kernels.pressure_eos(ndens, params.pressure_constant,
                                     params.rest_density)
        is_center = dy == 0 and dx == 0
        before = dy < 0 or (dy == 0 and dx < 0)
        for kp in range(k):
            sl = slice(kp, kp + 1)
            ddx = nx[:, sl] - grid.px
            ddy = ny[:, sl] - grid.py
            r2 = ddx * ddx + ddy * ddy
            dst = torch.sqrt(r2)
            ok = nv[:, sl] & grid.valid
            if is_center:
                ok = ok & (k_self != kp)
            in_range = ok & (r2 <= sq)
            safe = torch.where(dst == 0.0, 1.0, dst)
            dirx = ddx / safe
            diry = ddy / safe

            coincident = in_range & (dst == 0.0)
            eff_seed = seed_self + torch.clamp(coinc_count, max=1) * ORDINAL_SALT
            if is_center:
                eff_seed = eff_seed + torch.where(kp < k_self,
                                                  PAIR_ORDER_SALT, 0)
            elif before:
                eff_seed = eff_seed + PAIR_ORDER_SALT
            rdir = rand_unit_vector(eff_seed & U32)
            dirx = torch.where(coincident, rdir[..., 0], dirx)
            diry = torch.where(coincident, rdir[..., 1], diry)
            coinc_count = coinc_count + coincident

            ndk = ndens[:, sl]
            shared_p = (p_self + np_nb[:, sl]) * 0.5
            kern_p = kernels.spiky_derivative(h, dst, spiky_norm)
            safe_rho = torch.where(ndk == 0.0, 1.0, ndk)
            scale_p = kern_p * shared_p / safe_rho
            in_range_p = in_range
            if adaptive_subsampling:
                in_range_p = in_range & (kp % inc == 0)
            fx = fx + torch.where(in_range_p, dirx * scale_p, 0.0)
            fy = fy + torch.where(in_range_p, diry * scale_p, 0.0)

            scale_v = kernels.viscosity(h, dst, visc_norm) / safe_rho
            gx_ = gx_ + torch.where(in_range, (nvx[:, sl] - grid.vx) * scale_v,
                                    0.0)
            gy_ = gy_ + torch.where(in_range, (nvy[:, sl] - grid.vy) * scale_v,
                                    0.0)

            if surface_tension:
                # self pair INCLUDED (pairs.color_field_* contract)
                ok_st = nv[:, sl] & grid.valid & (r2 <= sq)
                co_st = ok_st & (dst == 0.0)
                sdx = torch.where(co_st, st_dir[..., 0], dirx)
                sdy = torch.where(co_st, st_dir[..., 1], diry)
                gxs, gys = kernels.poly6_gradient(h, sdx, sdy)
                m_rho = mass / safe_rho
                cgx = cgx + torch.where(ok_st, m_rho * gxs, 0.0)
                cgy = cgy + torch.where(ok_st, m_rho * gys, 0.0)
                lap = kernels.poly6_laplacian(h, dst)
                clap = clap + torch.where(ok_st, m_rho * lap, 0.0)

    if surface_tension:
        # pairs.surface_tension composition (compute.wgsl:303-315)
        n_len = torch.sqrt(cgx * cgx + cgy * cgy)
        safe_len = torch.where(n_len == 0.0, 1.0, n_len)
        k_st = (-clap) / (n_len + 1e-6)
        coef = params.surface_tension_coefficient
        apply_st = n_len > params.surface_tension_threshold
        fx = fx + torch.where(apply_st, -coef * k_st * (cgx / safe_len), 0.0)
        fy = fy + torch.where(apply_st, -coef * k_st * (cgy / safe_len), 0.0)

    mu = params.viscosity_coefficient
    return fx, fy, gx_ * mu, gy_ * mu


def density(grid: DenseGrid, mass, h: float) -> torch.Tensor:
    """``density_pass``: on a CUDA device the kernel ``dense_density``,
    bitwise the pass over the whole grid. ``mass``: a 0-d tensor on the
    grid's device (read there, no host sync)."""
    if not isinstance(mass, torch.Tensor):
        mass = torch.as_tensor(mass, dtype=torch.float32,
                               device=grid.px.device)
    if not on_cuda(grid.px, grid.py, grid.valid, mass):
        return density_pass(grid, mass, h)
    gy, k, gx = grid.px.shape
    _check_grids((gy, k, gx), grid.px, grid.py)
    sph._check_valid(grid.valid, grid.px.shape)
    out = torch.empty((gy, k, gx), dtype=torch.float32, device=grid.px.device)
    hf = kernels._f32(float(h))
    norm = kernels._f32(4.0 / (kernels.PI * hf**8))  # as kernels.poly6
    err = _build.load().tf_dense_density(
        ptr(grid.px), ptr(grid.py), ptr(grid.valid),
        ptr(mass.to(torch.float32).reshape(1)), ptr(out), gy, k, gx,
        kernels._h2(hf), norm, stream(grid.px.device))
    sph.check_capacity("dense_density", err, k)
    launched("dense_density", err)
    return out


def forces(grid: DenseGrid, dens_g, params, h: float, sqr_radius: float,
           spiky_norm: float, visc_norm: float, frame,
           surface_tension: bool = False,
           adaptive_subsampling: bool = False):
    """``force_pass``: on a CUDA device the kernel ``dense_forces``,
    bitwise the pass over the whole grid."""
    if not on_cuda(grid.px, grid.py, grid.vx, grid.vy, grid.valid, dens_g,
                   params.mass):
        return force_pass(grid, dens_g, params, h, sqr_radius, spiky_norm,
                          visc_norm, frame, surface_tension,
                          adaptive_subsampling)
    gy, k, gx = grid.px.shape
    _check_grids((gy, k, gx), grid.px, grid.py, grid.vx, grid.vy, dens_g)
    sph._check_valid(grid.valid, grid.px.shape)
    dev = grid.px.device
    fr = torch.as_tensor(frame, device=dev).to(torch.int64).reshape(1)
    outs = [torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
            for _ in range(4)]
    # each constant rounded to f32 once, as ops.kernels rounds it
    f32 = kernels._f32
    hf, h2 = f32(float(h)), kernels._h2(float(h))
    pi_h8 = kernels.PI * hf**8
    err = _build.load().tf_dense_forces(
        ptr(grid.px), ptr(grid.py), ptr(grid.vx), ptr(grid.vy),
        ptr(grid.valid), ptr(dens_g), ptr(sph._scalars(params)), ptr(fr),
        *(ptr(o) for o in outs), gy, k, gx,
        int(surface_tension), int(adaptive_subsampling),
        hf, h2, f32(sqr_radius), f32(spiky_norm), f32(visc_norm),
        f32(2.0 * hf**3), f32(-24.0 / pi_h8), f32(8.0 / pi_h8),
        f32(3.0 * h2), stream(dev))
    sph.check_capacity("dense_forces", err, k)
    launched("dense_forces", err)
    return tuple(outs)


def dense_neighbor_forces(pred_s, vel_s, sorted_cells, settings: SimSettings,
                          params, norms, frame, pallas: bool = False,
                          dims=None, **variant_kw):
    """The dense pipeline on [N, 2] sorted arrays: (density [N],
    pressure force [N, 2], viscosity force [N, 2], n_dropped)."""
    d, fpx, fpy, fvx, fvy, nd = dense_forces_cols(
        pred_s[:, 0], pred_s[:, 1], vel_s[:, 0], vel_s[:, 1], sorted_cells,
        settings, params, norms, frame, pallas=pallas, dims=dims,
        **variant_kw)
    return d, torch.stack([fpx, fpy], -1), torch.stack([fvx, fvy], -1), nd


def dense_forces_cols(pxs, pys, vxs, vys, sorted_cells,
                      settings: SimSettings, params, norms, frame,
                      pallas: bool = False, dims=None,
                      surface_tension: bool = False,
                      adaptive_subsampling: bool = False, passes=None):
    """The dense pipeline on sorted columns: build the slot grid, density
    (floored at 0.1, which covers the reference's EPSILON floor before it),
    forces, and read each particle's values back from its slot. The two
    passes are ``density`` and ``forces`` (the CUDA kernels on a CUDA
    device); ``pallas=True`` runs them through ``ops.sph`` instead. The
    build and read-back are ``build`` and ``readback``: on a CUDA device
    the kernels ``dense_build`` and ``dense_readback``, on the CPU
    ``build_grid_cols`` and ``readback_cols``. ``passes``, a (density,
    forces) pair of the same signatures, replaces the two passes and runs
    with the plain build and read-back on any device. Returns (density,
    f_pressure_x, f_pressure_y, f_visc_x, f_visc_y, n_dropped), each [N]."""
    if passes is None:
        passes = ((sph.density, sph.forces) if pallas
                  else (density, forces))
        build_fn, readback_fn = build, readback
    else:
        build_fn, readback_fn = build_grid_cols, readback_cols
    density_fn, forces_fn = passes
    h = float(settings.smoothing_radius)
    grid = build_fn(pxs, pys, vxs, vys, sorted_cells, settings, dims=dims)
    dens_g = torch.clamp(density_fn(grid, params.mass, h), min=0.1)
    args = (grid, dens_g, params, h, settings.sqr_radius,
            norms.spiky_derivative, norms.viscosity, frame)
    flags = dict(surface_tension=surface_tension,
                 adaptive_subsampling=adaptive_subsampling)
    fields = (dens_g, *forces_fn(*args, **flags))
    return (*readback_fn(grid.flat, fields), grid.n_dropped)
