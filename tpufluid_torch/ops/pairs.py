"""Pair-level SPH physics over a candidate axis (port of
``tpufluid.ops.pairs``).

Each reduction takes self fields of shape [...] and candidate fields of
shape [..., K] (K: a fixed 3x3-cell window of the sorted array, or all N
particles for the all-pairs oracle) plus a validity mask, and sums over K.
Every masked candidate contributes exactly +0.0, so the windowed and the
all-pairs reductions compute the same sums up to the order the sum takes.

Physics of compute.wgsl: density (funcs.wgsl:157-203), pressure force
(compute.wgsl:160-235), viscosity force (compute.wgsl:238-299) and the
optional colour-field surface tension (compute.wgsl:303-498).
"""

from __future__ import annotations

import torch

from . import kernels
from .kernels import _f32, div
from .prng import U32, rand_unit_vector

# seed salts of the coincident-pair tie-break (see pressure_force)
ORDINAL_SALT = 2654435761
PAIR_ORDER_SALT = 0x27220A95


def _pair_geometry(point, nb_pos, valid, sqr_radius: float):
    """offset [..., K, 2], r2, dst and the in-range mask [..., K]."""
    offset = nb_pos - point[..., None, :]
    ox, oy = offset[..., 0], offset[..., 1]
    r2 = ox * ox + oy * oy
    in_range = valid & (r2 <= _f32(sqr_radius))
    return offset, r2, torch.sqrt(r2), in_range


def density(point, nb_pos, valid, mass, h: float):
    """Sum of m * poly6(h, r^2) over the candidates, self included, no
    cutoff (poly6 vanishes beyond h; funcs.wgsl:157-203)."""
    offset = nb_pos - point[..., None, :]
    ox, oy = offset[..., 0], offset[..., 1]
    w = kernels.poly6(h, ox * ox + oy * oy)
    return torch.where(valid, mass * w, 0.0).sum(dim=-1)


def pressure_force(self_idx, point, self_density, nb_idx, nb_pos,
                   nb_density, valid, pressure_constant, rest_density,
                   h: float, sqr_radius: float, spiky_norm: float,
                   rand_seed):
    """Symmetrised pressure force (compute.wgsl:160-235): dir * spiky'(r)
    * (p_i + p_j)/2 / rho_j, summed. ``rand_seed``: the per-particle uint32
    tie-break seed (held in int64).

    Exactly coincident pairs take a random unit direction. The seed is a
    position hash (``prng.position_seed``) plus the frame salt; a pair
    whose candidate sorts before the particle adds ``PAIR_ORDER_SALT``, so
    both members separate; and the draw ordinal (the coincident pairs seen
    before this one along the candidate axis) is clamped at 1 and salted
    by ``ORDINAL_SALT``, so a third particle stacked on the same point
    reuses the second one's direction.
    """
    offset, r2, dst, in_range = _pair_geometry(point, nb_pos, valid,
                                               sqr_radius)
    active = in_range & (nb_idx != self_idx[..., None])
    safe_dst = torch.where(dst == 0.0, 1.0, dst)
    dir_to_nb = offset / safe_dst[..., None]

    coincident = active & (dst == 0.0)
    flat = coincident.reshape(coincident.shape[:point.dim() - 1] + (-1,))
    flat = flat.to(torch.int64)
    order = torch.clamp(torch.cumsum(flat, dim=-1) - flat, max=1)
    order = order.reshape(coincident.shape)
    eff_seed = (rand_seed[..., None] + order * ORDINAL_SALT
                + torch.where(nb_idx < self_idx[..., None],
                              PAIR_ORDER_SALT, 0)) & U32
    rand_dir = rand_unit_vector(eff_seed)
    dir_to_nb = torch.where(coincident[..., None], rand_dir, dir_to_nb)

    p_self = kernels.pressure_eos(self_density, pressure_constant,
                                  rest_density)
    p_nb = kernels.pressure_eos(nb_density, pressure_constant, rest_density)
    shared = (p_self[..., None] + p_nb) * 0.5
    kern = kernels.spiky_derivative(h, dst, spiky_norm)
    safe_rho = torch.where(nb_density == 0.0, 1.0, nb_density)
    contrib = dir_to_nb * (kern * shared / safe_rho)[..., None]
    return torch.where(active[..., None], contrib, 0.0).sum(dim=-2)


def viscosity_force(self_idx, point, self_velocity, nb_idx, nb_pos,
                    nb_velocity, nb_density, valid, viscosity_coefficient,
                    h: float, sqr_radius: float, visc_norm: float):
    """(v_j - v_i) / rho_j * W_visc, summed, times mu
    (compute.wgsl:238-299)."""
    _, _, dst, in_range = _pair_geometry(point, nb_pos, valid, sqr_radius)
    active = in_range & (nb_idx != self_idx[..., None])
    kern = kernels.viscosity(h, dst, visc_norm)
    safe_rho = torch.where(nb_density == 0.0, 1.0, nb_density)
    dv = nb_velocity - self_velocity[..., None, :]
    contrib = dv * (kern / safe_rho)[..., None]
    total = torch.where(active[..., None], contrib, 0.0).sum(dim=-2)
    return total * viscosity_coefficient


def color_field_gradient(point, nb_pos, nb_density, valid, mass, h: float,
                         sqr_radius: float, rand_seed):
    """Sum of m / rho_j * poly6_grad(h, dir) (compute.wgsl:405-498). The
    reference hands the gradient the NORMALISED direction (|r| = 1), a
    quirk kept here; a coincident pair takes one random direction per
    particle."""
    offset, _, dst, in_range = _pair_geometry(point, nb_pos, valid,
                                              sqr_radius)
    safe_dst = torch.where(dst == 0.0, 1.0, dst)
    dir_to_nb = offset / safe_dst[..., None]
    coincident = in_range & (dst == 0.0)
    rand_dir = rand_unit_vector(rand_seed[..., None])
    dir_to_nb = torch.where(coincident[..., None], rand_dir, dir_to_nb)
    gx, gy = kernels.poly6_gradient(h, dir_to_nb[..., 0], dir_to_nb[..., 1])
    safe_rho = torch.where(nb_density == 0.0, 1.0, nb_density)
    m_rho = mass / safe_rho
    contrib = torch.stack([gx * m_rho, gy * m_rho], dim=-1)
    return torch.where(in_range[..., None], contrib, 0.0).sum(dim=-2)


def color_field_laplacian(point, nb_pos, nb_density, valid, mass, h: float,
                          sqr_radius: float):
    """Sum of m / rho_j * poly6_laplacian(h, r) (compute.wgsl:319-401)."""
    _, _, dst, in_range = _pair_geometry(point, nb_pos, valid, sqr_radius)
    kern = kernels.poly6_laplacian(h, dst)
    safe_rho = torch.where(nb_density == 0.0, 1.0, nb_density)
    contrib = mass / safe_rho * kern
    return torch.where(in_range, contrib, 0.0).sum(dim=-1)


def surface_tension(point, nb_pos, nb_density, valid, mass, h: float,
                    sqr_radius: float, threshold, coefficient, rand_seed):
    """Colour-field surface tension (compute.wgsl:303-315)."""
    n = color_field_gradient(point, nb_pos, nb_density, valid, mass, h,
                             sqr_radius, rand_seed)
    nx, ny = n[..., 0], n[..., 1]
    n_len = torch.sqrt(nx * nx + ny * ny)
    lap = color_field_laplacian(point, nb_pos, nb_density, valid, mass, h,
                                sqr_radius)
    safe_len = torch.where(n_len == 0.0, 1.0, n_len)
    k = div(-lap, n_len + 1e-6)
    f = (-coefficient * k)[..., None] * (n / safe_len[..., None])
    return torch.where((n_len > threshold)[..., None], f, 0.0)
