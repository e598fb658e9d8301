"""Plain metaball frame of the offline render mode, from particles.

The fluid surface of the upstream fragment shader (shaders/
fluid_shader.wgsl:28-103): a Gaussian density field exp(-r^2 / tau),
tau = h^2 / 2, summed over the particles, and a speed-weighted field
beside it; the program evaluates both on a world lattice of ``sup``
samples per cell per axis, the first sample half a step inside the
sentinel cell at -half - h, and resamples the lattice bilinearly to the
camera's pixel centres. This file computes the same lattice fields by
summing every particle within 3.25 h of a sample (the program reaches at
least 3 cells; a particle beyond adds under 1.5e-8), resamples them
bilinearly and shades them with the shader's colormap, in float64 by
default. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

SUPERSAMPLE = 2
REACH = 3.25  # in units of h


def _lattice(size, h, sup):
    """(step, offsets (x, y), counts (x, y)): the sample lattice."""
    step = h / sup
    off = (size[0] * 0.5 + h, size[1] * 0.5 + h)
    n = tuple(int(math.ceil((s + 2 * h) / step)) + 2 for s in size)
    return step, off, n


def lattice_fields(pos, speed, size, h, sup=SUPERSAMPLE,
                   dtype=torch.float64, block=1 << 16):
    """(density, velocity factor) [ny, nx] on the sample lattice."""
    dev = pos.device
    step, off, (nx, ny) = _lattice(size, h, sup)
    pos, speed = pos.to(dtype), speed.to(dtype)
    neg_inv_tau = -1.0 / (h * h * 0.5)
    reach = int(math.ceil(REACH * h / step))
    offs = torch.arange(-reach, reach + 1, device=dev)
    dens = torch.zeros(ny * nx, dtype=dtype, device=dev)
    velf = torch.zeros_like(dens)
    for lo in range(0, pos.shape[0], block):
        p = pos[lo:lo + block]
        ci = torch.floor((p[:, 0] + off[0]) / step - 0.5).long()
        cj = torch.floor((p[:, 1] + off[1]) / step - 0.5).long()
        ii = ci[:, None, None] + offs[None, None, :]  # [B, 1, S]
        jj = cj[:, None, None] + offs[None, :, None]  # [B, S, 1]
        xs = (ii.to(dtype) + 0.5) * step - off[0]
        ys = (jj.to(dtype) + 0.5) * step - off[1]
        dx = xs - p[:, 0, None, None]
        dy = ys - p[:, 1, None, None]
        c = torch.exp((dx * dx + dy * dy) * neg_inv_tau)
        ok = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny)
        c = torch.where(ok, c, torch.zeros_like(c))
        flat = (jj.clamp(0, ny - 1) * nx + ii.clamp(0, nx - 1)).expand_as(c)
        dens.index_add_(0, flat.reshape(-1), c.reshape(-1))
        velf.index_add_(0, flat.reshape(-1),
                        (c * speed[lo:lo + block, None, None]).reshape(-1))
    return dens.reshape(ny, nx), velf.reshape(ny, nx)


def _resample_axis(field, coords, off, step, dim):
    """Bilinear along ``dim`` of ``field`` at world ``coords``; zero
    outside the lattice."""
    n = field.shape[dim]
    u = (coords + off) / step - 0.5
    i0 = torch.floor(u)
    w = u - i0
    i0 = i0.long()
    inb = (u >= 0) & (u <= n - 1)
    a = field.index_select(dim, i0.clamp(0, n - 1))
    b = field.index_select(dim, (i0 + 1).clamp(0, n - 1))
    shape = [1, 1]
    shape[dim] = -1
    w = w.reshape(shape)
    inb = inb.reshape(shape)
    return torch.where(inb, a * (1 - w) + b * w, torch.zeros_like(a))


def _smoothstep(e0, e1, x):
    t = ((x - e0) / (e1 - e0)).clamp(0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def shade(dens, velf):
    """fluid_shader.wgsl's colormap: rgba [H, W, 4] in [0, 1]."""
    v = (torch.log1p(5.0 * velf * 0.01) / math.log(6.0)).clamp(0.0, 1.0)
    interior = _smoothstep(0.5, 1.5, dens)
    edge = (_smoothstep(0.7, 1.0, dens) - _smoothstep(1.0, 1.5, dens)) \
        * (1.0 + v * 2.0)
    slow = torch.tensor([0.0, 0.5, 1.0], dtype=dens.dtype, device=dens.device)
    fast = torch.tensor([1.0, 0.0, 0.0], dtype=dens.dtype, device=dens.device)
    rgb = ((slow + (fast - slow) * v[..., None]) * interior[..., None]
           + edge[..., None]).clamp(0.0, 1.0)
    rgb = rgb * interior.clamp(0.0, 1.0)[..., None]  # black background
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def frame(pos, vel, size, h, width, height, dtype=torch.float64):
    """u8[H, W, 4]: the metaball frame of particles at ``pos`` with
    velocities ``vel``, seen by the render mode's default camera (centred,
    the world's width across, the image's aspect)."""
    dev = pos.device
    speed = torch.sqrt((vel.to(dtype) ** 2).sum(1))
    dens, velf = lattice_fields(pos, speed, size, h, dtype=dtype)
    step, off, _ = _lattice(size, h, SUPERSAMPLE)
    vw, vh = size[0], size[0] * height / width
    u = torch.arange(width, dtype=torch.float64, device=dev) + 0.5
    v = torch.arange(height, dtype=torch.float64, device=dev) + 0.5
    xs = ((u / width - 0.5) * vw).to(dtype)
    ys = ((0.5 - v / height) * vh).to(dtype)
    fields = []
    for f in (dens, velf):
        f = _resample_axis(f, xs, off[0], step, 1)
        fields.append(_resample_axis(f, ys, off[1], step, 0))
    rgba = shade(*fields)
    return (rgba.clamp(0.0, 1.0) * 255.0 + 0.5).floor().to(torch.uint8)
