"""Pixel-aligned binned rendering (port of ``tpufluid.ops.render_binned``).

The screen is tiled into SxS-pixel bins, S sized so one bin exceeds the
metaball influence radius (2.5h, the reference's 5x5-cell walk,
fluid_shader.wgsl:39-40). Particles are scattered once into
[By+2, Bx+2, K] bins (a one-bin margin), and each pixel sees the 3x3
neighbour bins of its own; the image is processed as [By, S, Bx, S] so a
bin's candidates broadcast over its pixels. Bin overflow drops the last
candidates in a stable order: a visual-only degradation.

Shading is ``tpufluid.ops.render``'s (fluid_shader.wgsl:28-103). The JAX
version walks candidates in an unrolled ``fori_loop`` to bound TPU memory
traffic; here a plain loop over candidates gives the same sums in the same
order. Plain PyTorch: no kernel of the JAX package lies on this path.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..params import SimSettings
from ..state import ParticleState
from .dense import ranks
from .render import (DEFAULT_SPRITE_COLORS, Camera, _div, _smoothstep,
                     sprite_colors, table)


def _bin_particles(xy_world, values, camera: Camera, width, height,
                   bin_px, capacity):
    """Scatter particles into pixel-aligned bins with a one-bin margin.

    Returns (bins: name -> f32[By+2, Bx+2, K], valid bool[...], (bx, by)
    bin counts without the margin)."""
    cx, cy = camera.center
    vw, vh = camera.view_size
    dev = xy_world.device
    # continuous pixel coords (row 0 = +y, the Camera convention)
    px = (_div(xy_world[:, 0] - cx, vw) + 0.5) * width
    py = (0.5 - _div(xy_world[:, 1] - cy, vh)) * height
    bx = -(-width // bin_px)   # ceil: the image is padded up to whole bins
    by = -(-height // bin_px)
    ix = torch.floor(_div(px, bin_px)).to(torch.int64) + 1
    iy = torch.floor(_div(py, bin_px)).to(torch.int64) + 1
    nbx, nby = bx + 2, by + 2
    inside = (ix >= 0) & (ix < nbx) & (iy >= 0) & (iy < nby)
    bid = torch.where(inside, iy * nbx + ix, nby * nbx)
    sb, perm = torch.sort(bid, stable=True)
    rank = ranks(sb)
    keep = (rank < capacity) & (sb < nby * nbx)
    size = nby * nbx * capacity
    # dropped candidates all land on one spare slot, sliced off
    flat = torch.where(keep, sb * capacity + rank, size)

    def scatter(v):
        buf = torch.zeros(size + 1, dtype=v.dtype, device=dev)
        buf[flat] = v[perm]
        return buf[:size].reshape(nby, nbx, capacity)

    bins = {name: scatter(v) for name, v in values.items()}
    valid = scatter(torch.ones_like(bid, dtype=torch.bool))
    return bins, valid, (bx, by)


def _pixel_world(camera: Camera, width, height, bin_px, bx, by, device):
    """World coords of each pixel, shaped [By, S, Bx, S] (padded image)."""
    xs, ys = camera.pixel_axes(width, height, device, n_x=bx * bin_px,
                               n_y=by * bin_px)
    shape = (by, bin_px, bx, bin_px)
    wx = xs[None, :].expand(by * bin_px, -1).reshape(shape)
    wy = ys[:, None].expand(-1, bx * bin_px).reshape(shape)
    return wx, wy


def _bin_size(reach, camera: Camera, width, height, bin_px, capacity):
    """(bin_px, capacity) defaults: a bin spans ``reach`` world units in
    pixels (at least 4), and holds the reference rest spacing x2."""
    vw, vh = camera.view_size
    if bin_px is None:
        bin_px = max(4, int(math.ceil(reach * max(width / vw, height / vh))))
    if capacity is None:
        area_world = (bin_px * vw / width) * (bin_px * vh / height)
        capacity = max(8, int(math.ceil(area_world / 0.1**2 * 2)))
    return bin_px, capacity


def _neighbour_bins(arrays, dy, dx, bx, by):
    """The [By, Bx, K] interior view of each margin grid shifted by
    (dy, dx) bins."""
    return [a[1 + dy:1 + dy + by, 1 + dx:1 + dx + bx] for a in arrays]


def metaball_fields(state: ParticleState, settings: SimSettings,
                    width, height, camera: Camera,
                    bin_px: int | None = None, capacity: int | None = None):
    """(density, velocity_factor) per pixel, f32[H, W] each."""
    bin_px, capacity = _bin_size(2.5 * settings.smoothing_radius, camera,
                                 width, height, bin_px, capacity)
    dev = state.position.device
    vel = state.velocity
    speed = torch.sqrt((vel * vel).sum(dim=-1))
    bins, valid, (bx, by) = _bin_particles(
        state.predicted, dict(x=state.predicted[:, 0],
                              y=state.predicted[:, 1], s=speed),
        camera, width, height, bin_px, capacity)
    wx, wy = _pixel_world(camera, width, height, bin_px, bx, by, dev)
    neg_inv_tau = torch.tensor(-1.0 / (settings.sqr_radius * 0.5),
                               dtype=torch.float32, device=dev)
    dens = torch.zeros_like(wx)
    velf = torch.zeros_like(wx)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nx, ny, ns, nv = _neighbour_bins(
                (bins["x"], bins["y"], bins["s"], valid), dy, dx, bx, by)
            for k in range(capacity):
                ddx = nx[:, None, :, None, k] - wx
                ddy = ny[:, None, :, None, k] - wy
                r2 = ddx * ddx + ddy * ddy
                c = torch.where(nv[:, None, :, None, k],
                                torch.exp(r2 * neg_inv_tau), 0.0)
                dens = dens + c
                velf = velf + c * ns[:, None, :, None, k]
    h_pad, w_pad = by * bin_px, bx * bin_px
    dens = dens.reshape(h_pad, w_pad)[:height, :width]
    velf = velf.reshape(h_pad, w_pad)[:height, :width]
    return dens, velf


def render_particles_binned(state: ParticleState, settings: SimSettings,
                            width: int = 960, height: int = 540,
                            camera: Camera = Camera(), scale: float = 0.35,
                            colors=None, capacity: int | None = None):
    """Point-sprite framebuffer f32[H, W, 4]: the binned variant of
    ``render.render_particles`` (the nearest sprite centre wins)."""
    colors = colors or DEFAULT_SPRITE_COLORS
    bin_px, capacity = _bin_size(0.5 * scale, camera, width, height, None,
                                 capacity)
    dev = state.position.device
    vel = state.velocity
    col = sprite_colors(torch.sqrt((vel * vel).sum(dim=-1)), colors)
    bins, valid, (bx, by) = _bin_particles(
        state.position,
        dict(x=state.position[:, 0], y=state.position[:, 1],
             r=col[:, 0], g=col[:, 1], b=col[:, 2]),
        camera, width, height, bin_px, capacity)
    wx, wy = _pixel_world(camera, width, height, bin_px, bx, by, dev)
    best_d = torch.full_like(wx, torch.inf)
    best_rgb = torch.zeros(wx.shape + (3,), dtype=torch.float32, device=dev)
    inv_scale = 1.0 / float(scale)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nx, ny, nv, nr, ng, nb = _neighbour_bins(
                (bins["x"], bins["y"], valid, bins["r"], bins["g"],
                 bins["b"]), dy, dx, bx, by)
            for k in range(capacity):
                pick = lambda a: a[:, None, :, None, k]
                ddx = pick(nx) - wx
                ddy = pick(ny) - wy
                duv = torch.sqrt(ddx * ddx + ddy * ddy) * inv_scale
                ok = pick(nv) & (duv <= 0.5) & (duv < best_d)
                rgb = (torch.stack([pick(nr), pick(ng), pick(nb)], dim=-1)
                       * (1.0 - duv)[..., None])
                best_d = torch.where(ok, duv, best_d)
                best_rgb = torch.where(ok[..., None], rgb, best_rgb)
    h_pad, w_pad = by * bin_px, bx * bin_px
    rgb = best_rgb.reshape(h_pad, w_pad, 3)[:height, :width]
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def _shade_consts(dev, background, density_clamp_blue: bool):
    """(log 6, slow colour, fast colour, background, clamp blue or None)
    on ``dev``: the shading's constants, made once (``render.table``)."""
    f32 = torch.float32
    return (torch.log(torch.tensor(6.0, dtype=f32, device=dev)),
            torch.tensor([0.0, 0.5, 1.0], dtype=f32, device=dev),
            torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=dev),
            torch.tensor(background, dtype=f32, device=dev),
            torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)
            if density_clamp_blue else None)


def shade_metaball(density, vel_factor,
                   background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                   density_clamp_blue: bool = False):
    """fluid_shader.wgsl:28-103 colormap: per-pixel (density, velocity
    factor) fields -> rgba f32[H, W, 4] (blue body, white edge highlight,
    red tint by speed; optional density > 50 solid-blue clamp,
    shaders/fluid_shader.wgsl:101-103)."""
    log6, slow, fast, bg, blue = table(
        ("shade", density.device, tuple(background), density_clamp_blue),
        lambda: _shade_consts(density.device, background,
                              density_clamp_blue))
    vel_factor = vel_factor * 0.01
    vel_factor = torch.log1p(5.0 * vel_factor) / log6
    vel_factor = vel_factor.clamp(0.0, 1.0)

    interior = _smoothstep(0.5, 1.5, density)
    edge = _smoothstep(0.7, 1.0, density) - _smoothstep(1.0, 1.5, density)
    edge = edge * (1.0 + vel_factor * 2.0)

    base = (slow + (fast - slow) * vel_factor[..., None]) * interior[..., None]
    color = base + edge[..., None]
    alpha = interior.clamp(0.0, 1.0)
    rgb = color.clamp(0.0, 1.0)
    rgb = bg + (rgb - bg) * alpha[..., None]
    if density_clamp_blue:
        rgb = torch.where((density > 50.0)[..., None], blue, rgb)
    return torch.cat([rgb, torch.ones_like(alpha[..., None])], dim=-1)


def render_metaball_binned(state: ParticleState, settings: SimSettings,
                           width: int = 960, height: int = 540,
                           camera: Camera = Camera(),
                           background: Tuple[float, float, float] = (
                               0.0, 0.0, 0.0),
                           density_clamp_blue: bool = False,
                           bin_px: int | None = None,
                           capacity: int | None = None):
    """Fluid-surface framebuffer f32[H, W, 4]: ``render.render_metaball``'s
    shading with the binned candidate search."""
    density, vel_factor = metaball_fields(
        state, settings, width, height, camera, bin_px, capacity)
    return shade_metaball(density, vel_factor, background,
                          density_clamp_blue)
