"""Headless render-to-tensor: the windowed (exact) renderers.

Port of ``tpufluid.ops.render``. Both renderers reuse the simulation's cell
binning for the per-pixel neighbour search, and walk the pixels in chunks
to bound the gather working set:

* :func:`render_metaball`: the fluid surface pass (fluid_shader.wgsl:28-103):
  per-pixel Gaussian density and proximity-weighted speed over the 5x5 cell
  neighbourhood, shaded by ``render_binned.shade_metaball``;
* :func:`render_particles`: point sprites (particle_shader.wgsl:42-78), a
  4-stop speed colormap with radial shading; the nearest sprite centre wins
  a pixel.

Plain PyTorch: no kernel of the JAX package lies on this path.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Tuple

import torch

from ..params import SimSettings
from ..state import ParticleState
from ..utils.profiling import count
from . import grid as gridops

# The render's constants (bilinear weights, shading colours) on the device,
# each under the values it is made from; the newest MAX_TABLES are kept.
MAX_TABLES = 8
_TABLES: collections.OrderedDict = collections.OrderedDict()


def table(key, build):
    """What ``build()`` returns, made once per ``key`` and reused by every
    later frame with an equal key: such a frame copies nothing from the
    host and so never waits for the device's queue. ``key`` holds values
    (the device, sizes, the camera's numbers), never a ``SimSettings``
    object, which the app swaps at each change of ``cell_capacity``. Each
    build counts ``render_tables``."""
    if key in _TABLES:
        _TABLES.move_to_end(key)
        return _TABLES[key]
    count("render_tables")
    value = _TABLES[key] = build()
    if len(_TABLES) > MAX_TABLES:
        _TABLES.popitem(last=False)
    return value


def clear_tables() -> None:
    """Drop every cached table (the next frame of each key builds anew)."""
    _TABLES.clear()


@dataclasses.dataclass(frozen=True)
class Camera:
    """Orthographic camera. The reference views 53x30 of the 53x53 world
    (src/renderer.rs:14,558-561). Row 0 of the output image is world +y."""

    center: Tuple[float, float] = (0.0, 0.0)
    view_size: Tuple[float, float] = (53.0, 30.0)

    def pixel_axes(self, width: int, height: int, device, n_x=None, n_y=None):
        """World x of each pixel column and world y of each pixel row,
        f32[n_x] and f32[n_y] (default width and height; more for a padded
        image, still spaced by the view over ``width`` / ``height``)."""
        cx, cy = self.center
        vw, vh = self.view_size
        f32 = torch.float32
        u = torch.arange(n_x or width, dtype=f32, device=device) + 0.5
        v = torch.arange(n_y or height, dtype=f32, device=device) + 0.5
        xs = cx + (_div(u, width) - 0.5) * vw
        ys = cy + (0.5 - _div(v, height)) * vh
        return xs, ys

    def pixel_world_coords(self, width: int, height: int, device):
        """f32[H, W, 2] world position of each pixel centre."""
        xs, ys = self.pixel_axes(width, height, device)
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        return torch.stack([gx, gy], dim=-1)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b in f32, rounded once: on a CUDA device torch divides by a
    Python scalar as a multiply by its reciprocal."""
    return a / torch.full_like(a, b)


def _clamped_cell_id(points, settings: SimSettings):
    """Cell ids of arbitrary world points, clamped into the grid."""
    xy = gridops.cell_xy(points, settings)
    x = xy[..., 0].clamp(0, settings.grid_w - 1)
    y = xy[..., 1].clamp(0, settings.grid_h - 1)
    return y * settings.grid_w + x


def _chunked_pixel_map(fn, pts, chunks: int):
    """``fn`` over the flattened pixels in ``chunks`` sequential chunks."""
    h, w = pts.shape[:2]
    flat = pts.reshape(-1, 2)
    size = -(-flat.shape[0] // chunks)
    out = torch.cat([fn(c) for c in torch.split(flat, size)])
    return out.reshape(h, w, -1)


def render_metaball(state: ParticleState, settings: SimSettings,
                    width: int = 960, height: int = 540,
                    camera: Camera = Camera(), chunks: int = 8,
                    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                    density_clamp_blue: bool = False):
    """Fluid surface framebuffer f32[H, W, 4] in [0, 1].

    Expects ``state`` as the step returns it (predicted and cell
    populated), the buffers the reference's fragment shader reads
    (src/renderer.rs:457-458)."""
    from .render_binned import shade_metaball

    dev = state.position.device
    binning = gridops.bin_particles(state.cell, settings)
    pred = state.predicted[binning.perm]
    vel = state.velocity[binning.perm]
    speed = torch.sqrt((vel * vel).sum(dim=-1))
    tau = torch.tensor(settings.sqr_radius, dtype=torch.float32,
                       device=dev) * 0.5

    def fields(chunk_pts):
        cells = _clamped_cell_id(chunk_pts, settings)
        win = gridops.point_windows(cells, binning.cell_start, settings,
                                    radius_cells=2)
        idx = win.idx.reshape(chunk_pts.shape[0], -1)
        valid = win.valid.reshape(chunk_pts.shape[0], -1)
        off = pred[idx] - chunk_pts[:, None, :]
        r2 = (off * off).sum(dim=-1)
        # contrib = exp(-r^2 / (h^2/2)) (fluid_shader.wgsl:66)
        contrib = torch.where(valid, torch.exp(-r2 / tau), 0.0)
        return torch.stack([contrib.sum(dim=-1),
                            (contrib * speed[idx]).sum(dim=-1)], dim=-1)

    pts = camera.pixel_world_coords(width, height, dev)
    f = _chunked_pixel_map(fields, pts, chunks)
    return shade_metaball(f[..., 0], f[..., 1], background, density_clamp_blue)


DEFAULT_SPRITE_COLORS = (
    (0.05, 0.15, 0.9, 1.0),   # slow
    (0.1, 0.6, 1.0, 1.0),
    (1.0, 0.7, 0.1, 1.0),
    (1.0, 0.1, 0.05, 1.0),    # fast
)


def sprite_colors(speed: torch.Tensor, colors) -> torch.Tensor:
    """f32[N, 4] 4-stop speed ramp, step = |v| * 0.05 with knots at 0.4
    and 0.85 (particle_shader.wgsl:50-64)."""
    step_v = speed * 0.05
    c = torch.tensor(colors, dtype=torch.float32, device=speed.device)
    t0 = _div(step_v, 0.4).clamp(0.0, 1.0)[:, None]
    t1 = _div(step_v - 0.4, 0.45).clamp(0.0, 1.0)[:, None]
    t2 = _div(step_v - 0.85, 0.15).clamp(0.0, 1.0)[:, None]
    return torch.where(
        (step_v < 0.4)[:, None], c[0] + (c[1] - c[0]) * t0,
        torch.where((step_v < 0.85)[:, None], c[1] + (c[2] - c[1]) * t1,
                    c[2] + (c[3] - c[2]) * t2))


def render_particles(state: ParticleState, settings: SimSettings,
                     width: int = 960, height: int = 540,
                     camera: Camera = Camera(), scale: float = 0.35,
                     colors=DEFAULT_SPRITE_COLORS, chunks: int = 8):
    """Point-sprite framebuffer f32[H, W, 4].

    A sprite is a circle of world diameter ``scale`` on each particle's
    position, shaded rgb * (1 - dist) (particle_shader.wgsl:70-78). Where
    the reference alpha-blends sprites in instance order, the nearest
    sprite centre takes the pixel."""
    dev = state.position.device
    binning = gridops.bin_particles(state.cell, settings)
    pos = state.position[binning.perm]
    vel = state.velocity[binning.perm]
    col = sprite_colors(torch.sqrt((vel * vel).sum(dim=-1)), colors)
    # the sprite radius in cells decides the stencil size
    r_cells = max(1, int(math.ceil(scale * 0.5 / settings.smoothing_radius)))

    def shade(chunk_pts):
        cells = _clamped_cell_id(chunk_pts, settings)
        win = gridops.point_windows(cells, binning.cell_start, settings,
                                    radius_cells=r_cells)
        idx = win.idx.reshape(chunk_pts.shape[0], -1)
        valid = win.valid.reshape(chunk_pts.shape[0], -1)
        off = pos[idx] - chunk_pts[:, None, :]
        # uv distance from the sprite centre: d / scale, cut off at 0.5
        duv = _div(torch.sqrt((off * off).sum(dim=-1)), scale)
        covered = valid & (duv <= 0.5)
        best = torch.where(covered, duv, torch.inf).argmin(dim=-1,
                                                           keepdim=True)
        hit = covered.gather(1, best)
        bd = duv.gather(1, best)
        rgb = col[idx.gather(1, best)[:, 0], :3] * (1.0 - bd)
        out = torch.where(hit, rgb, 0.0)
        return torch.cat([out, torch.ones_like(out[:, :1])], dim=-1)

    pts = camera.pixel_world_coords(width, height, dev)
    return _chunked_pixel_map(shade, pts, chunks)


def _smoothstep(e0, e1, x):
    t = _div(x - e0, e1 - e0).clamp(0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def to_rgba8(frame: torch.Tensor) -> torch.Tensor:
    """f32[H, W, 4] in [0, 1] -> u8[H, W, 4]."""
    return (frame.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
