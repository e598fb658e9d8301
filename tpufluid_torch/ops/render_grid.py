"""Fluid-surface rendering straight off the resident slot grid (port of
``tpufluid.ops.render_grid``).

The reference shades the surface per pixel in a fragment shader
(fluid_shader.wgsl:28-103, renderer.rs:159-234; RENDER_DIMS 960x540 at
renderer.rs:15). Here the Gaussian density and velocity fields are
evaluated on a world-aligned coarse lattice by one kernel reading the
resident grid (``render_coarse.coarse_metaball_fields``), resampled to the
camera with two separable-bilinear matrix products, and shaded with the
fluid_shader colormap (``render_binned.shade_metaball``).

The products are plain ``torch.matmul`` in full f32: each call checks that
TF32 is off (``allow_tf32`` False, matmul precision "highest"), the
PyTorch defaults. The bilinear resampling of a lattice with ``supersample``
samples per cell per axis is the only approximation against the per-pixel
renderers (``ops.render``, ``ops.render_binned``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..params import SimSettings
from ..state import ParticleState
from ..utils.profiling import span
from .render import Camera, _div, table
from .render_binned import shade_metaball
from .render_coarse import coarse_metaball_fields


def _axis_weights(pix_world, coarse_n: int, coarse_world_off, step):
    """[coarse_n, n_pix] bilinear interpolation matrix for one axis.

    pix_world: f32[n_pix] world coordinate of each output pixel; coarse
    sample i sits at world ``(i + 0.5) * step - coarse_world_off``.
    Pixels outside the lattice get all-zero weights (density-0 background).
    """
    u = _div(pix_world + coarse_world_off, step) - 0.5
    i0 = torch.floor(u)
    w = (u - i0)[None, :]
    i0 = i0.to(torch.int64)[None, :]
    rows = torch.arange(coarse_n, device=u.device)[:, None]
    mat = (torch.where(rows == i0, 1.0 - w, 0.0)
           + torch.where(rows == i0 + 1, w, 0.0))
    inb = (u >= 0.0) & (u <= coarse_n - 1.0)
    return mat * inb[None, :]


def _check_full_f32_matmul() -> None:
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "render_grid resamples in full f32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _weights(size, h, width: int, height: int, camera: Camera,
             supersample: int, hc: int, wc: int, dev):
    """(wx f32[Wc, W], wy f32[Hc, H]): the camera's bilinear matrices."""
    step = h / supersample
    half = torch.tensor(size, dtype=torch.float32, device=dev) * 0.5
    xs, ys = camera.pixel_axes(width, height, dev)
    return (_axis_weights(xs, wc, half[0] + h, step),
            _axis_weights(ys, hc, half[1] + h, step))


def resample_fields(fields, settings: SimSettings, width: int, height: int,
                    camera: Camera, supersample: int):
    """Bilinear-resample [Hc, Wc] world-lattice fields to the [H, W]
    camera viewport with two matrix products per field. The matrices are
    made once a camera (``render.table``)."""
    hc, wc = fields[0].shape
    dev = fields[0].device
    size, h = settings.size, settings.smoothing_radius
    wx, wy = table(
        ("resample", dev, tuple(size), h, width, height,
         tuple(camera.center), tuple(camera.view_size), supersample, hc, wc),
        lambda: _weights(size, h, width, height, camera, supersample, hc,
                         wc, dev))
    _check_full_f32_matmul()
    return tuple(torch.matmul(torch.matmul(wy.T, f), wx) for f in fields)


def render_metaball_grid(gs, settings: SimSettings, width: int = 960,
                         height: int = 540, camera: Camera = Camera(),
                         background: Tuple[float, float, float] = (
                             0.0, 0.0, 0.0),
                         density_clamp_blue: bool = False,
                         supersample: int = 2):
    """rgba f32[H, W, 4] fluid surface from a resident GridState.

    Positions are the grid's current positions (the per-pixel renderers
    use ``state.predicted``; the difference is v*dt)."""
    with span("tpufluid_torch.render.coarse"):
        speed = torch.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
        dens_c, velf_c = coarse_metaball_fields(
            gs.pos_x, gs.pos_y, speed, gs.occ_row, settings, supersample)
    with span("tpufluid_torch.render.resample"):
        dens, velf = resample_fields((dens_c, velf_c), settings, width,
                                     height, camera, supersample)
    with span("tpufluid_torch.render.shade"):
        return shade_metaball(dens, velf, background, density_clamp_blue)


def render_metaball_state(state: ParticleState, settings: SimSettings,
                          width: int = 960, height: int = 540,
                          camera: Camera = Camera(),
                          background: Tuple[float, float, float] = (
                              0.0, 0.0, 0.0),
                          density_clamp_blue: bool = False,
                          supersample: int = 2):
    """The same pipeline for a ParticleState: one grid binning replaces
    the per-frame sort and re-bin of the binned path."""
    from . import resident

    gs = resident.from_particles(state, settings)
    return render_metaball_grid(gs, settings, width, height, camera,
                                background, density_clamp_blue, supersample)
