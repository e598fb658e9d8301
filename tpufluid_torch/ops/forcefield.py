"""Obstacle force field: SDF rasterisation and a jump-flood distance field
(port of ``tpufluid.ops.forcefield``).

Obstacles (circles and rotated rectangles, image_shader.wgsl:42-85) are
rasterised to an outside mask over the simulation bounds, and a jump flood
turns the mask into a push-out field: for every pixel, the vector in pixel
units to the nearest outside pixel, zero on outside pixels themselves
(the semantics of the reference's CPU chamfer pass, src/main.rs:403-515).
The resident step samples the field once per grid cell
(``resident.forcefield_cells``) and the forces kernel applies it.

As in the JAX package, the mask is rasterised in simulation-bounds space,
the space the integrator samples it in. Plain PyTorch: no kernel of the
JAX package lies on this path.
"""

from __future__ import annotations

import dataclasses

import torch

from ..params import SimSettings

CIRCLE = 0
RECT = 1


@dataclasses.dataclass
class Objects:
    """Obstacle set, one entry per object (cf. the reference's
    ``FluidObject``, src/renderer.rs:82-90).

    kind: i32[M] (0 circle, 1 rect); position: f32[M, 2]; radius: f32[M]
    (circles); extents: f32[M, 2] and rotation: f32[M] (rects)."""

    kind: torch.Tensor
    position: torch.Tensor
    radius: torch.Tensor
    extents: torch.Tensor
    rotation: torch.Tensor

    @staticmethod
    def empty(device) -> "Objects":
        return Objects.from_list([], device)

    @staticmethod
    def from_list(objs, device) -> "Objects":
        """objs: ("circle", pos, radius) / ("rect", pos, extents[, rot])."""
        kinds, poss, radii, exts, rots = [], [], [], [], []
        for o in objs:
            if o[0] == "circle":
                kinds.append(CIRCLE)
                poss.append(o[1])
                radii.append(o[2])
                exts.append((0.0, 0.0))
                rots.append(0.0)
            elif o[0] == "rect":
                kinds.append(RECT)
                poss.append(o[1])
                radii.append(0.0)
                exts.append(o[2])
                rots.append(o[3] if len(o) > 3 else 0.0)
            else:
                raise ValueError(f"unknown object kind {o[0]!r}")
        f32 = dict(dtype=torch.float32, device=device)
        return Objects(
            kind=torch.tensor(kinds, dtype=torch.int32, device=device),
            position=torch.tensor(poss, **f32).reshape(-1, 2),
            radius=torch.tensor(radii, **f32),
            extents=torch.tensor(exts, **f32).reshape(-1, 2),
            rotation=torch.tensor(rots, **f32),
        )

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    def to(self, device) -> "Objects":
        return Objects(**{f.name: getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)})


def point_in_objects(points: torch.Tensor, objects: Objects) -> torch.Tensor:
    """bool[...]: the point lies inside any object (image_shader.wgsl:47-64).

    Circles: distance < radius. Rects: rotated into the local frame, then
    an inclusive box test against the half-extents (image_shader.wgsl:70-85).
    """
    if len(objects) == 0:
        return torch.zeros(points.shape[:-1], dtype=torch.bool,
                           device=points.device)
    local = points[..., None, :] - objects.position  # [..., M, 2]
    dist = torch.sqrt((local * local).sum(dim=-1))
    in_circle = (objects.kind == CIRCLE) & (dist < objects.radius)
    c = torch.cos(-objects.rotation)
    s = torch.sin(-objects.rotation)
    rx = local[..., 0] * c - local[..., 1] * s
    ry = local[..., 0] * s + local[..., 1] * c
    half = objects.extents * 0.5
    in_rect = ((objects.kind == RECT)
               & (rx >= -half[..., 0]) & (rx <= half[..., 0])
               & (ry >= -half[..., 1]) & (ry <= half[..., 1]))
    return (in_circle | in_rect).any(dim=-1)


def rasterize_outside_mask(objects: Objects,
                           settings: SimSettings) -> torch.Tensor:
    """bool[H, W]: the pixel centre lies outside every object (the
    reference's value-255 region, image_shader.wgsl:66)."""
    w, hgt = settings.texture_size
    dev = objects.position.device
    f32 = torch.float32
    bounds = torch.tensor(settings.size, dtype=f32, device=dev)
    xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / w
    ys = (torch.arange(hgt, dtype=f32, device=dev) + 0.5) / hgt
    wx = (xs - 0.5) * bounds[0]
    wy = (ys - 0.5) * bounds[1]
    gx, gy = torch.meshgrid(wx, wy, indexing="xy")
    return ~point_in_objects(torch.stack([gx, gy], dim=-1), objects)


def shift2d(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = arr[y+dy, x+dx] on an [H, W, ...] tensor; ``fill``
    outside the image (no wrap)."""
    h, w = arr.shape[:2]
    out = torch.full_like(arr, fill)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0),
                                                      h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0),
                                                      w + min(-dx, 0))
    if ys.start < ys.stop and xs.start < xs.stop:
        out[yd, xd] = arr[ys, xs]
    return out


def _jfa_pass(seeds: torch.Tensor, jump: int,
              coords: torch.Tensor) -> torch.Tensor:
    """One jump-flood pass: of the 8 neighbours at +-jump, keep the nearest
    seed. seeds: i32[H, W, 2] (x, y) of each pixel's best seed so far, -1
    where none; coords: i32[H, W, 2] the pixel's own (x, y)."""
    big = 2**30

    def dist2(s):
        d = s - coords
        return torch.where(s[..., 0] >= 0, (d * d).sum(dim=-1,
                                                        dtype=torch.int32),
                           big)

    best = seeds
    best_d = dist2(seeds)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shifted = shift2d(seeds, dy * jump, dx * jump, fill=-1)
            d = dist2(shifted)
            take = d < best_d
            best = torch.where(take[..., None], shifted, best)
            best_d = torch.where(take, d, best_d)
    return best


def jump_flood_field(outside_mask: torch.Tensor) -> torch.Tensor:
    """f32[H, W, 2] push-out vectors in pixel units, by jump flood plus one
    refinement pass.

    Seeds are the outside pixels, or the image border when nothing is
    outside (src/main.rs:425-438). out[y, x] = nearest seed (x, y) - (x, y);
    zero on seed pixels."""
    hgt, w = outside_mask.shape
    dev = outside_mask.device
    ys, xs = torch.meshgrid(torch.arange(hgt, dtype=torch.int32, device=dev),
                            torch.arange(w, dtype=torch.int32, device=dev),
                            indexing="ij")
    coords = torch.stack([xs, ys], dim=-1)
    border = (xs == 0) | (xs == w - 1) | (ys == 0) | (ys == hgt - 1)
    # a device-side select: no host read of the mask
    seed_mask = torch.where(outside_mask.any(), outside_mask, border)
    seeds = torch.where(seed_mask[..., None], coords, -1)
    jump = max(hgt, w) // 2
    while jump >= 1:
        seeds = _jfa_pass(seeds, jump, coords)
        jump //= 2
    seeds = _jfa_pass(seeds, 1, coords)  # the JFA+1 clean-up pass
    field = (seeds - coords).to(torch.float32)
    return torch.where((seeds[..., 0] >= 0)[..., None], field, 0.0)


def obstacle_force_field(objects: Objects,
                         settings: SimSettings) -> torch.Tensor:
    """Objects -> outside mask -> jump flood -> f32[H, W, 2] push-out
    field, on the objects' device: the ``forcefield`` argument of a step
    built with ``has_force_field=True``."""
    return jump_flood_field(rasterize_outside_mask(objects, settings))
