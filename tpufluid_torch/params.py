"""Simulation parameter containers (PyTorch port of ``tpufluid.params``).

Two tiers, as in the JAX package: :class:`SimSettings` holds the static,
shape-determining values (hashable, a cache key for built steps), and
:class:`TickParams` holds the per-tick tunables as tensors on the device.
Assigning a field of a ``TickParams`` changes the next step: the kernels
read the tunables from a device table built at each call, so nothing is
rebuilt and the host never reads them back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

PI = math.pi
# f32 machine epsilon, matching the reference's EPSILON (funcs.wgsl:55).
EPSILON = 1.19209290e-07
# Hard speed clamp applied after force integration (compute.wgsl:118-122).
MAX_SPEED = 500.0


@dataclasses.dataclass(frozen=True)
class SimSettings:
    """Construction-time settings; field for field ``tpufluid.SimSettings``.

    ``cell_capacity`` bounds the particles a grid cell can hold in the
    resident engine (overflow is counted in ``GridState.lost``);
    ``spawn_columns`` overrides the sqrt(n)-wide spawn lattice.
    """

    particle_count: int = 100_000
    particle_spacing: float = 0.1
    smoothing_radius: float = 0.2
    size: Tuple[float, float] = (53.0, 53.0)
    texture_size: Tuple[int, int] = (1024, 1024)
    cell_capacity: int = 8
    spawn_columns: Optional[int] = None

    def __post_init__(self):
        if self.particle_count <= 0:
            raise ValueError(f"particle_count must be > 0, got {self.particle_count}")
        if self.smoothing_radius <= 0:
            raise ValueError(f"smoothing_radius must be > 0, got {self.smoothing_radius}")
        if self.particle_spacing <= 0:
            raise ValueError(f"particle_spacing must be > 0, got {self.particle_spacing}")
        if self.size[0] <= 0 or self.size[1] <= 0:
            raise ValueError(f"size must be positive, got {self.size}")
        if self.cell_capacity <= 0:
            raise ValueError(f"cell_capacity must be > 0, got {self.cell_capacity}")

    @property
    def grid_w(self) -> int:
        # ceil(size/h) + 2: one-cell sentinel ring (src/simulation.rs:140).
        return int(math.ceil(self.size[0] / self.smoothing_radius)) + 2

    @property
    def grid_h(self) -> int:
        return int(math.ceil(self.size[1] / self.smoothing_radius)) + 2

    @property
    def num_cells(self) -> int:
        return self.grid_w * self.grid_h

    @property
    def sqr_radius(self) -> float:
        return self.smoothing_radius * self.smoothing_radius

    def kernel_norms(self) -> "KernelNorms":
        return KernelNorms.from_radius(self.smoothing_radius)


def suggest_cell_capacity(settings: SimSettings, params=None,
                          safety: float = 1.3, rounded: bool = True):
    """Cell capacity that keeps the resident engine loss-free.

    Same model as ``tpufluid.params.suggest_cell_capacity``: the spawn
    lattice packs ``(h / spacing)^2`` per cell, times the larger of a
    settled-pool and an impact compression factor from the linear EOS
    ``p = k rho`` (exponent capped at 3). ``safety``/``rounded`` give the
    padded recommendation rounded up to a multiple of 8.
    """
    occ0 = max(1.0, (settings.smoothing_radius
                     / settings.particle_spacing) ** 2)
    g = 0.0
    kp = 50.0
    if params is not None:
        grav = [float(v) for v in params.gravity.reshape(-1)]
        g = float(max(abs(grav[0]), abs(grav[1])))
        kp = float(params.pressure_constant)
    pool_h = min(settings.particle_count * settings.particle_spacing ** 2
                 / settings.size[0], settings.size[1])
    col_top = 0.5 * math.sqrt(settings.particle_count) \
        * settings.particle_spacing
    fall_h = min(col_top + settings.size[1] * 0.5, settings.size[1])
    kp = max(kp, EPSILON)
    x = max(0.55 * g * pool_h / kp, 0.9 * g * fall_h / kp)
    factor = math.exp(min(x, 3.0))
    cap = occ0 * factor * safety
    if not rounded:
        return cap
    return max(8, -(-int(math.ceil(cap)) // 8) * 8)


@dataclasses.dataclass(frozen=True)
class KernelNorms:
    """2D SPH kernel normalization constants (``src/simulation.rs:486-490``)."""

    poly6_volume: float
    poly6_gradient: float
    poly6_laplacian: float
    spiky_derivative: float
    viscosity: float

    @staticmethod
    def from_radius(h: float) -> "KernelNorms":
        return KernelNorms(
            poly6_volume=4.0 / (PI * h**8),
            poly6_gradient=24.0 / (PI * h**8),
            poly6_laplacian=8.0 / (PI * h**8),
            spiky_derivative=12.0 / (PI * h**4),
            viscosity=15.0 / (2.0 * PI * h**3),
        )


_F32_FIELDS = (
    "delta", "gravity", "mass", "pressure_constant", "rest_density",
    "damping_factor", "viscosity_coefficient", "surface_tension_threshold",
    "surface_tension_coefficient", "mouse_force_radius", "mouse_force_power",
    "mouse_pos",
)


@dataclasses.dataclass
class TickParams:
    """Per-tick tunables as tensors on one device.

    f32 0-d tensors, except ``gravity`` and ``mouse_pos`` (f32[2]) and
    ``mouse_state`` (i32 0-d: -1 repel, +1 attract, 0 off). Defaults from
    ``src/renderer.rs:374-388``.
    """

    delta: torch.Tensor
    gravity: torch.Tensor
    mass: torch.Tensor
    pressure_constant: torch.Tensor
    rest_density: torch.Tensor
    damping_factor: torch.Tensor
    viscosity_coefficient: torch.Tensor
    surface_tension_threshold: torch.Tensor
    surface_tension_coefficient: torch.Tensor
    mouse_force_radius: torch.Tensor
    mouse_force_power: torch.Tensor
    mouse_pos: torch.Tensor
    mouse_state: torch.Tensor

    @staticmethod
    def default(device, **overrides) -> "TickParams":
        vals = dict(
            delta=1.0 / 120.0,
            gravity=(0.0, 0.0),
            mass=1.0,
            pressure_constant=50.0,
            rest_density=0.0,
            damping_factor=0.1,
            viscosity_coefficient=25.0,
            surface_tension_threshold=0.1,
            surface_tension_coefficient=35.0,
            mouse_force_radius=5.0,
            mouse_force_power=150.0,
            mouse_pos=(0.0, 0.0),
            mouse_state=0,
        )
        unknown = set(overrides) - set(vals)
        if unknown:
            raise TypeError(f"unknown TickParams fields {sorted(unknown)}")
        vals.update(overrides)
        out = {name: torch.as_tensor(vals[name], dtype=torch.float32,
                                     device=device)
               for name in _F32_FIELDS}
        out["mouse_state"] = torch.as_tensor(vals["mouse_state"],
                                             dtype=torch.int32, device=device)
        return TickParams(**out)

    @property
    def device(self) -> torch.device:
        return self.delta.device
