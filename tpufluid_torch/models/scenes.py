"""Scene presets (port of ``tpufluid.models.scenes``): the reference's
default scene and the benchmark ladder, with the same settings, and
``batch_scenes`` (BASELINE config 4 on the per-step engines)."""

from __future__ import annotations

import dataclasses

import torch

from ..params import SimSettings, TickParams
from ..state import ParticleState, init_state
from ..step import make_step


@dataclasses.dataclass
class Scene:
    name: str
    settings: SimSettings
    params: TickParams

    def init(self) -> ParticleState:
        return init_state(self.settings, self.params.device)

    def make_step(self, **kw):
        return make_step(self.settings, **kw)


def default_scene(device, **overrides) -> Scene:
    """The reference's default scene (src/main.rs:48-54, renderer.rs:374-388)."""
    return Scene(
        name="reference-default-100k",
        settings=SimSettings(**overrides),
        params=TickParams.default(device),
    )


def dam_break_4k(device) -> Scene:
    """4k particles in a 16x16 box under gravity, K=32."""
    return Scene(
        name="dam-break-4k",
        settings=SimSettings(
            particle_count=4096, particle_spacing=0.1, smoothing_radius=0.2,
            size=(16.0, 16.0), cell_capacity=32,
        ),
        params=TickParams.default(device, gravity=(0.0, -9.8)),
    )


def scene_64k(device) -> Scene:
    """64k particles: 512-column grid, 1008 spawn columns at rest packing."""
    return Scene(
        name="sph-64k",
        settings=SimSettings(
            particle_count=65536, particle_spacing=0.1, smoothing_radius=0.2,
            size=(101.95, 6.75), cell_capacity=8, spawn_columns=1008,
        ),
        params=TickParams.default(device),
    )


def scene_256k(device) -> Scene:
    """256k particles: 512-column grid, 1008 spawn columns."""
    return Scene(
        name="sph-256k",
        settings=SimSettings(
            particle_count=262144, particle_spacing=0.1, smoothing_radius=0.2,
            size=(101.95, 26.25), cell_capacity=8, spawn_columns=1008,
        ),
        params=TickParams.default(device),
    )


def scene_1m(device) -> Scene:
    """1M particles: grid 512 x 523, 1008 spawn columns, two lattice
    columns per cell (spacing h/2); the box is offset an eighth-cell from
    the lattice so no lattice column sits on a cell boundary."""
    return Scene(
        name="sph-1m",
        settings=SimSettings(
            particle_count=1_048_576, particle_spacing=0.1,
            smoothing_radius=0.2, size=(101.95, 104.1), cell_capacity=8,
            spawn_columns=1008,
        ),
        params=TickParams.default(device),
    )


def scene_4m(device) -> Scene:
    """4M particles: grid 1024 x 1044, 2016 spawn columns."""
    return Scene(
        name="sph-4m",
        settings=SimSettings(
            particle_count=4_194_304, particle_spacing=0.1,
            smoothing_radius=0.2, size=(204.35, 208.3), cell_capacity=8,
            spawn_columns=2016,
        ),
        params=TickParams.default(device),
    )


def world_params(params: TickParams, w: int) -> TickParams:
    """World ``w``'s TickParams out of a batch with a leading [B] dim."""
    return TickParams(**{f.name: getattr(params, f.name)[w]
                         for f in dataclasses.fields(params)})


def batch_scenes(scene: Scene, gravities, viscosities, **step_kw):
    """BASELINE config 4 on the per-step engines: B independent copies of
    a scene with differing gravity and viscosity.

    Returns (states, batched_params, batched_step): a list of B
    ParticleStates, TickParams with a leading [B] dim on every field, and
    ``batched_step(states, params) -> states``. The JAX package vmaps the
    step; the port steps the B worlds in turn (a ctypes kernel launch does
    not batch under ``torch.func.vmap``), with the same numbers. The
    resident engine's row-stacked form is
    ``ops.resident.make_grid_step(n_worlds=B)``."""
    from ..step import make_step

    b = len(gravities)
    if len(viscosities) != b:
        raise ValueError(f"{b} gravities but {len(viscosities)} viscosities")
    state = scene.init()
    states = [dataclasses.replace(state) for _ in range(b)]
    params = scene.params
    dev = params.device
    bparams = TickParams(**{
        f.name: getattr(params, f.name).expand(
            (b,) + tuple(getattr(params, f.name).shape)).clone()
        for f in dataclasses.fields(params)})
    bparams.gravity = torch.as_tensor(gravities, dtype=torch.float32,
                                      device=dev).reshape(b, 2)
    bparams.viscosity_coefficient = torch.as_tensor(
        viscosities, dtype=torch.float32, device=dev).reshape(b)
    step = make_step(scene.settings, **step_kw)

    def batched_step(states, params):
        return [step(st, world_params(params, w))
                for w, st in enumerate(states)]

    return states, bparams, batched_step
