"""Particle state as a structure of arrays (port of ``tpufluid.state``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import SimSettings


@dataclasses.dataclass
class ParticleState:
    """position / predicted / velocity: f32[N, 2]; density: f32[N];
    cell: i32[N] grid-cell key (u32 in the JAX package: torch has no
    uint32 arithmetic on the CPU, and keys stay below 2^31); tick: i64
    0-d (u32 in the JAX package)."""

    position: torch.Tensor
    predicted: torch.Tensor
    velocity: torch.Tensor
    density: torch.Tensor
    cell: torch.Tensor
    tick: torch.Tensor

    @property
    def n(self) -> int:
        return self.position.shape[0]


def init_state(settings: SimSettings, device) -> ParticleState:
    """The centred spawn lattice at rest (``src/simulation.rs:147-163``),
    on ``device``; the same numpy arithmetic as
    ``tpufluid.state.init_state``."""
    n = settings.particle_count
    spacing = np.float32(settings.particle_spacing)
    if settings.spawn_columns is not None:
        per_row = np.float32(settings.spawn_columns)
    else:
        per_row = np.float32(np.sqrt(np.float32(n)))
    per_col = (np.float32(n) - 1.0) / per_row + 1.0

    i = np.arange(n, dtype=np.int64)
    xi = (i % int(per_row)).astype(np.float32)
    x = (xi - per_row * 0.5 + 0.5) * spacing
    y = (np.floor(i.astype(np.float32) / per_row) - per_col * 0.5 + 0.5) * spacing
    pos = np.stack([x, y], axis=-1).astype(np.float32)
    pos = torch.from_numpy(pos).to(device)
    return ParticleState(
        position=pos,
        predicted=pos.clone(),
        velocity=torch.zeros((n, 2), dtype=torch.float32, device=device),
        density=torch.zeros((n,), dtype=torch.float32, device=device),
        cell=torch.zeros((n,), dtype=torch.int32, device=device),
        tick=torch.zeros((), dtype=torch.int64, device=device),
    )
