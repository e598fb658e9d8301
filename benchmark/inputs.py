"""The inputs of a cell, made from ``--seed``: the scene's spawn lattice
with each position jittered, and zero velocities.

The lattice is the upstream project's (src/simulation.rs:147-163): rows of
``spawn_columns`` particles (sqrt(n) where the scene gives none) spaced
``particle_spacing`` apart and centred on the origin, in float32 as the
reference computes it. The jitter is uniform in +-``jitter`` on each axis,
drawn on the device from a ``torch.Generator`` seeded with ``--seed``, so
the same seed gives the same state on the same device.
"""

from __future__ import annotations

import numpy as np
import torch


def lattice(n: int, spacing: float, spawn_columns=None) -> np.ndarray:
    """f32[n, 2] spawn lattice."""
    spacing = np.float32(spacing)
    per_row = (np.float32(spawn_columns) if spawn_columns is not None
               else np.float32(np.sqrt(np.float32(n))))
    per_col = (np.float32(n) - 1.0) / per_row + 1.0
    i = np.arange(n, dtype=np.int64)
    xi = (i % int(per_row)).astype(np.float32)
    x = (xi - per_row * 0.5 + 0.5) * spacing
    y = (np.floor(i.astype(np.float32) / per_row) - per_col * 0.5
         + 0.5) * spacing
    return np.stack([x, y], axis=-1).astype(np.float32)


def jittered(config: dict, seed: int, device):
    """(pos, vel) f32[n, 2] on ``device``: the configuration's lattice with
    every coordinate moved by a uniform draw in +-``jitter``."""
    dom = config["domain"]
    pos = torch.from_numpy(lattice(dom["particle_count"],
                                   dom["particle_spacing"],
                                   dom.get("spawn_columns"))).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    u = torch.rand(pos.shape, generator=gen, device=device,
                   dtype=torch.float32)
    pos = pos + (u * 2.0 - 1.0) * float(config["inputs"]["jitter"])
    return pos, torch.zeros_like(pos)
