"""Carry values of the JAX package into the port and back, as numpy.

The JAX package is the port's reference: tests run both on the same
state. These helpers take its values (any object with the named
attributes, whose values ``numpy.array`` accepts: the JAX package's
dataclasses, or numpy arrays) and build the port's. Nothing here imports
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .ops.dense import DenseGrid
from .ops.forcefield import Objects
from .ops.resident import GridState
from .params import SimSettings, TickParams
from .parallel.shard import ShardedState, Slab
from .state import ParticleState

_GRID_FIELDS = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")
_STATE_FIELDS = ("position", "predicted", "velocity", "density", "cell", "tick")
_OBJECT_FIELDS = ("kind", "position", "radius", "extents", "rotation")


def _get(obj: Any, name: str) -> np.ndarray:
    # a writable copy: torch warns on read-only numpy views
    return np.array(getattr(obj, name))


def settings_from(obj: Any) -> SimSettings:
    """SimSettings from the JAX package's (a dataclass, same fields)."""
    fields = dataclasses.asdict(obj)
    fields["size"] = tuple(fields["size"])
    fields["texture_size"] = tuple(fields["texture_size"])
    return SimSettings(**fields)


def tick_params_from_numpy(obj: Any, device) -> TickParams:
    """TickParams on ``device`` from per-field values."""
    names = [f.name for f in dataclasses.fields(TickParams)]
    return TickParams.default(device, **{n: _get(obj, n) for n in names})


def particle_state_from_numpy(obj: Any, device) -> ParticleState:
    """ParticleState on ``device``; u32 cells and tick are widened."""
    v = {n: _get(obj, n) for n in _STATE_FIELDS}
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return ParticleState(
        position=f32(v["position"]), predicted=f32(v["predicted"]),
        velocity=f32(v["velocity"]), density=f32(v["density"]),
        cell=torch.from_numpy(v["cell"].astype(np.int32)).to(device),
        tick=torch.tensor(int(v["tick"]), dtype=torch.int64, device=device),
    )


def grid_state_from_numpy(obj: Any, device) -> GridState:
    """GridState on ``device`` from the JAX package's GridState fields."""
    v = {n: _get(obj, n) for n in _GRID_FIELDS}
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return GridState(
        pos_x=f32(v["pos_x"]), pos_y=f32(v["pos_y"]),
        vel_x=f32(v["vel_x"]), vel_y=f32(v["vel_y"]),
        occ_row=torch.from_numpy(v["occ_row"].astype(np.int32)).to(device),
        tick=torch.tensor(int(v["tick"]), dtype=torch.int64, device=device),
        lost=torch.tensor(int(v["lost"]), dtype=torch.int32, device=device),
    )


def dense_grid_from_numpy(obj: Any, device) -> DenseGrid:
    """DenseGrid on ``device`` from the JAX package's DenseGrid fields
    (flat slots widened to i64)."""
    f32 = lambda n: torch.from_numpy(_get(obj, n).astype(np.float32)).to(device)
    return DenseGrid(
        flat=torch.from_numpy(_get(obj, "flat").astype(np.int64)).to(device),
        px=f32("px"), py=f32("py"), vx=f32("vx"), vy=f32("vy"),
        valid=torch.from_numpy(_get(obj, "valid").astype(bool)).to(device),
        n_dropped=torch.tensor(int(_get(obj, "n_dropped")),
                               dtype=torch.int32, device=device),
    )


def grid_state_to_numpy(gs: GridState) -> Dict[str, np.ndarray]:
    """The GridState's fields as numpy arrays (tick as u32, as in JAX)."""
    out = {n: getattr(gs, n).cpu().numpy() for n in _GRID_FIELDS}
    out["tick"] = out["tick"].astype(np.uint32)
    return out


def objects_from(obj: Any, device) -> Objects:
    """Objects on ``device`` from the JAX package's (same fields)."""
    v = {n: torch.from_numpy(_get(obj, n)).to(device) for n in _OBJECT_FIELDS}
    v["kind"] = v["kind"].to(torch.int32)
    for n in _OBJECT_FIELDS[1:]:
        v[n] = v[n].to(torch.float32)
    return Objects(**v)


def forcefield_from_numpy(field: Any, device) -> torch.Tensor:
    """A push-out field f32[H, W, 2] on ``device``."""
    return torch.from_numpy(np.array(field, dtype=np.float32)).to(device)


def sharded_state_from_numpy(obj: Any, devices) -> ShardedState:
    """The port's ShardedState from the JAX package's (global arrays:
    position and velocity f32[D*C, 2], valid bool[D*C], tick), cut into
    one slab per device of ``devices`` (D of them)."""
    pos, vel = _get(obj, "position"), _get(obj, "velocity")
    valid = _get(obj, "valid").astype(bool)
    d = len(devices)
    c = pos.shape[0] // d
    t = lambda a, i, dev: torch.from_numpy(np.ascontiguousarray(
        a[i * c:(i + 1) * c])).to(dev)
    return ShardedState(tuple(
        Slab(position=t(pos.astype(np.float32), i, dev),
             velocity=t(vel.astype(np.float32), i, dev),
             valid=t(valid, i, dev),
             tick=torch.tensor(int(_get(obj, "tick")), dtype=torch.int64,
                               device=dev))
        for i, dev in enumerate(devices)))


def sharded_state_to_numpy(state: ShardedState) -> Dict[str, np.ndarray]:
    """The slabs joined into the JAX package's global arrays, as numpy
    (tick as u32)."""
    join = lambda n: np.concatenate([getattr(s, n).cpu().numpy()
                                     for s in state.slabs])
    return dict(position=join("position"), velocity=join("velocity"),
                valid=join("valid"),
                tick=np.asarray(int(state.tick), dtype=np.uint32))
