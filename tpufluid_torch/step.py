"""The per-step engines (port of ``tpufluid.step``).

One step (src/simulation.rs:502-538): predict -> cell keys -> stable sort
and segment starts -> density -> forces + integrate. The returned state is
in cell-sorted order. Four neighbour modes share the integration:

* ``"grid"``: fixed-shape 3x3-cell windows over the sorted array
  (``ops.grid.neighbor_windows``) and the pair math of ``ops.pairs``; the
  reference-faithful engine, pinned by the golden trajectory and the numpy
  oracle;
* ``"naive"``: all-pairs candidates, the O(N^2) oracle for tests;
* ``"dense"``: the slot grid ``[Gy, K, Gxp]`` rebuilt every step and the
  roll formulation of ``ops.dense``, whose density and forces are the
  hand-written CUDA kernels ``dense_density`` and ``dense_forces`` on a
  CUDA device (bitwise the roll passes, which run on the CPU);
* ``"pallas"``: the same slot grid through ``ops.sph``, whose density and
  forces are the hand-written CUDA kernels ``csrc/sph_density.cu`` and
  ``csrc/sph_forces.cu`` on a CUDA device (the name is the JAX package's,
  kept for API parity; there the two passes are Pallas TPU kernels).

A step waits for nothing on the host: every tunable is read on the device
and every constant tensor is made once per device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import graphs
from .params import EPSILON, MAX_SPEED, SimSettings
from .state import ParticleState
from .ops import dense as denseops
from .ops import grid as gridops
from .ops import pairs
from .ops import prng
from .ops import sph

NEIGHBOR_MODES = ("grid", "naive", "dense", "pallas")


@functools.lru_cache(maxsize=None)
def _consts(settings: SimSettings, device: torch.device) -> dict:
    """The step's constant tensors on ``device`` (f32 as in the JAX step)."""
    size = np.asarray(settings.size, np.float32)
    tex = np.asarray(settings.texture_size, np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return dict(half=t(size * np.float32(0.5)), bounds=t(size), tex=t(tex),
                pixel_to_world=t((size * np.float32(2.0)) / tex))


def predict_positions(position, velocity, delta, settings: SimSettings):
    """pos + vel * dt, clamped to the half-bounds box (compute.wgsl:8-30)."""
    half = _consts(settings, position.device)["half"]
    pred = position + velocity * delta
    return torch.where(pred.abs() > half, half * torch.sign(pred), pred)


def sample_force_field(predicted, forcefield, settings: SimSettings):
    """The obstacle push-out field at predicted positions
    (compute.wgsl:127-132, with its 2x pixel-to-world scale).
    ``forcefield``: f32[H, W, 2] push-out vectors in pixels. Returns
    (force in pixels [N, 2], force in world units [N, 2])."""
    c = _consts(settings, predicted.device)
    uv = predicted / c["bounds"] + 0.5
    texel = (uv * c["tex"]).to(torch.int32)
    tx = torch.clamp(texel[..., 0], 0, settings.texture_size[0] - 1)
    ty = torch.clamp(texel[..., 1], 0, settings.texture_size[1] - 1)
    force = forcefield[ty.long(), tx.long()]
    return force, force * c["pixel_to_world"]


def _apply_force_field(position, velocity, predicted, forcefield, damping,
                       settings: SimSettings):
    """Push-out and normal-velocity damping (compute.wgsl:127-140)."""
    force, force_world = sample_force_field(predicted, forcefield, settings)
    fx, fy = force[..., 0], force[..., 1]
    hit = ((fx != 0.0) | (fy != 0.0))[..., None]
    norm = torch.sqrt(fx * fx + fy * fy)[..., None]
    nhat = force / torch.where(norm == 0.0, 1.0, norm)
    vn = (velocity[..., 0] * nhat[..., 0]
          + velocity[..., 1] * nhat[..., 1])[..., None]
    new_vel = velocity - (1.0 - damping) * vn * nhat
    return (torch.where(hit, position + force_world, position),
            torch.where(hit, new_vel, velocity))


def _integrate(position, velocity, predicted, density, accel, params,
               settings: SimSettings, forcefield: Optional[torch.Tensor],
               x_boundary: str = "bounce"):
    """The velocity and position update of move_particle
    (compute.wgsl:95-155)."""
    dt = params.delta
    velocity = velocity + (accel / density[..., None]) * dt
    velocity = velocity + params.gravity * dt

    # mouse impulse (compute.wgsl:99-108): diff / dist^2 scaled by
    # power * state * (dist / radius); dist 0 under a press is the
    # reference's 0/0 = NaN, which the NaN reset below zeroes
    diff = params.mouse_pos - predicted
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    safe = torch.where(dist == 0.0, 1.0, dist)
    scale = (params.mouse_force_power * params.mouse_state.to(torch.float32)
             * (dist / params.mouse_force_radius))
    impulse = diff / (safe * safe)[..., None] * scale[..., None]
    impulse = torch.where((dist == 0.0)[..., None], float("nan"), impulse)
    apply = (params.mouse_state != 0) & (dist <= params.mouse_force_radius)
    velocity = torch.where(apply[..., None], velocity + impulse, velocity)

    # NaN reset: any NaN component zeroes the velocity (compute.wgsl:113-116)
    nan_any = torch.isnan(velocity).any(dim=-1, keepdim=True)
    velocity = torch.where(nan_any, 0.0, velocity)

    # speed clamp (compute.wgsl:118-122)
    speed = torch.sqrt(velocity[..., 0] * velocity[..., 0]
                       + velocity[..., 1] * velocity[..., 1])[..., None]
    fast = speed > MAX_SPEED
    velocity = torch.where(
        fast, velocity / torch.where(fast, speed, 1.0) * MAX_SPEED, velocity)

    position = position + velocity * dt
    if forcefield is not None:
        position, velocity = _apply_force_field(
            position, velocity, predicted, forcefield, params.damping_factor,
            settings)

    # walls: bounce with v *= -damping per axis (compute.wgsl:143-153), or
    # "wrap": teleport across the x walls, velocity untouched
    # (shaders/compute.wgsl:145-146)
    half = _consts(settings, position.device)["half"]
    out = position.abs() > half
    if x_boundary == "wrap":
        px, py = position[..., 0], position[..., 1]
        px = torch.where(out[..., 0], -half[0] * torch.sign(px), px)
        py = torch.where(out[..., 1], half[1] * torch.sign(py), py)
        vy = torch.where(out[..., 1], velocity[..., 1] * -params.damping_factor,
                         velocity[..., 1])
        return (torch.stack([px, py], dim=-1),
                torch.stack([velocity[..., 0], vy], dim=-1))
    position = torch.where(out, half * torch.sign(position), position)
    velocity = torch.where(out, velocity * -params.damping_factor, velocity)
    return position, velocity


def make_step(settings: SimSettings, *, neighbor_mode: str = "grid",
              surface_tension: bool = False, has_force_field: bool = False,
              x_boundary: str = "bounce",
              adaptive_subsampling: bool = False):
    """``step(state, params)``, or ``step(state, params, forcefield)`` with
    ``has_force_field`` (forcefield: f32[H, W, 2] pixel push-out vectors of
    ``ops.forcefield``). The step runs where the state lies.

    Variants of the reference's forked shaders (SURVEY.md 2.12):
    ``x_boundary="wrap"`` teleports across the x walls
    (shaders/compute.wgsl:145-146); ``adaptive_subsampling`` strides each
    cell's pressure candidates by 1/5/13 as the particle's density crosses
    150/200 (shaders/compute.wgsl:170-174,195); ``surface_tension`` adds
    the colour-field force the reference leaves switched off
    (compute.wgsl:92).
    """
    return _make_step(settings, neighbor_mode, surface_tension,
                      has_force_field, x_boundary, adaptive_subsampling)


def make_plain_step(settings: SimSettings, **kw):
    """The pallas-mode step on the plain PyTorch versions of its two
    kernels (``sph.density_plain``, ``sph.forces_plain``), on any device:
    the reference that the CUDA step is held to on the card. Takes
    ``make_step``'s flags."""
    kw = dict(dict(surface_tension=False, has_force_field=False,
                   x_boundary="bounce", adaptive_subsampling=False), **kw)
    return _make_step(settings, "pallas", kw["surface_tension"],
                      kw["has_force_field"], kw["x_boundary"],
                      kw["adaptive_subsampling"],
                      passes=(sph.density_plain, sph.forces_plain))


def _make_step(settings: SimSettings, neighbor_mode: str,
               surface_tension: bool, has_force_field: bool,
               x_boundary: str, adaptive_subsampling: bool, passes=None,
               audit=None):
    """``audit(stage, *tensors)``, where given, sees each stage's output
    (``utils.debugging.checked_step``): ``input``, ``predict``,
    ``density``, ``forces``, ``integrate``."""
    audit = audit or (lambda stage, *tensors: None)
    if neighbor_mode not in NEIGHBOR_MODES:
        raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}")
    if x_boundary not in ("bounce", "wrap"):
        raise ValueError(f"unknown x_boundary {x_boundary!r}")
    norms = settings.kernel_norms()
    h = float(settings.smoothing_radius)
    sqr_radius = settings.sqr_radius

    def step(state: ParticleState, params,
             forcefield: Optional[torch.Tensor] = None) -> ParticleState:
        if has_force_field and forcefield is None:
            raise ValueError("step built with has_force_field=True needs a "
                             "forcefield argument")
        ff = forcefield if has_force_field else None
        frame = state.tick + 1
        audit("input", state.position, state.velocity)
        pred = predict_positions(state.position, state.velocity,
                                 params.delta, settings)
        audit("predict", pred)
        binning = gridops.bin_particles(gridops.cell_id(pred, settings),
                                        settings)
        perm = binning.perm
        n = perm.shape[0]

        if neighbor_mode in ("dense", "pallas"):
            # one row gather applies the sort to all six columns
            g6 = torch.cat([pred, state.velocity, state.position], dim=1)[perm]
            dens, fpx, fpy, fvx, fvy, _ = denseops.dense_forces_cols(
                g6[:, 0], g6[:, 1], g6[:, 2], g6[:, 3], binning.sorted_cells,
                settings, params, norms, frame,
                pallas=neighbor_mode == "pallas", passes=passes,
                surface_tension=surface_tension,
                adaptive_subsampling=adaptive_subsampling)
            accel = torch.stack([fpx + fvx, fpy + fvy], dim=-1)
            audit("density", dens)
            audit("forces", accel)
            pred_s, vel_s, pos_s = g6[:, 0:2], g6[:, 2:4], g6[:, 4:6]
            new_pos, new_vel = _integrate(pos_s, vel_s, pred_s, dens, accel,
                                          params, settings, ff, x_boundary)
            audit("integrate", new_pos, new_vel)
            return ParticleState(position=new_pos, predicted=pred_s,
                                 velocity=new_vel, density=dens,
                                 cell=binning.sorted_cells, tick=frame)

        pos_s, vel_s, pred_s = state.position[perm], state.velocity[perm], \
            pred[perm]
        sorted_idx = torch.arange(n, device=pred.device)
        if neighbor_mode == "grid":
            win = gridops.neighbor_windows(binning.sorted_cells,
                                           binning.cell_start, settings)
            nb_idx = win.idx.reshape(n, -1)
            nb_valid = win.valid.reshape(n, -1)
        else:
            nb_idx = sorted_idx[None, :].expand(n, n)
            nb_valid = torch.ones((n, n), dtype=torch.bool,
                                  device=pred.device)
        nb_pred = pred_s[nb_idx]

        # density, with the EPSILON and 0.1 floors in the reference's order
        # (funcs.wgsl:202, compute.wgsl:70)
        dens = pairs.density(pred_s, nb_pred, nb_valid, params.mass, h)
        dens = torch.clamp(torch.clamp(dens, min=EPSILON), min=0.1)
        audit("density", dens)

        # forces (compute.wgsl:160-299); tie-break seed: position hash plus
        # the frame salt (cf. compute.wgsl:161)
        nb_dens = dens[nb_idx]
        rand_seed = (prng.position_seed(pred_s) + frame * 69) & prng.U32
        nb_valid_pressure = nb_valid
        if adaptive_subsampling:
            # the rank in the cell run strided by 1/5/13 as the particle's
            # density crosses 150/200; candidates are in sorted order, so
            # this holds in naive mode too
            inc = (1 + torch.where(dens >= 150.0, 4, 0)
                   + torch.where(dens >= 200.0, 8, 0))
            cell_start = binning.cell_start.to(torch.int64)
            off_in_cell = nb_idx - cell_start[binning.sorted_cells[nb_idx]]
            nb_valid_pressure = nb_valid & (off_in_cell % inc[:, None] == 0)
        accel = pairs.pressure_force(
            sorted_idx, pred_s, dens, nb_idx, nb_pred, nb_dens,
            nb_valid_pressure, params.pressure_constant, params.rest_density,
            h, sqr_radius, norms.spiky_derivative, rand_seed)
        accel = accel + pairs.viscosity_force(
            sorted_idx, pred_s, vel_s, nb_idx, nb_pred, vel_s[nb_idx],
            nb_dens, nb_valid, params.viscosity_coefficient, h, sqr_radius,
            norms.viscosity)
        if surface_tension:
            # seed per compute.wgsl:406: WGSL u32(f32) saturates negatives
            # to 0, made explicit so every engine draws the same seed
            st_i = torch.clamp(pred_s[:, 0], min=0.0).to(torch.int32)
            st_seed = (st_i.to(torch.int64) * 324 + frame * 5632) & prng.U32
            accel = accel + pairs.surface_tension(
                pred_s, nb_pred, nb_dens, nb_valid, params.mass, h,
                sqr_radius, params.surface_tension_threshold,
                params.surface_tension_coefficient, st_seed)
        audit("forces", accel)

        new_pos, new_vel = _integrate(pos_s, vel_s, pred_s, dens, accel,
                                      params, settings, ff, x_boundary)
        audit("integrate", new_pos, new_vel)
        return ParticleState(position=new_pos, predicted=pred_s,
                             velocity=new_vel, density=dens,
                             cell=binning.sorted_cells, tick=frame)

    return step


_MULTI_STEP_CACHE: dict = {}


def make_multi_step(settings: SimSettings, n_steps: int, **kw):
    """``run(state, params[, forcefield])``: ``n_steps`` steps. On a CUDA
    device the burst replays the step's CUDA graph once a step
    (``graphs.burst``; the JAX package's ``jax.jit(lax.scan(step))``, no
    host work between steps), bitwise the eager burst of
    ``make_eager_multi_step``; a failed capture raises. On the CPU the
    eager burst, a Python loop. Memoised on its arguments, so
    ``FluidApp.run`` reuses one per burst size; the burst sizes of one step
    share its graph."""
    flags = tuple(sorted(kw.items()))
    hit = _MULTI_STEP_CACHE.get((settings, n_steps, flags))
    if hit is not None:
        return hit
    eager = make_eager_multi_step(settings, n_steps, **kw)
    what = (f"the {kw.get('neighbor_mode', 'grid')} step of "
            f"{settings.particle_count} particles")

    def body(state: ParticleState, params, *forcefield) -> ParticleState:
        # the state the next replay reads is the static one
        out = eager.step(state, params, *forcefield)
        for f in ("position", "velocity", "tick"):
            getattr(state, f).copy_(getattr(out, f))
        return out

    def run(state: ParticleState, params, *forcefield) -> ParticleState:
        dev = state.position.device
        if not graphs.graphable(dev):
            return eager(state, params, *forcefield)
        key = (settings, flags, dev, graphs.signature(params),
               tuple((tuple(f.shape), f.dtype) for f in forcefield))
        return graphs.burst(key, dev, n_steps, eager.step, body, what,
                            state, params, *forcefield)

    _MULTI_STEP_CACHE[settings, n_steps, flags] = run
    return run


def make_eager_multi_step(settings: SimSettings, n_steps: int, **kw):
    """``make_multi_step``'s burst as a Python loop of eager steps on any
    device: what the graphed burst is held to on the card."""
    step = make_step(settings, **kw)

    def run(state: ParticleState, params, *forcefield) -> ParticleState:
        for _ in range(n_steps):
            state = step(state, params, *forcefield)
        return state

    run.step = step
    return run

