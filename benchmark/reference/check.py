"""The readings that decide ``correct``, each a number that a limit holds
(``benchmark/limits/<cell>.json``).

* ``start_gap``: the state the app holds once it is handed the inputs,
  against the inputs (exact: 0).
* The window's state at its close: ``tick_gap`` (ticks it advanced less
  the steps the window asked for), ``lost`` (particles the engine dropped,
  and particles missing from its state), ``nonfinite`` (particles with a
  coordinate or velocity not finite), ``outside`` (particles outside the
  box); each exact, 0.
* ``pos_gap`` / ``vel_gap``: from the window's last state, the window's
  own step (its captured graph, replayed once a call) runs ``check_steps``
  more times; each step is held to one reference step (``sph.step``, float64)
  from the program's state before it (``compare.state_gaps``), the widest
  gap over the steps counted. The reference step takes the state's tick,
  and for a resident grid the engine's visit order of coincident predicted
  particles from their slots (``sph.resident_visit``). Beside them, not
  held by a limit: ``pred_tie_max``, the most particles that share one
  predicted point in any of those steps (1: none share).
* ``frame_gap``: each sampled frame of the window against the reference's
  frame of the state it was rendered from (``render.frame``).

Imports nothing of the program.
"""

from __future__ import annotations

import torch

from . import compare, render, sph


def window_invariants(pos, vel, lost: int, n: int, ph: dict) -> dict:
    ok = torch.isfinite(pos).all(1) & torch.isfinite(vel).all(1)
    # the walls as float32 holds them (a particle on a wall sits at them)
    half = torch.tensor(ph["size"], dtype=torch.float32,
                        device=pos.device) * 0.5
    outside = (pos[ok].abs() > half).any(1)
    return dict(lost=int(lost) + abs(n - int(pos.shape[0])),
                nonfinite=int((~ok).sum()), outside=int(outside.sum()))


def reference_step(state, ph: dict, dtype=torch.float64):
    """One reference step from a check state (pos, vel, tick, slots)."""
    pos, vel, tick, slots = state
    visit = (None if slots is None else
             sph.resident_visit(slots, sph.predict(pos, vel, ph), ph))
    return sph.step(pos, vel, ph, dtype, tick, visit)


def step_gaps(states, ph: dict, dtype=torch.float64) -> dict:
    """The widest gaps of the program's steps ``states[i] -> states[i+1]``
    (each (pos, vel, tick, slots)) against one reference step each
    (computed in ``dtype``), and ``pred_tie_max``."""
    pos_gap = vel_gap = 0.0
    ties = 1
    for s0, (p1, v1, _, _) in zip(states, states[1:]):
        rp, rv = reference_step(s0, ph, dtype)
        g = compare.state_gaps(p1, v1, rp.double(), rv.double(), ph["h"],
                               ph["size"])
        pos_gap = max(pos_gap, g["pos_gap"])
        vel_gap = max(vel_gap, g["vel_gap"])
        _, count = torch.unique(sph.predict(s0[0], s0[1], ph), dim=0,
                                return_counts=True)
        ties = max(ties, int(count.max()))
    return dict(pos_gap=pos_gap, vel_gap=vel_gap, pred_tie_max=ties)


def frame_gaps(kept, config: dict, mix: dict, dtype=torch.float64) -> dict:
    """The widest channel gap, in levels, of the frames ``kept`` ((u8
    array, (pos, vel))) against the reference's frames of their states."""
    dom = config["domain"]
    gap = 0
    for rgba8, (pos, vel) in kept:
        ref = render.frame(pos, vel, tuple(dom["size"]),
                           dom["smoothing_radius"], int(mix["width"]),
                           int(mix["height"]), dtype)
        gap = max(gap, compare.frame_gap(
            torch.as_tensor(rgba8).to(ref.device), ref))
    return dict(frame_gap=gap)


def control_gaps(states, kept, config: dict, mix: dict,
                 dtype=torch.bfloat16) -> dict:
    """The control's readings: the reference computed in ``dtype`` put in
    the program's place, from the same states and frames, held to the
    float64 reference by the same comparisons."""
    ph = sph.physics(config)
    pos_gap = vel_gap = 0.0
    for s0 in states[:-1]:
        cp, cv = reference_step(s0, ph, dtype)
        rp, rv = reference_step(s0, ph, torch.float64)
        g = compare.state_gaps(cp.double(), cv.double(), rp, rv, ph["h"],
                               ph["size"])
        pos_gap = max(pos_gap, g["pos_gap"])
        vel_gap = max(vel_gap, g["vel_gap"])
    out = dict(pos_gap=pos_gap, vel_gap=vel_gap)
    if kept:
        dom = config["domain"]
        args = (tuple(dom["size"]), dom["smoothing_radius"],
                int(mix["width"]), int(mix["height"]))
        out["frame_gap"] = max(
            compare.frame_gap(render.frame(p, v, *args, dtype),
                              render.frame(p, v, *args, torch.float64))
            for _, (p, v) in kept)
    return out
