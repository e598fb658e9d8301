"""NaN/Inf provenance debugging (port of ``tpufluid.utils.debugging``).

The reference's only NaN story is the silent in-kernel velocity reset
(compute.wgsl:113-116): a blowup leaves no trace of where it started.
Two tools:

* ``checked_step``: an [N]-engine step (``step.make_step``) that audits
  the output of each of its stages for NaN and reports the first stage
  that produced one. The JAX package wraps its step in
  ``jax.experimental.checkify``; torch has none, so the audit is explicit,
  one host read per stage. That is fine for a debug tool; ``make_step``
  itself reads nothing back.
* ``diagnose_resident_step``: runs ONE resident step stage by stage
  (rebin -> density -> forces + integrate, through the same kernels as
  ``ops.resident``) and reports per-stage finiteness, occupancy and loss,
  localising a blowup to the stage that first produced a non-finite
  value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import fused
from ..ops import resident
from ..params import SimSettings, TickParams
from ..step import _make_step


@dataclasses.dataclass(frozen=True)
class StageError:
    """The outcome of one checked step: ``stage`` names the first stage
    whose output held a NaN, or is None when the step was clean."""

    stage: Optional[str] = None
    neighbor_mode: str = ""

    def get(self) -> Optional[str]:
        """The error message, or None when clean."""
        if self.stage is None:
            return None
        return (f"NaN first produced at stage {self.stage!r} of the "
                f"{self.neighbor_mode!r} step")

    def throw(self) -> None:
        """Raise FloatingPointError naming the stage; a no-op when clean."""
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


def checked_step(settings: SimSettings, neighbor_mode: str = "dense",
                 **step_kw):
    """``step(state, params[, forcefield]) -> (err, new_state)``: the step
    of ``make_step(settings, neighbor_mode=..., **step_kw)`` with a NaN
    audit after each stage (``input``, ``predict``, ``density``,
    ``forces``, ``integrate``). ``err.throw()`` raises with the first
    stage that produced a NaN.

    Only NaN counts, not Inf, as in the JAX package: the step divides by
    guarded denominators on purpose (an infinity is produced, then masked,
    like the reference's own guarded divisions).

    Example::

        step = checked_step(settings)
        err, state = step(state, params)
        err.throw()   # no-op when clean
    """
    kw = dict(dict(surface_tension=False, has_force_field=False,
                   x_boundary="bounce", adaptive_subsampling=False),
              **step_kw)
    first = []

    def audit(stage, *tensors):
        if not first and any(bool(torch.isnan(t).any()) for t in tensors):
            first.append(stage)

    base = _make_step(settings, neighbor_mode, kw["surface_tension"],
                      kw["has_force_field"], kw["x_boundary"],
                      kw["adaptive_subsampling"], audit=audit)

    def step(state, params, *forcefield):
        first.clear()
        out = base(state, params, *forcefield)
        return StageError(first[0] if first else None, neighbor_mode), out

    return step


def diagnose_resident_step(gs: resident.GridState, params: TickParams,
                           settings: SimSettings,
                           forcefield: Optional[torch.Tensor] = None) -> dict:
    """Stage-level audit of one resident step, on the host.

    Returns {stage: {"finite": bool, "occ_max": int, ...}} for the stages
    ``input``, ``rebin``, ``density``, ``forces``, in that order; the first
    stage with ``finite == False`` is where the blowup entered. ``rebin``
    adds the far-mover and overflow counts (``far``, ``over``; the step's
    far-mover reinsert is not run), ``density`` the largest pressure and
    density of a live slot (``pres_max``, ``rho_max``).
    """
    settings = resident.pad_capacity(settings)
    report = {}

    def stat(name, px, py, vx, vy, occ_row, extra=None):
        live = px < fused.SENTINEL_HALF
        finite = all(bool(torch.isfinite(torch.where(live, a, 0.0)).all())
                     for a in (px, py, vx, vy))
        row = dict(
            finite=finite,
            live=int(live.sum()),
            occ_max=int(occ_row.max()),
            speed_max=float(torch.where(live, vx.abs() + vy.abs(),
                                        0.0).max()),
        )
        if extra:
            row.update(extra)
        report[name] = row

    stat("input", gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row)

    px, py, vx, vy, occ_row, far_n, over_n = fused.rebin(
        gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, params.delta,
        settings)
    stat("rebin", px, py, vx, vy, occ_row,
         extra=dict(far=int(far_n.sum()), over=int(over_n.sum())))

    pres, invr = fused.density(
        px, py, vx, vy, occ_row, params.mass, params.delta,
        params.pressure_constant, params.rest_density, settings)
    live = px < fused.SENTINEL_HALF
    report["density"] = dict(
        finite=(bool(torch.isfinite(torch.where(live, pres, 0.0)).all())
                and bool(torch.isfinite(torch.where(live, invr, 0.0)).all())),
        pres_max=float(torch.where(live, pres, 0.0).max()),
        rho_max=float(torch.where(live, 1.0 / invr, 0.0).max()),
    )

    ff_cells = None
    if forcefield is not None:
        ff_cells = resident.forcefield_cells(forcefield, settings,
                                             px.shape[-1])
    npx, npy, nvx, nvy = fused.forces_integrate(
        px, py, vx, vy, pres, invr, occ_row, params, settings, gs.tick + 1,
        ff_cells=ff_cells)
    stat("forces", npx, npy, nvx, nvy, occ_row)
    return report
