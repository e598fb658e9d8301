"""Headless app shell, resident engine (port of ``tpufluid.app.FluidApp``).

Ticks and burst ``run()``, and the capacity policies with the resident
engine's loss audit and regrow-and-replay. Only
``neighbor_mode="resident"`` with the base variant is ported; the rest
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from .params import SimSettings, TickParams, suggest_cell_capacity
from .state import init_state
from .ops import resident as residentops
from .utils.profiling import StepTimer


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


class FluidApp:
    """Owns settings, tick params and the resident step on one device."""

    # ticks between runtime mass-loss audits (one device->host sync each)
    LOSS_CHECK_EVERY = 256
    LOSS_FRACTION = 1e-3
    # capacity regrow ceiling (slots/cell)
    MAX_CELL_CAPACITY = 512
    # shrink-back hysteresis: one tile down after this many consecutive
    # clean audits whose peak occupancy clears the smaller capacity by
    # the margin
    SHRINK_AFTER_AUDITS = 2
    SHRINK_MARGIN = 2
    # burst sizes used by run()
    _BURST_SIZES = (64, 16, 4, 1)

    def __init__(self, settings: SimSettings = SimSettings(),
                 params: Optional[TickParams] = None, objects=None,
                 capacity_policy: str = "grow", *,
                 device, neighbor_mode: str = "resident",
                 x_boundary: Optional[str] = None,
                 surface_tension: bool = False,
                 adaptive_subsampling: bool = False):
        """capacity_policy: ``"grow"`` (default) sizes the capacity for the
        spawn lattice and regrows + replays on any counted loss;
        ``"strict"`` refuses undersized scenes and raises on loss;
        ``"fixed"`` keeps the capacity and warns on loss."""
        if neighbor_mode != "resident":
            _unported(f"neighbor_mode={neighbor_mode!r}",
                      "queue 1, grid and naive engines")
        if objects is not None:
            _unported("obstacles", "queue 1, forcefield.py")
        self.device = torch.device(device)
        self.settings = settings
        self.params = params or TickParams.default(self.device)
        if capacity_policy not in ("grow", "strict", "fixed"):
            raise ValueError(f"unknown capacity_policy {capacity_policy!r}")
        self._capacity_policy = capacity_policy
        if capacity_policy == "grow":
            # start lean (rest occupancy); the loss audit + regrow-and-replay
            # is the backstop
            rec = suggest_cell_capacity(self.settings)
            if settings.cell_capacity < rec:
                self.settings = dataclasses.replace(settings,
                                                    cell_capacity=rec)
        elif capacity_policy == "strict":
            raw = suggest_cell_capacity(self.settings, self.params,
                                        safety=1.0, rounded=False)
            if settings.cell_capacity < raw:
                rec = suggest_cell_capacity(self.settings, self.params)
                raise ValueError(
                    f"cell_capacity={settings.cell_capacity} is undersized "
                    f"for this scene: gravity/EOS compression needs ~{rec} "
                    f"(suggest_cell_capacity). Raise cell_capacity, or pass "
                    f"capacity_policy='grow' (auto-size + regrow) / 'fixed' "
                    f"(accept counted mass loss, GridState.lost).")
        self._step_kw = dict(x_boundary=x_boundary or "bounce",
                             surface_tension=surface_tension,
                             adaptive_subsampling=adaptive_subsampling)
        self._step = residentops.make_grid_step(self.settings, **self._step_kw)
        self.n_regrows = 0
        self._shrink_streak = 0
        self.state = init_state(self.settings, self.device)
        self.timer = StepTimer(self.device)

    def restart(self) -> None:  # egui restart button (src/renderer.rs:873-875)
        self.state = init_state(self.settings, self.device)
        self.n_regrows = 0

    def _rebuild_step(self) -> None:
        self._step = residentops.make_grid_step(self.settings, **self._step_kw)

    # ------------------------------------------------------------------ state

    @property
    def state(self):
        """ParticleState view, materialised from the grid on access."""
        if self._state_dirty:
            self._state, _ = residentops.to_particles(self._grid_state,
                                                      self.settings)
            self._state_dirty = False
        return self._state

    @state.setter
    def state(self, value):
        self._state = value
        self._state_dirty = False
        self._grid_state = residentops.from_particles(value, self.settings)
        if self._capacity_policy == "grow":
            # binning drops regrow at once: the source particles are still
            # in hand, so nothing is lost (one device sync per load)
            while int(self._grid_state.lost) > 0:
                k = self.settings.cell_capacity
                new_k = -(-(k + max(8, k // 4)) // 8) * 8
                if new_k > self.MAX_CELL_CAPACITY:
                    break  # leave the counted loss; the audit reports it
                self.settings = dataclasses.replace(self.settings,
                                                    cell_capacity=new_k)
                self._rebuild_step()
                self._grid_state = residentops.from_particles(value,
                                                              self.settings)
        # regrow-and-replay bookkeeping
        self._snapshot = self._grid_state
        self._lost_baseline = None  # resolved at the first audit
        self._ticks_since_snapshot = 0
        self._ticks_since_audit = 0

    @property
    def grid_state(self) -> residentops.GridState:
        return self._grid_state

    # ------------------------------------------------------------------- tick

    def tick(self) -> None:
        self._grid_state = self._step(self._grid_state, self.params)
        self._state_dirty = True
        self.timer.lap()
        self._ticks_since_snapshot += 1
        self._ticks_since_audit += 1
        if self._ticks_since_audit >= self.LOSS_CHECK_EVERY:
            self._ticks_since_audit = 0
            self._audit_loss()

    def run(self, n_steps: int, max_burst: int = 64) -> None:
        """Advance ``n_steps`` ticks in bursts of at most ``max_burst``;
        the loss audit runs every <= LOSS_CHECK_EVERY ticks, at a burst
        boundary, and live tuning applies at burst boundaries."""
        if n_steps <= 0:
            return
        if max_burst < 1:
            raise ValueError("max_burst must be >= 1")
        remaining = n_steps
        while remaining:
            room = self.LOSS_CHECK_EVERY - self._ticks_since_audit
            b = next(s for s in self._BURST_SIZES
                     if s <= max_burst and s <= remaining
                     and s <= max(room, 1))
            run_fn = residentops.make_grid_multi_step(self.settings, b,
                                                      **self._step_kw)
            self._grid_state = run_fn(self._grid_state, self.params)
            self._state_dirty = True
            self.timer.laps(b)
            self._ticks_since_snapshot += b
            self._ticks_since_audit += b
            remaining -= b
            if self._ticks_since_audit >= self.LOSS_CHECK_EVERY:
                self._ticks_since_audit = 0
                self._audit_loss()

    def _audit_loss(self) -> None:
        """Runtime mass-loss audit (one device->host sync). Under "grow" a
        lossy stretch is replayed from the last loss-free snapshot at a
        wider capacity, which is bitwise the always-wide trajectory."""
        lost = int(self._grid_state.lost)
        lost0 = self._lost_baseline
        if lost0 is None:  # first audit: the snapshot's own count
            lost0 = int(self._snapshot.lost)
        if lost > lost0 and self._capacity_policy == "grow":
            self._regrow_and_replay(lost0)
            return
        if (lost > lost0
                and lost > self.LOSS_FRACTION * self.settings.particle_count):
            msg = (f"resident engine shed {lost} of "
                   f"{self.settings.particle_count} particles "
                   f"(cell_capacity {self.settings.cell_capacity} exceeded "
                   f"by compression): raise cell_capacity or use "
                   f"capacity_policy='grow'")
            if self._capacity_policy == "strict":
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning)
        self._snapshot = self._grid_state
        self._lost_baseline = lost
        self._ticks_since_snapshot = 0
        if self._capacity_policy == "grow":
            self._maybe_shrink()

    def _maybe_shrink(self) -> None:
        """Give back capacity left by a transient-compression regrow: the
        rebin kernel writes all K output slots, so headroom costs memory
        traffic every step."""
        k = self.settings.cell_capacity
        new_k = k - 8
        if new_k < 8:
            self._shrink_streak = 0
            return
        occ = int(self._grid_state.occ_row.max())
        if occ > new_k - self.SHRINK_MARGIN:
            self._shrink_streak = 0
            return
        self._shrink_streak += 1
        if self._shrink_streak < self.SHRINK_AFTER_AUDITS:
            return
        self._shrink_streak = 0
        self.settings = dataclasses.replace(self.settings, cell_capacity=new_k)
        self._rebuild_step()
        self._grid_state = residentops.shrink_capacity(self._grid_state, new_k)
        self._snapshot = self._grid_state
        self._state_dirty = True

    def _regrow_and_replay(self, lost0: int) -> None:
        self._shrink_streak = 0
        replay = self._ticks_since_snapshot
        # one event per overflow, however many widenings it needs
        self.n_regrows += 1
        while True:
            k = self.settings.cell_capacity
            new_k = -(-(k + max(8, k // 4)) // 8) * 8
            if new_k > self.MAX_CELL_CAPACITY:
                raise RuntimeError(
                    f"capacity regrow exceeded {self.MAX_CELL_CAPACITY} "
                    f"slots/cell")
            self.settings = dataclasses.replace(self.settings,
                                                cell_capacity=new_k)
            self._rebuild_step()
            self._grid_state = residentops.grow_capacity(self._snapshot, new_k)
            # replay with the current params
            for _ in range(replay):
                self._grid_state = self._step(self._grid_state, self.params)
            self._state_dirty = True
            lost = int(self._grid_state.lost)
            if lost <= lost0:
                self._snapshot = self._grid_state
                self._lost_baseline = lost
                self._ticks_since_snapshot = 0
                return

    # -------------------------------------------------------------- metrics

    def metrics(self) -> dict:
        """Tick, steps/s, loss and capacity counters (two device reads)."""
        return dict(
            tick=int(self._grid_state.tick),
            steps_per_sec=self.timer.last_rate,
            particle_steps_per_sec=(self.timer.last_rate
                                    * self.settings.particle_count),
            lost_particles=int(self._grid_state.lost),
            n_regrows=self.n_regrows,
            cell_capacity=self.settings.cell_capacity,
        )

    # ------------------------------------------------------ not ported yet

    def render_frame(self, *args, **kwargs):
        _unported("rendering", "queue 1, render")

    def set_objects(self, objects) -> None:
        _unported("obstacles", "queue 1, forcefield.py")

    def set_video_field(self, frames) -> None:
        _unported("video force fields", "queue 1, forcefield.py")

    def save(self, path: str) -> None:
        _unported("checkpoints", "queue 1, utils/io.py checkpoints")

    def load(self, path: str) -> None:
        _unported("checkpoints", "queue 1, utils/io.py checkpoints")
