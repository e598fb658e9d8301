"""Headless app shell (port of ``tpufluid.app.FluidApp``).

The reference's event loop as a Python API (src/main.rs:20-318): the
Running/Render/Step/Stopped state machine with its fixed-timestep
accumulator, ticks and burst ``run()``, obstacles, the capacity policies,
the offline render mode (16 ticks per frame, src/main.rs:153-216) and
checkpoints, and video force fields (one grayscale frame per rendered
frame). Engines: ``"resident"`` (the slot grid kept between steps, with
the loss audit and regrow-and-replay) and the per-step engines of
``step.make_step``: ``"grid"``, ``"naive"``, ``"dense"`` and ``"pallas"``;
each takes every variant flag.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .native import distfield
from .params import SimSettings, TickParams, suggest_cell_capacity
from .state import init_state
from .step import NEIGHBOR_MODES, make_multi_step, make_step
from .ops import forcefield as ff
from .ops import render as renderops
from .ops import render_binned, render_grid
from .ops import resident as residentops
from .utils import io as ioutils
from .utils.profiling import StepTimer, health_check


class SimState(enum.Enum):
    RUNNING = "running"
    RENDER = "render"
    STEP = "step"
    STOPPED = "stopped"


class FluidApp:
    """Owns settings, tick params, obstacles and the step on one device."""

    # frame-drop bailout threshold (src/main.rs:143-146)
    FRAME_BUDGET = 1.0 / 90.0
    # offline render cadence (src/main.rs:199-201)
    TICKS_PER_RENDER_FRAME = 16

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
                 params: Optional[TickParams] = None,
                 objects: Optional[ff.Objects] = None,
                 capacity_policy: str = "grow", *,
                 device, neighbor_mode: str = "resident",
                 x_boundary: Optional[str] = None,
                 surface_tension: bool = False,
                 adaptive_subsampling: bool = False):
        """capacity_policy, for the engines with a cell capacity
        (resident, dense, pallas): ``"grow"`` (default) sizes the capacity
        up front (resident: for the spawn lattice, then regrows + replays
        on any counted loss; dense/pallas: for the modelled compression
        peak, having no runtime regrow); ``"strict"`` refuses undersized
        scenes (and the resident engine raises on loss); ``"fixed"`` keeps
        the capacity (the resident engine warns on loss). grid and naive
        are not sized."""
        if neighbor_mode not in ("resident",) + NEIGHBOR_MODES:
            raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}")
        self._resident = neighbor_mode == "resident"
        self.neighbor_mode = neighbor_mode
        self.device = torch.device(device)
        self.settings = settings
        self.params = params or TickParams.default(self.device)
        if capacity_policy not in ("grow", "strict", "fixed"):
            raise ValueError(f"unknown capacity_policy {capacity_policy!r}")
        self._capacity_policy = capacity_policy
        bounded = neighbor_mode in ("resident", "dense", "pallas")
        if bounded and capacity_policy == "grow":
            # resident starts lean (rest occupancy): the loss audit +
            # regrow-and-replay is the backstop; dense/pallas have none,
            # so they are sized for the compression peak
            rec = (suggest_cell_capacity(self.settings) if self._resident
                   else suggest_cell_capacity(self.settings, self.params))
            if settings.cell_capacity < rec:
                self.settings = dataclasses.replace(settings,
                                                    cell_capacity=rec)
        elif bounded and capacity_policy == "strict":
            raw = suggest_cell_capacity(self.settings, self.params,
                                        safety=1.0, rounded=False)
            if settings.cell_capacity < raw:
                rec = suggest_cell_capacity(self.settings, self.params)
                raise ValueError(
                    f"cell_capacity={settings.cell_capacity} is undersized "
                    f"for this scene: gravity/EOS compression needs ~{rec} "
                    f"(suggest_cell_capacity). Raise cell_capacity, use "
                    f"neighbor_mode='grid', or pass capacity_policy='grow' "
                    f"(auto-size) / 'fixed' (accept counted mass loss: "
                    f"GridState.lost, health_check).")
        self._step_kw = dict(x_boundary=x_boundary or "bounce",
                             surface_tension=surface_tension,
                             adaptive_subsampling=adaptive_subsampling)
        self._video_fields = []
        self._video_index = 0
        self.set_objects(objects if objects is not None
                         else ff.Objects.empty(self.device))
        self.n_regrows = 0
        self._shrink_streak = 0
        self.state = init_state(self.settings, self.device)
        self.sim_state = SimState.STOPPED
        self.accumulator = 0.0
        self.dropped_frames = 0
        self.timer = StepTimer(self.device)

    # ---------------------------------------------------------------- control

    def toggle_running(self) -> None:  # Space (src/main.rs:246-254)
        if self.sim_state is SimState.STOPPED:
            self.accumulator = 0.0
            self.sim_state = SimState.RUNNING
        else:
            self.sim_state = SimState.STOPPED

    def request_step(self) -> None:  # N key (src/main.rs:255-257)
        self.sim_state = SimState.STEP

    def start_render(self) -> None:  # Enter key (src/main.rs:261-269)
        self.restart()
        self.sim_state = SimState.RENDER

    def restart(self) -> None:  # egui restart button (src/renderer.rs:873-875)
        self.state = init_state(self.settings, self.device)
        self.accumulator = 0.0
        self.n_regrows = 0

    def set_objects(self, objects: ff.Objects) -> None:
        """Replace the obstacle set and recompute its push-out field on the
        device; the step is rebuilt when obstacles appear or disappear."""
        self.objects = objects.to(self.device)
        has = len(self.objects) > 0
        self._forcefield = (ff.obstacle_force_field(self.objects,
                                                    self.settings)
                            if has else None)
        self._rebuild_step()

    def set_mouse(self, pos=None, state: Optional[int] = None) -> None:
        """World-space impulse source: ``pos`` (x, y) and ``state`` -1
        repel / +1 attract / 0 off; either may be left as it is. Written
        into the params' tensors in place, so anything holding them (a
        captured graph) sees the change."""
        if pos is not None:
            pos = torch.as_tensor(pos, dtype=torch.float32)
            if pos.shape != (2,):
                raise ValueError(f"mouse pos must be (x, y), got shape "
                                 f"{tuple(pos.shape)}")
            self.params.mouse_pos.copy_(pos)
        if state is not None:
            self.params.mouse_state.fill_(int(state))

    def set_video_field(self, frames) -> None:
        """Drive the obstacle force field from grayscale frames u8[T, H, W]
        of the texture's size (completes reference component 2.15, whose
        upload the reference left commented out, src/main.rs:120-126).
        Dark pixels (<= 128) are obstacles. Each frame's chamfer field is
        computed once, here, on the app's device; ``tick`` and ``run`` use
        the current one, and the offline render mode moves to the next
        after each rendered frame (``advance_video_frame``)."""
        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError(f"expected u8[T, H, W], got {frames.shape}")
        th, tw = frames.shape[1:]
        if (tw, th) != tuple(self.settings.texture_size):
            raise ValueError(
                f"frame size {(tw, th)} != texture_size "
                f"{self.settings.texture_size}")
        self._video_fields = [distfield.chamfer_push_field(f, self.device)
                              for f in frames]
        self._video_index = 0
        self._forcefield = self._video_fields[0]
        self._rebuild_step()

    def advance_video_frame(self) -> None:
        """Move to the next video field, cycling; no-op without one."""
        if self._video_fields:
            self._video_index = ((self._video_index + 1)
                                 % len(self._video_fields))
            self._forcefield = self._video_fields[self._video_index]

    def _rebuild_step(self) -> None:
        has_ff = self._forcefield is not None
        if self._resident:
            self._step = residentops.make_grid_step(
                self.settings, has_force_field=has_ff, **self._step_kw)
        else:
            self._step = make_step(self.settings,
                                   neighbor_mode=self.neighbor_mode,
                                   has_force_field=has_ff, **self._step_kw)

    def _ff_args(self) -> tuple:
        """The step's extra argument: the push-out field, if any."""
        return () if self._forcefield is None else (self._forcefield,)

    # ------------------------------------------------------------------ state

    @property
    def state(self):
        """The ParticleState; in resident mode materialised from the grid
        on access."""
        if self._resident and self._state_dirty:
            self._state, _ = residentops.to_particles(self._grid_state,
                                                      self.settings)
            self._state_dirty = False
        return self._state

    @state.setter
    def state(self, value):
        self._state = value
        self._state_dirty = False
        if not self._resident:
            return
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
        if not self._resident:
            self._state = self._step(self._state, self.params,
                                     *self._ff_args())
            self.timer.lap()
            return
        self._grid_state = self._step(self._grid_state, self.params,
                                      *self._ff_args())
        self._state_dirty = True
        self.timer.lap()
        self._ticks_since_snapshot += 1
        self._ticks_since_audit += 1
        if self._ticks_since_audit >= self.LOSS_CHECK_EVERY:
            self._ticks_since_audit = 0
            self._audit_loss()

    def run(self, n_steps: int, max_burst: int = 64) -> None:
        """Advance ``n_steps`` ticks in bursts of at most ``max_burst``,
        queued without a host sync; live tuning applies at burst
        boundaries, and in resident mode the loss audit runs every <=
        LOSS_CHECK_EVERY ticks, at a burst boundary."""
        if n_steps <= 0:
            return
        if max_burst < 1:
            raise ValueError("max_burst must be >= 1")
        remaining = n_steps
        if not self._resident:
            while remaining:
                b = next(s for s in self._BURST_SIZES
                         if s <= max_burst and s <= remaining)
                run_fn = make_multi_step(
                    self.settings, b, neighbor_mode=self.neighbor_mode,
                    has_force_field=self._forcefield is not None,
                    **self._step_kw)
                self._state = run_fn(self._state, self.params,
                                     *self._ff_args())
                self.timer.laps(b)
                remaining -= b
            return
        while remaining:
            room = self.LOSS_CHECK_EVERY - self._ticks_since_audit
            b = next(s for s in self._BURST_SIZES
                     if s <= max_burst and s <= remaining
                     and s <= max(room, 1))
            run_fn = residentops.make_grid_multi_step(
                self.settings, b,
                has_force_field=self._forcefield is not None,
                **self._step_kw)
            self._grid_state = run_fn(self._grid_state, self.params,
                                      *self._ff_args())
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
                self._grid_state = self._step(self._grid_state, self.params,
                                              *self._ff_args())
            self._state_dirty = True
            lost = int(self._grid_state.lost)
            if lost <= lost0:
                self._snapshot = self._grid_state
                self._lost_baseline = lost
                self._ticks_since_snapshot = 0
                return

    def advance(self, wall_dt: float) -> int:
        """Fixed-timestep accumulator: run as many ticks as wall time owes,
        bailing out when the burst overruns the frame budget
        (src/main.rs:137-147). Returns the ticks run."""
        if self.sim_state is SimState.STOPPED:
            return 0
        if self.sim_state is SimState.STEP:
            self.tick()
            self.sim_state = SimState.STOPPED
            return 1
        delta = float(self.params.delta)
        if delta == 0.0:
            return 0
        self.accumulator += wall_dt
        ticks = 0
        start = time.perf_counter()
        while self.accumulator > delta:
            self.tick()
            self.accumulator -= delta
            ticks += 1
            if time.perf_counter() - start > self.FRAME_BUDGET:
                self.dropped_frames += int(self.accumulator / delta)
                self.accumulator = 0.0
                break
        return ticks

    # ----------------------------------------------------------------- render

    def render_frame(self, width: int = 960, height: int = 540,
                     camera: Optional[renderops.Camera] = None,
                     mode: str = "metaball") -> torch.Tensor:
        """rgba f32[H, W, 4] on the app's device. ``metaball``: the fluid
        surface, in resident mode shaded straight off the slot grid
        (``ops.render_grid``), else by the per-pixel binned renderer;
        ``metaball_exact``: the binned renderer; ``particles``: point
        sprites."""
        cam = camera or renderops.Camera(view_size=(
            self.settings.size[0], self.settings.size[0] * height / width))
        if mode == "metaball" and self._resident:
            return render_grid.render_metaball_grid(
                self._grid_state, self.settings, width, height, cam)
        if mode in ("metaball", "metaball_exact"):
            return render_binned.render_metaball_binned(
                self.state, self.settings, width, height, cam)
        if mode == "particles":
            return render_binned.render_particles_binned(
                self.state, self.settings, width, height, cam)
        raise ValueError(f"unknown render mode {mode!r}")

    def iter_frames(self, frames: int, width: int = 960, height: int = 540,
                    mode: str = "metaball",
                    progress: Optional[Callable[[int], None]] = None):
        """The offline render mode (src/main.rs:153-216) as a generator:
        16 ticks per frame, then one u8[H, W, 4] numpy frame. Frame i runs
        under video field i (mod T): the reference decodes one packet per
        rendered frame from the first frame on (src/main.rs:154-197), so
        the field advances after each frame."""
        self.sim_state = SimState.RENDER
        for i in range(frames):
            self.run(self.TICKS_PER_RENDER_FRAME)
            frame = self.render_frame(width, height, mode=mode)
            yield renderops.to_rgba8(frame).cpu().numpy()
            self.advance_video_frame()
            if progress:
                progress(i)
        self.sim_state = SimState.STOPPED

    def render_sequence(self, out_dir: str, frames: int, width: int = 960,
                        height: int = 540, mode: str = "metaball",
                        progress: Optional[Callable[[int], None]] = None):
        """Offline render to PNGs ``out_dir/frame_00000.png``, ...; returns
        the paths."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, rgba8 in enumerate(self.iter_frames(frames, width, height,
                                                   mode, progress)):
            path = os.path.join(out_dir, f"frame_{i:05d}.png")
            paths.append(ioutils.write_png(path, rgba8))
        return paths

    def render_mp4(self, path: str, frames: int, width: int = 960,
                   height: int = 540, mode: str = "metaball", fps: int = 30,
                   progress: Optional[Callable[[int], None]] = None) -> str:
        """Offline render straight to an mp4 (needs an ffmpeg binary: the
        check comes before any frame is rendered)."""
        return ioutils.save_mp4(
            path, self.iter_frames(frames, width, height, mode, progress),
            fps=fps)

    # -------------------------------------------------------------- metrics

    def metrics(self, deep: bool = False) -> dict:
        """Tick, steps/s and drop counters; in resident mode also the loss
        and capacity counters (one or two device reads). ``deep=True``
        adds ``health_check`` (NaN counts, bounds, peak cell occupancy
        against the capacity, top speed), which reads the whole state
        back and re-bins it: for debugging, not the hot loop."""
        src = self._grid_state if self._resident else self._state
        out = dict(
            tick=int(src.tick),
            sim_state=self.sim_state.value,
            steps_per_sec=self.timer.last_rate,
            particle_steps_per_sec=(self.timer.last_rate
                                    * self.settings.particle_count),
            dropped_frames=self.dropped_frames,
        )
        if self._resident:
            out.update(lost_particles=int(self._grid_state.lost),
                       n_regrows=self.n_regrows,
                       cell_capacity=self.settings.cell_capacity)
        if deep:
            out.update(health_check(self.state, self.settings))
        return out

    # ------------------------------------------------------------ checkpoint

    def save(self, path: str) -> None:
        ioutils.save_checkpoint(path, self.state)

    def load(self, path: str) -> None:
        self.state = ioutils.load_checkpoint(path, self.device)
