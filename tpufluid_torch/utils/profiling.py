"""Step timing, trace capture and the health snapshot (port of
``StepTimer``, ``trace`` and ``health_check`` of
``tpufluid.utils.profiling``)."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StepTimer:
    """Steps/sec meter for work queued on ``device``. Call ``laps(n)``
    after each dispatch of ``n`` steps; it waits for the device only when
    a report is due, so the queue stays full in between."""

    device: torch.device
    report_every: int = 120
    _count: int = 0
    _t0: Optional[float] = None
    last_rate: float = 0.0

    def lap(self) -> Optional[float]:
        return self.laps(1)

    def laps(self, n: int) -> Optional[float]:
        if self._t0 is None:
            synchronize(self.device)
            self._t0 = time.perf_counter()
            return None
        self._count += n
        if self._count < self.report_every:
            return None
        synchronize(self.device)
        now = time.perf_counter()
        self.last_rate = self._count / (now - self._t0)
        self._count = 0
        self._t0 = now
        return self.last_rate


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler capture around a block (CPU, and CUDA where a device
    is present), written on exit as a Chrome trace
    ``logdir/trace_<pid>_<n>.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def health_check(state, settings) -> dict:
    """Host-side snapshot of a ParticleState: NaN counts, particles out of
    bounds, the peak cell occupancy against the capacity, the top speed.
    Cells come from the predicted positions (a fresh state's ``cell`` is
    all zeros). Reads the whole state back: not for the hot loop."""
    from ..ops import grid as gridops

    pos = state.position.detach().cpu().double()
    vel = state.velocity.detach().cpu().double()
    cells = gridops.cell_id(state.predicted, settings)
    occ = int(gridops.max_cell_occupancy(
        gridops.bin_particles(cells, settings).cell_start))
    half = torch.tensor(settings.size, dtype=torch.float64) * 0.5
    speed = torch.sqrt((vel * vel).sum(dim=1))
    return dict(
        nan_positions=int(torch.isnan(pos).sum()),
        nan_velocities=int(torch.isnan(vel).sum()),
        out_of_bounds=int((pos.abs() > half + 1e-4).any(dim=1).sum()),
        max_cell_occupancy=occ,
        cell_capacity=settings.cell_capacity,
        capacity_exceeded=occ > settings.cell_capacity,
        max_speed=float(speed.max()) if len(speed) else 0.0,
        tick=int(state.tick),
    )
