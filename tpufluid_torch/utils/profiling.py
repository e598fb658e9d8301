"""Step timing (port of ``tpufluid.utils.profiling.StepTimer``)."""

from __future__ import annotations

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
