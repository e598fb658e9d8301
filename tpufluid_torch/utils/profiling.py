"""Step timing, trace capture and the health snapshot (port of
``StepTimer``, ``trace`` and ``health_check`` of
``tpufluid.utils.profiling``), and the program's spans and counters
(``span``, ``count``, ``record``).

Spans and counters record only while a ``torch.profiler`` session records
(``trace`` here, or any other session in the process); otherwise each is
one check of the profiler's flag. A span then enters a record function of
its name, so it shows among the profiler's events and in ``trace``'s
Chrome trace, and also appends a ``SpanRecord`` to the newest session's
``Record``, stamped with ``time.time_ns()``: the clock of the profiler's
own event times. Single-threaded, as the app is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StepTimer:
    """Steps/sec meter for work queued on ``device``. Call ``laps(n)``
    after each dispatch of ``n`` steps; the steps from the first call's
    dispatch on are counted, and a report is due every ``report_every``.

    On a CUDA device a report records a CUDA event and never waits:
    ``last_rate`` is the rate between the newest two report events that
    the device has passed (``Event.query``), so it trails the host by the
    work still queued. On the CPU a report reads the host clock."""

    device: torch.device
    report_every: int = 120
    _count: int = 0
    _t0: Optional[float] = None
    _rate: float = 0.0
    # CUDA: (event, steps since the previous one) of each report not yet
    # superseded by a newer completed one; the first is the clock's start
    _marks: list = dataclasses.field(default_factory=list)

    @property
    def last_rate(self) -> float:
        if len(self._marks) > 1:
            self._poll()
        return self._rate

    def lap(self) -> Optional[float]:
        return self.laps(1)

    def laps(self, n: int) -> Optional[float]:
        cuda = torch.device(self.device).type == "cuda"
        if self._t0 is None and not self._marks:
            if cuda:
                self._mark(0)
            else:
                self._t0 = time.perf_counter()
            return None
        self._count += n
        if self._count < self.report_every:
            return None
        if cuda:
            self._mark(self._count)
            self._poll()
        else:
            now = time.perf_counter()
            self._rate = self._count / (now - self._t0)
            self._t0 = now
        self._count = 0
        return self._rate

    def _mark(self, steps: int) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        self._marks.append((ev, steps))

    def _poll(self) -> None:
        """The rate over the newest completed pair of marks; the marks
        before that pair's first are dropped."""
        for i in range(len(self._marks) - 1, 0, -1):
            ev, steps = self._marks[i]
            if ev.query():  # the stream passes its events in order
                ms = self._marks[i - 1][0].elapsed_time(ev)
                if ms > 0:
                    self._rate = steps / (ms * 1e-3)
                del self._marks[:i]
                return


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


# ------------------------------------------------- spans and counters

@dataclass
class SpanRecord:
    """One span of a session: ``parent`` is the index of the span it
    opened in (-1: none), ``start_ns`` / ``end_ns`` are ``time.time_ns()``
    (``end_ns`` 0 while open), ``request`` the request it served (the
    serial of the outermost ``FluidApp.run`` call, or the frame's index in
    ``iter_frames``; None outside both), ``counts`` the counters made while
    it was the innermost open span."""

    name: str
    parent: int
    start_ns: int
    end_ns: int
    request: Optional[int]
    counts: dict


@dataclass
class Record:
    """The spans and counters of one profiler session: ``spans`` in the
    order they opened, ``counts`` every counter's total (those made with
    no span open among them)."""

    session: int
    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)


# serial of the profiler sessions started in this process, bumped by
# _run_on_profiler_start (below); the newest session's record; the spans
# (_Span) open in it, innermost last
_SESSIONS = [0]
_RECORD = Record(session=0)
_OPEN: list = []


def _watch_sessions() -> None:
    """Count profiler sessions: every ``torch.autograd.profiler`` session
    (which ``torch.profiler.profile`` runs) calls
    ``_run_on_profiler_start`` as it starts."""
    start = _autograd_profiler._run_on_profiler_start

    def started():
        _SESSIONS[0] += 1
        start()

    _autograd_profiler._run_on_profiler_start = started


_watch_sessions()

# A span's record function, of the function scope: ``record_function``'s
# user scope also lays an annotation over the device's timeline, which a
# reader of the trace's device activity (the benchmark's ``trace.read``)
# takes for device work.
_function_range = torch._C._profiler._RecordFunctionFast


def recording() -> bool:
    """Whether a profiler session records (one flag check)."""
    return _autograd_profiler._is_profiler_enabled


def _current() -> Record:
    """The record of the session now recording, started anew (and the
    open spans forgotten) when the session changed."""
    global _RECORD
    if _RECORD.session != _SESSIONS[0]:
        _RECORD = Record(session=_SESSIONS[0])
        _OPEN.clear()
    return _RECORD


def record() -> Record:
    """The spans and counters of the newest profiler session that made
    any; reading does not clear it."""
    return _RECORD


def _add(rec: Record, i: int, name: str, n: int) -> None:
    rec.counts[name] = rec.counts.get(name, 0) + n
    if i >= 0:
        c = rec.spans[i].counts
        c[name] = c.get(name, 0) + n


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (and to
    the session's total), while a profiler session records."""
    if not recording():
        return
    rec = _current()
    _add(rec, _OPEN[-1].i if _OPEN else -1, name, n)


def _device_allocs(device) -> int:
    return torch.cuda.memory_stats_as_nested_dict(device)["num_device_alloc"]


class _Span:
    __slots__ = ("name", "request", "device", "rec", "i", "fn", "allocs")

    def __init__(self, name, request, device):
        self.name, self.request, self.device = name, request, device

    def __enter__(self):
        self.fn = _function_range(self.name)
        self.fn.__enter__()
        rec = self.rec = _current()
        parent = _OPEN[-1].i if _OPEN else -1
        request = (rec.spans[parent].request if parent >= 0 else None)
        if request is None:
            request = self.request
        self.i = len(rec.spans)
        rec.spans.append(SpanRecord(self.name, parent, time.time_ns(), 0,
                                    request, {}))
        # outermost spans only: an allocator read costs ~27 us of host
        # time, and inside a frame both ends fall where the device waits
        self.allocs = (_device_allocs(self.device)
                       if self.device is not None and not _OPEN else None)
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        if self.allocs is not None:
            _add(self.rec, self.i, "device_allocs",
                 _device_allocs(self.device) - self.allocs)
        self.rec.spans[self.i].end_ns = time.time_ns()
        if _OPEN and _OPEN[-1] is self:
            _OPEN.pop()
        self.fn.__exit__(*exc)
        return False


_NOT_RECORDING = contextlib.nullcontext()


def span(name: str, request: Optional[int] = None, device=None):
    """A context manager around a layer of the program, named
    ``tpufluid_torch.<layer>``. With no profiler session recording it is
    a shared no-op (one flag check). While one records: a record
    function ``name`` and a ``SpanRecord`` in the session's
    record, whose request is the enclosing span's or else ``request``;
    with a CUDA ``device``, when no other span is open, its counter
    ``device_allocs`` takes the rise of the caching allocator's
    ``num_device_alloc`` (its ``cudaMalloc`` calls) across the span."""
    if not recording():
        return _NOT_RECORDING
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _Span(name, request, device)


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
