"""The traced slice: ``torch.profiler`` (CPU and CUDA activities) held in
memory over a bounded slice of the window, read into plain records that
the per-layer metric readers take.

The harness opens a ``record_function`` span around each call it makes
into the program in the slice (``app.run`` for a call of the run loop,
``frame`` for a frame of ``iter_frames``) and one span around the whole
slice (``slice``), which ends after a ``torch.cuda.synchronize()``. Each
device operation (kernel, memcpy, memset) is tied to the CUDA runtime call
that launched it by their correlation id, and through that call's host
time to the harness's span around it. No Chrome trace is written.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Callable, Optional

from benchmark import roofline

SLICE = "slice"
# runtime calls that wait for the device
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
GRAPH_LAUNCH = ("cudaGraphLaunch",)
# the program's kernels by their CUDA function names (csrc/*.cu)
KERNEL_NAMES = {
    "rebin": re.compile(r"(?<![A-Za-z0-9_])rebin_kernel"),
    "density": re.compile(r"(?<![A-Za-z0-9_])density_kernel"),
    "forces_integrate": re.compile(r"(?<![A-Za-z0-9_])forces_kernel"),
    "physics": re.compile(r"(?<![A-Za-z0-9_])physics_kernel"),
    "metaball_coarse": re.compile(r"metaball_coarse_kernel"),
}


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy", "memset"
    start: float  # seconds on the trace's clock
    end: float
    span: Optional[str]  # the harness span around its launch, if any
    launch: Optional[str]  # the runtime call that launched it


@dataclasses.dataclass
class HostCall:
    name: str
    start: float
    end: float
    span: Optional[str]


@dataclasses.dataclass
class Trace:
    """One traced slice. ``steps``: the program's steps in the slice;
    ``frames``: its frames; ``states``: the resident grid states at its
    start and end (none for the per-step engines)."""

    window: tuple
    device_ops: list
    host_calls: list
    spans: list
    engine: str = ""
    steps: int = 0
    frames: int = 0
    states: tuple = ()
    linked: float = 0.0  # share of device operations tied to a launch

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self, keep: Callable[[DeviceOp], bool] = lambda op: True):
        """Seconds of the window in which a kept operation ran (the union
        of their intervals, clipped to the window)."""
        lo, hi = self.window
        ivs = sorted((max(op.start, lo), min(op.end, hi))
                     for op in self.device_ops if keep(op))
        total, cur_s, cur_e = 0.0, None, None
        for s, e in ivs:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def work(self, kernel: str):
        """(bytes, operations) of one launch of a resident kernel
        (``roofline.work``), the mean over the slice's grid states; None
        without them."""
        if not self.states:
            return None
        w = [roofline.work(kernel, g.pos_x, g.occ_row) for g in self.states]
        return tuple(sum(x) / len(w) for x in zip(*w))

    def kernels(self, name: str):
        """The program kernel ``name``'s launches (``KERNEL_NAMES``)."""
        pat = KERNEL_NAMES[name]
        return [op for op in self.device_ops
                if op.kind == "kernel" and pat.search(op.name)]

    def host_count(self, names, span: str) -> int:
        """Runtime calls named in ``names`` (a version suffix such as
        ``_v10000`` ignored) made inside the harness's ``span``."""
        return sum(1 for c in self.host_calls
                   if c.span == span and c.name.split("_v")[0] in names)

    def idle_gaps(self, top: int = 10):
        """The device's idle gaps in the window, summed by what the host
        was doing at each gap's start (the innermost host call or span
        open then), longest first: [[label, seconds], ...]."""
        lo, hi = self.window
        ivs = sorted((op.start, op.end) for op in self.device_ops)
        gaps, t = [], lo
        for s, e in ivs:
            if s > t:
                gaps.append((t, min(s, hi)))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        opened = sorted(self.host_calls + self.spans, key=lambda c: c.start)
        starts = [c.start for c in opened]
        sums = {}
        for s, e in gaps:
            if e <= s:
                continue
            label = "host"
            # the latest-opened call still open at s is the innermost
            i = bisect.bisect_right(starts, s)
            for c in reversed(opened[max(0, i - 256):i]):
                if c.end > s:
                    label = c.name
                    break
            sums[label] = sums.get(label, 0.0) + (e - s)
        return sorted(([k, v] for k, v in sums.items()),
                      key=lambda kv: -kv[1])[:top]

    def device_top(self, top: int = 10):
        """[[name, seconds], ...]: device operations by total time."""
        sums = {}
        for op in self.device_ops:
            sums[op.name] = sums.get(op.name, 0.0) + (op.end - op.start)
        return sorted(([k, v] for k, v in sums.items()),
                      key=lambda kv: -kv[1])[:top]


def _kind(ev) -> Optional[str]:
    """'kernel', 'memcpy', 'memset' for a device event, else None."""
    if "CUDA" not in str(ev.device_type()):
        return None
    act = str(getattr(ev, "activity_type", lambda: "")()).lower()
    if "annotation" in act:  # a span's shadow on the device's timeline
        return None
    name = ev.name().lower()
    if "memcpy" in act or name.startswith("memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("memset"):
        return "memset"
    return "kernel"


def read(prof, span_names, engine: str = "", steps: int = 0,
         frames: int = 0, states=()) -> Trace:
    """The slice of a stopped ``torch.profiler.profile``: its device
    operations, its CUDA runtime calls and the harness's spans named in
    ``span_names`` (and ``SLICE``), read from the profiler's events in
    memory."""
    results = prof.profiler.kineto_results
    base = getattr(results, "trace_start_ns", lambda: 0)()
    spans, host, dev = [], [], []
    for ev in results.events():
        s = (ev.start_ns() - base) * 1e-9  # small numbers keep the ns
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        kind = _kind(ev)
        if kind is not None:
            if name != SLICE and name not in span_names:
                dev.append((ev, kind, s, e))
            continue
        if name == SLICE or name in span_names:
            spans.append(HostCall(name, s, e, None))
        elif name.startswith("cu"):
            host.append((ev, HostCall(name, s, e, None)))
    win = [c for c in spans if c.name == SLICE]
    if not win:
        raise RuntimeError("the traced slice has no span named 'slice'")
    window = (win[0].start, win[0].end)
    outer = sorted((c for c in spans if c.name != SLICE),
                   key=lambda c: c.start)

    def span_at(t: float) -> Optional[str]:
        for c in outer:  # spans do not nest; few hundred at most
            if c.start <= t <= c.end:
                return c.name
        return None

    by_corr = {}
    calls = []
    for ev, call in host:
        call.span = span_at(call.start)
        calls.append(call)
        by_corr[ev.correlation_id()] = call
    ops, n_linked = [], 0
    for ev, kind, s, e in dev:
        call = (by_corr.get(ev.correlation_id())
                or by_corr.get(ev.linked_correlation_id()))
        n_linked += call is not None
        ops.append(DeviceOp(ev.name(), kind, s, e,
                            call.span if call else None,
                            call.name if call else None))
    return Trace(window=window, device_ops=ops, host_calls=calls,
                 spans=outer, engine=engine, steps=steps, frames=frames,
                 states=tuple(states),
                 linked=n_linked / len(ops) if ops else 0.0)
