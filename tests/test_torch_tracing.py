"""PyTorch port, the program's own tracing on the CPU
(``tpufluid_torch.utils.profiling``): the spans and counters that
``FluidApp``, the render and the graphs record while a ``torch.profiler``
session records, and nothing without one; the six benchmark readers of
that record (``benchmark/layer_metrics/``); and ``StepTimer``'s rate on
the host clock and from its CUDA events (events faked here)."""

import dataclasses
import importlib.util
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpufluid_torch as tt
from tpufluid_torch.app import FluidApp
from tpufluid_torch.ops import render
from tpufluid_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
READERS = ("readback_ms_per_frame", "render_host_ms_per_frame",
           "tick_host_ms_per_frame", "burst_host_ms_per_step",
           "host_reads_per_kstep", "device_allocs_per_kstep")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _app(policy="fixed", k=16):
    """A 256-particle resident app whose loss audit comes every 8 ticks."""
    s = tt.SimSettings(particle_count=256, size=(3.2, 3.2), cell_capacity=k)
    app = FluidApp(s, capacity_policy=policy, device="cpu")
    app.LOSS_CHECK_EVERY = 8
    return app


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, profiling.record()


def _by_name(rec):
    out = {}
    for i, s in enumerate(rec.spans):
        out.setdefault(s.name, []).append((i, s))
    return out


def test_no_profiler_records_nothing(monkeypatch):
    """Without a session no span enters its record function and the
    record is left as it was."""
    rec = profiling.record()
    before = (len(rec.spans), dict(rec.counts))

    def refuse(name):
        raise AssertionError(f"record function {name!r} entered")

    monkeypatch.setattr(profiling, "_function_range", refuse)
    app = _app()
    app.run(20)
    for _ in app.iter_frames(2, 48, 27):
        pass
    assert profiling.record() is rec
    assert (len(rec.spans), rec.counts) == before
    if rec.session == 0:  # no session has recorded in this process
        assert rec.spans == [] and rec.counts == {}


def test_spans_parents_requests_and_reads():
    """A resident run whose audit fires, then two frames: each span under
    its parent, the run's serial and the frames' indices as requests, a
    ``host_reads`` at each read; each span's record-function twin in the
    profiler's events under its name, starting within 2 ms of it, and
    none of them a user annotation (which would lay a shadow over the
    device's timeline)."""
    app = _app()
    app.run(4)  # the first audit's baseline read comes in the session
    serial = app._runs + 1
    render.clear_tables()  # the first frame builds the render's two tables

    def work():
        app.run(20)  # audits at ticks 8, 16, 24
        for _ in app.iter_frames(2, 48, 27):
            pass

    prof, rec = _profiled(work)
    names = _by_name(rec)
    (i_run, run), = [(i, s) for i, s in names["tpufluid_torch.run"]
                     if s.parent == -1]
    assert run.request == serial
    kids = [s.name[15:] for s in rec.spans if s.parent == i_run]
    # bursts of 4 from tick 4, an audit at each multiple of 8
    assert kids == ["burst", "audit"] + ["burst", "burst", "audit"] * 2
    audits = [s for s in rec.spans if s.parent == i_run
              and s.name == "tpufluid_torch.audit"]
    # first audit: the loss and the snapshot's; then the loss alone
    assert [a.counts for a in audits] == [{"host_reads": 2},
                                          {"host_reads": 1},
                                          {"host_reads": 1}]
    frames = names["tpufluid_torch.frame"]
    assert [(s.parent, s.request) for _, s in frames] == [(-1, 0), (-1, 1)]
    for n, (i_f, f) in enumerate(frames):
        kids = [(j, s) for j, s in enumerate(rec.spans) if s.parent == i_f]
        assert [s.name for _, s in kids] == [
            "tpufluid_torch.run", "tpufluid_torch.render",
            "tpufluid_torch.readback"]
        assert all(s.request == n for _, s in kids)
        assert kids[2][1].counts == {"host_reads": 1}
        i_r = kids[1][0]
        assert [(s.name, s.counts) for s in rec.spans if s.parent == i_r] == [
            ("tpufluid_torch.render.coarse", {}),
            ("tpufluid_torch.render.resample",
             {"render_tables": 1} if n == 0 else {}),
            ("tpufluid_torch.render.shade",
             {"render_tables": 1} if n == 0 else {}),
            ("tpufluid_torch.rgba8", {})]
        assert f.start_ns <= kids[0][1].start_ns <= kids[2][1].end_ns \
            <= f.end_ns
    # the run's first audit reads two, each other audit (two in the run,
    # two a frame) one; and each frame's readback
    assert rec.counts == {"host_reads": 2 + 2 + 2 * 2 + 2,
                          "render_tables": 2}
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)
    assert "device_allocs" not in str(rec.spans)  # none on the CPU

    twins = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("tpufluid_torch."):
            twins.setdefault(ev.name(), []).append(ev.start_ns())
            assert not ev.is_user_annotation(), ev.name()
    for s in rec.spans:
        gap = min(abs(t - s.start_ns) for t in twins[s.name])
        assert gap < 2e6, (s.name, gap)


def test_render_tables_built_in_the_first_frame():
    """Over iter_frames(4) of one size the render's constants (the
    camera's bilinear matrices, the shading's colours) are built once
    each, in the first frame, and frames 2-4 build none."""
    app = _app()
    render.clear_tables()
    _, rec = _profiled(lambda: list(app.iter_frames(4, 48, 27)))
    builds = [0] * 4
    for s in rec.spans:
        builds[s.request] += s.counts.get("render_tables", 0)
    assert builds == [2, 0, 0, 0]
    assert rec.counts["render_tables"] == 2


def test_regrow_shrink_and_state_spans():
    """The grow policy's spans: the ``state`` setter, a regrow (a gravity
    spike as in test_torch_resident's regrow test) and a shrink
    (two clean audits at K=16 over the spawn lattice), with their
    reads."""
    s = tt.SimSettings(particle_count=128, size=(3.2, 3.2), cell_capacity=8)
    app = FluidApp(s, device="cpu")
    app.LOSS_CHECK_EVERY = 8
    st0 = tt.init_state(s, "cpu")
    st0.velocity[:, 1] -= 20.0

    def regrow():
        app.state = st0
        app.params.gravity = torch.tensor([0.0, -60.0])
        app.run(16, max_burst=4)

    _, rec = _profiled(regrow)
    assert app.n_regrows >= 1
    names = _by_name(rec)
    (_, state), = names["tpufluid_torch.state"]
    assert state.parent == -1 and state.counts == {"host_reads": 1}
    regrows = names["tpufluid_torch.regrow"]
    assert len(regrows) == app.n_regrows
    for _, r in regrows:
        assert rec.spans[r.parent].name == "tpufluid_torch.audit"
        assert r.counts["host_reads"] >= 1

    shrink = _app(policy="grow", k=16)
    _, rec = _profiled(lambda: shrink.run(24))
    assert shrink.settings.cell_capacity == 8
    names = _by_name(rec)
    (_, sh), = names["tpufluid_torch.shrink"]
    assert rec.spans[sh.parent].name == "tpufluid_torch.audit"
    # audits: loss, snapshot, occupancy; loss, occupancy (the shrink);
    # the loss alone at the floor K=8
    assert [s.counts for _, s in names["tpufluid_torch.audit"]] == [
        {"host_reads": 3}, {"host_reads": 2}, {"host_reads": 1}]


def test_a_new_session_clears_the_record():
    app = _app()
    _, first = _profiled(lambda: app.run(4))
    assert [s.name for s in first.spans] == ["tpufluid_torch.run",
                                             "tpufluid_torch.burst"]
    _, empty = _profiled(lambda: None)
    assert empty is first  # a session that makes nothing keeps it
    _, second = _profiled(lambda: app.run(8))
    assert second is not first and second.session > first.session
    assert [s.name[15:] for s in second.spans] == ["run", "burst", "audit",
                                                   "burst"]
    assert second.counts == {"host_reads": 2}
    assert profiling.record() is second


def test_device_allocs_count_at_the_outermost_span(monkeypatch):
    """``device_allocs`` on a CUDA device (the allocator's count faked):
    an outermost span given the device counts the rise across it; one
    inside another span does not, as the frame's run."""
    allocs = iter(range(0, 100, 3))  # three more at each read
    monkeypatch.setattr(profiling, "_device_allocs", lambda dev: next(allocs))
    cuda = torch.device("cuda")

    def work():
        with profiling.span("tpufluid_torch.frame", 0):
            with profiling.span("tpufluid_torch.run", None, cuda):
                pass
        with profiling.span("tpufluid_torch.run", 7, cuda):
            with profiling.span("tpufluid_torch.burst"):
                pass
        with profiling.span("tpufluid_torch.run", 8, "cpu"):
            pass

    _, rec = _profiled(work)
    assert [(s.name[15:], s.request, s.counts) for s in rec.spans] == [
        ("frame", 0, {}), ("run", 0, {}),
        ("run", 7, {"device_allocs": 3}), ("burst", 7, {}), ("run", 8, {})]
    assert rec.counts == {"device_allocs": 3}


def test_span_names_leave_the_harness_spans_alone():
    """``benchmark/trace.py`` keeps the harness's spans by name and the
    runtime calls by the prefix ``cu``: no program span may look like
    either."""
    import re

    names = set()
    for path in (ROOT / "tpufluid_torch").rglob("*.py"):
        names |= set(re.findall(r'span\("([^"]+)"', path.read_text()))
    assert {"tpufluid_torch.run", "tpufluid_torch.burst",
            "tpufluid_torch.capture", "tpufluid_torch.frame",
            "tpufluid_torch.readback"} <= names
    for n in names:
        assert n.startswith("tpufluid_torch.")
        assert n not in ("slice", "app.run", "frame")


# ------------------------------------------------------------ readers

def _reader(name):
    path = ROOT / "benchmark" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, parent, start_ms, end_ms, request=None, **counts):
    return profiling.SpanRecord(name, parent, int(start_ms * 1e6),
                                int(end_ms * 1e6), request, counts)


def _trace(steps=0, frames=0):
    from benchmark.trace import Trace

    return Trace(window=(0.0, 1.0), device_ops=[], host_calls=[], spans=[],
                 engine="resident", steps=steps, frames=frames)


def test_readers_on_a_hand_built_record(monkeypatch):
    p = "tpufluid_torch."
    frames = profiling.Record(session=-1, spans=[
        _span(p + "frame", -1, 0.0, 7.0, 0),
        _span(p + "run", 0, 0.1, 1.6, 0, device_allocs=0),
        _span(p + "burst", 1, 0.2, 1.0, 0),
        _span(p + "render", 0, 1.6, 2.6, 0),
        _span(p + "readback", 0, 2.6, 6.9, 0, host_reads=1),
        _span(p + "frame", -1, 7.0, 14.0, 1),
        _span(p + "run", 5, 7.1, 9.6, 1),
        _span(p + "render", 5, 9.6, 10.1, 1),
        _span(p + "readback", 5, 10.1, 13.9, 1, host_reads=1)],
        counts={"host_reads": 2})
    steps = profiling.Record(session=-1, spans=[
        _span(p + "run", -1, 0.0, 3.0, 1, device_allocs=2),
        _span(p + "burst", 0, 0.5, 1.5, 1),
        _span(p + "burst", 0, 1.5, 2.0, 1),
        _span(p + "audit", 0, 2.0, 2.5, 1, host_reads=2),
        _span(p + "run", -1, 3.0, 4.0, 2, device_allocs=1),
        _span(p + "burst", 4, 3.0, 3.75, 2)],
        counts={"host_reads": 2})
    read = {n: _reader(n) for n in READERS}

    monkeypatch.setattr(profiling, "record", lambda: frames)
    t = _trace(steps=32, frames=2)
    assert read["readback_ms_per_frame"](t) == pytest.approx(8.1 / 2)
    assert read["render_host_ms_per_frame"](t) == pytest.approx(1.5 / 2)
    assert read["tick_host_ms_per_frame"](t) == pytest.approx(4.0 / 2)
    for n in ("burst_host_ms_per_step", "host_reads_per_kstep",
              "device_allocs_per_kstep"):
        assert read[n](t) is None, n  # steps metrics: not in frames

    monkeypatch.setattr(profiling, "record", lambda: steps)
    t = _trace(steps=250)
    assert read["burst_host_ms_per_step"](t) == pytest.approx(2.25 / 250)
    assert read["host_reads_per_kstep"](t) == pytest.approx(8.0)
    assert read["device_allocs_per_kstep"](t) == pytest.approx(12.0)
    for n in READERS[:3]:
        assert read[n](t) is None, n  # frames metrics: not in steps

    # without their spans (a program that records none) each reads None
    monkeypatch.setattr(profiling, "record",
                        lambda: profiling.Record(session=-1))
    for n in READERS:
        assert read[n](_trace(steps=32, frames=2)) is None, n
        assert read[n](_trace(steps=250)) is None, n
    # on the CPU the runs carry no device_allocs
    cpu = dataclasses.replace(steps, spans=[
        dataclasses.replace(s, counts={}) for s in steps.spans])
    monkeypatch.setattr(profiling, "record", lambda: cpu)
    assert read["device_allocs_per_kstep"](_trace(steps=250)) is None
    assert read["host_reads_per_kstep"](_trace(steps=250)) == 8.0


def test_harness_reports_the_cpu_metrics(tmp_path):
    """``run_cell(..., trace=True, device="cpu")`` on the harness's tiny
    tree: the traced slice of the resident steps cell reports the burst's
    host ms and the host reads; the card-only metrics stay out."""
    from benchmark import run
    from benchmark.tests.test_bench_harness import _tiny_tree

    root = _tiny_tree(tmp_path)
    spec = run.load_spec(root)
    res = run.run_cell(spec, run.workload(spec, "sph1m-steps"), 2**31 + 19,
                       0.2, True, device="cpu", here=root / "benchmark",
                       root=root)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["burst_host_ms_per_step"]["value"] > 0.0
    assert m["burst_host_ms_per_step"]["unit"] == "ms"
    assert m["host_reads_per_kstep"]["value"] == 0.0  # no audit in 4 steps
    assert "device_allocs_per_kstep" not in m


# ------------------------------------------------------------ the timer

def test_step_timer_on_the_cpu_reports_a_rate():
    t = profiling.StepTimer(torch.device("cpu"), report_every=8)
    assert t.laps(4) is None  # starts the clock
    time.sleep(0.01)
    assert t.laps(4) is None
    rate = t.laps(4)
    assert rate is not None and 0.0 < rate < 8 / 0.01
    assert t.last_rate == rate


class _FakeEvent:
    """A CUDA event on a fake clock: done once ``now`` reaches its time."""

    clock = {"now": 0.0}

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = self.clock["pending"]

    def query(self):
        return self.t <= self.clock["now"]

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return (other.t - self.t) * 1e3


def test_step_timer_reads_its_events_without_waiting(monkeypatch):
    """On a CUDA device each report records an event; the rate is the
    newest pair the device has passed, and older marks are dropped."""
    clock = _FakeEvent.clock
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    t = profiling.StepTimer(torch.device("cuda"), report_every=10)
    clock.update(now=0.0, pending=1.0)  # the device finishes at t = 1 s
    assert t.laps(5) is None
    assert t.last_rate == 0.0
    clock["pending"] = 2.0
    assert t.laps(10) == 0.0  # a report whose events are not done yet
    clock["pending"] = 2.5
    t.laps(10)
    clock["now"] = 2.0  # the device has passed the first report
    assert t.last_rate == pytest.approx(10 / 1.0)
    assert len(t._marks) == 2
    clock["now"] = 3.0
    assert t.last_rate == pytest.approx(10 / 0.5)
    assert len(t._marks) == 1
