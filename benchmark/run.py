"""One run of one cell of the benchmark of ``tpufluid_torch`` on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m benchmark.run ...``), from the root of a checkout. The
cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: the scene, its physics and how the
app is built), a traffic mix (``benchmark/traffic/<mix>.json``: the loop,
the engine, the call, warm-up, the traced slice and the check) and the
limits of its check (``benchmark/limits/<cell>.json``); each per-layer
metric is a reader ``benchmark/layer_metrics/<metric>.py``. All are found
by name: a cell, a mix or a metric is added by adding files.

A run: make the inputs from ``--seed`` (``inputs.jittered``), hand them to
the app, warm up every shape the loop uses (set-up, ``setup_s``), run the
closed loop for ``--seconds``, then check the outputs against the plain
reference (``reference/``) and print one JSON line. ``--trace 1`` holds
the profiler over a bounded slice at the window's start and reports the
per-layer metrics instead of the end-to-end ones.

Exits 2 with no result when no CUDA device is present, and 3 when a module
of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:  # started as a script
    sys.path.insert(0, str(ROOT))

_T_IMPORT = time.perf_counter()
# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufluid")
# the frames loop asks the app for more frames than any window delivers
_ENDLESS = 1 << 40


def seconds_since_start() -> float:
    """Seconds since this process started (/proc; else since import)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


# ------------------------------------------------------------ by name

def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for wl in spec["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in spec["configs"] if c["name"] == name)
    with open(root / entry["file"]) as f:
        return json.load(f)


def load_json(kind: str, name: str, here: Path = HERE) -> dict:
    with open(here / kind / f"{name}.json") as f:
        return json.load(f)


def reader(metric: str, here: Path = HERE):
    """The ``read(trace)`` function of ``layer_metrics/<metric>.py``."""
    path = here / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.layer_metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, group: str, cell: str) -> list:
    """The ``group`` metrics ("end_to_end", "per_layer") the cell reports."""
    return [m for m in spec[group]
            if "workloads" not in m or cell in m["workloads"]]


# ------------------------------------------------------------ the program

def build_app(config: dict, engine: str, device):
    """The app as the configuration says: ``"fluid_app"`` from its domain
    and physics, or ``"cli"`` through the CLI's own ``build_app`` with the
    configuration's arguments (the CLI's defaults where it gives none)."""
    from tpufluid_torch import cli
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.params import SimSettings, TickParams

    how = config["app"]
    dom, ph = config["domain"], config["physics"]
    if how["via"] == "cli":
        args = cli.parser().parse_args(
            ["run", "--device", str(device), "--neighbor-mode", engine]
            + list(how.get("args", [])))
        app = cli.build_app(args)
    else:
        settings = SimSettings(
            particle_count=dom["particle_count"],
            particle_spacing=dom["particle_spacing"],
            smoothing_radius=dom["smoothing_radius"],
            size=tuple(dom["size"]), texture_size=tuple(dom["texture_size"]),
            cell_capacity=dom["cell_capacity"],
            spawn_columns=dom.get("spawn_columns"))
        params = TickParams.default(
            device, delta=ph["dt"], gravity=tuple(ph["gravity"]),
            mass=ph["mass"], pressure_constant=ph["pressure_constant"],
            rest_density=ph["rest_density"],
            damping_factor=ph["damping_factor"],
            viscosity_coefficient=ph["viscosity_coefficient"])
        app = FluidApp(settings, params, capacity_policy=how["policy"],
                       device=device, neighbor_mode=engine)
    s = app.settings
    got = dict(particle_count=s.particle_count,
               particle_spacing=s.particle_spacing,
               smoothing_radius=s.smoothing_radius, size=list(s.size),
               cell_capacity=s.cell_capacity)
    want = {k: dom[k] for k in got}
    if got != want:
        raise RuntimeError(f"the app's settings {got} are not the "
                           f"configuration's {want}")
    return app


def held_state(app):
    """The state object the app holds now (no copy, no device work): the
    resident grid, or the per-step engines' particle arrays."""
    return app.grid_state if app.neighbor_mode == "resident" else app.state


def particles(state):
    """(pos, vel, tick, lost) of a held state: the live slots of a
    resident grid, or a per-step engine's arrays."""
    import torch

    if hasattr(state, "pos_x"):
        live = state.pos_x < 5.0e8
        pos = torch.stack([state.pos_x[live], state.pos_y[live]], 1)
        vel = torch.stack([state.vel_x[live], state.vel_y[live]], 1)
        return pos, vel, int(state.tick), int(state.lost)
    return (state.position.clone(), state.velocity.clone(),
            int(state.tick), 0)


def check_state(state):
    """(pos, vel, tick, slots) of a held state as the check reads it: its
    particles and tick, and for a resident grid the (row, slot, column) of
    each particle's slot, i64[N, 3] (None for the per-step engines)."""
    pos, vel, tick, _ = particles(state)
    slots = ((state.pos_x < 5.0e8).nonzero() if hasattr(state, "pos_x")
             else None)
    return pos, vel, tick, slots


def hand_state(app, pos, vel):
    """Give the app the inputs through its ``state`` setter; returns how
    far the state it holds then is from them (0: the same values)."""
    import torch
    from tpufluid_torch.state import ParticleState

    n = pos.shape[0]
    app.state = ParticleState(
        position=pos.clone(), predicted=pos.clone(), velocity=vel.clone(),
        density=torch.zeros(n, dtype=torch.float32, device=pos.device),
        cell=torch.zeros(n, dtype=torch.int32, device=pos.device),
        tick=torch.zeros((), dtype=torch.int64, device=pos.device))
    got, gvel, _, lost = particles(held_state(app))
    if got.shape != pos.shape or lost:
        return float("inf")
    a, b = got[_lex_order(got)], pos[_lex_order(pos)]
    return float(torch.cat([(a - b).abs(), gvel.abs()]).max())


def _lex_order(p):
    """Indices that sort points [N, 2] by x, then y."""
    import torch

    idx = torch.sort(p[:, 1], stable=True).indices
    return idx[torch.sort(p[idx, 0], stable=True).indices]


class RunLoop:
    """Closed loop of ``FluidApp.run(steps_per_call)``."""

    span = "app.run"

    def __init__(self, app, mix: dict):
        self.app, self.n = app, int(mix["steps_per_call"])

    def call(self, n=None):
        self.app.run(n or self.n)
        return None

    def steps(self, calls: int) -> int:
        return calls * self.n


class FrameLoop:
    """Closed loop of ``FluidApp.iter_frames``: each call asks for the
    next frame and returns the u8[H, W, 4] array the app hands over."""

    span = "frame"

    def __init__(self, app, mix: dict):
        self.app = app
        self.frames = app.iter_frames(_ENDLESS, int(mix["width"]),
                                      int(mix["height"]), mode=mix["mode"])

    def call(self, n=None):
        return next(self.frames)

    def steps(self, calls: int) -> int:
        return calls * self.app.TICKS_PER_RENDER_FRAME


LOOPS = {"run": RunLoop, "frames": FrameLoop}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


# ------------------------------------------------------------ one run

def window_stats(seconds: float, calls: int, steps: int, n: int,
                 latencies) -> dict:
    """The end-to-end readings of a window: its length, the steps it
    completed and, for frames, the latency of each."""
    out = dict(particle_steps_per_s=n * steps / seconds)
    if latencies:
        out["frame_ms"] = seconds / calls * 1e3
        out["frame_ms_p95"] = (statistics.quantiles(
            latencies, n=20, method="inclusive")[18] if len(latencies) > 1
            else latencies[0]) * 1e3
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """A cell made ready to run: its files read and the app built on
    ``device`` (the program's set-up that no seed changes)."""

    def __init__(self, spec: dict, wl: dict, device="cuda",
                 here: Path = HERE, root: Path = ROOT):
        import torch

        self.spec, self.wl, self.here = spec, wl, here
        self.device = torch.device(device)
        self.config = load_config(spec, wl["config"], root)
        self.mix = load_json("traffic", wl["traffic"], here)
        self.limits = load_json("limits", wl["name"], here)
        self.n = self.config["domain"]["particle_count"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        self.app = build_app(self.config, self.mix["engine"], self.device)

    def close(self) -> None:
        """Free the program's state (before the reference runs)."""
        import torch

        self.app = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def measure(cell: Cell, seed: int, seconds: float, trace: bool) -> dict:
    """Inputs from ``seed`` handed to the app, the warm-up, the window (its
    traced slice first when ``trace``), then the outputs the check reads:
    the window's last state and ``check_steps`` more steps from it, and the
    sampled frames with their states, as particle arrays."""
    import torch

    from benchmark import inputs
    from benchmark.reference import check, sph

    app, mix, dev = cell.app, cell.mix, cell.device
    pos, vel = inputs.jittered(cell.config, seed, dev)
    start_gap = hand_state(app, pos, vel)
    del pos, vel
    loop = LOOPS[mix["loop"]](app, mix)
    for _ in range(int(mix["warmup_calls"])):
        loop.call(mix.get("warmup_call_steps"))
    tr = mix.get("trace", {})
    if trace and tr.get("call_steps"):
        loop.call(int(tr["call_steps"]))
    _sync(dev)
    _, _, tick0, _ = particles(held_state(app))
    setup_s = seconds_since_start()

    rng = random.Random(seed)
    kept, latencies = [], []
    prof = gs_slice = None
    calls = slice_steps = slice_calls = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    if trace:
        prof, gs_slice, slice_calls, slice_steps = _traced_slice(
            app, loop, tr, dev)
    while calls == 0 or time.perf_counter() < end:
        ta = time.perf_counter()
        out = loop.call()
        latencies.append(time.perf_counter() - ta)
        calls += 1
        if out is not None:  # reservoir sample of the window's frames
            k = int(mix["check_frames"])
            if len(kept) < k:
                kept.append((out, held_state(app)))
            elif rng.randrange(calls) < k:
                kept[rng.randrange(k)] = (out, held_state(app))
    _sync(dev)
    window_s = time.perf_counter() - t0
    steps = loop.steps(calls) + slice_steps
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    # the window's outputs: its last state, then the check's steps from it
    pos_w, vel_w, tick_w, lost_w = particles(held_state(app))
    states = [check_state(held_state(app))]
    for _ in range(int(mix["check_steps"])):
        app.run(1)
        states.append(check_state(held_state(app)))
    readings = dict(start_gap=start_gap,
                    tick_gap=abs(tick_w - tick0 - steps),
                    **check.window_invariants(pos_w, vel_w, lost_w, cell.n,
                                              sph.physics(cell.config)))
    out = dict(setup_s=setup_s, window_s=window_s, calls=calls, steps=steps,
               latencies=latencies, memory_peak=memory_peak, states=states,
               readings=readings,
               kept=[(f, particles(st)[:2]) for f, st in kept])
    if trace:
        out["layer"], out["busy"], out["breakdown"] = _read_trace(
            cell.spec, cell.wl, prof, loop, gs_slice, slice_steps,
            slice_calls, cell.here)
    return out


def judge(cell: Cell, m: dict) -> dict:
    """Every reading of the check, the reference's among them."""
    from benchmark.reference import check, sph

    readings = dict(m["readings"])
    readings.update(check.step_gaps(m["states"],
                                    sph.physics(cell.config)))
    if m["kept"]:
        readings.update(check.frame_gaps(m["kept"], cell.config, cell.mix))
    return readings


def run_cell(spec: dict, wl: dict, seed: int, seconds: float, trace: bool,
             device="cuda", here: Path = HERE, root: Path = ROOT) -> dict:
    """One run of the cell ``wl``; the result's dict (without printing)."""
    import torch

    cell = Cell(spec, wl, device, here, root)
    dev = cell.device
    card = power_limit() if dev.type == "cuda" else "cpu"
    m = measure(cell, seed, seconds, trace)
    cell.close()
    readings = judge(cell, m)
    # every limit needs its reading; a missing one fails
    checks = {k: [readings.get(k), lim] for k, lim in cell.limits.items()}
    correct = all(v is not None and v <= lim for v, lim in checks.values())

    result = dict(correct=correct, attempted=cell.n,
                  failed=readings["lost"] + readings["nonfinite"])
    if trace:
        result["metrics"] = m["layer"]
    else:
        stats = window_stats(
            m["window_s"], m["calls"], m["steps"], cell.n,
            m["latencies"] if cell.mix["loop"] == "frames" else None)
        stats["setup_s"] = m["setup_s"]
        result["metrics"] = {
            x["name"]: dict(value=stats[x["name"]], unit=x["unit"])
            for x in metrics_of(spec, "end_to_end", wl["name"])}
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=m["memory_peak"], power=card)
    if trace:
        device_info.update(m["busy"])
        result["breakdown"] = m["breakdown"]
    result["device"] = device_info
    result["checks"] = checks
    return result


def _traced_slice(app, loop, tr: dict, dev):
    """The profiler over ``tr["calls"]`` calls (of ``tr["call_steps"]``
    steps where given), each in a span, the whole in ``slice``. Returns
    (profiler, the resident grid state at the slice's start and end,
    calls, steps)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    resident = app.neighbor_mode == "resident"
    gs0 = app.grid_state if resident else None
    calls = int(tr["calls"])
    step_n = tr.get("call_steps")
    prof = profile(activities=acts)
    prof.start()
    try:
        with record_function("slice"):
            for _ in range(calls):
                with record_function(loop.span):
                    loop.call(step_n)
            _sync(dev)
    finally:
        prof.stop()
    gs1 = app.grid_state if resident else None
    steps = (calls * int(step_n) if step_n else loop.steps(calls))
    return prof, (gs0, gs1), calls, steps


def _read_trace(spec, wl, prof, loop, gs_slice, steps, calls, here):
    """(per-layer metrics, device's busy_s / window_s, breakdown)."""
    from benchmark import trace

    frames = calls if isinstance(loop, FrameLoop) else 0
    t = trace.read(prof, {loop.span}, engine=loop.app.neighbor_mode,
                   steps=steps, frames=frames,
                   states=[g for g in gs_slice if g is not None])
    out = {}
    for m in metrics_of(spec, "per_layer", wl["name"]):
        v = reader(m["name"], here)(t)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    busy = t.busy_s()
    by_launch = {}
    for op in t.device_ops:
        key = f"{op.span}/{op.launch}/{op.kind}"
        by_launch[key] = by_launch.get(key, 0.0) + op.end - op.start
    print(f"traced slice: {len(t.device_ops)} device operations, "
          f"{t.linked:.4f} tied to a launch, {steps} steps, "
          f"{t.window_s:.6f} s; device seconds by span/launch/kind: "
          f"{json.dumps(by_launch)}", file=sys.stderr)
    return (out, dict(busy_s=busy, window_s=t.window_s),
            dict(device_ops=t.device_top(), idle_gaps=t.idle_gaps()))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec()
    wl = workload(spec, args.workload)

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(wl["chips"])):
        print(f"benchmark: the cell needs {wl['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, wl, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that this process may not hold: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
