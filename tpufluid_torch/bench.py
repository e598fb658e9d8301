"""Benchmark harness of the port (BASELINE.json's configs 1-5), after the
repo-root ``bench.py`` of the JAX package.

    python -m tpufluid_torch.bench [--all | --parity | --xparity |
        --config5-model] [--iters N] [--neighbor-mode MODE] [--device DEV]
    python -m tpufluid_torch bench --config N [--device DEV]

Without a flag it times particle-steps/s at scene_1m (mean of 5 repeats,
with their sigma and samples), runs engine parity (its report to stderr),
then prints ONE JSON line: the rate and whether parity held. ``--all``
prints the ladder, one JSON line a config, to stderr, in place of the
parity run. ``--config5-model`` prints config 5's derived 4M/8-card
estimate. Every record names the device it ran on. On the card each burst
of steps is timed with CUDA events after warm bursts; on the CPU with
``time.perf_counter`` around the
burst and a synchronize. Runs on the card unless ``--device`` says
otherwise; nothing here writes a file unless given ``out_path``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from .cli import _device


def device_name(dev) -> str:
    """The card's name, or ``cpu``."""
    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _timeit(fn, state, params, *extra, devices, warmup=3, iters=20,
            repeats=1):
    """Mean seconds per call of ``state = fn(state, params, *extra)``, the
    final state and the per-repeat samples (each repeat times ``iters``
    calls). CUDA events time the calls when all ``devices`` are one card;
    otherwise the host clock, after a synchronize of every device."""
    devices = [torch.device(d) for d in devices]
    events = len(set(devices)) == 1 and devices[0].type == "cuda"
    for _ in range(warmup):
        state = fn(state, params, *extra)
    _sync(devices)
    samples = []
    for _ in range(max(repeats, 1)):
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                state = fn(state, params, *extra)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                state = fn(state, params, *extra)
            _sync(devices)
            samples.append((time.perf_counter() - t0) / iters)
    return sum(samples) / len(samples), state, samples


def bench_step(scene, warmup=3, iters=20, burst=10, neighbor_mode="resident",
               repeats=1, **step_kw):
    """ms/step of a burst of ``burst`` steps (``make_grid_multi_step`` for
    "resident", else ``make_multi_step``) on the scene's device;
    ``repeats`` > 1 adds the rate's samples and sigma."""
    from . import make_multi_step
    from .ops import resident

    dev = scene.params.device
    n = scene.settings.particle_count
    if neighbor_mode == "resident":
        run = resident.make_grid_multi_step(scene.settings, burst)
        state = resident.init_grid_state(scene.settings, dev)
    else:
        run = make_multi_step(scene.settings, burst,
                              neighbor_mode=neighbor_mode, **step_kw)
        state = scene.init()
    sec, _, samples = _timeit(run, state, scene.params, devices=[dev],
                              warmup=warmup, iters=iters, repeats=repeats)
    sec /= burst
    out = dict(config=scene.name, particles=n, mode=neighbor_mode,
               ms_per_step=sec * 1e3, particle_steps_per_sec=n / sec,
               device=device_name(dev))
    if repeats > 1:
        rates = [n / (s / burst) for s in samples]
        mean = sum(rates) / len(rates)
        var = sum((r - mean) ** 2 for r in rates) / (len(rates) - 1)
        out["particle_steps_per_sec_samples"] = rates
        out["particle_steps_per_sec_sigma"] = var ** 0.5
    return out


def _camera(scene, width, height):
    from .ops import render

    return render.Camera(view_size=(
        scene.settings.size[0], scene.settings.size[0] * height / width))


def bench_render(scene, width=1920, height=1080, warmup=2, iters=5):
    """ms/frame of the binned metaball renderer on a state 3 dense steps
    from the lattice."""
    from .ops import render_binned

    step = scene.make_step(neighbor_mode="dense")
    state = scene.init()
    for _ in range(3):
        state = step(state, scene.params)
    cam = _camera(scene, width, height)

    def frame(st, _):
        render_binned.render_metaball_binned(st, scene.settings, width,
                                             height, cam)
        return st

    sec, _, _ = _timeit(frame, state, None, devices=[scene.params.device],
                        warmup=warmup, iters=iters)
    return sec * 1e3


def bench_render_grid(scene, width=1920, height=1080, warmup=2, iters=5):
    """ms/frame of the resident-grid renderer (the metaball coarse-field
    kernel, then resampling and shading) straight off the slot grid, 10
    resident steps from the lattice."""
    from .ops import render_grid, resident

    dev = scene.params.device
    gs = resident.init_grid_state(scene.settings, dev)
    gs = resident.make_grid_multi_step(scene.settings, 10)(gs, scene.params)
    cam = _camera(scene, width, height)
    burst = 10

    def frames(g, _):
        for _ in range(burst):
            render_grid.render_metaball_grid(g, scene.settings, width,
                                             height, cam)
        return g

    sec, _, _ = _timeit(frames, gs, None, devices=[dev], warmup=warmup,
                        iters=iters)
    return sec / burst * 1e3


def bench_frame(scene, width=960, height=540, warmup=2, iters=5):
    """ms of one rendered frame end to end at the reference's render size
    (renderer.rs:15, 960x540) and offline cadence: 16 resident ticks, then
    the grid renderer (main.rs:199-201)."""
    from .ops import render_grid, resident

    dev = scene.params.device
    run16 = resident.make_grid_multi_step(scene.settings, 16)
    gs = resident.init_grid_state(scene.settings, dev)
    gs = resident.make_grid_multi_step(scene.settings, 10)(gs, scene.params)
    cam = _camera(scene, width, height)
    burst = 5

    def frames(g, params):
        for _ in range(burst):
            g = run16(g, params)
            render_grid.render_metaball_grid(g, scene.settings, width,
                                             height, cam)
        return g

    sec, _, _ = _timeit(frames, gs, scene.params, devices=[dev],
                        warmup=warmup, iters=iters)
    return sec / burst * 1e3


def config4_batch(dev, burst=10, warmup=2, iters=5) -> dict:
    """BASELINE config 4's batch: 8 independent 131,072-particle worlds
    with gravity -linspace(0, 2) and viscosity linspace(5, 40), stacked
    along the grid-row axis of the resident engine (one set of kernel
    launches a step); per-world occupancy and the counted losses."""
    import numpy as np

    from .ops import resident as res
    from .params import SimSettings, TickParams

    b = 8
    bsettings = SimSettings(
        particle_count=131072, particle_spacing=0.1, smoothing_radius=0.2,
        size=(101.95, 13.1), cell_capacity=8, spawn_columns=1008)
    plist = [TickParams.default(dev, gravity=(0.0, -float(g)),
                                viscosity_coefficient=float(v))
             for g, v in zip(np.linspace(0.0, 2.0, b),
                             np.linspace(5.0, 40.0, b))]
    bp = res.batched_params(plist)
    brun = res.make_grid_multi_step(bsettings, burst, n_worlds=b)
    bgs = res.init_batched_grid_state(bsettings, b, dev)
    sec, end, _ = _timeit(brun, bgs, bp, devices=[dev], warmup=warmup,
                          iters=iters)
    sec /= burst
    return {"batch8x128k_ms_per_step": sec * 1e3,
            "batch8x128k_particle_steps_per_sec":
                b * bsettings.particle_count / sec,
            "batch8x128k_world_stats": res.batched_world_stats(
                end, bsettings, b),
            "batch8x128k_lost": int(end.lost)}


def run_configs(which=None, out=None, mode="resident", device=None):
    """The BASELINE.json ladder on ``device`` (default the card): config
    ``which`` (1-5) or all. One JSON line a config on ``out`` (default
    stdout); returns the records by key."""
    from .models import scenes

    out = out or sys.stdout
    dev = _device(device or "cuda")
    results = {}

    def wants(i):
        return which is None or which == i

    def record(key, value):
        results[key] = value
        print(json.dumps({key: value}, default=float), file=out, flush=True)

    if wants(1):
        record("config1_4k", bench_step(scenes.dam_break_4k(dev),
                                        neighbor_mode=mode, burst=200))
    if wants(2):
        record("config2_64k", bench_step(scenes.scene_64k(dev),
                                         neighbor_mode=mode, burst=80))
    if wants(3):
        r = bench_step(scenes.scene_256k(dev), neighbor_mode=mode, burst=50)
        r["render_ms_per_frame_1080p"] = bench_render(scenes.scene_256k(dev))
        r["render_grid_ms_per_frame_1080p"] = bench_render_grid(
            scenes.scene_256k(dev))
        r["frame_ms_960x540_16ticks"] = bench_frame(scenes.scene_256k(dev))
        record("config3_256k", r)
    if wants(4):
        r = bench_step(scenes.scene_1m(dev), neighbor_mode=mode, burst=120)
        r["render_grid_ms_per_frame_1080p"] = bench_render_grid(
            scenes.scene_1m(dev))
        r.update(config4_batch(dev))
        record("config4_1m", r)
    if wants(5):
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        if n_cards >= 2:
            record("config5_sharded", bench_sharded())
        else:
            record("config5_sharded", dict(
                skipped=f"needs multi-device, have {n_cards}"))
    return results


def bench_sharded(mode="resident", n=None, iters=10, devices=None):
    """Config 5: ms/step of a sharded step over ``devices`` (default one
    card a shard, all of them). ``mode`` "resident" runs the row-band
    sharded resident step, "dense" the slab-sharded dense step. The
    scene: scene_4m at 8 shards or more, else ``n`` (524,288 a shard)
    particles in a square world scaled from scene_4m's, K=16."""
    from .models import scenes
    from .params import SimSettings, TickParams
    from . import parallel

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    d = len(devices)
    if d == 0:
        raise RuntimeError("bench_sharded: no device to shard on")
    if n is None and d >= 8:
        settings = scenes.scene_4m(devices[0]).settings
        n = settings.particle_count
    else:
        if n is None:
            n = 524_288 * d
        side = round(204.3 * math.sqrt(n / 4_194_304), 1)
        settings = SimSettings(particle_count=n, particle_spacing=0.1,
                               smoothing_radius=0.2, size=(side, side),
                               cell_capacity=16)
    params = TickParams.default(devices[0])
    if mode == "resident":
        spec = parallel.build_resident_spec(settings, d)
        mesh = parallel.make_resident_mesh(spec, devices)
        step = parallel.make_sharded_resident_step(spec, mesh)
        state = parallel.init_sharded_resident(spec, mesh)
    elif mode == "dense":
        spec = parallel.build_shard_spec(settings, d)
        mesh = parallel.make_mesh(spec, devices)
        step = parallel.make_sharded_step(spec, mesh, neighbor_mode="dense")
        state = parallel.init_sharded(spec, mesh)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    def fn(st, p):
        return step(st, p)[0]

    sec, _, _ = _timeit(fn, state, params, devices=mesh.devices, warmup=2,
                        iters=iters)
    return dict(config=f"sharded-{d}dev-{mode}", particles=n,
                ms_per_step=sec * 1e3, particle_steps_per_sec=n / sec,
                devices=d, device=[device_name(x) for x in mesh.devices])


# Config 5's derived estimate: the inter-card link is NVLink 4 on the H100
# SXM5, 900 GB/s a GPU over both directions (NVIDIA's H100 datasheet), so
# 450 GB/s one way; the per-phase latency (one kernel launch and one hop)
# is an assumption of the estimate, not a measurement.
LINK_ONEWAY_BYTES_PER_S = 450e9
PHASE_LATENCY_S = 5e-6
# collective phases of one sharded resident step: the boundary-row merge,
# the (pos, vel) halo and the far-mover gate
COMM_PHASES = 3


def config5_band(dev):
    """(spec, band): scene_4m's row-band spec at 8 shards, and one shard's
    share as a standalone scene: scene_4m's width, K and spawn columns,
    n / 8 particles in a world ``rows_per_dev - 2`` cells tall (the fluid a
    horizontal slab, as each shard's share of the 4M scene). The lattice
    overhangs that height by half a spacing; the init clamps it into the
    box and loses nothing, as JAX's does, and the clamped edge rows then
    lose 65 particles in the third step, as JAX's band does."""
    from . import parallel
    from .models import scenes
    from .params import SimSettings, TickParams

    settings = scenes.scene_4m(dev).settings
    spec = parallel.build_resident_spec(settings, 8)
    h = settings.smoothing_radius
    band_settings = SimSettings(
        particle_count=settings.particle_count // spec.n_devices,
        particle_spacing=settings.particle_spacing, smoothing_radius=h,
        size=(settings.size[0], (spec.rows_per_dev - 2) * h),
        cell_capacity=settings.cell_capacity,
        spawn_columns=settings.spawn_columns)
    return spec, scenes.Scene(name="config5-band", settings=band_settings,
                              params=TickParams.default(dev))


def _measured_comm_bytes_per_dir(spec, device) -> int:
    """Per-direction bytes of one row-band sharded resident step, counted
    by ``comm_audit.audit_step`` while the step runs once on ``spec``'s
    shards, all on ``device`` (the port's mesh notes each collective it
    makes; the JAX package traces its step instead)."""
    from . import parallel
    from .params import TickParams
    from .parallel import comm_audit

    device = torch.device(device)
    mesh = parallel.make_resident_mesh(spec, [device] * spec.n_devices)
    step = parallel.make_sharded_resident_step(spec, mesh)
    sgs = parallel.init_sharded_resident(spec, mesh)
    audit = comm_audit.audit_step(step, sgs, TickParams.default(device))
    return audit["ppermute_bytes_per_dir"]


def config5_model(out=None, device=None) -> dict:
    """Config 5's derived estimate (4M particles over 8 cards) from one
    card: the measured step of one shard's band (``config5_band``, timed
    by ``bench_step``), scaled by the 4 halo rows the sharded kernels also
    run, plus the link time of the step's measured traffic under the two
    assumed link figures above:

        t_step = t_band * (rows + 4) / rows
                 + bytes_per_dir / link + COMM_PHASES * phase_latency

    Prints the record as one JSON line on ``out`` (default stdout) and
    returns it."""
    from .ops import resident

    out = out or sys.stdout
    dev = _device(device or "cuda")
    spec, band = config5_band(dev)
    n, d = spec.settings.particle_count, spec.n_devices
    rows = spec.rows_per_dev
    t_band = bench_step(band, warmup=2, iters=10)["ms_per_step"] * 1e-3
    halo_factor = (rows + 4) / rows
    bytes_dir = _measured_comm_bytes_per_dir(spec, dev)
    t_comm = (bytes_dir / LINK_ONEWAY_BYTES_PER_S
              + COMM_PHASES * PHASE_LATENCY_S)
    t_step = t_band * halo_factor + t_comm
    est = dict(
        config="config5-derived-4M-h100x8",
        particles=n, devices=d, band_particles=n // d, band_rows=rows,
        k=spec.settings.cell_capacity, gxp=resident._gxp(spec.settings),
        measured_band_ms_per_step=t_band * 1e3,
        halo_factor=round(halo_factor, 4),
        measured_comm_bytes=bytes_dir,
        assumed_link_oneway_GBps=LINK_ONEWAY_BYTES_PER_S / 1e9,
        assumed_phase_latency_us=PHASE_LATENCY_S * 1e6,
        modeled_comm_ms_per_step=t_comm * 1e3,
        est_ms_per_step=t_step * 1e3,
        est_particle_steps_per_sec=n / t_step,
        note=("derived: one band's step measured on one card, plus a link "
              "model of the step's audited traffic; it leaves out the "
              "sharded step's own work beside the band's kernels (the edge "
              "rows' merges, the halo and far-mover packets, the copies "
              "of its collectives: device work in the step's CUDA graph "
              "on one card), so it is a lower bound of this port's "
              "ms/step on 8 cards; multi-card correctness is held on one card by "
              "the sharded step bitwise its plain version at D = 2 and 4 "
              "(chip_smoke.py phase 23) and at D = 8 for one scene_4m step "
              "(phase 26), and at D = 8 by tests/test_torch_shard*.py "
              "against the JAX package on the CPU"),
        device=device_name(dev))
    print(json.dumps(est, default=float), file=out, flush=True)
    return est


def _write(out_path, key, record) -> None:
    """Merge ``record`` under ``key`` into the JSON file ``out_path``."""
    try:
        with open(out_path) as f:
            report = json.load(f)
    except (OSError, json.JSONDecodeError):
        report = {}
    report[key] = record
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)


def run_parity(steps_short=10, steps_long=200, n=16384, out_path=None,
               device=None, size=26.0):
    """Engine parity on ``device`` (default the card). Short horizon:
    grid and pallas trajectories within 1e-4 of dense (each coordinate's
    sorted positions), resident nearest-neighbour-close to dense (under
    1e-3; SPH is chaotic, so tolerance parity means something only over
    a short window). Long horizon: per engine (dense, resident) mass
    kept, finite, in bounds, and the kinetic energies within 10% of each
    other. The scene: ``n`` particles in a ``size`` square, K=32,
    gravity -3 (bounded peak occupancy; at -9.8 the box compacts without
    bound). Prints the report as JSON and returns whether every check
    passed; writes ``out_path`` (under "parity") only when given."""
    import numpy as np

    from . import init_state, make_multi_step
    from .ops import resident
    from .params import SimSettings, TickParams

    dev = _device(device or "cuda")
    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(size, size),
                    cell_capacity=32)
    params = TickParams.default(dev, gravity=(0.0, -3.0))
    report = {"device": device_name(dev), "n": n, "checks": {}}
    ok_all = True

    def check(name, cond, detail=""):
        nonlocal ok_all
        report["checks"][name] = {"ok": bool(cond), "detail": detail}
        ok_all = ok_all and bool(cond)

    # --- short horizon: trajectory parity
    outs = {}
    for mode in ("grid", "dense", "pallas"):
        run = make_multi_step(s, steps_short, neighbor_mode=mode)
        outs[mode] = run(init_state(s, dev), params).position.cpu().numpy()
    for mode in ("grid", "pallas"):
        d = float(np.abs(np.sort(outs[mode], 0)
                         - np.sort(outs["dense"], 0)).max())
        check(f"{mode}_vs_dense_{steps_short}step", d < 1e-4,
              f"max|dpos|={d:.2e}")

    rrun = resident.make_grid_multi_step(s, steps_short)
    gs = rrun(resident.init_grid_state(s, dev), params)
    ps, live = resident.to_particles(gs, s)
    check(f"resident_mass_{steps_short}step",
          int(live) == n and int(gs.lost) == 0,
          f"live={int(live)} lost={int(gs.lost)}")
    try:
        from scipy.spatial import cKDTree
        dd, _ = cKDTree(outs["dense"]).query(
            ps.position[:n].cpu().numpy())
        check(f"resident_vs_dense_{steps_short}step", dd.max() < 1e-3,
              f"max nn dist={dd.max():.2e}")
    except ImportError:
        report["checks"]["resident_vs_dense_nn"] = "not run: no scipy"

    # --- long horizon: invariants per engine
    energies = {}
    for mode in ("dense", "resident"):
        if mode == "resident":
            run = resident.make_grid_multi_step(s, steps_long)
            gs = run(resident.init_grid_state(s, dev), params)
            st, live = resident.to_particles(gs, s)
            check(f"{mode}_mass_{steps_long}step",
                  int(live) == n and int(gs.lost) == 0,
                  f"live={int(live)} lost={int(gs.lost)}")
            pos = st.position[:n].cpu().numpy()
            vel = st.velocity[:n].cpu().numpy()
        else:
            run = make_multi_step(s, steps_long, neighbor_mode=mode)
            st = run(init_state(s, dev), params)
            pos = st.position.cpu().numpy()
            vel = st.velocity.cpu().numpy()
        finite = bool(np.all(np.isfinite(pos)) and np.all(np.isfinite(vel)))
        inb = bool(np.all(np.abs(pos) <= size / 2 + 1e-4))
        check(f"{mode}_sane_{steps_long}step", finite and inb,
              f"finite={finite} in_bounds={inb}")
        energies[mode] = float(0.5 * (vel.astype(np.float64) ** 2).sum())
    rel = abs(energies["resident"] - energies["dense"]) / max(
        energies["dense"], 1e-9)
    check(f"energy_within_10pct_{steps_long}step", rel < 0.10,
          f"dense={energies['dense']:.4g} resident="
          f"{energies['resident']:.4g} rel={rel:.3f}")

    report["ok"] = ok_all
    report["generated_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime())
    if out_path is not None:
        _write(out_path, "parity", report)
    print(json.dumps({"metric": "engine_parity", "value": int(ok_all),
                      "unit": "bool", **report}), flush=True)
    return ok_all


def run_cross_backend_parity(steps=50, n=4096, out_path=None):
    """Step-for-step CPU-vs-card divergence of the same grid-mode step:
    each step both devices get the identical input (the card's output
    becomes the next input of both), so the numbers are single-step
    divergences, not compounded chaos. Prints the record (max per-step
    |dpos|, |dvel|, |drho|, bitwise or not) as JSON and returns it, None
    without a card; writes ``out_path`` (under "cpu_vs_cuda") only when
    given."""
    from . import init_state, make_step
    from .params import SimSettings, TickParams

    if not torch.cuda.is_available():
        print(json.dumps({"metric": "cpu_vs_cuda_step_parity",
                          "skipped": "no CUDA device"}), flush=True)
        return None
    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(16.0, 16.0),
                    cell_capacity=32)
    cpu, acc = torch.device("cpu"), torch.device("cuda")
    p_cpu = TickParams.default(cpu, gravity=(0.0, -3.0))
    p_acc = TickParams.default(acc, gravity=(0.0, -3.0))
    step = make_step(s, neighbor_mode="grid")
    state = init_state(s, cpu)
    worst = dict(position=0.0, velocity=0.0, density=0.0)
    per_step = []
    for _ in range(steps):
        st_acc = step(_state_on(state, acc), p_acc)
        st_cpu = step(state, p_cpu)
        row = {f: float((getattr(st_acc, f).cpu()
                         - getattr(st_cpu, f)).abs().max())
               for f in worst}
        per_step.append(row)
        worst = {f: max(worst[f], row[f]) for f in worst}
        state = _state_on(st_acc, cpu)  # synced: the card's trajectory
    rec = dict(steps=steps, n=n, accelerator=device_name(acc),
               max_step_dpos=worst["position"],
               max_step_dvel=worst["velocity"],
               max_step_drho=worst["density"],
               bitwise=not any(worst.values()),
               per_step=per_step,
               generated_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime()))
    if out_path is not None:
        _write(out_path, "cpu_vs_cuda", rec)
    print(json.dumps({"metric": "cpu_vs_cuda_step_parity", **rec}),
          flush=True)
    return rec


def _state_on(state, dev):
    import dataclasses

    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(state)})


def main(argv=None) -> int:
    """The harness's command line. Without ``--all`` the headline run
    refreshes engine parity (``run_parity(10, 120, 16384)``, its report
    sent to stderr) before it prints its line, as the JAX harness does,
    with three departures. The refresh runs after the headline's bursts,
    not before them, so that nothing it leaves in the process can move
    the rate. No file is written: the repo's PARITY.json is the JAX
    package's record, so the headline line carries ``parity_ok`` instead.
    A parity run that raises ends the run with its exception, where the
    JAX harness prints it and goes on."""
    import contextlib

    ap = argparse.ArgumentParser(prog="tpufluid_torch.bench")
    ap.add_argument("--all", action="store_true",
                    help="the whole ladder, one JSON line a config, to "
                         "stderr")
    ap.add_argument("--parity", action="store_true",
                    help="engine parity; exit 0 when every check passes")
    ap.add_argument("--xparity", action="store_true",
                    help="step-for-step CPU-vs-card divergence")
    ap.add_argument("--config5-model", action="store_true",
                    help="derived 4M/8-card estimate (one band's measured "
                         "step + a link model of the audited traffic)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--neighbor-mode", default="resident",
                    choices=("grid", "dense", "pallas", "resident"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    if args.parity:
        return 0 if run_parity(device=args.device) else 1
    if args.xparity:
        run_cross_backend_parity()
        return 0
    if args.config5_model:
        config5_model(device=args.device)
        return 0
    if args.all:
        run_configs(None, out=sys.stderr, mode=args.neighbor_mode,
                    device=args.device)
    from .models import scenes

    r = bench_step(scenes.scene_1m(_device(args.device)), warmup=3,
                   iters=max(args.iters, 5), burst=120,
                   neighbor_mode=args.neighbor_mode, repeats=5)
    parity_ok = None
    if not args.all:
        with contextlib.redirect_stdout(sys.stderr):
            parity_ok = run_parity(steps_short=10, steps_long=120, n=16384,
                                   device=args.device)
    print(json.dumps(dict(
        metric="particle_steps_per_sec_1M",
        value=r["particle_steps_per_sec"], unit="particle-steps/s",
        sigma=r.get("particle_steps_per_sec_sigma"),
        samples=r.get("particle_steps_per_sec_samples"),
        mode=args.neighbor_mode, device=r["device"], parity_ok=parity_ok)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
