"""Chip smoke test of the PyTorch + CUDA port (tpufluid_torch) on one GPU.

    python3 chip_smoke.py

Builds the resident engine's CUDA kernels from ``tpufluid_torch/csrc``,
holds each kernel against its plain PyTorch version on the card at scene_1m
shapes (K=8, and the same grid at K=32), runs a synced 20-step comparison
of the kernel step against the plain step, drives
``FluidApp(scene_1m, neighbor_mode="resident", device="cuda").run(200)``
with the launch counters reset just before it, and runs the reference's
default scene (100k particles, gravity) through the CLI's ``run`` path for
512 steps. Any failed phase raises and the script exits non-zero.

Output: progress lines, then the card's name and power limit, then one JSON
line of per-kernel results, and last one JSON line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

# BASELINE.md's measured cross-backend per-step bounds, relative where the
# value exceeds 1: what the kernels must meet against the plain versions
POS_TOL, VEL_TOL, RHO_TOL = 4.8e-7, 3.8e-5, 9.2e-5
SEED = 1234
KERNELS = {
    "rebin": ("tpufluid_torch/csrc/rebin.cu",
              "tpufluid/ops/pallas/fused.py:396"),
    "density": ("tpufluid_torch/csrc/density.cu",
                "tpufluid/ops/pallas/fused.py:627"),
    "forces_integrate": ("tpufluid_torch/csrc/forces.cu",
                         "tpufluid/ops/pallas/fused.py:1702"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want, mask) -> float:
    """max |got - want| / max(1, |want|) over ``mask``."""
    got, want = got[mask].double(), want[mask].double()
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def abs_err(got, want, mask) -> float:
    return float((got[mask].double() - want[mask].double()).abs().max())


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Device ms per call, CUDA events around ``reps`` calls. A ~20 ms sleep
    kernel ahead of them lets the host queue the calls first, so a call
    whose host side is slower than its kernel is still timed on the
    device (unless queuing outlasts the sleep)."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at the H100's 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_state(settings, device):
    """The spawn lattice with seeded random velocities, 256 far movers
    (up to 12 cells a step) and 256 coincident pairs."""
    from tpufluid_torch.state import init_state

    st = init_state(settings, "cpu")
    n = settings.particle_count
    g = torch.Generator().manual_seed(SEED)
    vel = torch.randn((n, 2), generator=g) * 2.0
    far = torch.randperm(n, generator=g)[:256]
    vel[far] = (torch.rand((256, 2), generator=g) * 2.0 - 1.0) * 300.0
    pos = st.position.clone()
    twin = torch.randperm(n - 1, generator=g)[:256]
    pos[twin] = pos[twin + 1]
    vel[twin] = vel[twin + 1]
    return dataclasses.replace(
        st, position=pos.to(device), predicted=pos.clone().to(device),
        velocity=vel.to(device), density=st.density.to(device),
        cell=st.cell.to(device), tick=st.tick.to(device))


def compare_kernels(settings, params, label):
    """Each kernel against its plain version on one grid. Returns per-kernel
    dicts of max_abs_err, and the calls for ``time_kernels``."""
    from tpufluid_torch.ops import fused, resident

    dev = params.device
    gs = resident.from_particles(seeded_state(settings, dev), settings)
    fr = gs.tick + 1
    out = {}

    rargs = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, params.delta,
             settings)
    got, want = fused.rebin(*rargs), fused.rebin_plain(*rargs)
    names = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "far_n", "over_n")
    for a, b, n in zip(got, want, names):
        if not torch.equal(a, b):
            raise AssertionError(f"{label} rebin {n}: kernel != plain")
    n_far = int(got[5].sum())
    if n_far == 0:
        raise AssertionError(f"{label}: the state has no far movers")
    out["rebin"] = dict(max_abs_err=0.0)
    log(f"{label} rebin: bitwise equal to plain (far movers {n_far}, "
        f"over {int(got[6].sum())}, max occupancy {int(got[4].max())})")

    px, py, vx, vy, occ = got[:5]
    dargs = (px, py, vx, vy, occ, params.mass, params.delta,
             params.pressure_constant, params.rest_density, settings)
    pres, invr = fused.density(*dargs)
    pres_p, invr_p = fused.density_plain(*dargs)
    live = px < fused.SENTINEL_HALF
    e_rho = rel_err(1.0 / invr, 1.0 / invr_p, live)
    e_pres = rel_err(pres, pres_p, live)
    if not (e_rho <= RHO_TOL and e_pres <= RHO_TOL):
        raise AssertionError(f"{label} density: rel err rho {e_rho} pres "
                             f"{e_pres} > {RHO_TOL}")
    out["density"] = dict(max_abs_err=max(abs_err(pres, pres_p, live),
                                          abs_err(invr, invr_p, live)))
    log(f"{label} density: rel err rho {e_rho:.3g} pres {e_pres:.3g} "
        f"(bound {RHO_TOL}), max abs err {out['density']['max_abs_err']:.3g}")

    fargs = (px, py, vx, vy, pres, invr, occ, params, settings, fr)
    new = fused.forces_integrate(*fargs)
    new_p = fused.forces_integrate_plain(*fargs)
    errs = [rel_err(a, b, live) for a, b in zip(new, new_p)]
    if not (max(errs[:2]) <= POS_TOL and max(errs[2:]) <= VEL_TOL):
        raise AssertionError(f"{label} forces_integrate: rel errs {errs}")
    for a, b in zip(new, new_p):
        if not torch.equal(a[~live], b[~live]):
            raise AssertionError(f"{label} forces_integrate: dead slots differ")
    out["forces_integrate"] = dict(
        max_abs_err=max(abs_err(a, b, live) for a, b in zip(new, new_p)))
    log(f"{label} forces_integrate: rel err pos {max(errs[:2]):.3g} (bound "
        f"{POS_TOL}) vel {max(errs[2:]):.3g} (bound {VEL_TOL}), max abs err "
        f"{out['forces_integrate']['max_abs_err']:.3g}")

    calls = {
        "rebin": (lambda: fused.rebin(*rargs),
                  lambda: fused.rebin_plain(*rargs)),
        "density": (lambda: fused.density(*dargs),
                    lambda: fused.density_plain(*dargs)),
        "forces_integrate": (lambda: fused.forces_integrate(*fargs),
                             lambda: fused.forces_integrate_plain(*fargs)),
    }
    return out, calls


def time_kernels(calls, out, label) -> None:
    """Kernel and plain times in the order plain, kernel, kernel, plain;
    each number is the mean of its pair. Repeats reuse their inputs, so at
    K=8 (4 x 8.6 MB) these stay in the 50 MB L2, as between the step's
    kernels."""
    for name, (kern, plain) in calls.items():
        p1 = time_ms(plain, 3, warm=1)
        k1 = time_ms(kern, 50)
        k2 = time_ms(kern, 50)
        p2 = time_ms(plain, 3, warm=0)
        out[name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        log(f"{label} {name}: kernel {out[name]['ms']:.4f} ms "
            f"({k1:.4f}, {k2:.4f}), plain {out[name]['plain_ms']:.3f} ms "
            f"({p1:.3f}, {p2:.3f})")


def synced_steps(settings, params, n_steps: int) -> None:
    """The kernel step against the plain step, each step from the plain
    step's state: occupancy, layout, tick and lost bitwise, floats within
    the bounds."""
    from tpufluid_torch.ops import fused, resident

    kstep = resident.make_grid_step(settings)
    pstep = resident.make_plain_grid_step(settings)
    gs = resident.from_particles(seeded_state(settings, params.device),
                                 settings)
    worst = [0.0, 0.0]
    for i in range(n_steps):
        k = kstep(gs, params)
        p = pstep(gs, params)
        for f in ("occ_row", "tick", "lost"):
            if not torch.equal(getattr(k, f), getattr(p, f)):
                raise AssertionError(f"synced step {i}: {f} differs")
        live = p.pos_x < fused.SENTINEL_HALF
        if not torch.equal(k.pos_x < fused.SENTINEL_HALF, live):
            raise AssertionError(f"synced step {i}: slot layout differs")
        e_pos = max(rel_err(k.pos_x, p.pos_x, live),
                    rel_err(k.pos_y, p.pos_y, live))
        e_vel = max(rel_err(k.vel_x, p.vel_x, live),
                    rel_err(k.vel_y, p.vel_y, live))
        if e_pos > POS_TOL or e_vel > VEL_TOL:
            raise AssertionError(f"synced step {i}: rel err pos {e_pos} vel "
                                 f"{e_vel}")
        worst = [max(worst[0], e_pos), max(worst[1], e_vel)]
        gs = p
    log(f"synced {n_steps} steps at {tuple(gs.pos_x.shape)}: layout, "
        f"occupancy, tick and lost bitwise; worst rel err pos {worst[0]:.3g} "
        f"vel {worst[1]:.3g}; lost {int(gs.lost)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from tpufluid_torch import _build, cli
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.models import scenes
    from tpufluid_torch.ops import fused, resident

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    scene = scenes.scene_1m(dev)
    s8 = scene.settings
    s32 = dataclasses.replace(s8, cell_capacity=32)

    # 1. each kernel against its plain version, K=8 and K=32, then timed
    # (deterministic mode for the comparisons only: it slows the plain
    # versions' scatters)
    torch.use_deterministic_algorithms(True)
    res, calls = compare_kernels(s8, scene.params, "scene_1m K=8")
    res32, calls32 = compare_kernels(s32, scene.params, "scene_1m K=32")

    # 2. synced 20-step comparison, kernel step vs plain step
    synced_steps(s8, scene.params, 20)
    torch.use_deterministic_algorithms(False)
    time_kernels(calls, res, "scene_1m K=8")
    time_kernels(calls32, res32, "scene_1m K=32")
    del calls, calls32

    # 3. the main path: FluidApp(scene_1m, resident, cuda).run(200)
    warm = FluidApp(s8, scenes.scene_1m(dev).params, device=dev,
                    neighbor_mode="resident")
    warm.run(20)
    torch.cuda.synchronize()
    del warm
    app = FluidApp(s8, scene.params, device=dev, neighbor_mode="resident")
    torch.cuda.synchronize()
    for name in fused.LAUNCHES:
        fused.LAUNCHES[name] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    app.run(200)
    end.record()
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    ms_step = start.elapsed_time(end) / 200
    m = app.metrics()
    ps, live = resident.to_particles(app.grid_state, app.settings)
    n_live = int(live)
    finite = bool(torch.isfinite(ps.position[:n_live]).all())
    log(f"scene_1m FluidApp.run(200): tick {m['tick']}, lost "
        f"{m['lost_particles']}, live {n_live}, finite {finite}, K "
        f"{m['cell_capacity']}, launches {launches}")
    log(f"scene_1m: {ms_step:.4f} ms/step, {1e3 * s8.particle_count / ms_step:.4e} "
        f"particle-steps/s (CUDA events over 200 steps after a 20-step "
        f"warm-up; {card})")
    if not (m["tick"] == 200 and m["lost_particles"] == 0
            and n_live == s8.particle_count and finite):
        raise AssertionError(f"scene_1m run failed: {m}, live {n_live}")
    if any(launches[n] != 200 for n in launches):
        raise AssertionError(f"kernel launches in the run: {launches}")

    # 4. the reference's default scene through the CLI's run path
    args = cli.parser().parse_args([
        "run", "--device", "cuda", "--neighbor-mode", "resident",
        "--cell-capacity", "8", "--gravity", "0", "-9.8", "--steps", "512",
        "--report-every", "128"])
    t0 = time.perf_counter()
    app100 = cli.run(args)
    wall = time.perf_counter() - t0
    m = app100.metrics()
    _, live = resident.to_particles(app100.grid_state, app100.settings)
    log(f"default scene (100k, 53x53, g -9.8), 512 steps: lost "
        f"{m['lost_particles']}, live {int(live)}, regrows {m['n_regrows']}, "
        f"final K {m['cell_capacity']}, wall {wall:.2f} s")
    if not (m["tick"] == 512 and m["lost_particles"] == 0
            and int(live) == 100_000):
        raise AssertionError(f"default scene failed: {m}, live {int(live)}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=res[name]["max_abs_err"],
            ms=res[name]["ms"], plain_ms=res[name]["plain_ms"],
            k32=dict(max_abs_err=res32[name]["max_abs_err"],
                     ms=res32[name]["ms"],
                     plain_ms=res32[name]["plain_ms"])))
    print(card)
    print(json.dumps({"kernels": kernels, "ms_per_step": ms_step}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
