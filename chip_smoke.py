"""Chip smoke test of the PyTorch + CUDA port (tpufluid_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpufluid_torch/csrc`` and runs, in order:

1. each resident-step kernel (rebin, density, forces_integrate) against its
   plain PyTorch version on the card at scene_1m shapes (K=8, and the same
   grid at K=32), timed;
2. a synced 20-step comparison of the kernel step against the plain step;
3. ``FluidApp(scene_1m, neighbor_mode="resident", device="cuda").run(200)``
   with the launch counters reset just before it, then a torch.profiler
   reading of 20 more steps;
4. the reference's default scene (100k particles, gravity) through the
   CLI's ``run`` path for 512 steps;
5. the metaball coarse-field kernel against its plain version, bitwise,
   at scene_1m (K=8, K=32) and on phase 4's high-occupancy grid, timed;
6. forces_integrate's obstacle (has_ff) variant against its plain version
   at scene_1m, and 20 synced obstacle steps, kernel step against plain;
7. the render path through the CLI's parser: 16 frames at 960x540 of the
   default scene falling onto a circle, counters reset just before it;
8. the frame breakdown at scene_1m, 960x540;
9. the pallas engine's two kernels (sph_density, sph_forces) against their
   plain versions, bitwise over the whole grid, on the slot grid of a
   seeded scene_1m state (K=8, K=32), the surface-tension variant on an
   h = 1.5 scene of 65,536 particles and the adaptive variant on scene_1m
   with a clump above density 200, timed; on the last two grids the
   dense engine's kernels (dense_density, dense_forces) against the roll
   passes (``ops.dense.density_pass``, ``force_pass``) with the flag,
   bitwise over the whole grid;
10. 20 synced pallas-mode steps at scene_1m, kernel step against plain step;
11. ``FluidApp(scene_1m, neighbor_mode="pallas", device="cuda").run(200)``
    with the launch counters reset just before it, and a torch.profiler
    reading of 16 more steps (no ``torch.cummax`` scan among its kernels);
    then the CLI's ``run --neighbor-mode pallas`` on the reference's
    default scene under gravity (the app sizes K for the compression
    peak), counters reset just before it, and both kernels bitwise
    against their plain versions on its last slot grid, timed there;
12. engine parity through the harness (``tpufluid_torch.bench.run_parity``
    on bench.py's parity scene: grid and pallas within 1e-4 of dense over
    10 steps, the resident engine's mass and nearest-neighbour distance,
    the 200-step invariants of dense and resident), and the CLI's default
    ``run`` (the dense engine) on the reference's default scene for 64
    steps, counters reset just before it (one launch of dense_build,
    dense_density, dense_forces and dense_readback a step, no other
    kernel); then both pass kernels against the roll passes, bitwise over
    the whole grid, on its last slot grid ([267, 16, 384]) with the base
    flags, surface tension and adaptive subsampling, timed against the
    passes, and the build and read-back kernels against their plain
    versions (``build_grid_cols``, ``readback_cols``) on the same state,
    bitwise, timed against them;
13. forces_integrate's variants against their plain versions, bitwise:
    x wrap at scene_1m with movers across the x walls, surface tension at
    scene_1m (and at h = 1.5, where it acts), adaptive subsampling on the
    clumped K=16 state, timed; then 200 steps of
    ``FluidApp(scene_1m, resident, wrap, surface tension, adaptive)``;
14. BASELINE config 4 (eight 131,072-particle worlds stacked to
    ``[544, 8, 512]``): rebin with row_shift, density and forces with wid
    against their plain versions, bitwise, timed; 10 batched steps
    against 8 single-world runs, bitwise; ms/step of
    ``make_grid_multi_step(n_worlds=8)`` over 200 steps;
15. the fused physics kernel against the split kernel pair and its plain
    version, bitwise, at scene_1m K=8 and K=32, on phase 4's K=192 grid,
    with has_ff, with the three variant flags, with wid on config 4's
    stack, and on phase 18's grids: 41 rows (ragged for every tile
    height) with a full row at K=8 (base and the three flags) and at the
    largest K its tile takes, and sparse at K=8 (the three flags), each
    with its tile logged; timed against the pair; resident ms/step split
    vs fused at scene_1m;
16. the CLI's ``run --neighbor-mode resident`` with ``--x-boundary wrap
    --surface-tension --adaptive-subsampling`` on the default scene;
17. the round-1 rebin with a valid mask (``ops.rebin.rebin_valid``, no
    caller on any path) against its plain version, bitwise: at scene_1m's
    grid with valid_f from the seeded state (timed), the same mask with a
    tenth of its valid slots set to 0 over their stale data, phase 4's
    K=192 grid, and a hand-made grid with valid slots in the clamped
    first and last rows and columns;
18. the tile kernels of density and forces_integrate against their plain
    versions, bitwise, at every tile shape the kernels pick: scene_1m
    K=8 (its 524 rows ragged for the density tile), the clump at K=16,
    scene_1m K=32, phase 4's K=192 grid (64 rows from its densest one; the
    whole grid timed) and a small grid of 41 rows (ragged for every tile
    height) at K=8 and K=256 with a row at full occupancy, and sparse (60
    particles, halo rows of at most one slot) at K=8 and K=192; with each
    variant flag, an obstacle field and two worlds (wid); rebin bitwise
    against its plain version on each of those grids, and on the whole
    K=192 grid, timed; the metaball coarse kernel on the K=256 full-row
    grid (supersample 8) and the sparse K=192 grid (supersample 1); the
    pallas engine's sph_density and sph_forces, bitwise with each flag, on
    the slot grids of the same particles (41 rows at K=8 and 256, sparse
    at K=8 and 192), on a hand-made grid with live slots in the clamped
    first and last rows and the wrapped first and last columns, and on
    the K=8 grid with its empty slots at nonzero positions;
19. ``FluidApp.set_mouse`` at scene_1m: 16 resident ticks with the mouse
    repelling at the centre against 16 with it off;
20. the chamfer push-out field of a video frame: the compiled host copy
    (``csrc/distfield.cpp``) against its NumPy plain version, bitwise, on
    a seeded 1024x1024 stack of 4 frames (a moving dark disc), both timed;
21. ``render --video-field`` through the CLI's parser on the default
    scene, resident engine, 4 frames at 960x540: frame i under field i,
    no loss, all finite, no particle inside the last disc, ms/frame;
22. the NaN-provenance tools at scene_1m: ``diagnose_resident_step``
    clean and with an inf in a live velocity (``input`` not finite),
    ``checked_step`` on the grid and dense engines, clean and with a NaN
    input (located at ``input``);
23. the row-band sharded resident step on D = 2 and 4 shards of one card
    (``[cuda:0] * D``): first its far-mover kernels (``csrc/far_sharded.cu``,
    collect and insert, gated on the device) against their plain
    versions, bitwise, on the post-merge bands of scene_1m's lattice with
    16 far movers crossing bands (timed), at rest (none; timed), the
    seeded state over a capacity of 8 a band (packet drops), and the wall
    movers after a wrap step (thousands; timed); then the step, graphed
    (a CUDA graph a call), from the lattice with 16 far movers, without
    and with a push field that varies by row: bitwise against its plain
    version over 4 synced steps (rebin with a row shift on band + 2 rows,
    density and forces on band + 4 rows with the windowed field) and
    against its eager twin over 8, then 32 graphed steps with the counts
    reset under ``torch.cuda.set_sync_debug_mode("error")``, held to the
    single-device step (live count, no loss, sorted positions), graphed
    against eager ms/step, the capture's seconds and nodes, the audited
    traffic against the formula; ms/step at D = 1, 2, 4;
24. the slab-sharded step of the per-step engines on D = 2 and 4 shards
    of one card, scene_1m's lattice under gravity: pallas mode bitwise
    against its plain version over 4 synced steps (the sph kernels on
    slab-local grids 384 and 256 columns wide), dense and pallas within
    1e-6 of the single-device step after 2 steps, 16 timed steps each
    with the launches counted (one of each sph kernel, or of each dense
    kernel, a shard a step), and the audited bytes against the
    formula; grid mode on bench.py's parity scene within 5e-4 of the
    single-device step over 5 steps, and 40 steps of sideways gravity
    moving particles across slabs with none lost; every slab step after
    a warm one under ``torch.cuda.set_sync_debug_mode("error")``; each
    mode's graphed step (a CUDA graph a call) bitwise its eager twin over
    4 steps, both timed, with the capture's seconds and nodes;
25. the bench harness: the CLI's ``bench --config 1`` and ``--config 4``
    (JSON lines parsed, finite ms/step), ``bench_sharded`` resident and
    dense on ``[cuda:0] * 2``, and the CPU-vs-card divergence of the
    grid step over 50 synced steps;
26. config 5's derived 4M/8-card estimate (``bench.config5_model``): first
    rebin, density and forces_integrate against their plain versions,
    bitwise, on the band's [132, 8, 1024] grid, 3 band steps against 3
    plain steps (65 lost, as JAX's band), and one step of the sharded
    resident step on 8 shards of scene_4m against its plain version, none
    lost; then, counts reset just before it, the model: one band of
    scene_4m's 8-shard spec timed on the card, and one audited step of the
    sharded resident step on 8 shards of the card at scene_4m, whose bytes
    must equal the formula's 397,320; then a torch.profiler reading of 20
    band steps and the band's losses, and the graphed sharded step's
    ms/step at scene_4m on 8 shards of the card (a shard's share against
    the band's);
27. the resident step's far-mover pass (``csrc/far_reinsert.cu``, gated on
    the device) against its plain version, bitwise: scene_1m's seeded
    state (256 far movers), the lattice at rest (none: the rebin's outputs
    untouched), over a capacity of 100, the wall movers after a wrap step,
    config 4's stack; timed with none, with the seeded movers and in the
    wrap run; then each burst graphed (a CUDA graph replayed once a step)
    against the same burst run eagerly, bitwise, and both timed, with the
    capture's seconds and node count: the resident step (64 steps at
    scene_1m, the wrap + surface tension + adaptive variant, config 4, 16
    obstacle steps under one field and 16 under a swapped one), one burst
    under ``torch.cuda.set_sync_debug_mode("error")`` with its launches
    counted, and the grid, dense and pallas engines on the CLI's default
    scene. Phase 3's run counts 200 launches of the far-mover pass.

Any failed phase raises and the script exits non-zero. Output: progress
lines (each after the seconds since the start), then the card's name and
power limit, then one JSON line of per-kernel results, and last one JSON
line ``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero and prints no result.
Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

# the script's start, for the progress lines
T_START = time.perf_counter()

# f32 machine epsilon, the density floor (funcs.wgsl:55)
EPSILON = 1.19209290e-07
# BASELINE.md's measured cross-backend per-step bounds, relative where the
# value exceeds 1: what the kernels must meet against the plain versions
POS_TOL, VEL_TOL, RHO_TOL = 4.8e-7, 3.8e-5, 9.2e-5
# the sharded step against the single-device step, each coordinate sorted:
# only the order of slots in merged edge rows and far-inserted cells
# differs, so f32 sums round apart: a few ulps of |x| <= 52 (3.8e-6) by
# step 4, and by step 32 at most a twentieth of h, however chaos grows it
SHARD_DRIFT_4, SHARD_DRIFT_32 = 1e-4, 1e-2
# the metaball coarse fields: |kernel - plain| <= FIELD_TOL * max(1, |plain|)
FIELD_TOL = 1e-5
SEED = 1234
# the dense engine's kernels (tpufluid_torch._build.LAUNCHES names)
DENSE_KERNELS = ("dense_density", "dense_forces", "dense_build",
                 "dense_readback")
# the H100 SXM's published peaks (at 700 W): HBM bytes/s, f32 (non-tensor)
# operations/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# f32 operations per unit of work, counted from the kernel sources: per live
# particle (rebin: predict 2 x 4, cell 2 x 3), per live (target, candidate)
# pair (density: predict 8, distance 5, kernel 5; forces: predict 8,
# distance 7, pressure 11, viscosity 17), per live (sample, candidate) pair
# (metaball_coarse: distance 5, scale 1, exp 1, sums 3)
OPS = {"rebin": 14, "rebin_valid": 14, "density": 18,
       "forces_integrate": 43, "metaball_coarse": 10}
# forces_integrate's variants: f32 operations per live pair beyond the
# base 43, counted from csrc/resident_math.cuh (surface tension: direction
# 2, length 4, gradient weight 5, mass / rho 1, two gradient sums 6, the
# Laplacian 6, its sum 3; adaptive: the stride factor's multiply). The
# wrap changes only the per-particle wall test.
OPS_VARIANT = {"wrap": 0, "surface_tension": 27, "adaptive": 1}
# the dense engine's kernels, per (target, live candidate) pair of the 3x3
# stencil: (every pair, a pair in range), and per live slot: what the
# function needs, counted from csrc/sph_density.cu (every pair 6: distance
# 5 (2 sub, 2 mul, add), the range compare; in range 6: h^2 - r^2, the
# cube's 2 mul, mass and norm 2 mul, the sum; the kernel runs the in-range
# work on every pair, branch-free, but an out-of-range pair needs none of
# it) and csrc/sph_forces.cu (every pair 6: distance 5, the range
# compare; in range 36: sqrt, the 1/dst division, 2 direction mul, 4
# compares and selects, the pressure term 8, the viscosity term 12, the
# four sums 8; per live slot 4: the pressure k (rho - rho0) and 1/rho,
# staged once). sph_density's targets are the live slots and, per cell
# with an empty slot, its first one (the cell's other empty slots share
# that sum); sph_forces' the live slots.
OPS_SPH = {"sph_density": (6, 6, 0), "sph_forces": (6, 36, 4)}
# (f32 input fields read below each cell's occupancy, f32 output fields
# written whole); the bool valid mask is read whole
IO_SPH = {"sph_density": (2, 1), "sph_forces": (5, 4)}
# the dense engine's kernels (the same tiles with the roll's pair terms),
# counted as OPS_SPH from the ROLL forms of csrc/sph_density.cu (every
# pair 6, in range 6: as sph_density) and csrc/sph_forces.cu (every pair
# 6; in range 36: sqrt, the safe distance, two divisions for the
# direction, the coincidence test; the pressure term 11: shared pressure
# 2, the spiky kernel 3, its product and division by rho 2, two mul and
# two sums; the viscosity term 20: the kernel's 13 with its three
# divisions and two selects, the division by rho, two differences, two
# mul, two sums; per live slot 3: the pressure k (rho - rho0) and the
# safe rho, staged once); their fields as IO_SPH's
OPS_SPH.update({"dense_density": (6, 6, 0), "dense_forces": (6, 36, 3)})
IO_SPH.update({"dense_density": (2, 1), "dense_forces": (5, 4)})
KERNELS = {
    "rebin": ("tpufluid_torch/csrc/rebin.cu",
              "tpufluid/ops/pallas/fused.py:396"),
    "rebin_valid": ("tpufluid_torch/csrc/rebin_valid.cu",
                    "tpufluid/ops/pallas/rebin.py:124"),
    "density": ("tpufluid_torch/csrc/density.cu",
                "tpufluid/ops/pallas/fused.py:627"),
    "forces_integrate": ("tpufluid_torch/csrc/forces.cu",
                         "tpufluid/ops/pallas/fused.py:1702"),
    "physics": ("tpufluid_torch/csrc/physics.cu",
                "tpufluid/ops/pallas/fused.py:1608"),
    "metaball_coarse": ("tpufluid_torch/csrc/metaball_coarse.cu",
                        "tpufluid/ops/pallas/render.py:103"),
    "sph_density": ("tpufluid_torch/csrc/sph_density.cu",
                    "tpufluid/ops/pallas/sph.py:104"),
    "sph_forces": ("tpufluid_torch/csrc/sph_forces.cu",
                   "tpufluid/ops/pallas/sph.py:350"),
    # the counterparts of XLA code (the dense engine's roll passes), no
    # Pallas kernel
    "dense_density": ("tpufluid_torch/csrc/sph_density.cu",
                      "tpufluid/ops/dense.py:122"),
    "dense_forces": ("tpufluid_torch/csrc/sph_forces.cu",
                     "tpufluid/ops/dense.py:146"),
    # the counterparts of XLA's slot-grid scatter and read-back gather
    # around the roll passes, no Pallas kernel
    "dense_build": ("tpufluid_torch/csrc/dense_glue.cu",
                    "tpufluid/ops/dense.py:76"),
    "dense_readback": ("tpufluid_torch/csrc/dense_glue.cu",
                       "tpufluid/ops/dense.py:353"),
    # the counterpart of XLA code (do_far under lax.cond), no Pallas kernel
    "far_reinsert": ("tpufluid_torch/csrc/far_reinsert.cu",
                     "tpufluid/ops/resident.py:396"),
    # the row-band sharded step's do_far under lax.cond (XLA code): its
    # packet half and its insert half
    "far_collect": ("tpufluid_torch/csrc/far_sharded.cu",
                    "tpufluid/parallel/shard.py:661"),
    "far_insert": ("tpufluid_torch/csrc/far_sharded.cu",
                   "tpufluid/parallel/shard.py:684"),
}
# bench.py:run_parity's scene (the slab step's grid-mode gate, phase 24)
PARITY_N = 16384
# obstacles of phases 6 and 7 (scene_1m world: 101.95 x 104.1)
OBSTACLES_1M = [("circle", (0.0, 0.0), 6.0), ("circle", (-20.0, 10.0), 4.0),
                ("circle", (15.0, -12.0), 3.0),
                ("rect", (5.0, 20.0), (12.0, 5.0), 0.5)]
CIRCLE_7 = (0.0, -20.0, 4.0)
# BASELINE config 4 (bench.py): eight 128k worlds, gravity -linspace(0, 2),
# viscosity linspace(5, 40)
CONFIG4_WORLDS = 8
# surface tension's parameters in the JAX package's tests
ST_PARAMS = dict(surface_tension_threshold=0.05,
                 surface_tension_coefficient=5.0)


def log(msg: str) -> None:
    """A progress line, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


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
    """Device ms per call, CUDA events around ``reps`` calls. A sleep
    kernel ahead of them lets the host queue the calls first, so a call
    whose host side is slower than its kernel is still timed on the
    device. Where the device reached the first call before the host had
    queued the last (a slow host), a reading of 10 calls or more is taken
    again behind a sleep ten times as long; fewer reps (the plain
    versions, which may sync) are timed as they run."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for cycles in (40_000_000, 400_000_000):  # ~20, ~200 ms at 1.98 GHz
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()  # the device still sleeps
        end.record()
        torch.cuda.synchronize()
        if queued or reps < 10:
            break
    return start.elapsed_time(end) / reps


def seeded_state(settings, device, seed=SEED):
    """The spawn lattice with seeded random velocities, 256 far movers
    (up to 12 cells a step) and 256 coincident pairs."""
    from tpufluid_torch.state import init_state

    st = init_state(settings, "cpu")
    n = settings.particle_count
    g = torch.Generator().manual_seed(seed)
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


def bound(n_bytes: float, n_ops: float):
    """(ms, "bytes" | "operations"): the least time the card could take,
    bytes read and written once over the memory rate against the f32
    operations over the f32 peak."""
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = n_ops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def live_per_cell(pos_x):
    from tpufluid_torch.ops.fused import SENTINEL_HALF

    return (pos_x < SENTINEL_HALF).sum(dim=1).double()  # [Gy, Gxp]


def stencil_pairs(pos_x) -> float:
    """Live (target, candidate) pairs over the 3x3 cell stencil: the work
    of density and forces on this grid."""
    c = live_per_cell(pos_x)
    box = torch.nn.functional.conv2d(
        c[None, None], torch.ones(1, 1, 3, 3, dtype=c.dtype,
                                  device=c.device), padding=1)[0, 0]
    return float((c * box).sum())


def coarse_pairs(pos_x, sup: int = 2) -> float:
    """Live (sample, candidate) pairs of the metaball coarse kernel. The
    8 x (sup * Gxp) samples of block p read the source rows 8p/sup - 3 ..
    + n_rows - 1, 7 columns each; over a row of samples every column is
    read sup times per dx, so the block's pairs are 8 * sup * 7 * (live
    particles in its rows)."""
    gy = pos_x.shape[0]
    rows = live_per_cell(pos_x).sum(dim=1).cpu()  # live per source row
    n_rows = 7 // sup + 1 + 6
    total = 0.0
    for p in range(sup * gy // 8):
        r0 = (8 * p) // sup - 3
        total += float(rows[max(r0, 0):min(r0 + n_rows, gy)].sum())
    return total * 8 * sup * 7


def grid_bytes(a) -> int:
    return a.numel() * a.element_size()


def resident_bytes(px, occ_row, n_in: int, n_out: int) -> int:
    """Bytes a resident kernel must move: of each of its ``n_in`` input
    fields [Gy, K, Gxp] the slots below their row's occupancy (the slots
    above are empty by the grid's invariant, and their outputs are fixed),
    and the whole of each of its ``n_out`` output fields."""
    k, gx = px.shape[1], px.shape[2]
    live = int(torch.clamp(occ_row, max=k).sum()) * gx * px.element_size()
    return n_in * live + n_out * grid_bytes(px)


def compare_kernels(settings, params, label):
    """Each kernel against its plain version on one grid. Returns per-kernel
    dicts of max_abs_err and the bound, and the calls for
    ``time_kernels``."""
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
    bitwise((pres, invr), (pres_p, invr_p), f"{label} density")
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
    bitwise(new, new_p, f"{label} forces_integrate")
    out["forces_integrate"] = dict(
        max_abs_err=max(abs_err(a, b, live) for a, b in zip(new, new_p)))
    log(f"{label} forces_integrate: rel err pos {max(errs[:2]):.3g} (bound "
        f"{POS_TOL}) vel {max(errs[2:]):.3g} (bound {VEL_TOL}), max abs err "
        f"{out['forces_integrate']['max_abs_err']:.3g}")

    n_live = float(live_per_cell(gs.pos_x).sum())
    pairs = stencil_pairs(px)
    for name, n_bytes, n_ops in (
            ("rebin", resident_bytes(gs.pos_x, gs.occ_row, 4, 4),
             OPS["rebin"] * n_live),
            ("density", resident_bytes(px, occ, 4, 2),
             OPS["density"] * pairs),
            ("forces_integrate", resident_bytes(px, occ, 6, 4),
             OPS["forces_integrate"] * pairs)):
        out[name]["bound_ms"], out[name]["bound_by"] = bound(n_bytes, n_ops)
    log(f"{label}: {n_live:.0f} live particles, {pairs:.4e} stencil pairs")

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
            f"({p1:.3f}, {p2:.3f}), bound {out[name]['bound_ms']:.4f} ms "
            f"({out[name]['bound_by']})")


def synced_steps(settings, params, n_steps: int, field=None) -> None:
    """The kernel step against the plain step, each step from the plain
    step's state: occupancy, layout, tick and lost bitwise, floats within
    the bounds. ``field``: an obstacle push-out field (the has_ff step)."""
    from tpufluid_torch.ops import fused, resident

    has_ff = field is not None
    extra = (field,) if has_ff else ()
    kstep = resident.make_grid_step(settings, has_force_field=has_ff)
    pstep = resident.make_plain_grid_step(settings, has_force_field=has_ff)
    gs = resident.from_particles(seeded_state(settings, params.device),
                                 settings)
    worst = [0.0, 0.0]
    for i in range(n_steps):
        k = kstep(gs, params, *extra)
        p = pstep(gs, params, *extra)
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
    log(f"synced {n_steps} {'obstacle ' if has_ff else ''}steps at "
        f"{tuple(gs.pos_x.shape)}: layout, "
        f"occupancy, tick and lost bitwise; worst rel err pos {worst[0]:.3g} "
        f"vel {worst[1]:.3g}; lost {int(gs.lost)}")


def compare_coarse(gs, settings, label, plain_reps):
    """The metaball coarse kernel against its plain version on one grid,
    then timed (plain, kernel, kernel, plain)."""
    from tpufluid_torch.ops import render_coarse

    speed = torch.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
    args = (gs.pos_x, gs.pos_y, speed, gs.occ_row, settings, 2)
    got = render_coarse.coarse_metaball_fields(*args)
    want = render_coarse.coarse_metaball_fields_plain(*args)
    full = torch.ones_like(want[0], dtype=torch.bool)
    e_rel = max(rel_err(a, b, full) for a, b in zip(got, want))
    e_abs = max(abs_err(a, b, full) for a, b in zip(got, want))
    if not (e_rel <= FIELD_TOL and float(want[0].max()) > 1.0):
        raise AssertionError(f"{label} metaball_coarse: rel err {e_rel} > "
                             f"{FIELD_TOL}")
    bitwise(got, want, f"{label} metaball_coarse")
    kern = lambda: render_coarse.coarse_metaball_fields(*args)
    plain = lambda: render_coarse.coarse_metaball_fields_plain(*args)
    p1 = time_ms(plain, plain_reps, warm=1)
    k1 = time_ms(kern, 50)
    k2 = time_ms(kern, 50)
    p2 = time_ms(plain, plain_reps, warm=0)
    pairs = coarse_pairs(gs.pos_x)
    n_bytes = 3 * grid_bytes(gs.pos_x) + 2 * grid_bytes(want[0])
    b_ms, b_by = bound(n_bytes, OPS["metaball_coarse"] * pairs)
    res = dict(max_abs_err=e_abs, max_rel_err=e_rel, ms=(k1 + k2) / 2,
               plain_ms=(p1 + p2) / 2, bound_ms=b_ms, bound_by=b_by,
               grid=list(gs.pos_x.shape),
               max_occupancy=int(gs.occ_row.max()))
    log(f"{label} metaball_coarse {tuple(gs.pos_x.shape)} (max occupancy "
        f"{res['max_occupancy']}, {pairs:.4e} pairs): bitwise equal to "
        f"plain (max rel err {e_rel:.3g}, bound {FIELD_TOL}); kernel "
        f"{res['ms']:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
        f"{res['plain_ms']:.3f} ms ({p1:.3f}, {p2:.3f}), bound {b_ms:.4f} "
        f"ms ({b_by})")
    return res


def compare_has_ff(settings, params, field, label):
    """forces_integrate with an obstacle field against its plain version
    on the seeded scene_1m state, then timed."""
    from tpufluid_torch.ops import fused, resident

    gs = resident.from_particles(seeded_state(settings, params.device),
                                 settings)
    ffc = resident.forcefield_cells(field, settings)
    px, py, vx, vy, occ = fused.rebin(gs.pos_x, gs.pos_y, gs.vel_x,
                                      gs.vel_y, gs.occ_row, params.delta,
                                      settings)[:5]
    pres, invr = fused.density(px, py, vx, vy, occ, params.mass,
                               params.delta, params.pressure_constant,
                               params.rest_density, settings)
    fargs = (px, py, vx, vy, pres, invr, occ, params, settings, gs.tick + 1)
    new = fused.forces_integrate(*fargs, ff_cells=ffc)
    new_p = fused.forces_integrate_plain(*fargs, ff_cells=ffc)
    base = fused.forces_integrate(*fargs)
    live = px < fused.SENTINEL_HALF
    errs = [rel_err(a, b, live) for a, b in zip(new, new_p)]
    if not (max(errs[:2]) <= POS_TOL and max(errs[2:]) <= VEL_TOL):
        raise AssertionError(f"{label} forces_integrate has_ff: rel errs "
                             f"{errs}")
    bitwise(new, new_p, f"{label} forces_integrate has_ff")
    pushed = int(((new[0] != base[0]) & live).sum())
    if pushed < 1000:
        raise AssertionError(f"{label} has_ff: only {pushed} pushed")
    kern = lambda: fused.forces_integrate(*fargs, ff_cells=ffc)
    plain = lambda: fused.forces_integrate_plain(*fargs, ff_cells=ffc)
    p1 = time_ms(plain, 3, warm=1)
    k1 = time_ms(kern, 50)
    k2 = time_ms(kern, 50)
    p2 = time_ms(plain, 3, warm=0)
    n_bytes = resident_bytes(px, occ, 6, 4) + 2 * grid_bytes(ffc[0])
    b_ms, b_by = bound(n_bytes, OPS["forces_integrate"] * stencil_pairs(px))
    res = dict(max_abs_err=max(abs_err(a, b, live)
                               for a, b in zip(new, new_p)),
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    log(f"{label} forces_integrate has_ff: {pushed} particles pushed; rel "
        f"err pos {max(errs[:2]):.3g} (bound {POS_TOL}) vel "
        f"{max(errs[2:]):.3g} (bound {VEL_TOL}), max abs err "
        f"{res['max_abs_err']:.3g}; kernel {res['ms']:.4f} ms ({k1:.4f}, "
        f"{k2:.4f}), plain {res['plain_ms']:.3f} ms ({p1:.3f}, {p2:.3f}), "
        f"bound {b_ms:.4f} ms ({b_by})")
    return res


def reset_counts():
    """Every kernel's launch count (``_build.LAUNCHES``) to 0, the
    far-mover pass's (which ``read_counts`` leaves out) too."""
    from tpufluid_torch._build import LAUNCHES

    for name in LAUNCHES:
        LAUNCHES[name] = 0


def read_counts() -> dict:
    """Every kernel's launch count but the far-mover pass's."""
    from tpufluid_torch._build import LAUNCHES

    return {n: v for n, v in LAUNCHES.items() if n != "far_reinsert"}


def render_cli():
    """The render path through the CLI's parser: the default scene falls
    onto a circle below it, 16 frames (256 ticks, so the grow policy's loss
    audit at tick 256 and any regrow-and-replay run before the last frame
    is shaded) at 960x540. Returns (result dict, launch counts)."""
    import numpy as np
    from tpufluid_torch import cli
    from tpufluid_torch.ops import render as renderops
    from tpufluid_torch.ops import resident
    from tpufluid_torch.utils import io as ioutils

    cx, cy, r = CIRCLE_7
    with tempfile.TemporaryDirectory() as out:
        args = cli.parser().parse_args([
            "render", "--device", "cuda", "--neighbor-mode", "resident",
            "--gravity", "0", "-9.8", "--cell-capacity", "8", "--circle",
            str(cx), str(cy), str(r), "--frames", "16", "--width", "960",
            "--height", "540", "--out", out])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        app = cli.render(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        names = sorted(os.listdir(out))
        frames = [ioutils.read_png(os.path.join(out, n)) for n in names]
    m = app.metrics()
    _, live = resident.to_particles(app.grid_state, app.settings)
    log(f"render CLI (default scene, circle {CIRCLE_7}, 16 frames 960x540): "
        f"{len(names)} PNGs, tick {m['tick']}, lost {m['lost_particles']}, "
        f"live {int(live)}, regrows {m['n_regrows']}, final K "
        f"{m['cell_capacity']}, wall {wall:.2f} s, "
        f"{1e3 * wall / 16:.1f} ms/frame; launches {launches}")
    if not (names == [f"frame_{i:05d}.png" for i in range(16)]
            and all(f.shape == (540, 960, 4) and f.dtype == np.uint8
                    for f in frames)):
        raise AssertionError(f"render CLI frames: {names}")
    if not (m["tick"] == 256 and m["lost_particles"] == 0
            and int(live) == 100_000):
        raise AssertionError(f"render CLI run: {m}, live {int(live)}")
    if not (launches["metaball_coarse"] == 16
            and launches["forces_integrate_has_ff"]
            == launches["forces_integrate"] > 0
            and launches["rebin"] == launches["density"]
            == launches["forces_integrate"]
            and launches["sph_density"] == launches["sph_forces"] == 0):
        raise AssertionError(f"render CLI launches: {launches}")

    # the hole: every pixel more than 3h inside the circle is background.
    # The circle lies below the default view (53 x 29.8 around the
    # origin), so the last state is shaded once more with a camera on it.
    h = app.settings.smoothing_radius
    cam = renderops.Camera(center=(cx, cy), view_size=(16.0, 9.0))
    img = renderops.to_rgba8(app.render_frame(960, 540, camera=cam))
    img = img.cpu().numpy()
    pts = cam.pixel_world_coords(960, 540, "cpu").numpy()
    d = np.hypot(pts[..., 0] - cx, pts[..., 1] - cy)
    bg = (img[..., :3] == 0).all(axis=-1) & (img[..., 3] == 255)
    deep = d < r - 3 * h
    ring = (d > r) & (d < r + 2.0)
    fluid_near = int((~bg & ring).sum())
    log(f"obstacle hole: {int(deep.sum())} pixels more than 3h inside the "
        f"circle, {int((~bg & deep).sum())} of them not background; "
        f"{fluid_near} fluid pixels within 2 of its rim")
    if not (deep.sum() > 1000 and bg[deep].all() and fluid_near > 1000):
        raise AssertionError("render CLI: no clean obstacle hole")
    return dict(frames=len(names), tick=m["tick"], lost=m["lost_particles"],
                live=int(live), n_regrows=m["n_regrows"],
                final_k=m["cell_capacity"], wall_s=wall,
                ms_per_frame=1e3 * wall / 16), launches


def frame_breakdown(app, card):
    """CUDA-event ms of the render path's parts at 960x540 on the app's
    grid, and of a 16-tick frame plus its render (the ticks' wall time is
    host-bound, so also the device's busy ms over two frames)."""
    from tpufluid_torch.ops import render as renderops
    from tpufluid_torch.ops import render_binned, render_coarse, render_grid

    gs, s = app.grid_state, app.settings
    cam = renderops.Camera(view_size=(s.size[0], s.size[0] * 540 / 960))
    speed = torch.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
    coarse = lambda: render_coarse.coarse_metaball_fields(
        gs.pos_x, gs.pos_y, speed, gs.occ_row, s, 2)
    fields = coarse()
    resample = lambda: render_grid.resample_fields(fields, s, 960, 540,
                                                   cam, 2)
    dens, velf = resample()
    out = dict(
        coarse_ms=time_ms(coarse, 20),
        resample_ms=time_ms(resample, 20),
        shade_ms=time_ms(lambda: render_binned.shade_metaball(dens, velf),
                         20),
        render_frame_ms=time_ms(lambda: app.render_frame(960, 540), 20))
    app.run(16)
    app.render_frame(960, 540)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        app.run(16)
        app.render_frame(960, 540)
    end.record()
    torch.cuda.synchronize()
    out["ms_per_frame"] = start.elapsed_time(end) / 5

    def one_frame():
        app.run(16)
        app.render_frame(960, 540)

    prof = profile_steps(app, 2, "scene_1m frame (16 ticks + render)",
                         step=one_frame)
    out["busy_ms_per_frame"] = (None if prof is None
                                else prof["busy_ms_per_step"])
    log(f"scene_1m frame at 960x540: coarse kernel {out['coarse_ms']:.4f} "
        f"ms, resample (2 x 2 matmuls) {out['resample_ms']:.4f} ms, shading "
        f"{out['shade_ms']:.4f} ms, render_frame {out['render_frame_ms']:.4f}"
        f" ms; 16 ticks + render {out['ms_per_frame']:.3f} ms/frame (CUDA "
        f"events over 5 frames), device busy "
        f"{out['busy_ms_per_frame'] or 0:.4f} ms/frame ({card})")
    return out


# ------------------------------------------------ the dense engine (9-12)

def dense_grid_of(state, settings, params):
    """The pallas-mode step's slot grid of a state: predicted positions,
    binned and packed by cell (``ops.dense.build_grid``)."""
    from tpufluid_torch import step as tstep
    from tpufluid_torch.ops import dense, grid

    pred = tstep.predict_positions(state.position, state.velocity,
                                   params.delta, settings)
    b = grid.bin_particles(grid.cell_id(pred, settings), settings)
    return dense.build_grid(pred[b.perm], state.velocity[b.perm],
                            b.sorted_cells, settings)


def sph_pairs(g, settings, roll: bool = False) -> dict:
    """(target, live candidate) pairs of the 3x3 stencil (rows clamped,
    or wrapped with ``roll`` as the dense kernels walk them; columns
    wrapped), and those in range: for the density kernels the targets
    are each cell's live slots and its first empty one (r^2 < h^2), for
    the forces kernels the live slots (r^2 <= h^2). Also the live
    slots."""
    from tpufluid_torch.ops import sph

    def rows3(a):
        if roll:
            return [torch.roll(a, -r, dims=0) for r in (-1, 0, 1)]
        return sph._rows3(a)

    h2 = sph._f32(settings.sqr_radius)
    k = g.px.shape[1]
    occ = g.valid.sum(dim=1)  # [Gy, Gxp]: each cell's valid prefix
    targets = occ + (occ < k).to(occ.dtype)  # density's walks per cell
    walked = (torch.arange(k, device=occ.device)[None, :, None]
              <= occ[:, None])  # density's targets: live or first empty
    out = dict(density_pairs=0, density_in=0, forces_pairs=0, forces_in=0,
               live=int(occ.sum()))
    live = g.valid
    for cx, cy, cv in zip(rows3(g.px), rows3(g.py), rows3(g.valid)):
        for dx in (-1, 0, 1):
            nx, ny, nv = (sph._roll_x(a, dx) for a in (cx, cy, cv))
            for kp in range(k):
                v = nv[:, kp:kp + 1]
                if not bool(v.any()):
                    continue
                ddx = nx[:, kp:kp + 1] - g.px
                ddy = ny[:, kp:kp + 1] - g.py
                r2 = ddx * ddx + ddy * ddy
                out["density_pairs"] += int((v[:, 0] * targets).sum())
                out["density_in"] += int((v & walked & (r2 < h2)).sum())
                out["forces_pairs"] += int((v & live).sum())
                out["forces_in"] += int((v & live & (r2 <= h2)).sum())
    return out


def sph_bound(name, g, pairs):
    """The bound of a slot-grid kernel (sph_* or dense_*) on grid ``g``:
    its input fields below
    each cell's occupancy, the valid mask and its outputs whole (as
    ``resident_bytes`` counts the resident kernels'), against OPS_SPH per
    pair and live slot."""
    n_pair, n_in, n_slot = OPS_SPH[name]
    key = "density" if name.endswith("_density") else "forces"
    n_ops = (n_pair * pairs[f"{key}_pairs"] + n_in * pairs[f"{key}_in"]
             + n_slot * pairs["live"])
    f_in, f_out = IO_SPH[name]
    n_bytes = (4 * f_in * pairs["live"] + g.valid.numel()
               + 4 * f_out * g.px.numel())
    return bound(n_bytes, n_ops)


def compare_sph(state, settings, params, label, flags=None):
    """sph_density and sph_forces (with ``flags``) against their plain
    versions on a state's slot grid, bitwise over the whole grid. Returns
    per-kernel dicts and the calls for ``time_kernels``."""
    from tpufluid_torch.ops import sph

    flags = flags or {}
    g = dense_grid_of(state, settings, params)
    h, n = settings.smoothing_radius, settings.kernel_norms()
    rho = sph.density(g, params.mass, h)
    rho_p = sph.density_plain(g, params.mass, h)
    full = torch.ones_like(g.valid)
    bitwise((rho,), (rho_p,), f"{label} sph_density")
    d = torch.clamp(torch.clamp(rho_p, min=EPSILON), min=0.1)
    fargs = (g, d, params, h, settings.sqr_radius, n.spiky_derivative,
             n.viscosity, torch.tensor(9, device=d.device))
    got = sph.forces(*fargs, **flags)
    want = sph.forces_plain(*fargs, **flags)
    bitwise(got, want, f"{label} sph_forces {flags}")
    if flags:  # the flag changes the forces
        base = sph.forces(*fargs)
        changed = int(((base[0] != got[0]) & g.valid).sum())
        if changed == 0:
            raise AssertionError(f"{label}: {flags} changed no force")
        log(f"{label}: {flags} changes fx at {changed} live slots")
    pairs = sph_pairs(g, settings)
    out = {"sph_density": dict(max_abs_err=abs_err(rho, rho_p, full)),
           "sph_forces": dict(max_abs_err=max(abs_err(a, b, full)
                                              for a, b in zip(got, want)))}
    for name in out:
        out[name]["bound_ms"], out[name]["bound_by"] = sph_bound(name, g,
                                                                 pairs)
    live = g.valid
    strides = {f"stride_{k}": int(v) for k, v in (
        (1, (live & (d < 150.0)).sum()),
        (5, (live & (d >= 150.0) & (d < 200.0)).sum()),
        (13, (live & (d >= 200.0)).sum()))}
    out["sph_forces"].update(strides)
    log(f"{label} {tuple(g.px.shape)} {flags or 'base'} (tiles: density "
        f"{sph.density_tile(g.px.shape[1])}, forces "
        f"{sph.forces_tile(g.px.shape[1])}): {int(live.sum())} "
        f"live slots (dropped {int(g.n_dropped)}), max density "
        f"{float(d[live].max()):.1f}, slots per stride {strides}, "
        f"{pairs}; sph_density and sph_forces bitwise equal to plain")
    calls = {
        "sph_density": (lambda: sph.density(g, params.mass, h),
                        lambda: sph.density_plain(g, params.mass, h)),
        "sph_forces": (lambda: sph.forces(*fargs, **flags),
                       lambda: sph.forces_plain(*fargs, **flags)),
    }
    return out, calls, want


def compare_dense(g, settings, params, label, flags=None):
    """dense_density and dense_forces (with ``flags``) against the roll
    passes (``ops.dense.density_pass``, ``force_pass``) on slot grid
    ``g``, bitwise over the whole grid, each with one launch counted.
    Returns per-kernel dicts (max_abs_err, bound, live slots whose fx the
    flag changes) and the calls for ``time_kernels``."""
    from tpufluid_torch._build import LAUNCHES
    from tpufluid_torch.ops import dense

    flags = flags or {}
    h, n = settings.smoothing_radius, settings.kernel_norms()
    before = dict(LAUNCHES)
    rho = dense.density(g, params.mass, h)
    rho_p = dense.density_pass(g, params.mass, h)
    bitwise((rho,), (rho_p,), f"{label} dense_density")
    d = torch.clamp(torch.clamp(rho_p, min=EPSILON), min=0.1)
    fargs = (g, d, params, h, settings.sqr_radius, n.spiky_derivative,
             n.viscosity, torch.tensor(9, device=d.device))
    got = dense.forces(*fargs, **flags)
    want = dense.force_pass(*fargs, **flags)
    bitwise(got, want, f"{label} dense_forces {flags}")
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] - before[k] for k in DENSE_KERNELS}
    if launched != {"dense_density": 1, "dense_forces": 1, "dense_build": 0,
                    "dense_readback": 0}:
        raise AssertionError(f"{label} dense launches {launched}")
    changed = 0
    if flags:
        base = dense.forces(*fargs)
        changed = int(((base[0] != got[0]) & g.valid).sum())
    full = torch.ones_like(g.valid)
    pairs = sph_pairs(g, settings, roll=True)
    out = {"dense_density": dict(max_abs_err=abs_err(rho, rho_p, full)),
           "dense_forces": dict(max_abs_err=max(abs_err(a, b, full)
                                                for a, b in zip(got, want)),
                                flag_changes_fx=changed)}
    for name in out:
        out[name]["bound_ms"], out[name]["bound_by"] = sph_bound(name, g,
                                                                 pairs)
        out[name]["grid"] = list(g.px.shape)
    log(f"{label} {tuple(g.px.shape)} {flags or 'base'}: "
        f"{int(g.valid.sum())} live slots (dropped {int(g.n_dropped)}), "
        f"the flag changes fx at {changed} live slots, {pairs}; "
        f"dense_density and dense_forces bitwise equal to the roll passes")
    calls = {
        "dense_density": (lambda: dense.density(g, params.mass, h),
                          lambda: dense.density_pass(g, params.mass, h)),
        "dense_forces": (lambda: dense.forces(*fargs, **flags),
                         lambda: dense.force_pass(*fargs, **flags)),
    }
    return out, calls


def compare_glue(state, settings, params, label):
    """dense_build and dense_readback against ``build_grid_cols`` and
    ``readback_cols``, bitwise, on the slot grid of ``state``'s next step
    (its columns as the step passes them: stride-6 views of one [N, 6]
    gather) and the density and forces the kernels give there, one launch
    of each counted. Returns per-kernel dicts (max_abs_err, bound, grid)
    and the calls for ``time_kernels``; the bounds count the build's
    whole zeroed buffer (17 B a slot), its flat slots (8 B), keys (4 B)
    and four columns (16 B) a particle, and the read-back's slot (8 B),
    five values read and five written a particle."""
    from tpufluid_torch import step as tstep
    from tpufluid_torch._build import LAUNCHES
    from tpufluid_torch.ops import dense, grid

    pred = tstep.predict_positions(state.position, state.velocity,
                                   params.delta, settings)
    b = grid.bin_particles(grid.cell_id(pred, settings), settings)
    g6 = torch.cat([pred, state.velocity, state.position], dim=1)[b.perm]
    cols = tuple(g6[:, j] for j in range(4))
    cells = b.sorted_cells
    before = dict(LAUNCHES)
    got = dense.build(*cols, cells, settings)
    want = dense.build_grid_cols(*cols, cells, settings)
    bitwise(tuple(got), tuple(want), f"{label} dense_build")
    h, n = settings.smoothing_radius, settings.kernel_norms()
    d = torch.clamp(dense.density(want, params.mass, h), min=0.1)
    fields = (d, *dense.forces(want, d, params, h, settings.sqr_radius,
                               n.spiky_derivative, n.viscosity,
                               torch.tensor(9, device=d.device)))
    back = dense.readback(want.flat, fields)
    bitwise(back, dense.readback_cols(want.flat, fields),
            f"{label} dense_readback")
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] - before[k] for k in DENSE_KERNELS}
    if launched != dict.fromkeys(DENSE_KERNELS, 1):
        raise AssertionError(f"{label} glue launches {launched}")
    n_p, size = cells.shape[0], want.px.numel()
    out = {}
    for name, n_bytes in (("dense_build", 17 * size + 4 + 28 * n_p),
                          ("dense_readback", 48 * n_p)):
        b_ms, b_by = bound(n_bytes, 0)
        out[name] = dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                         grid=list(want.px.shape))
    log(f"{label} {tuple(want.px.shape)}: {n_p} particles (dropped "
        f"{int(want.n_dropped)}); dense_build bitwise equal to "
        f"build_grid_cols, dense_readback to readback_cols")
    calls = {
        "dense_build": (lambda: dense.build(*cols, cells, settings),
                        lambda: dense.build_grid_cols(*cols, cells,
                                                      settings)),
        "dense_readback": (lambda: dense.readback(want.flat, fields),
                           lambda: dense.readback_cols(want.flat, fields)),
    }
    return out, calls


def clumped_state(settings, device):
    """The seeded scene_1m state with the particles of a 12 x 12 square at
    the centre pulled to 0.6 of their distance from it: ~2.8x the rest
    density, above 200, with a rim between 150 and 200."""
    st = seeded_state(settings, device)
    pos = st.position.clone()
    inner = (pos.abs() < 6.0).all(dim=1)
    pos[inner] = pos[inner] * 0.6
    return dataclasses.replace(st, position=pos, predicted=pos.clone())


def synced_pallas_steps(settings, params, n_steps: int) -> None:
    """The pallas-mode kernel step against the same step on the plain
    versions, each step from the plain step's state: cells and tick
    bitwise, and the floats too (both kernels are bitwise; the rest of the
    step is the same code)."""
    from tpufluid_torch.step import make_plain_step, make_step

    kstep = make_step(settings, neighbor_mode="pallas")
    pstep = make_plain_step(settings)
    st = seeded_state(settings, params.device)
    worst = dict(position=0.0, velocity=0.0, density=0.0)
    for i in range(n_steps):
        k, p = kstep(st, params), pstep(st, params)
        if not (torch.equal(k.cell, p.cell) and torch.equal(k.tick, p.tick)):
            raise AssertionError(f"synced pallas step {i}: cell/tick differ")
        for f, tol in (("position", POS_TOL), ("velocity", VEL_TOL),
                       ("density", RHO_TOL)):
            want = getattr(p, f)
            e = rel_err(getattr(k, f), want,
                        torch.ones_like(want, dtype=torch.bool))
            if e > tol or not torch.equal(getattr(k, f), want):
                raise AssertionError(f"synced pallas step {i}: {f} not "
                                     f"bitwise (rel err {e}, bound {tol})")
            worst[f] = max(worst[f], e)
        st = p
    log(f"synced {n_steps} pallas steps at scene_1m (K="
        f"{settings.cell_capacity}): cells, tick, positions, velocities "
        f"and densities bitwise; worst rel err pos {worst['position']:.3g} "
        f"vel {worst['velocity']:.3g} rho {worst['density']:.3g}")


def profile_steps(app, n_steps: int, label: str, step=None):
    """Device time by kernel, launches and the device's busy share over
    ``app.run(n_steps)``, or ``n_steps`` calls of ``step`` (torch.profiler;
    the busy share is the union of the kernels' spans over the span from
    the first kernel's start to the last one's end), per step. Returns
    None, and says "not measured", when the profiler sees no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if step is None:
                app.run(n_steps)
            else:
                for _ in range(n_steps):
                    step()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as exc:  # the profile is a reading, not a gate
        log(f"{label} profile: not measured ({type(exc).__name__}: {exc})")
        return None
    if not kern:
        log(f"{label} profile: the profiler saw no device time; busy share "
            f"not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + (hi - lo), a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kern:
        key = e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end
                                                - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = dict(launches_per_step=len(kern) / n_steps,
               busy_ms_per_step=busy / 1e3 / n_steps,
               window_ms_per_step=window / 1e3 / n_steps,
               busy_share=busy / window if window > 0 else None,
               top_ms_per_step={k: v / 1e3 / n_steps for k, v in top})
    log(f"{label} profile over {n_steps} steps: {out['launches_per_step']:.0f}"
        f" kernel launches/step, device busy {out['busy_ms_per_step']:.4f} "
        f"of {out['window_ms_per_step']:.4f} ms/step (busy share "
        f"{out['busy_share']:.3f}); top kernels ms/step "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["top_ms_per_step"].items()))
    return out


def engine_parity():
    """The harness's engine parity (``tpufluid_torch.bench.run_parity``)
    on the card: grid and pallas within 1e-4 of dense over 10 steps, the
    resident engine's mass and nearest-neighbour distance to dense, and
    the 200-step invariants (mass, finite, in bounds, energy within 10%).
    Returns its report; fails unless every check passed."""
    import contextlib
    import io

    from tpufluid_torch import bench

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ok = bench.run_parity()
    wall = time.perf_counter() - t0
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"engine parity (bench.run_parity: {PARITY_N}, 26x26, K=32, g -3; "
        f"wall {wall:.1f} s): ok {ok}; " + "; ".join(
            f"{k} {v['detail']}" for k, v in report["checks"].items()))
    if not (ok and report["ok"]):
        raise AssertionError(f"engine parity: {report['checks']}")
    return dict(report, wall_s=wall)


def cli_pallas_run(card):
    """The CLI's ``run --neighbor-mode pallas`` on the reference's default
    scene under gravity, 200 steps, counters reset just before it (the
    app sizes K for the compression peak); then 100 more steps timed with
    CUDA events; then both kernels against their plain versions, bitwise,
    on the next step's slot grid, and timed there. Returns K, the wall and
    device ms/step, the particles that grid drops, the launch counts and
    per-kernel results."""
    from tpufluid_torch import cli
    from tpufluid_torch.ops import sph

    args = cli.parser().parse_args([
        "run", "--device", "cuda", "--neighbor-mode", "pallas", "--gravity",
        "0", "-9.8", "--steps", "200", "--report-every", "100"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    app = cli.run(args)
    wall = time.perf_counter() - t0
    counts = read_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    app.run(100)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 100
    m = app.metrics(deep=True)
    s, prm = app.settings, app.params
    g = dense_grid_of(app.state, s, prm)
    dropped = int(g.n_dropped)
    res = dict(cell_capacity=s.cell_capacity,
               wall_ms_per_step=1e3 * wall / 200, ms_per_step=ms,
               dropped=dropped, max_cell_occupancy=m["max_cell_occupancy"],
               launches={k: v for k, v in counts.items() if v})
    h, n = s.smoothing_radius, s.kernel_norms()
    torch.use_deterministic_algorithms(True)
    rho_p = sph.density_plain(g, prm.mass, h)
    bitwise((sph.density(g, prm.mass, h),), (rho_p,),
            "CLI pallas sph_density")
    d = torch.clamp(torch.clamp(rho_p, min=EPSILON), min=0.1)
    fargs = (g, d, prm, h, s.sqr_radius, n.spiky_derivative, n.viscosity,
             torch.tensor(9, device=d.device))
    bitwise(sph.forces(*fargs), sph.forces_plain(*fargs),
            "CLI pallas sph_forces")
    torch.use_deterministic_algorithms(False)
    pairs = sph_pairs(g, s)
    for name, fn in (("sph_density", lambda: sph.density(g, prm.mass, h)),
                     ("sph_forces", lambda: sph.forces(*fargs))):
        k1, k2 = time_ms(fn, 50), time_ms(fn, 50)
        b_ms, b_by = sph_bound(name, g, pairs)
        res[name] = dict(max_abs_err=0.0, ms=(k1 + k2) / 2, bound_ms=b_ms,
                         bound_by=b_by, grid=list(g.px.shape))
        log(f"CLI pallas grid {tuple(g.px.shape)} {name} (tile "
            f"{getattr(sph, name[4:] + '_tile')(s.cell_capacity)}): bitwise "
            f"equal to plain; kernel {res[name]['ms']:.4f} ms ({k1:.4f}, "
            f"{k2:.4f}), bound {b_ms:.4f} ms ({b_by}); {pairs}")
    log(f"CLI run --neighbor-mode pallas (100k, 53x53, g -9.8, K="
        f"{res['cell_capacity']}): 200 steps, wall {wall:.2f} s "
        f"({res['wall_ms_per_step']:.3f} ms/step); 100 more {ms:.4f} ms/step "
        f"(CUDA events; {card}); tick {m['tick']}, NaN {m['nan_positions']},"
        f" max occupancy {m['max_cell_occupancy']}, dropped next step "
        f"{dropped}; launches {res['launches']}")
    if not (m["tick"] == 300 and m["nan_positions"] == 0):
        raise AssertionError(f"CLI pallas run: {m}")
    if counts != {**dict.fromkeys(counts, 0), "sph_density": 200,
                  "sph_forces": 200, "dense_build": 200,
                  "dense_readback": 200}:
        raise AssertionError(f"CLI pallas run launches: {counts}")
    return res


def cli_default_run(card):
    """The CLI's ``run`` with no --neighbor-mode (the dense engine) on the
    reference's default scene, 64 steps with the counters reset just
    before them: one launch of dense_build, dense_density, dense_forces
    and dense_readback a step and no other kernel. Then 120 more steps
    timed (CUDA events) and a torch.profiler reading of 8; then both pass
    kernels against the roll passes, bitwise over the whole grid, on the
    slot grid of its last state, with the base flags (timed against the
    passes), surface tension and adaptive subsampling, and the build and
    read-back kernels against their plain versions on the same state
    (``compare_glue``, timed). Returns the run's results and the
    per-kernel dicts."""
    from tpufluid_torch import cli

    args = cli.parser().parse_args(["run", "--device", "cuda", "--steps",
                                    "64", "--report-every", "32"])
    if args.neighbor_mode != "dense":
        raise AssertionError(f"CLI default engine {args.neighbor_mode}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    app = cli.run(args)
    wall = time.perf_counter() - t0
    counts = read_counts()
    m = app.metrics(deep=True)
    log(f"CLI default run (dense, 100k, 53x53, K={app.settings.cell_capacity}"
        f"), 64 steps: wall {wall:.2f} s, {1e3 * wall / 64:.1f} ms/step; "
        f"tick {m['tick']}, NaN {m['nan_positions']}, max occupancy "
        f"{m['max_cell_occupancy']}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if not (m["tick"] == 64 and m["nan_positions"] == 0
            and not m["capacity_exceeded"]):
        raise AssertionError(f"CLI default run: {m}")
    if counts != {**dict.fromkeys(counts, 0), "dense_density": 64,
                  "dense_forces": 64, "dense_build": 64,
                  "dense_readback": 64}:
        raise AssertionError(f"CLI default run launches: {counts}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    app.run(120)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 120
    log(f"CLI default run, 120 more steps: {ms:.4f} ms/step, "
        f"{1e3 * app.settings.particle_count / ms:.4e} particle-steps/s "
        f"(CUDA events; {card})")
    res = dict(wall_s=wall, wall_ms_per_step=1e3 * wall / 64,
               ms_per_step=ms, cell_capacity=app.settings.cell_capacity,
               launches={k: v for k, v in counts.items() if v},
               profile=profile_steps(app, 8, "CLI default dense"))
    s, prm = app.settings, app.params
    g = dense_grid_of(app.state, s, prm)
    torch.use_deterministic_algorithms(True)
    kern, calls = compare_dense(g, s, prm, "CLI default grid")
    for key, flags in (("surface_tension", dict(surface_tension=True)),
                       ("adaptive", dict(adaptive_subsampling=True))):
        fres, _ = compare_dense(g, s, prm, f"CLI default grid {key}", flags)
        kern["dense_forces"][key] = fres["dense_forces"]
    glue, glue_calls = compare_glue(app.state, s, prm, "CLI default grid")
    kern.update(glue)
    calls.update(glue_calls)
    torch.use_deterministic_algorithms(False)
    time_kernels(calls, kern, f"CLI default grid {tuple(g.px.shape)}")
    return res, kern


# ------------------------------- the resident engine's rest (13-16)

VARIANT_NAMES = {"x_boundary": "wrap", "surface_tension": "surface_tension",
                 "adaptive_subsampling": "adaptive"}


def timed_pair(kern, plain, plain_reps=3):
    """(kernel ms, plain ms, the four readings) in the order plain,
    kernel, kernel, plain."""
    p1 = time_ms(plain, plain_reps, warm=1)
    k1 = time_ms(kern, 50)
    k2 = time_ms(kern, 50)
    p2 = time_ms(plain, plain_reps, warm=0)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def bitwise(got, want, what) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs in "
                                 f"{int((a != b).sum())} elements")


def wall_state(settings, device):
    """The seeded state with every particle within 0.85 of an x wall (at
    scene_1m the lattice's three outer columns, six particles a cell)
    moved to 0.05 from it and
    moving out at 60 (half a unit a step): each stays in its cell (the
    rebin keeps it) and crosses the wall in the move."""
    st = seeded_state(settings, device)
    pos, vel = st.position.clone(), st.velocity.clone()
    half = settings.size[0] / 2
    edge = pos[:, 0].abs() > half - 0.85
    side = torch.sign(pos[edge, 0])
    pos[edge, 0] = side * (half - 0.05)
    vel[edge, 0] = side * 60.0
    return dataclasses.replace(st, position=pos, predicted=pos.clone(),
                               velocity=vel), int(edge.sum())


def rebinned(gs, settings, params, **kw):
    """The kernel rebin's grids (pos_x, pos_y, vel_x, vel_y, occ_row) of a
    GridState."""
    from tpufluid_torch.ops import fused

    return fused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row,
                       params.delta, settings, **kw)[:5]


def compare_variant(gs, settings, params, flags, label, timed=True):
    """forces_integrate with variant flags against its plain version,
    bitwise, then timed; the bound adds the variant's operations."""
    from tpufluid_torch.ops import fused

    px, py, vx, vy, occ = rebinned(gs, settings, params)
    pres, invr = fused.density(px, py, vx, vy, occ, params.mass,
                               params.delta, params.pressure_constant,
                               params.rest_density, settings)
    fargs = (px, py, vx, vy, pres, invr, occ, params, settings, gs.tick + 1)
    torch.use_deterministic_algorithms(True)
    got = fused.forces_integrate(*fargs, **flags)
    want = fused.forces_integrate_plain(*fargs, **flags)
    torch.use_deterministic_algorithms(False)
    bitwise(got, want, f"{label} forces_integrate {flags}")
    base = fused.forces_integrate(*fargs)
    live = px < fused.SENTINEL_HALF
    rho = 1.0 / invr[live]
    res = dict(
        max_abs_err=0.0, grid=list(px.shape),
        changed=int((((got[2] != base[2]) | (got[3] != base[3])) & live)
                    .sum()),
        wrapped=int(((got[0] * base[0] < 0) & live).sum()),
        rho_max=float(rho.max()), rho_150_200=int(
            ((rho >= 150.0) & (rho < 200.0)).sum()),
        rho_200=int((rho >= 200.0).sum()))
    if timed:
        pairs = stencil_pairs(px)
        extra = sum(OPS_VARIANT[VARIANT_NAMES[f]] for f in flags)
        res["bound_ms"], res["bound_by"] = bound(
            resident_bytes(px, occ, 6, 4),
            (OPS["forces_integrate"] + extra) * pairs)
        res["ms"], res["plain_ms"], raw = timed_pair(
            lambda: fused.forces_integrate(*fargs, **flags),
            lambda: fused.forces_integrate_plain(*fargs, **flags))
        res["library_ms"] = None
        times = (f"; kernel {res['ms']:.4f} ms ({raw[0]:.4f}, {raw[1]:.4f}), "
                 f"plain {res['plain_ms']:.3f} ms ({raw[2]:.3f}, "
                 f"{raw[3]:.3f}), bound {res['bound_ms']:.4f} ms "
                 f"({res['bound_by']})")
    else:
        times = ""
    log(f"{label} forces_integrate {flags} {tuple(px.shape)}: bitwise equal "
        f"to plain; the flag changes the velocity of {res['changed']} live "
        f"slots ({res['wrapped']} wrapped); rho max {res['rho_max']:.1f}, "
        f"{res['rho_150_200']} in [150, 200), {res['rho_200']} >= 200"
        + times)
    return res


def stacked(worlds):
    """One row stack of single-world GridStates."""
    from tpufluid_torch.ops import resident

    cat = lambda f: torch.cat([getattr(w, f) for w in worlds]).contiguous()
    return resident.GridState(
        pos_x=cat("pos_x"), pos_y=cat("pos_y"), vel_x=cat("vel_x"),
        vel_y=cat("vel_y"), occ_row=cat("occ_row"), tick=worlds[0].tick,
        lost=worlds[0].lost)


def config4(dev):
    """BASELINE config 4's settings and per-world params (bench.py)."""
    import numpy as np
    import tpufluid_torch as tt

    bs = tt.SimSettings(particle_count=131072, particle_spacing=0.1,
                        smoothing_radius=0.2, size=(101.95, 13.1),
                        cell_capacity=8, spawn_columns=1008)
    plist = [tt.TickParams.default(dev, gravity=(0.0, -float(g)),
                                   viscosity_coefficient=float(v))
             for g, v in zip(np.linspace(0.0, 2.0, CONFIG4_WORLDS),
                             np.linspace(5.0, 40.0, CONFIG4_WORLDS))]
    return bs, plist


def compare_batched(bs, bp, dev):
    """rebin (row_shift), density and forces_integrate (wid) against their
    plain versions on config 4's stack of seeded worlds, bitwise, timed.
    Returns (results, the rebinned stack, wid)."""
    from tpufluid_torch.ops import fused, resident

    gs = stacked([resident.from_particles(seeded_state(bs, dev, SEED + w),
                                          bs)
                  for w in range(CONFIG4_WORLDS)])
    rows = resident._rows(bs)
    wid = torch.arange(CONFIG4_WORLDS, dtype=torch.int32,
                       device=dev).repeat_interleave(rows)
    shift = -(wid * rows)
    rargs = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, bp.delta, bs)
    torch.use_deterministic_algorithms(True)
    got = fused.rebin(*rargs, row_shift=shift)
    bitwise(got, fused.rebin_plain(*rargs, row_shift=shift),
            "config 4 rebin row_shift")
    px, py, vx, vy, occ = got[:5]
    dargs = (px, py, vx, vy, occ, bp.mass, bp.delta, bp.pressure_constant,
             bp.rest_density, bs)
    pres, invr = fused.density(*dargs, wid=wid)
    bitwise((pres, invr), fused.density_plain(*dargs, wid=wid),
            "config 4 density wid")
    fargs = (px, py, vx, vy, pres, invr, occ, bp, bs, gs.tick + 1)
    new = fused.forces_integrate(*fargs, wid=wid)
    bitwise(new, fused.forces_integrate_plain(*fargs, wid=wid),
            "config 4 forces_integrate wid")
    torch.use_deterministic_algorithms(False)
    n_live = float(live_per_cell(gs.pos_x).sum())
    pairs = stencil_pairs(px)
    wid_bytes = 4 * rows * CONFIG4_WORLDS
    calls = {
        "rebin": (resident_bytes(gs.pos_x, gs.occ_row, 4, 4) + wid_bytes,
                  OPS["rebin"] * n_live,
                  lambda: fused.rebin(*rargs, row_shift=shift),
                  lambda: fused.rebin_plain(*rargs, row_shift=shift)),
        "density": (resident_bytes(px, occ, 4, 2) + wid_bytes,
                    OPS["density"] * pairs,
                    lambda: fused.density(*dargs, wid=wid),
                    lambda: fused.density_plain(*dargs, wid=wid)),
        "forces_integrate": (resident_bytes(px, occ, 6, 4) + wid_bytes,
                             OPS["forces_integrate"] * pairs,
                             lambda: fused.forces_integrate(*fargs, wid=wid),
                             lambda: fused.forces_integrate_plain(*fargs,
                                                                  wid=wid)),
    }
    out = {}
    for name, (n_bytes, n_ops, kern, plain) in calls.items():
        b_ms, b_by = bound(n_bytes, n_ops)
        ms, plain_ms, raw = timed_pair(kern, plain, 2)
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"config 4 {name} ({'row_shift' if name == 'rebin' else 'wid'}, "
            f"{tuple(px.shape)}): bitwise equal to plain; kernel {ms:.4f} ms "
            f"({raw[0]:.4f}, {raw[1]:.4f}), plain {plain_ms:.3f} ms "
            f"({raw[2]:.3f}, {raw[3]:.3f}), bound {b_ms:.4f} ms ({b_by})")
    log(f"config 4 stack: {n_live:.0f} live particles, {pairs:.4e} stencil "
        f"pairs, far movers {int(got[5].sum())}, over {int(got[6].sum())}")
    return out, (px, py, vx, vy, occ, gs.tick + 1), wid


def batched_vs_single(bs, plist, bp, dev, n_steps: int) -> None:
    """``n_steps`` batched steps against the same steps of each world on
    its own, bitwise world by world."""
    from tpufluid_torch.ops import resident

    gs = resident.init_batched_grid_state(bs, CONFIG4_WORLDS, dev)
    bstep = resident.make_grid_step(bs, n_worlds=CONFIG4_WORLDS)
    for _ in range(n_steps):
        gs = bstep(gs, bp)
    single = resident.make_grid_step(bs)
    for w, p in enumerate(plist):
        ref = resident.init_grid_state(bs, dev)
        for _ in range(n_steps):
            ref = single(ref, p)
        got = resident.world_state(gs, bs, w)
        for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row"):
            if not torch.equal(getattr(got, f), getattr(ref, f)):
                raise AssertionError(f"config 4 world {w}: {f} differs from "
                                     f"the single-world run")
    log(f"config 4: {n_steps} batched steps bitwise equal, world by world, "
        f"to {CONFIG4_WORLDS} single-world runs (lost {int(gs.lost)})")


def loss_probe(bs, bp, dev, marks=(28, 41, 70)):
    """The batched stack's cumulative lost count at steps ``marks`` from
    the spawn lattice (BASELINE.md records 13-15 drops for the JAX engine
    over 70 steps, in steps 28-41)."""
    from tpufluid_torch.ops import resident

    step = resident.make_grid_step(bs, n_worlds=CONFIG4_WORLDS)
    gs = resident.init_batched_grid_state(bs, CONFIG4_WORLDS, dev)
    out = {}
    for i in range(1, max(marks) + 1):
        gs = step(gs, bp)
        if i in marks:
            out[i] = int(gs.lost)
    log(f"config 4 lost from the spawn lattice at steps {out}")
    return out


def compare_physics(grids, settings, params, label, ff_cells=None,
                    wid=None, plain=True, **flags):
    """The physics kernel against the split kernel pair (and against
    physics_plain), bitwise."""
    from tpufluid_torch.ops import fused

    px, py, vx, vy, occ, frame = grids
    got = fused.physics(px, py, vx, vy, occ, params, settings, frame,
                        ff_cells=ff_cells, wid=wid, **flags)
    pres, invr = fused.density(px, py, vx, vy, occ, params.mass,
                               params.delta, params.pressure_constant,
                               params.rest_density, settings, wid=wid)
    split = fused.forces_integrate(px, py, vx, vy, pres, invr, occ, params,
                                   settings, frame, ff_cells=ff_cells,
                                   wid=wid, **flags)
    bitwise(got, split, f"{label} physics vs split")
    if plain:
        torch.use_deterministic_algorithms(True)
        bitwise(got, fused.physics_plain(px, py, vx, vy, occ, params,
                                         settings, frame, ff_cells=ff_cells,
                                         wid=wid, **flags),
                f"{label} physics vs plain")
        torch.use_deterministic_algorithms(False)
    rows, cols = fused.physics_tile(px.shape[1])
    log(f"{label} physics {tuple(px.shape)} (tile {rows} x {cols}; max "
        f"occupancy {int(occ.max())}) "
        f"{'has_ff ' if ff_cells is not None else ''}"
        f"{'wid ' if wid is not None else ''}{flags or ''}: bitwise equal "
        f"to the split pair{' and to plain' if plain else ''}")
    return got


def time_physics(grids, settings, params):
    """The physics kernel, its plain version and the split kernel pair,
    in turns (plain, kernel, split, kernel, split, plain)."""
    from tpufluid_torch.ops import fused

    px, py, vx, vy, occ, frame = grids
    kern = lambda: fused.physics(px, py, vx, vy, occ, params, settings, frame)
    plain = lambda: fused.physics_plain(px, py, vx, vy, occ, params,
                                        settings, frame)

    def split():
        pres, invr = fused.density(px, py, vx, vy, occ, params.mass,
                                   params.delta, params.pressure_constant,
                                   params.rest_density, settings)
        fused.forces_integrate(px, py, vx, vy, pres, invr, occ, params,
                               settings, frame)

    p1 = time_ms(plain, 2, warm=1)
    k1, s1 = time_ms(kern, 50), time_ms(split, 50)
    k2, s2 = time_ms(kern, 50), time_ms(split, 50)
    p2 = time_ms(plain, 2, warm=0)
    pairs = stencil_pairs(px)
    b_ms, b_by = bound(resident_bytes(px, occ, 4, 4),
                       (OPS["density"] + OPS["forces_integrate"]) * pairs)
    res = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               split_ms=(s1 + s2) / 2, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, max_abs_err=0.0)
    log(f"scene_1m K={px.shape[1]} physics: kernel {res['ms']:.4f} ms "
        f"({k1:.4f}, {k2:.4f}), split pair {res['split_ms']:.4f} ms "
        f"({s1:.4f}, {s2:.4f}), plain {res['plain_ms']:.3f} ms ({p1:.3f}, "
        f"{p2:.3f}), bound {b_ms:.4f} ms ({b_by})")
    return res


def resident_run(settings, params, fused_physics: bool, n_steps: int, dev):
    """ms/step of ``make_grid_multi_step`` from the spawn lattice (CUDA
    events, after a 20-step warm-up), the launches and the end state,
    with the split pair or the fused physics kernel."""
    from tpufluid_torch.ops import resident

    os.environ["TPUFLUID_FUSED_PHYSICS"] = "1" if fused_physics else ""
    try:
        warm = resident.make_grid_multi_step(settings, 20)
        run = resident.make_grid_multi_step(settings, n_steps)
        gs = resident.init_grid_state(settings, dev)
        warm(gs, params)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts()
        start.record()
        out = run(gs, params)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n_steps, read_counts(), out
    finally:
        os.environ.pop("TPUFLUID_FUSED_PHYSICS")


def cli_variant_run():
    """``python -m tpufluid_torch run --neighbor-mode resident`` with the
    three variant flags on the default scene, 64 steps, in its own
    process: it must exit 0."""
    args = [sys.executable, "-m", "tpufluid_torch", "run", "--device", "cuda",
            "--neighbor-mode", "resident", "--x-boundary", "wrap",
            "--surface-tension", "--adaptive-subsampling", "--steps", "64",
            "--report-every", "32"]
    t0 = time.perf_counter()
    out = subprocess.run(args, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    tail = (out.stdout + out.stderr).strip().splitlines()[-3:]
    log(f"CLI run --neighbor-mode resident --x-boundary wrap "
        f"--surface-tension --adaptive-subsampling (default scene, 64 "
        f"steps): exit {out.returncode}, wall {wall:.2f} s; "
        + " | ".join(tail))
    if out.returncode != 0 or "done: 64 steps" not in out.stdout:
        raise AssertionError(f"CLI variant run: exit {out.returncode}\n"
                             f"{out.stdout}\n{out.stderr}")
    return dict(exit=out.returncode, wall_s=wall)


def valid_edge_grid(device):
    """A hand-made [22, 4, 128] grid (a 25.2 x 4 world at h 0.2, so grid_w
    is the grid's whole width) whose valid slots lie in rows 0, 1, 20, 21
    and columns 0, 1, 126, 127, positioned near the matching world edges,
    so that their predicted cells are clamped into rows 1 and 20 and
    columns 1 and 126 (the first and last rows and columns take no
    arrival and only lose their slots), a tenth of them far movers; the
    other slots hold random stale data with valid_f 0, also between valid
    slots. Also the card tests' edge grid (tests/test_torch_cuda.py).
    Returns (settings, (px, py, vx, vy, valid_f))."""
    import numpy as np
    import tpufluid_torch as tt

    s = tt.SimSettings(particle_count=64, size=(25.2, 4.0), cell_capacity=4)
    gy, k, gx = 22, 4, 128
    if (s.grid_w, s.grid_h) != (gx, gy):
        raise AssertionError(f"edge grid: grid {s.grid_w} x {s.grid_h}")
    rng = np.random.default_rng(SEED + 29)
    edge_r = np.zeros(gy, bool)
    edge_r[[0, 1, gy - 2, gy - 1]] = True
    edge_c = np.zeros(gx, bool)
    edge_c[[0, 1, gx - 2, gx - 1]] = True
    cells = edge_r[:, None] | edge_c[None, :]
    valid = (rng.random((gy, k, gx)) < 0.6) & cells[:, None, :]
    y = np.arange(gy)[:, None, None]
    x = np.arange(gx)[None, None, :]
    px = ((np.clip(x, 1, gx - 2) - 1 + rng.uniform(0.1, 0.9, valid.shape))
          * 0.2 - 12.6)
    py = ((np.clip(y, 1, gy - 2) - 1 + rng.uniform(0.1, 0.9, valid.shape))
          * 0.2 - 2.0)
    vx = rng.uniform(-15.0, 15.0, valid.shape)
    vy = rng.uniform(-15.0, 15.0, valid.shape)
    vx[rng.random(valid.shape) < 0.1] *= 30.0
    f = [torch.from_numpy(np.where(valid, a, rng.uniform(-10, 10, a.shape))
                          .astype(np.float32)).to(device)
         for a in (px, py, vx, vy)]
    return s, (*f, torch.from_numpy(valid.astype(np.float32)).to(device))


def with_holes(grids, frac=0.1):
    """The grids with a seeded ``frac`` of the valid slots set to
    valid_f 0, their data left in place as stale data."""
    valid = grids[4].clone()
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    holes = (torch.rand(valid.shape, generator=g) < frac).to(
        valid.device) & (valid > 0)
    valid[holes] = 0.0
    if int(holes.sum()) == 0:
        raise AssertionError("no holes in the valid mask")
    return (*grids[:4], valid)


def compare_rebin_valid(grids, settings, params, label, timed=False,
                        far=True):
    """ops.rebin.rebin_valid against its plain version, bitwise, on grids
    (px, py, vx, vy, valid_f); checks that every valid slot is moved or
    counted lost, and with ``far`` that some are lost (the grid has far
    movers); with ``timed``, times it against its plain version.
    The bound counts what the function reads and writes: valid_f and the
    six outputs whole, the four input fields at the valid slots."""
    from tpufluid_torch.ops import rebin

    px, py, vx, vy, valid = grids
    args = (px, py, vx, vy, valid, params.delta, settings)
    got = rebin.rebin_valid(*args)
    want = rebin.rebin_valid_plain(*args)
    bitwise(got, want, f"{label} rebin_valid")
    n_valid = float(valid.sum())
    lost = float(want[5][:, 0].sum()) * settings.cell_capacity
    if not ((lost > 0 or not far) and float(want[4].sum()) > 0
            and float(want[4].sum()) + lost == n_valid):
        raise AssertionError(f"{label} rebin_valid: {n_valid} valid, "
                             f"{float(want[4].sum())} moved, {lost} lost")
    k = px.shape[1]
    msg = (f"{label} rebin_valid {tuple(px.shape)} (tile "
           f"{rebin.rebin_valid_tile(k)}): bitwise equal to plain "
           f"({n_valid:.0f} valid slots, {lost:.0f} lost)")
    if not timed:
        log(msg)
        return None
    b_ms, b_by = bound(7 * grid_bytes(px) + 4 * 4 * n_valid,
                       OPS["rebin_valid"] * n_valid)
    ms, plain_ms, raw = timed_pair(lambda: rebin.rebin_valid(*args),
                                   lambda: rebin.rebin_valid_plain(*args))
    res = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, grid=list(px.shape),
               tile=list(rebin.rebin_valid_tile(k)))
    log(f"{msg}; kernel {ms:.4f} ms ({raw[0]:.4f}, {raw[1]:.4f}), plain "
        f"{plain_ms:.3f} ms ({raw[2]:.3f}, {raw[3]:.3f}), bound {b_ms:.4f} "
        f"ms ({b_by})")
    return res


def small_state(device, k, n_random=1500, fill_row=True, seed=SEED):
    """A 9 x 8 world (47 x 42 cells, Gxp 128) at capacity ``k``:
    ``n_random`` random particles, a coincident pair, and with
    ``fill_row`` eight neighbouring cells of row 20 filled to ``k``; its
    grid is cut to its first 41 rows (the rows dropped are empty), which
    no tile height of 2, 4 or 8 divides. With few particles most tiles
    stage halo rows of at most one slot. Returns (settings, GridState)."""
    from tpufluid_torch.ops import resident

    s, st = small_particles(device, k, n_random, fill_row, seed)
    gs = resident.from_particles(st, s)
    gs = dataclasses.replace(gs, **{
        f: getattr(gs, f)[:41].contiguous()
        for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row")})
    if (fill_row and int(gs.occ_row.max()) != k) or int(gs.lost) != 0:
        raise AssertionError(f"small state at K={k}: occupancy "
                             f"{int(gs.occ_row.max())}, lost {int(gs.lost)}")
    return s, gs


def small_particles(device, k, n_random, fill_row, seed=SEED):
    """(settings, State) of ``small_state``'s particles."""
    import numpy as np
    import tpufluid_torch as tt

    rng = np.random.default_rng(seed)
    h, half = 0.2, np.array([4.5, 4.0])
    full = np.stack(np.meshgrid(np.arange(10, 18), [20]), -1).reshape(-1, 2)
    rand = rng.uniform(-half, half, (3000, 2))
    cell = np.floor((rand + half) / h).astype(int) + 1
    clear = ~((cell[:, 1] == 20) & (cell[:, 0] >= 10) & (cell[:, 0] < 18))
    rand = rand[clear][:n_random]
    packed = ((np.repeat(full, k if fill_row else 0, axis=0) - 1
               + rng.uniform(0.05, 0.95, (len(full) * k * fill_row, 2)))
              * h - half)
    pos = np.concatenate([rand, packed]).astype(np.float32)
    pos[1] = pos[0]
    vel = rng.normal(size=pos.shape).astype(np.float32) * 2.0
    vel[1] = vel[0]
    s = tt.SimSettings(particle_count=len(pos), size=(9.0, 8.0),
                       cell_capacity=k)
    st = tt.init_state(s, device)
    st = dataclasses.replace(
        st, position=torch.from_numpy(pos).to(device),
        predicted=torch.from_numpy(pos).to(device),
        velocity=torch.from_numpy(vel).to(device))
    return s, st


def sph_tile_grid(device, case):
    """(settings, DenseGrid) of a tile gate of the dense kernels:
    "full row 8" / "full row 256": ``small_particles`` at K=8 / 256 (a row
    of full cells) binned by ``dense.build_grid``, cut to 41 rows;
    "sparse 8" / "sparse 192": 60 of them (halo cells of at most one
    slot); "edges": a hand-made [6, 4, 128] grid with live slots in rows 0
    and 5 and columns 0 and 127 (each cell's valid slots a prefix), every
    position within 0.15 of the origin, so that the clamped rows and the
    wrapped columns meet pairs in range; "dead bits": "full row 8" with
    its empty slots at (0.5, -0.25), a tenth of them elsewhere, and
    nonzero velocities."""
    import numpy as np
    import tpufluid_torch as tt
    from tpufluid_torch.ops import dense, grid

    rng = np.random.default_rng(SEED + 21)
    if case == "edges":
        s = tt.SimSettings(particle_count=64, size=(9.0, 8.0),
                           cell_capacity=4)
        gy, k, gx = 6, 4, 128
        occ = rng.integers(0, k + 1, (gy, gx))
        occ[rng.random((gy, gx)) < 0.7] = 0
        occ[:, [0, 1, gx - 2, gx - 1]] = rng.integers(1, k + 1, (gy, 4))
        occ[[0, 1, gy - 2, gy - 1], :3] = k
        valid = torch.arange(k)[None, :, None] < torch.from_numpy(occ)[:, None]
        f = [torch.from_numpy(rng.uniform(-0.15, 0.15, (gy, k, gx))
                              .astype(np.float32)) * valid for _ in range(4)]
        f[0][0, 1, 0], f[1][0, 1, 0] = f[0][0, 0, 0], f[1][0, 0, 0]
        return s, dense.DenseGrid(
            torch.zeros(0, dtype=torch.int64), *(a.to(device) for a in f),
            valid.to(device), torch.tensor(0, dtype=torch.int32))
    k = {"full row 256": 256, "sparse 192": 192}.get(case, 8)
    sparse = case.startswith("sparse")
    s, st = small_particles(device, k, 60 if sparse else 1500, not sparse)
    b = grid.bin_particles(grid.cell_id(st.position, s), s)
    g = dense.build_grid(st.position[b.perm], st.velocity[b.perm],
                         b.sorted_cells, s)
    g = g._replace(**{f: getattr(g, f)[:41].contiguous()
                      for f in ("px", "py", "vx", "vy", "valid")})
    occ = g.valid.sum(dim=1)
    if int(g.n_dropped) != 0 or (not sparse and int(occ.max()) != k):
        raise AssertionError(f"sph tile grid {case}: dropped "
                             f"{int(g.n_dropped)}, max occupancy "
                             f"{int(occ.max())}")
    if case == "dead bits":
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        dead = ~g.valid
        other = dead & (torch.rand(dead.shape, generator=gen) < 0.1).to(
            device)
        rand = ((torch.rand((2, *dead.shape), generator=gen) - 0.5)
                * 8.0).to(device)
        g = g._replace(
            px=torch.where(other, rand[0], torch.where(dead, 0.5, g.px)),
            py=torch.where(other, rand[1], torch.where(dead, -0.25, g.py)),
            vx=torch.where(dead, 3.0, g.vx), vy=torch.where(dead, -1.0, g.vy))
    return s, g


def sph_tile_gates(dev) -> list:
    """sph_density and sph_forces against their plain versions, bitwise
    over the whole grid, with base flags, surface tension and adaptive,
    on each ``sph_tile_grid`` case."""
    import tpufluid_torch as tt
    from tpufluid_torch.ops import sph

    p = tt.TickParams.default(dev, gravity=(0.0, -9.8), **ST_PARAMS)
    torch.use_deterministic_algorithms(True)
    gates = []
    for case in ("full row 8", "full row 256", "sparse 8", "sparse 192",
                 "edges", "dead bits"):
        s, g = sph_tile_grid(dev, case)
        h, n = s.smoothing_radius, s.kernel_norms()
        rho_p = sph.density_plain(g, p.mass, h)
        bitwise((sph.density(g, p.mass, h),), (rho_p,),
                f"{case} sph_density")
        d = torch.clamp(torch.clamp(rho_p, min=EPSILON), min=0.1)
        args = (g, d, p, h, s.sqr_radius, n.spiky_derivative, n.viscosity,
                torch.tensor(9, device=dev))
        flags = ("base", "surface_tension", "adaptive_subsampling")
        for flag in flags:
            kw = {} if flag == "base" else {flag: True}
            bitwise(sph.forces(*args, **kw), sph.forces_plain(*args, **kw),
                    f"{case} sph_forces {flag}")
        k = g.px.shape[1]
        occ = g.valid.sum(dim=1)
        log(f"{case} {tuple(g.px.shape)} (tiles: density "
            f"{sph.density_tile(k)}, forces {sph.forces_tile(k)}; max "
            f"occupancy {int(occ.max())}, cells of at most one slot "
            f"{int((occ <= 1).sum())} of {occ.numel()}): sph_density and "
            f"sph_forces bitwise equal to plain with {', '.join(flags)}")
        gates.append(f"sph {case} K={k}: {', '.join(flags)}")
    torch.use_deterministic_algorithms(False)
    return gates


# the variant sets of the tile gates: forces_integrate's flags, "has_ff"
# (a seeded random push-out field) and "wid" (rows split into two worlds)
TILE_VARIANTS = {
    "base": {}, "wrap": dict(x_boundary="wrap"),
    "surface_tension": dict(surface_tension=True),
    "adaptive": dict(adaptive_subsampling=True), "has_ff": dict(has_ff=True),
    "wid": dict(wid=True),
    "all": dict(x_boundary="wrap", surface_tension=True,
                adaptive_subsampling=True, has_ff=True)}


def tile_gates(label, settings, grids, variants):
    """rebin, then density and forces_integrate against their plain
    versions, bitwise, on ``grids`` (px, py, vx, vy, occ, frame), the
    latter two with each of ``variants`` (TILE_VARIANTS keys). Params: gravity -9.8 and surface tension's
    test values; "wid" splits the rows between that world and one with
    gravity -2 and viscosity 25."""
    import tpufluid_torch as tt
    from tpufluid_torch.ops import fused, resident

    px, py, vx, vy, occ, frame = grids
    dev = px.device
    gy, k, gx = px.shape
    plist = [tt.TickParams.default(dev, gravity=(0.0, -9.8), **ST_PARAMS),
             tt.TickParams.default(dev, gravity=(0.0, -2.0),
                                   viscosity_coefficient=25.0, **ST_PARAMS)]
    g = torch.Generator(device="cpu").manual_seed(SEED + k)
    ff = (torch.rand((2, gy, gx), generator=g) - 0.5) * 4.0
    ff[torch.rand(ff.shape, generator=g) < 0.7] = 0.0
    ff = ff.to(dev)
    # rebin's plain version scatters into distinct slots (and a spare
    # slot it drops), so it needs no deterministic mode, which would make
    # its K x 9 scatters take seconds at K=256
    rargs = (px, py, vx, vy, occ, plist[0].delta, settings)
    bitwise(fused.rebin(*rargs), fused.rebin_plain(*rargs),
            f"{label} rebin")
    torch.use_deterministic_algorithms(True)
    for name in variants:
        kw = dict(TILE_VARIANTS[name])
        prm = plist[0]
        if kw.pop("wid", False):
            prm = resident.batched_params(plist)
            kw["wid"] = (torch.arange(gy, device=dev) >= gy // 2).to(
                torch.int32)
        if kw.pop("has_ff", False):
            kw["ff_cells"] = (ff[0], ff[1])
        wid = kw.get("wid")
        dargs = (px, py, vx, vy, occ, prm.mass, prm.delta,
                 prm.pressure_constant, prm.rest_density, settings)
        want = fused.density_plain(*dargs, wid=wid)
        bitwise(fused.density(*dargs, wid=wid), want,
                f"{label} density {name}")
        fargs = (px, py, vx, vy, *want, occ, prm, settings, frame)
        bitwise(fused.forces_integrate(*fargs, **kw),
                fused.forces_integrate_plain(*fargs, **kw),
                f"{label} forces_integrate {name}")
    torch.use_deterministic_algorithms(False)
    log(f"{label} {(gy, k, gx)} (tiles: rebin {fused.rebin_tile(k)}, "
        f"density {fused.density_tile(k)}, forces {fused.forces_tile(k)}; "
        f"max occupancy {int(occ.max())}): rebin bitwise equal to plain; "
        f"density and forces_integrate bitwise equal to plain with "
        f"{', '.join(variants)}")
    return f"{label} K={k}: {', '.join(variants)}"


def time_big_k(grids, settings, params, label):
    """rebin (bitwise against its plain version on the whole grid),
    density and forces_integrate against their plain versions' time and
    the bound on a high-occupancy grid."""
    from tpufluid_torch.ops import fused

    px, py, vx, vy, occ, frame = grids
    rargs = (px, py, vx, vy, occ, params.delta, settings)
    bitwise(fused.rebin(*rargs), fused.rebin_plain(*rargs),
            f"{label} rebin")
    dargs = (px, py, vx, vy, occ, params.mass, params.delta,
             params.pressure_constant, params.rest_density, settings)
    pres, invr = fused.density(*dargs)
    fargs = (px, py, vx, vy, pres, invr, occ, params, settings, frame)
    pairs = stencil_pairs(px)
    n_live = float(live_per_cell(px).sum())
    out = {}
    for name, n_bytes, n_ops, kern, plain in (
            ("rebin", resident_bytes(px, occ, 4, 4), OPS["rebin"] * n_live,
             lambda: fused.rebin(*rargs), lambda: fused.rebin_plain(*rargs)),
            ("density", resident_bytes(px, occ, 4, 2),
             OPS["density"] * pairs,
             lambda: fused.density(*dargs),
             lambda: fused.density_plain(*dargs)),
            ("forces_integrate", resident_bytes(px, occ, 6, 4),
             OPS["forces_integrate"] * pairs,
             lambda: fused.forces_integrate(*fargs),
             lambda: fused.forces_integrate_plain(*fargs))):
        b_ms, b_by = bound(n_bytes, n_ops)
        k1, k2 = time_ms(kern, 50), time_ms(kern, 50)
        plain_ms = time_ms(plain, 1, warm=0)  # seconds a call: one reading
        out[name] = dict(max_abs_err=0.0, ms=(k1 + k2) / 2,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, grid=list(px.shape))
        log(f"{label} {name} {tuple(px.shape)}"
            f"{' (bitwise equal to plain)' if name == 'rebin' else ''}: "
            f"kernel {out[name]['ms']:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"{n_live:.0f} live, {pairs:.4e} stencil pairs")
    return out


def coarse_gate(gs, settings, sup, label) -> str:
    """The metaball coarse kernel against its plain version, bitwise, on
    the first 40 rows of a grid (any supersample fits)."""
    from tpufluid_torch.ops import render_coarse

    gy = gs.pos_x.shape[0] // 8 * 8
    px, py, vx, vy, occ = (getattr(gs, f)[:gy].contiguous() for f in (
        "pos_x", "pos_y", "vel_x", "vel_y", "occ_row"))
    args = (px, py, torch.sqrt(vx * vx + vy * vy), occ, settings, sup)
    got = render_coarse.coarse_metaball_fields(*args)
    want = render_coarse.coarse_metaball_fields_plain(*args)
    full = torch.ones_like(want[0], dtype=torch.bool)
    e_rel = max(rel_err(a, b, full) for a, b in zip(got, want))
    if not (e_rel <= FIELD_TOL and float(want[0].max()) > 0.5):
        raise AssertionError(f"{label} metaball_coarse: rel err {e_rel}")
    bitwise(got, want, f"{label} metaball_coarse sup {sup}")
    log(f"{label} metaball_coarse {tuple(px.shape)} supersample {sup}: "
        f"bitwise equal to plain")
    return f"{label} metaball_coarse sup {sup}"


def mouse_run(dev, card):
    """FluidApp.set_mouse on the card: scene_1m through the resident
    engine, 16 ticks with the mouse repelling at the centre against 16
    with it off, each app with its own params, at mouse power 0.5 (an
    attracting mouse is a sink that packs its cell past K=8 at any power,
    and the default 150 packs the front of a repelled ring past it too;
    the loss audit that regrows comes at tick 256). The call writes the
    params' tensors in place; nothing is lost, each tick launches the
    three kernels once, and the particles within 0.5-4 of the mouse gain
    velocity away from it."""
    import tpufluid_torch as tt
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.models import scenes

    outward = {}
    for state in (-1, 0):
        app = FluidApp(scenes.scene_1m(dev).settings,
                       tt.TickParams.default(dev, mouse_force_power=0.5),
                       device=dev, neighbor_mode="resident")
        pos_t, state_t = app.params.mouse_pos, app.params.mouse_state
        app.set_mouse(pos=(0.0, 0.0), state=state)
        if not (app.params.mouse_pos is pos_t
                and app.params.mouse_state is state_t
                and int(state_t) == state):
            raise AssertionError("set_mouse did not write in place")
        torch.cuda.synchronize()
        reset_counts()
        app.run(16)
        torch.cuda.synchronize()
        launches = read_counts()
        m = app.metrics()
        st = app.state
        r = torch.linalg.norm(st.position, dim=1)
        near = (r < 4.0) & (r > 0.5)
        outward[state] = float(
            ((st.position * st.velocity).sum(dim=1)[near] / r[near]).mean())
        if not (m["tick"] == 16 and m["lost_particles"] == 0
                and bool(torch.isfinite(st.velocity).all())
                and launches == {**dict.fromkeys(launches, 0),
                                 "rebin": 16, "density": 16,
                                 "forces_integrate": 16}):
            raise AssertionError(f"mouse run (state {state}): {m}, "
                                 f"launches {launches}")
    log(f"scene_1m FluidApp.set_mouse((0, 0), -1), power 0.5, then "
        f"run(16): lost 0, 16 launches of each kernel; mean velocity away "
        f"from the mouse within 0.5-4 of it {outward[-1]:.3f} (mouse off: "
        f"{outward[0]:.3g}; {card})")
    if not (outward[-1] > 0.2 and outward[-1] - outward[0] > 0.2):
        raise AssertionError(f"mouse impulse: outward velocity {outward}")
    return dict(outward_repel=outward[-1], outward_off=outward[0])


# ------------------------- video fields, debugging and shards (20-23)

def video_frames(t: int = 4, size: int = 1024):
    """u8[T, size, size] frames: white, with a dark disc of about 1 world
    unit at the default scene's scale that moves right a frame, inside its
    fluid block (seeded radius and rows). Returns (frames, discs in
    pixels)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[:size, :size]
    frames = np.full((t, size, size), 255, np.uint8)
    discs = []
    for i in range(t):
        r = size * (0.018 + 0.004 * rng.random())
        cx = size * (0.45 + 0.01 * i)
        cy = size * (0.48 + 0.04 * rng.random())
        frames[i][(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = 0
        discs.append((cx, cy, r))
    return frames, discs


def chamfer_check(frames, dev, card):
    """The compiled chamfer copy against its NumPy plain version, bitwise,
    on each frame; both timed on the host (the compiled one with its
    upload)."""
    import numpy as np
    from tpufluid_torch.native import distfield

    calls0 = distfield.CALLS["chamfer"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [distfield.chamfer_push_field(f, dev) for f in frames]
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [distfield._chamfer_numpy(f) for f in frames]
    t_n = time.perf_counter() - t0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy()
        if not (g.dtype == w.dtype and g.shape == w.shape
                and np.array_equal(g.view(np.uint32), w.view(np.uint32))):
            raise AssertionError(f"chamfer frame {i}: compiled != NumPy")
    if distfield.CALLS["chamfer"] - calls0 != len(frames):
        raise AssertionError("chamfer: the compiled copy did not run")
    t = len(frames)
    h, w = frames.shape[1:]
    out = dict(frames=t, size=[h, w], compiled_ms_per_frame=1e3 * t_c / t,
               numpy_ms_per_frame=1e3 * t_n / t)
    log(f"chamfer {t} x {h}x{w}: compiled copy bitwise equal to NumPy; "
        f"compiled {out['compiled_ms_per_frame']:.1f} ms/frame (host, with "
        f"the upload), NumPy {out['numpy_ms_per_frame']:.1f} ms/frame "
        f"({card})")
    return out


def video_render(frames, discs, card):
    """``render --video-field`` through the CLI's parser on the default
    scene (100k), resident engine, 4 frames at 960x540: frame i renders
    under field i, nothing is lost, every particle is finite, and none
    sits more than h inside the last frame's disc. K=32: the first step
    pushes the disc's particles onto its rim (the 256-tick loss audit that
    would regrow a smaller K comes after the 64 ticks)."""
    import numpy as np
    from tpufluid_torch import cli
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.native import distfield
    from tpufluid_torch.ops import resident

    t = len(frames)
    seen = []
    orig = FluidApp.render_frame

    def recorded(self, *a, **kw):
        seen.append([j for j, f in enumerate(self._video_fields)
                     if f is self._forcefield])
        return orig(self, *a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        np.save(path, frames)
        out = os.path.join(tmp, "out")
        args = cli.parser().parse_args([
            "render", "--device", "cuda", "--neighbor-mode", "resident",
            "--cell-capacity", "32", "--video-field", path, "--frames",
            str(t), "--width", "960", "--height", "540", "--out", out])
        torch.cuda.synchronize()
        calls0 = distfield.CALLS["chamfer"]
        reset_counts()
        FluidApp.render_frame = recorded
        try:
            t0 = time.perf_counter()
            app = cli.render(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            FluidApp.render_frame = orig
        launches = read_counts()
        names = sorted(os.listdir(out))
    m = app.metrics()
    ps, live = resident.to_particles(app.grid_state, app.settings)
    pos = ps.position[:int(live)]
    finite = bool(torch.isfinite(pos).all()
                  and torch.isfinite(ps.velocity[:int(live)]).all())
    sx, sy = app.settings.size
    tw, th = app.settings.texture_size
    cx, cy, r = discs[-1]
    wx = ((cx + 0.5) / tw - 0.5) * sx
    wy = ((cy + 0.5) / th - 0.5) * sy
    wr = r * sx / tw
    h = app.settings.smoothing_radius
    d = torch.hypot(pos[:, 0] - wx, pos[:, 1] - wy)
    inside = int((d < wr - h).sum())
    near = int((d < wr + 1.0).sum())
    res = dict(frames=len(names), fields_seen=seen, tick=m["tick"],
               lost=m["lost_particles"], live=int(live), finite=finite,
               inside_last_disc=inside, within_1_of_its_rim=near,
               wall_s=wall, ms_per_frame=1e3 * wall / t,
               chamfer_calls=distfield.CALLS["chamfer"] - calls0)
    log(f"render --video-field (default scene, {t} frames 960x540, "
        f"resident): fields by frame {seen}, tick {m['tick']}, lost "
        f"{m['lost_particles']}, live {int(live)}, finite {finite}, "
        f"{inside} particles more than h inside the last disc "
        f"({near} within 1 of its rim); wall {wall:.2f} s, "
        f"{res['ms_per_frame']:.1f} ms/frame with the {t} fields' set-up "
        f"({card}); launches {launches}")
    if not (names == [f"frame_{i:05d}.png" for i in range(t)]
            and seen == [[i] for i in range(t)]
            and m["tick"] == 16 * t and m["lost_particles"] == 0
            and int(live) == 100_000 and finite and inside == 0
            and near > 100 and res["chamfer_calls"] == t):
        raise AssertionError(f"video render: {res}")
    if not (launches["metaball_coarse"] == t
            and launches["forces_integrate_has_ff"]
            == launches["forces_integrate"] == launches["rebin"]
            == launches["density"] == 16 * t):
        raise AssertionError(f"video render launches: {launches}")
    return res


def debugging_check(s8, params, dev, card):
    """diagnose_resident_step at scene_1m, clean (the spawn lattice) and
    with an inf in a live vel_x; checked_step on the grid and dense
    engines, clean and with a NaN input."""
    from tpufluid_torch.ops import resident
    from tpufluid_torch.state import init_state
    from tpufluid_torch.utils.debugging import (checked_step,
                                                diagnose_resident_step)

    gs = resident.init_grid_state(s8, dev)
    clean = diagnose_resident_step(gs, params, s8)
    live = torch.nonzero(resident.valid_mask(gs))
    y, k, x = (int(v) for v in live[live.shape[0] // 2])
    vx = gs.vel_x.clone()
    vx[y, k, x] = float("inf")
    bad = diagnose_resident_step(dataclasses.replace(gs, vel_x=vx), params,
                                 s8)
    stages = ["input", "rebin", "density", "forces"]
    n = s8.particle_count
    if not (list(clean) == stages and all(v["finite"] for v in
                                          clean.values())
            and clean["rebin"]["over"] == 0
            and clean["input"]["live"] == clean["forces"]["live"] == n):
        raise AssertionError(f"diagnose, clean: {clean}")
    if not (list(bad) == stages and not bad["input"]["finite"]):
        raise AssertionError(f"diagnose, poisoned: {bad}")
    st = init_state(s8, dev)
    pos = st.position.clone()
    pos[n // 2, 0] = float("nan")
    nan_state = dataclasses.replace(st, position=pos, predicted=pos.clone())
    checked = {}
    for mode in ("grid", "dense"):
        step = checked_step(s8, neighbor_mode=mode)
        err, out = step(st, params)
        err_bad, _ = step(nan_state, params)
        checked[mode] = dict(clean=err.stage, nan_input=err_bad.stage)
        if not (err.stage is None and err_bad.stage == "input"
                and bool(torch.isfinite(out.position).all())):
            raise AssertionError(f"checked_step {mode}: {checked[mode]}")
    log(f"debugging at scene_1m: diagnose clean {clean}; poisoned input "
        f"finite {bad['input']['finite']}, rebin finite "
        f"{bad['rebin']['finite']}; checked_step {checked} ({card})")
    return dict(diagnose_clean=clean, diagnose_poisoned=bad,
                checked_step=checked)


def sorted_drift(a, b) -> float:
    """max over both axes of |sorted(a) - sorted(b)|: each coordinate
    sorted on its own, which bounds nothing looser than the largest
    per-particle difference, and needs no matching of particles."""
    return max(float((torch.sort(a[:, i])[0] - torch.sort(b[:, i])[0])
                     .abs().max()) for i in range(2))


def shear_field(settings, device):
    """A push-out field f32[H, W, 2] (pixels) that varies by row and by
    column: bands of 7 texel rows push left or right, bands of 5 texel
    columns up or down, at most 0.01 pixel (0.002 world units at scene_1m)
    a step. scene_1m's fluid fills its world, so an obstacle's push-out
    moves the fluid inside it onto its rim, past K=8 (at a hundredth of
    the push too: 98 lost in 32 steps on an H100); this field
    shears the fluid without piling it up, and a band's windowed cell
    samples differ row by row."""
    tw, th = settings.texture_size
    ty = torch.arange(th, device=device, dtype=torch.float32)
    tx = torch.arange(tw, device=device, dtype=torch.float32)
    fx = 0.01 * (torch.remainder(ty, 7.0) - 3.0) / 3.0
    fy = 0.01 * (torch.remainder(tx, 5.0) - 2.0) / 2.0
    return torch.stack([fx[:, None].expand(th, tw),
                        fy[None, :].expand(th, tw)], dim=-1).contiguous()


def far_mover_state(settings, device, n_far: int = 16):
    """The spawn lattice at rest with ``n_far`` seeded far movers (speed
    300, up to 12 cells a step)."""
    from tpufluid_torch.state import init_state

    st = init_state(settings, "cpu")
    g = torch.Generator().manual_seed(SEED)
    vel = torch.zeros((settings.particle_count, 2))
    far = torch.randperm(settings.particle_count, generator=g)[:n_far]
    ang = torch.rand(n_far, generator=g) * 6.2831853
    vel[far] = torch.stack([ang.cos(), ang.sin()], dim=1) * 300.0
    return dataclasses.replace(st, position=st.position.to(device),
                               predicted=st.predicted.to(device),
                               velocity=vel.to(device),
                               density=st.density.to(device),
                               cell=st.cell.to(device),
                               tick=st.tick.to(device))


def step_loop(step, n_steps: int):
    """``run(state, *args)``: ``n_steps`` calls of a sharded step."""
    def run(state, *args):
        for _ in range(n_steps):
            state = step(state, *args)[0]
        return state

    return run


def last_capture(prefix: str):
    """The newest capture record (``graphs.CAPTURES``) whose ``what``
    starts with ``prefix``."""
    from tpufluid_torch import graphs

    hits = [c for c in graphs.CAPTURES if c["what"].startswith(prefix)]
    return hits[-1] if hits else None


def capture_text(cap) -> str:
    return ("no capture" if cap is None else
            f"capture {cap['capture_s']:.3f} s, instantiate "
            f"{cap['instantiate_s']:.3f} s, {cap['nodes']} nodes")


def band_far_bytes(bands, far_n, n_far: int, fcap: int) -> list:
    """Bytes the collect must move, per band: the gate's int; with movers
    anywhere, the band's per-row counts, the four fields below occupancy
    of the rows that hold movers, and the packet and its drop count
    written."""
    out = []
    for b, fn in zip(bands, far_n):
        if n_far == 0:
            out.append(4)
            continue
        rows = fn > 0
        occ = b.occ_row.clamp(max=b.pos_x.shape[1])[rows].double().sum()
        out.append(4 + 4 * fn.numel() + float(occ) * b.pos_x.shape[2] * 16
                   + 20 * fcap + 4)
    return out


def band_far_case(sgs, spec, mesh, params, label, timed=False):
    """csrc/far_sharded.cu against its plain versions on the kernel step's
    post-merge bands of ``sgs`` (``shard.rebin_and_merge`` with the rebin
    kernel): the collect's packets and drop counts bitwise where the psum'd
    count is not 0; the insert's grids, occ_row and lost bitwise on every
    band (its plain version: ``insert_far_plain`` plus the drops), and
    with no mover the post-merge bands, occ_row and lost untouched. Timed:
    each half by repeated calls (the insert on one copy of the bands, a
    call with movers inserting them again: the same work), the plain
    versions on the same inputs, ms a launch (the mean over the bands)."""
    from tpufluid_torch.ops import far_sharded as fs, fused
    from tpufluid_torch.parallel import shard

    s, rloc, fcap = spec.settings, spec.rows_per_dev, spec.far_capacity
    n_dev, dt = spec.n_devices, params.delta
    bands = sgs.bands
    reb, band4, occ_band, n_lost = shard.rebin_and_merge(
        mesh, bands, [dt] * n_dev, shard.band_shifts(spec, mesh), s)
    total = [sum(r[5].sum() for r in reb).to(torch.int32)] * n_dev
    n_far = int(total[0])
    far_n = [r[5][1:rloc + 1] for r in reb]

    def collect():
        return [fs.far_collect(b.pos_x, b.pos_y, b.vel_x, b.vel_y,
                               b.occ_row, far_n[d], total[d], dt, s,
                               d * rloc, fcap) for d, b in enumerate(bands)]

    def collect_plain():
        return [fs.far_packet_plain(b.pos_x, b.pos_y, b.vel_x, b.vel_y, dt,
                                    s, d * rloc, fcap)
                for d, b in enumerate(bands)]

    got, want = collect(), collect_plain()
    if n_far:
        for d in range(n_dev):
            bitwise(got[d], want[d], f"{label} far_collect band {d}")
    allp = torch.cat([p for p, _ in got])
    allp_plain = torch.cat([p for p, _ in want])
    copies = [(tuple(a.clone() for a in band4[d]), occ_band[d].clone(),
               n_lost[d].clone()) for d in range(n_dev)]

    def insert(cp=copies):
        return [fs.far_insert(*cp[d], allp, total[d], got[d][1], dt, s,
                              d * rloc) for d in range(n_dev)]

    def insert_plain():
        return [fs.insert_far_plain(band4[d], allp_plain, dt, s, d * rloc)
                for d in range(n_dev)]

    kout = insert()
    mine, dropped = [], 0
    for d, (pg4, pocc, pdrop) in enumerate(insert_plain()):
        g4, occ, lost = kout[d]
        bitwise((*g4, occ, lost), (*pg4, pocc, n_lost[d] + pdrop
                                   + want[d][1]), f"{label} far_insert "
                f"band {d}")
        if n_far == 0:
            bitwise((*g4, occ, lost), (*band4[d], occ_band[d], n_lost[d]),
                    f"{label} far_insert band {d}, no mover")
        gcx, gcy = fused._cells(*(allp_plain[:, i] for i in range(4)), dt, s)
        mine.append(int(((allp_plain[:, 4] > 0.5) & (gcy >= d * rloc)
                         & (gcy < (d + 1) * rloc)).sum()))
        dropped += int(pdrop + want[d][1])
    res = dict(d=n_dev, n_far=n_far, far_capacity=fcap,
               pk_drop=[int(w[1]) for w in want], dropped=dropped,
               band_movers=mine, max_abs_err=0.0)
    log(f"{label} D={n_dev}: far_collect and far_insert bitwise equal to "
        f"plain ({n_far} far movers, capacity {fcap} a band, band movers "
        f"{mine}, packet drops {res['pk_drop']}, {dropped} dropped)")
    if timed:
        res["collect"] = c = {}
        c["ms"], c["plain_ms"], raw = timed_pair(collect, collect_plain)
        c["ms"], c["plain_ms"] = c["ms"] / n_dev, c["plain_ms"] / n_dev
        c["readings"] = [r / n_dev for r in raw]
        c["bound_ms"], c["bound_by"] = bound(sum(band_far_bytes(
            bands, far_n, n_far, fcap)) / n_dev, 0)
        res["insert"] = i = {}
        i["ms"], i["plain_ms"], raw = timed_pair(insert, insert_plain)
        i["ms"], i["plain_ms"] = i["ms"] / n_dev, i["plain_ms"] / n_dev
        i["readings"] = [r / n_dev for r in raw]
        k = s.cell_capacity
        ibytes = (4 if n_far == 0 else
                  sum(4 + 4 * allp.shape[0] + m * (16 + 4 * k + 16) + 8
                      for m in mine) / n_dev)
        i["bound_ms"], i["bound_by"] = bound(ibytes, 0)
        for name, r in (("far_collect", c), ("far_insert", i)):
            r["library_ms"] = None
            log(f"{label} D={n_dev} {name}: kernel {r['ms']:.4f} ms a "
                f"launch, plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.6f} ms ({r['bound_by']}; readings k k p p "
                + ", ".join(f"{x:.4f}" for x in r["readings"]) + ")")
    return res


def band_far_gates(s8, params, dev):
    """Phase 23's far kernel cases at D = 2 and 4 on scene_1m: the 16 far
    movers of ``far_mover_state`` crossing bands (timed), the lattice at
    rest (none; timed), the seeded state (254 movers) over a capacity of
    8 a band (packet drops), and the wall movers one wrap step later
    (thousands; timed)."""
    from tpufluid_torch.ops import resident
    from tpufluid_torch.parallel import (
        build_resident_spec, make_eager_sharded_resident_step,
        make_resident_mesh, shard_grid_state)

    out = {}
    wst, _ = wall_state(s8, dev)
    for d in (2, 4):
        spec = build_resident_spec(s8, d)
        mesh = make_resident_mesh(spec, [dev] * d)
        cases = {}
        cases["seeded"] = band_far_case(shard_grid_state(
            resident.from_particles(far_mover_state(s8, dev), s8), spec,
            mesh), spec, mesh, params, "scene_1m 16 movers", timed=True)
        cases["none"] = band_far_case(shard_grid_state(
            resident.init_grid_state(s8, dev), spec, mesh), spec, mesh,
            params, "scene_1m lattice", timed=True)
        over = build_resident_spec(s8, d, far_capacity=8)
        cases["over"] = band_far_case(shard_grid_state(
            resident.from_particles(seeded_state(s8, dev), s8), over, mesh),
            over, mesh, params, "scene_1m seeded, capacity 8")
        wrap = make_eager_sharded_resident_step(spec, mesh,
                                                x_boundary="wrap")
        sgs = wrap(shard_grid_state(resident.from_particles(wst, s8), spec,
                                    mesh), params)[0]
        cases["wrap"] = band_far_case(sgs, spec, mesh, params,
                                      "scene_1m wall movers, wrapped",
                                      timed=True)
        if not (cases["none"]["n_far"] == 0 and cases["seeded"]["n_far"] > 0
                and sum(cases["over"]["pk_drop"]) > 0
                and cases["wrap"]["n_far"] > 1000):
            raise AssertionError(f"sharded far cases D={d}: {cases}")
        out[d] = cases
    return out


def sharded_runs(s8, params, field, dev, card):
    """The row-band sharded step on D = 2 and 4 shards of one card, from
    scene_1m's lattice with 16 far movers, without and with a push field
    (``shear_field``): graphed (a CUDA graph a call) bitwise against its
    plain version over 4 synced steps and against its eager twin over 8,
    then 32 graphed steps with the counts reset under
    ``torch.cuda.set_sync_debug_mode("error")``, held to the
    single-device step (live count, no loss, sorted positions), audited,
    and timed graphed against eager. ms/step at D = 1 (the single-device
    step), 2 and 4."""
    from tpufluid_torch.ops import resident
    from tpufluid_torch.parallel import (
        build_resident_spec, comm_audit, gather_resident, make_resident_mesh,
        make_eager_sharded_resident_step, make_plain_sharded_resident_step,
        make_sharded_resident_step, shard_grid_state, unshard_grid_state)

    n = s8.particle_count
    gs0 = resident.from_particles(far_mover_state(s8, dev), s8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = {}
    for has_ff in (False, True):
        tag = "push field" if has_ff else "plain"
        extra = (field,) if has_ff else ()
        single = resident.make_grid_step(s8, has_force_field=has_ff)
        single(gs0, params, *extra)  # warm
        torch.cuda.synchronize()
        ref, ref4 = gs0, None
        start.record()
        for i in range(32):
            ref = single(ref, params, *extra)
            if i == 3:
                ref4 = ref
        end.record()
        torch.cuda.synchronize()
        row = {1: dict(ms_per_step=start.elapsed_time(end) / 32,
                       lost=int(ref.lost))}
        if not has_ff:  # where a step's time goes, D=1 and (below) D=2, 4
            held = [ref]

            def one():
                held[0] = single(held[0], params)

            row[1]["profile"] = profile_steps(
                None, 8, "sharded scene_1m D=1 (the single-device step)",
                step=one)
        p4, live4 = resident.to_particles(ref4, s8)
        p32, live32 = resident.to_particles(ref, s8)
        for d in (2, 4):
            spec = build_resident_spec(s8, d)
            mesh = make_resident_mesh(spec, [dev] * d)
            kstep = make_sharded_resident_step(spec, mesh,
                                               has_force_field=has_ff)
            estep = make_eager_sharded_resident_step(spec, mesh,
                                                     has_force_field=has_ff)
            pstep = make_plain_sharded_resident_step(spec, mesh,
                                                     has_force_field=has_ff)
            if not kstep.graphed or estep.graphed:
                raise AssertionError(f"sharded D={d}: graphed "
                                     f"{kstep.graphed}, eager twin "
                                     f"{estep.graphed}")
            sgs0 = shard_grid_state(gs0, spec, mesh)
            # captured here, as a caller would, not under the
            # deterministic mode of the comparison below (its scatters
            # would be captured too)
            kstep(sgs0, params, *extra)
            sgs = sgs0
            torch.use_deterministic_algorithms(True)
            for i in range(4):
                k, kst = kstep(sgs, params, *extra)
                p, pst = pstep(sgs, params, *extra)
                kg, pg = unshard_grid_state(k), unshard_grid_state(p)
                for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row",
                          "tick", "lost"):
                    if not torch.equal(getattr(kg, f), getattr(pg, f)):
                        raise AssertionError(
                            f"sharded D={d} {tag} step {i}: {f}: kernels "
                            f"!= plain")
                if not torch.equal(kst["n_valid"], pst["n_valid"]):
                    raise AssertionError(f"sharded D={d} {tag}: n_valid")
                sgs = p
            torch.use_deterministic_algorithms(False)
            a = b = sgs0
            for i in range(8):
                a, ast = kstep(a, params, *extra)
                b, bst = estep(b, params, *extra)
                ag, bg = unshard_grid_state(a), unshard_grid_state(b)
                for f in GRID_FIELDS:
                    if not torch.equal(getattr(ag, f), getattr(bg, f)):
                        raise AssertionError(
                            f"sharded D={d} {tag} step {i}: {f}: graphed "
                            f"!= eager")
                if not torch.equal(ast["n_valid"], bst["n_valid"]):
                    raise AssertionError(f"sharded D={d} {tag}: n_valid "
                                         f"graphed != eager")
            cap = last_capture(f"the row-band sharded step, D={d} ")
            sgs = sgs0
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            start.record()
            with no_host_sync():
                for i in range(32):
                    sgs, stats = kstep(sgs, params, *extra)
                    if i == 3:
                        s4 = sgs
                end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            ms = start.elapsed_time(end) / 32
            g_ms, e_ms, raw = burst_times(
                step_loop(kstep, 32), step_loop(estep, 32),
                (sgs0, params, *extra), 32)
            audit = comm_audit.audit_step(kstep, sgs, params, *extra)
            model = comm_audit.resident_comm_formula(spec)
            profile = eager_profile = None
            if not has_ff:
                held = [sgs]

                def one():
                    held[0] = kstep(held[0], params)[0]

                profile = profile_steps(None, 8, f"sharded scene_1m D={d} "
                                        f"graphed", step=one)

                def one_eager():
                    held[0] = estep(held[0], params)[0]

                eager_profile = profile_steps(
                    None, 8, f"sharded scene_1m D={d} eager",
                    step=one_eager)
            ps4, l4 = gather_resident(s4, spec)
            ps, live = gather_resident(sgs, spec)
            drift4 = sorted_drift(ps4.position[:int(l4)],
                                  p4.position[:int(live4)])
            drift32 = sorted_drift(ps.position[:int(live)],
                                   p32.position[:int(live32)])
            want = {**dict.fromkeys(launches, 0), **dict.fromkeys(
                ("rebin", "rebin_row_shift", "density",
                 "forces_integrate", "far_collect", "far_insert"), 32 * d)}
            if has_ff:
                want["forces_integrate_has_ff"] = 32 * d
            row[d] = dict(
                ms_per_step=ms, wall_ms_per_step=1e3 * wall / 32,
                graphed_ms_per_step=g_ms, eager_ms_per_step=e_ms,
                readings=raw, capture=cap,
                launches_per_step={k: v / 32 for k, v in launches.items()
                                   if v},
                n_valid=stats["n_valid"].tolist(), lost=int(sgs.lost),
                drift_4=drift4, drift_32=drift32,
                bytes_per_step=audit["ppermute_bytes_total"],
                far_packet_bytes=audit["all_gather_bytes_conditional"],
                rows_per_shard=spec.rows_per_dev,
                far_capacity=spec.far_capacity, profile=profile,
                eager_profile=eager_profile)
            log(f"sharded scene_1m D={d} ({tag}, {spec.rows_per_dev} rows "
                f"a shard on one card): graphed bitwise its plain version "
                f"(4 steps) and its eager twin (8 steps); {ms:.4f} ms/step "
                f"graphed (CUDA events over 32 steps under sync debug "
                f"'error'; host {row[d]['wall_ms_per_step']:.4f}); graphed "
                f"{g_ms:.4f} / eager {e_ms:.4f} ms/step (e g g e "
                + ", ".join(f"{r:.4f}" for r in raw) + f"); {capture_text(cap)}"
                f"; launches/step {row[d]['launches_per_step']}, n_valid "
                f"{row[d]['n_valid']}, lost {int(sgs.lost)}; against the "
                f"single-device step: live {int(live)} vs {int(live32)}, "
                f"sorted position drift {drift4:.3g} at step 4, "
                f"{drift32:.3g} at step 32; audited "
                f"{audit['ppermute_bytes_per_dir']} B/dir a step "
                f"(formula {model['bytes_per_dir']}), far packet "
                f"{audit['all_gather_bytes_conditional']} B ({card})")
            if not (int(live) == int(live32) == n and int(sgs.lost) == 0
                    and int(ref.lost) == 0 and int(l4) == n
                    and sum(row[d]["n_valid"]) == n
                    and drift4 <= SHARD_DRIFT_4 and drift32 <= SHARD_DRIFT_32):
                raise AssertionError(f"sharded D={d} {tag}: {row[d]}")
            if launches != want:
                raise AssertionError(f"sharded D={d} {tag} launches: "
                                     f"{launches}")
            if not (audit["ppermute_bytes_per_dir"] == model["bytes_per_dir"]
                    and audit["all_gather_bytes_conditional"]
                    == model["far_packet_bytes"]
                    and audit["all_gather_bytes_unconditional"] == 0):
                raise AssertionError(f"sharded D={d} audit: {audit}")
        log(f"sharded scene_1m ({tag}): ms/step D=1 "
            f"{row[1]['ms_per_step']:.4f}, D=2 {row[2]['ms_per_step']:.4f}, "
            f"D=4 {row[4]['ms_per_step']:.4f} graphed ({card})")
        out[tag] = row
    return out


# ------------------------------- the slab step and the harness (24-25)

class no_host_sync:
    """``torch.cuda.set_sync_debug_mode("error")`` while open: any call
    that waits for the device on the host raises."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)


def slab_equal(a, b, sa, sb, what) -> None:
    """Two slab-sharded states and their stats, bitwise."""
    for x, y in zip(a.slabs, b.slabs):
        for f in ("position", "velocity", "valid", "tick"):
            if not torch.equal(getattr(x, f), getattr(y, f)):
                raise AssertionError(f"{what}: {f} differs")
    for k in sa:
        if not torch.equal(sa[k], sb[k]):
            raise AssertionError(f"{what}: stats {k} differ")


def timed_slab(step, st, params, n_steps, label, profile_steps_n):
    """``n_steps`` steps from ``st`` with the counts reset, every step
    under ``no_host_sync``: device ms/step (CUDA events), host ms/step,
    the port's kernel launches, and a torch.profiler reading."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    start.record()
    with no_host_sync():
        for _ in range(n_steps):
            st, stats = step(st, params)
        end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    held = [st]

    def one():
        held[0] = step(held[0], params)[0]

    prof = profile_steps(None, profile_steps_n, label, step=one)
    return dict(ms_per_step=start.elapsed_time(end) / n_steps,
                wall_ms_per_step=1e3 * wall / n_steps, launches=launches,
                launches_per_step=prof["launches_per_step"] if prof else None,
                busy_ms_per_step=prof["busy_ms_per_step"] if prof else None,
                busy_share=prof["busy_share"] if prof else None), st, stats


def slab_graph_case(kstep, estep, st0, params, n_steps, label, card):
    """The graphed slab step against its eager twin from ``st0``: 4 steps
    bitwise (state, valid, stats), then ``n_steps`` of each timed in
    turns (``burst_times``); the capture's seconds and nodes."""
    if not kstep.graphed or estep.graphed:
        raise AssertionError(f"{label}: graphed {kstep.graphed}, eager "
                             f"twin {estep.graphed}")
    a = b = st0
    for i in range(4):
        a, ast = kstep(a, params)
        b, bst = estep(b, params)
        slab_equal(a, b, ast, bst, f"{label} step {i}: graphed vs eager")
    cap = last_capture(f"the slab-sharded step, D={len(st0.slabs)}, "
                       f"{label.split()[-1]}")
    g_ms, e_ms, raw = burst_times(step_loop(kstep, n_steps),
                                  step_loop(estep, n_steps), (st0, params),
                                  n_steps)
    log(f"{label}: graphed bitwise its eager twin over 4 steps; graphed "
        f"{g_ms:.4f} / eager {e_ms:.4f} ms/step over {n_steps} (e g g e "
        + ", ".join(f"{r:.4f}" for r in raw) + f"); {capture_text(cap)} "
        f"({card})")
    return dict(graphed_ms_per_step=g_ms, eager_ms_per_step=e_ms,
                readings=raw, steps=n_steps, capture=cap)


def slab_runs(s8, dev, card):
    """The slab-sharded step on D = 2 and 4 shards of one card
    (``[cuda:0] * D``). At scene_1m, from the spawn lattice under gravity:
    pallas mode bitwise against its plain version (state, valid, stats)
    over 4 synced steps, on slab-local grids of 384 (D=2) and 256 (D=4)
    columns; dense and pallas held to the single-device step of their
    mode (sorted positions within 1e-6 after 2 steps); 16 timed steps of
    each, and the audited bytes a direction against (8 + 8 + 1) B a slot
    of the halo and migration packs. At bench.py's parity scene: grid
    mode within 5e-4 of the single-device grid step over 5 steps with no
    drops, and 40 steps under gravity (30, 0) at capacity factor 3 that
    move particles across slabs with none lost. Every slab step after a
    warm one runs under ``no_host_sync``."""
    import tpufluid_torch as tt
    from tpufluid_torch.parallel import (
        build_shard_spec, comm_audit, gather_state, init_sharded, make_mesh,
        make_eager_sharded_step, make_plain_sharded_step, make_sharded_step)

    n = s8.particle_count
    params = tt.TickParams.default(dev, gravity=(0.0, -9.8))
    single = {m: tt.make_step(s8, neighbor_mode=m)
              for m in ("dense", "pallas")}
    out = {}
    for d in (2, 4):
        spec = build_shard_spec(s8, d)
        mesh = make_mesh(spec, [dev] * d)
        widths = [b - a for a, b in zip(spec.col_bounds[:-1],
                                        spec.col_bounds[1:])]
        grid = [s8.grid_h, s8.cell_capacity, -(-(max(widths) + 4) // 128)
                * 128]
        st0 = init_sharded(spec, mesh)
        steps = {"pallas": make_sharded_step(spec, mesh,
                                             neighbor_mode="pallas"),
                 "dense": make_sharded_step(spec, mesh,
                                            neighbor_mode="dense")}
        pstep = make_plain_sharded_step(spec, mesh)
        for step in (*steps.values(), pstep):
            step(st0, params)  # warm: constants, the kernels' build
        torch.cuda.synchronize()
        st = st0
        for i in range(4):
            with no_host_sync():
                k, kst = steps["pallas"](st, params)
                p, pst = pstep(st, params)
            slab_equal(k, p, kst, pst, f"slab D={d} pallas step {i}")
            st = p
        log(f"slab scene_1m D={d} (slabs {widths} columns, grids "
            f"{grid}): pallas step bitwise equal to its plain version over "
            f"4 synced steps (state, valid, stats; n_valid "
            f"{kst['n_valid'].tolist()})")
        row = dict(grid=grid, capacity=spec.capacity,
                   halo_capacity=spec.halo_capacity,
                   migration_capacity=spec.migration_capacity)
        ref0 = gather_state(st0)
        for mode, step in steps.items():
            a, b, drops = st0, ref0, 0
            for _ in range(2):
                with no_host_sync():
                    a, stats = step(a, params)
                b = single[mode](b, params)
                drops += int(stats["halo_dropped"].sum()
                             + stats["migration_dropped"].sum())
            drift = sorted_drift(gather_state(a).position, b.position)
            res, _, tstats = timed_slab(
                step, st0, params, 16, f"slab scene_1m D={d} {mode}",
                2 if mode == "pallas" else 1)
            res.update(drift_2=drift, drops_2=drops,
                       n_valid=tstats["n_valid"].tolist())
            want = {f"{'sph' if mode == 'pallas' else 'dense'}_{k}": 16 * d
                    for k in ("density", "forces")}
            want.update(dense_build=16 * d, dense_readback=16 * d)
            log(f"slab scene_1m D={d} {mode}: sorted position drift "
                f"{drift:.3g} from the single-device step after 2 steps "
                f"(bound 1e-6), drops {drops}; {res['ms_per_step']:.4f} "
                f"ms/step (CUDA events over 16 steps; host "
                f"{res['wall_ms_per_step']:.4f}), launches {res['launches']}"
                f", {res['launches_per_step']} kernels a step, n_valid "
                f"{res['n_valid']} ({card})")
            if not (drift <= 1e-6 and drops == 0 and res["launches"] == want
                    and sum(res["n_valid"]) == n):
                raise AssertionError(f"slab D={d} {mode}: {res}")
            res["graph"] = slab_graph_case(
                step, make_eager_sharded_step(spec, mesh,
                                              neighbor_mode=mode),
                st0, params, 16 if mode == "pallas" else 4,
                f"slab scene_1m D={d} {mode}", card)
            row[mode] = res
        audit = comm_audit.audit_step(steps["pallas"], st0, params)
        formula = (spec.halo_capacity + spec.migration_capacity) * (8 + 8 + 1)
        row["bytes_per_dir"] = audit["ppermute_bytes_per_dir"]
        log(f"slab scene_1m D={d}: audited {audit['ppermute_bytes_per_dir']}"
            f" B/dir a step (formula {formula}: halo {spec.halo_capacity} "
            f"+ migration {spec.migration_capacity} slots x 17 B)")
        if not (audit["ppermute_bytes_per_dir"] == formula
                and audit["all_gather_bytes_conditional"] == 0
                and audit["all_gather_bytes_unconditional"] == 0):
            raise AssertionError(f"slab D={d} audit: {audit}")
        out[d] = row

    # grid mode at bench.py's parity scene
    sp = tt.SimSettings(particle_count=PARITY_N, particle_spacing=0.1,
                        smoothing_radius=0.2, size=(26.0, 26.0),
                        cell_capacity=32)
    pp = tt.TickParams.default(dev, gravity=(0.0, -3.0))
    pg = tt.TickParams.default(dev, gravity=(30.0, 0.0))
    single_g = tt.make_step(sp)
    for d in (2, 4):
        spec = build_shard_spec(sp, d)
        mesh = make_mesh(spec, [dev] * d)
        gstep = make_sharded_step(spec, mesh)
        st, ref = init_sharded(spec, mesh), tt.init_state(sp, dev)
        gstep(st, pp)  # warm
        worst, drops = 0.0, 0
        for i in range(5):
            with no_host_sync():
                st, stats = gstep(st, pp)
            ref = single_g(ref, pp)
            worst = max(worst, sorted_drift(gather_state(st).position,
                                            ref.position))
            drops += int(stats["halo_dropped"].sum()
                         + stats["migration_dropped"].sum())
            if int(stats["n_valid"].sum()) != PARITY_N:
                raise AssertionError(f"slab grid D={d} step {i}: "
                                     f"{stats['n_valid'].tolist()}")
        res, _, _ = timed_slab(gstep, init_sharded(spec, mesh), pp, 16,
                               f"slab parity scene D={d} grid", 2)
        res["graph"] = slab_graph_case(
            gstep, make_eager_sharded_step(spec, mesh),
            init_sharded(spec, mesh), pp, 16,
            f"slab parity scene D={d} grid", card)
        # 40 steps of sideways gravity, room for every particle per shard
        mspec = build_shard_spec(sp, d, capacity_factor=3.0)
        mstep = make_sharded_step(mspec, mesh)
        ms = init_sharded(mspec, mesh)
        before = [int(x.valid.sum()) for x in ms.slabs]
        mstep(ms, pg)  # warm
        lost = torch.zeros((), dtype=torch.int64, device=dev)
        with no_host_sync():
            for _ in range(40):
                ms, mstats = mstep(ms, pg)
                lost = lost + mstats["halo_dropped"].sum() + mstats[
                    "migration_dropped"].sum()
        after = [int(x.valid.sum()) for x in ms.slabs]
        mean_x = float(gather_state(ms).position[:, 0].mean())
        res.update(drift_5=worst, drops_5=drops, migration=dict(
            before=before, after=after, dropped=int(lost), mean_x=mean_x))
        log(f"slab parity scene D={d} grid: sorted position drift "
            f"{worst:.3g} from the single-device grid step over 5 steps "
            f"(bound 5e-4), drops {drops}; {res['ms_per_step']:.4f} ms/step "
            f"(CUDA events over 16; host {res['wall_ms_per_step']:.4f}), "
            f"{res['launches_per_step']} kernels a step; 40 steps of "
            f"gravity (30, 0): slabs {before} -> {after}, dropped "
            f"{int(lost)}, mean x {mean_x:.3f} ({card})")
        if not (worst <= 5e-4 and drops == 0 and int(lost) == 0
                and sum(after) == PARITY_N and after[-1] > before[-1]
                and mean_x > 0.5):
            raise AssertionError(f"slab grid D={d}: {res}")
        out[d]["grid_parity_scene"] = res
    return out


def bench_phase(dev, card):
    """The harness: the CLI's ``bench --config 1`` and ``--config 4``
    (their JSON lines parsed, ms_per_step finite), ``bench_sharded`` in
    both modes on ``[cuda:0] * 2``, and the step-for-step CPU-vs-card
    divergence of the grid step (printed per step)."""
    import contextlib
    import io
    import math

    from tpufluid_torch import bench, cli

    out = {}
    for config in (1, 4):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--config", str(config)])
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.strip()]
        if rc != 0 or len(recs) != 1:
            raise AssertionError(f"bench --config {config}: rc {rc}, {recs}")
        (key, rec), = recs[0].items()
        finite = [math.isfinite(rec["ms_per_step"])]
        if config == 4:
            finite.append(math.isfinite(rec["batch8x128k_ms_per_step"]))
        log(f"CLI bench --config {config} (wall {wall:.1f} s): {key} "
            f"{json.dumps(rec)}")
        if not all(finite) or rec["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"bench --config {config}: {rec}")
        out[key] = rec
    for mode in ("resident", "dense"):
        rec = bench.bench_sharded(mode, iters=3, devices=[dev] * 2)
        log(f"bench_sharded({mode!r}, [cuda:0] * 2): {json.dumps(rec)}")
        if not math.isfinite(rec["ms_per_step"]):
            raise AssertionError(f"bench_sharded {mode}: {rec}")
        out[f"sharded_{mode}"] = rec
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        x = bench.run_cross_backend_parity()
    log(f"CPU vs card, grid step, {x['steps']} synced steps of {x['n']}: "
        f"max |dpos| {x['max_step_dpos']:.3g}, |dvel| "
        f"{x['max_step_dvel']:.3g}, |drho| {x['max_step_drho']:.3g}, "
        f"bitwise {x['bitwise']}; per step (dpos, dvel, drho): " + ", ".join(
            f"({r['position']:.2g}, {r['velocity']:.2g}, {r['density']:.2g})"
            for r in x["per_step"]))
    if not all(math.isfinite(v) for v in (x["max_step_dpos"],
                                          x["max_step_dvel"],
                                          x["max_step_drho"])):
        raise AssertionError(f"cross-backend parity: {x}")
    out["cpu_vs_cuda"] = {k: v for k, v in x.items() if k != "per_step"}
    return out


GRID_FIELDS = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")
# config 5's band loses 65 particles in its first 3 steps, as the JAX
# package's band does (tests/test_torch_config5.py): the lattice overhangs
# the band's height, the init clamps the overhang into the edge rows, and
# their cells pass K=8 in the third step
BAND_LOST_3 = 65


def config5_gates(spec, band, dev):
    """Phase 26's kernels at the shapes its path gives them, bitwise their
    plain versions: each resident kernel on the band's [132, 8, 1024] grid
    from a seeded state (far movers, coincident pairs); 3 band steps of
    ``make_grid_multi_step`` against 3 plain steps from the band's init
    state, losing JAX's count (``BAND_LOST_3``); one step of the sharded
    resident step on 8 shards of scene_4m (grids [135, 8, 1024]) against
    its plain version, nothing lost. Returns the kernels' max_abs_err."""
    from tpufluid_torch.ops import resident
    from tpufluid_torch.parallel import (
        init_sharded_resident, make_plain_sharded_resident_step,
        make_resident_mesh, make_sharded_resident_step, unshard_grid_state)

    torch.use_deterministic_algorithms(True)
    try:
        errs, _ = compare_kernels(band.settings, band.params,
                                  "config5 band [132, 8, 1024]")
        gs = resident.init_grid_state(band.settings, dev)
        got = resident.make_grid_multi_step(band.settings, 3)(gs, band.params)
        pstep = resident.make_plain_grid_step(band.settings)
        want = gs
        for _ in range(3):
            want = pstep(want, band.params)
        for f in GRID_FIELDS:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"config5 band 3 steps: {f}: kernels "
                                     f"!= plain")
        if int(want.lost) != BAND_LOST_3:
            raise AssertionError(f"config5 band: lost {int(want.lost)} in 3 "
                                 f"steps, JAX's band {BAND_LOST_3}")
        mesh = make_resident_mesh(spec, [dev] * spec.n_devices)
        sgs = init_sharded_resident(spec, mesh)
        k, kst = make_sharded_resident_step(spec, mesh)(sgs, band.params)
        p, pst = make_plain_sharded_resident_step(spec, mesh)(sgs,
                                                              band.params)
        kg, pg = unshard_grid_state(k), unshard_grid_state(p)
        for f in GRID_FIELDS:
            if not torch.equal(getattr(kg, f), getattr(pg, f)):
                raise AssertionError(f"scene_4m D=8 step: {f}: kernels != "
                                     f"plain")
        n = spec.settings.particle_count
        if not (torch.equal(kst["n_valid"], pst["n_valid"])
                and int(pst["n_valid"].sum()) == n and int(pg.lost) == 0):
            raise AssertionError(f"scene_4m D=8 step: n_valid "
                                 f"{kst['n_valid'].tolist()} / "
                                 f"{pst['n_valid'].tolist()}, lost "
                                 f"{int(pg.lost)}")
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"config5: 3 band steps (lost {BAND_LOST_3}, as JAX's band) and "
        f"scene_4m's 8-shard step (grid {tuple(kg.pos_x.shape)} gathered, "
        f"{n} live, none lost) bitwise their plain versions")
    return {name: e["max_abs_err"] for name, e in errs.items()}


def config5_phase(card):
    """Config 5's derived estimate through the harness
    (``bench.config5_model`` on the card). First its kernels at its own
    shapes against their plain versions (``config5_gates``); then the
    counts are reset just before the model: the band's 120 timed and warm
    steps and the audited 8-shard step at scene_4m launch the resident
    step's three kernels. Holds the audited bytes to the formula
    (397,320), the band's rows and halo factor, every time finite and
    positive, the card's name; then a torch.profiler reading of 20 band
    steps, for the device's share of the band's ms/step, and the band's
    losses over its 30 steps (logged)."""
    import contextlib
    import io
    import math

    from tpufluid_torch import bench
    from tpufluid_torch.ops import resident
    from tpufluid_torch.parallel import comm_audit

    dev = torch.device("cuda")
    spec, band = bench.config5_band(dev)
    t0 = time.perf_counter()
    gate_errs = config5_gates(spec, band, dev)
    gate_wall = time.perf_counter() - t0
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rec = bench.config5_model()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    lines = [line for line in buf.getvalue().splitlines() if line.strip()]
    formula = comm_audit.resident_comm_formula(spec)["bytes_per_dir"]
    log(f"config5_model (wall {wall:.1f} s; {card}): {json.dumps(rec)}; "
        f"launches {launches}")
    times = ("measured_band_ms_per_step", "modeled_comm_ms_per_step",
             "est_ms_per_step", "est_particle_steps_per_sec")
    # the band's 2 warm + 10 timed bursts of 10, and one step of 8 shards
    path = dict.fromkeys(("rebin", "density", "forces_integrate"), 128)
    if not (len(lines) == 1 and json.loads(lines[0]) == json.loads(
                json.dumps(rec, default=float))
            and rec["measured_comm_bytes"] == formula == 397_320
            and rec["band_rows"] == 131
            and rec["halo_factor"] == round(135 / 131, 4)
            and all(math.isfinite(rec[k]) and rec[k] > 0 for k in times)
            and rec["device"] == torch.cuda.get_device_name(0)
            and all(launches[k] == v for k, v in path.items())):
        raise AssertionError(f"config5_model: {rec}, launches {launches}, "
                             f"printed {lines}")
    run = resident.make_grid_multi_step(band.settings, 10)
    state = [run(resident.init_grid_state(band.settings, band.params.device),
                 band.params)]

    def one_step():
        state[0] = run.step(state[0], band.params)

    prof = profile_steps(None, 20, "config5 band [132, 8, 1024]",
                         step=one_step)
    band_lost = int(state[0].lost)
    log(f"config5 band: lost {band_lost} of {band.settings.particle_count} "
        f"in 30 steps")
    # the graphed sharded step at scene_4m on 8 shards of the card: a
    # shard's share of its ms/step against the band's (what the estimate
    # leaves out: the step's merges, packets and copies)
    from tpufluid_torch.parallel import (
        init_sharded_resident, make_resident_mesh, make_sharded_resident_step)
    mesh8 = make_resident_mesh(spec, [dev] * spec.n_devices)
    step8 = make_sharded_resident_step(spec, mesh8)
    held = [init_sharded_resident(spec, mesh8)]
    for _ in range(2):
        held[0] = step8(held[0], band.params)[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        held[0] = step8(held[0], band.params)[0]
    end.record()
    torch.cuda.synchronize()
    ms8 = start.elapsed_time(end) / 10

    def one_sharded():
        held[0] = step8(held[0], band.params)[0]

    prof8 = profile_steps(None, 4, "scene_4m graphed sharded step, 8 shards "
                          "of one card", step=one_sharded)
    sharded8 = dict(ms_per_step=ms8, ms_per_shard=ms8 / spec.n_devices,
                    graphed=step8.graphed, profile=prof8,
                    capture=last_capture("the row-band sharded step, D=8 "))
    log(f"scene_4m graphed sharded step on 8 shards of one card: {ms8:.4f} "
        f"ms/step (CUDA events over 10), {ms8 / spec.n_devices:.4f} a shard "
        f"against the band's {rec['measured_band_ms_per_step']:.4f} and "
        f"est_ms_per_step {rec['est_ms_per_step']:.4f} ({card_line()})")
    if prof is not None:
        busy = prof["busy_ms_per_step"]
        log(f"config5 band: device busy {busy:.4f} ms/step of the measured "
            f"{rec['measured_band_ms_per_step']:.4f}; busy x halo factor is "
            f"{busy * rec['halo_factor'] / rec['est_ms_per_step']:.3f} of "
            f"est_ms_per_step")
    return dict(rec, launches={k: launches[k] for k in path},
                band_profile=prof, band_lost_30=band_lost, wall_s=wall,
                sharded_8=sharded8,
                gate_wall_s=gate_wall,
                gate_max_abs_err=gate_errs)


# ------------------------------------------ the bursts as graphs (27)

def far_bytes(gs, n_far: int, k: int) -> int:
    """Bytes the far-mover pass must move: the rebin's per-row counts (the
    gate); with movers, the four fields of the pre-rebin grid below each
    row's occupancy (to find them), each mover's target cell's K slots of
    the post-rebin pos_x (its occupancy) and its four fields written."""
    gy = gs.pos_x.shape[0]
    if n_far == 0:
        return 4 * gy
    return (4 * gy + resident_bytes(gs.pos_x, gs.occ_row, 4, 0)
            + n_far * (4 * k + 16))


def far_case(gs, settings, params, label, timed=False, **step_kw):
    """csrc/far_reinsert.cu against its plain version (``_reinsert_far``,
    run whatever the count) on the kernel rebin's outputs of ``gs``:
    grids, occ_row and lost bitwise, the far-step counter 1 when there are
    movers, and with none the rebin's outputs untouched. ``step_kw``:
    make_grid_step's (far_capacity, x_boundary, n_worlds). Timed: the
    kernel by repeated calls on one copy of the rebin's grids (a call with
    movers inserts them again, the same work), the plain version on the
    same inputs."""
    from tpufluid_torch.ops import fused, resident

    dev = gs.pos_x.device
    step = resident.make_grid_step(settings, **step_kw)
    cap = step.far_capacity
    _, row_shift = step._world_tables(dev)
    rb = fused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row,
                     params.delta, step.settings, row_shift=row_shift)
    far_n = rb[5]
    n_far = int(far_n.sum())
    lost0 = gs.lost + rb[6].sum().to(torch.int32)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    got = resident.far_reinsert(gs, *(t.clone() for t in rb[:5]), far_n,
                                lost0.clone(), params.delta, step.settings,
                                cap, counter)
    *want, dropped = resident._reinsert_far(
        gs, *rb[:4], far_n.sum(), params.delta, step.settings, cap)
    bitwise(got, (*want, lost0 + dropped), f"{label} far_reinsert")
    if int(counter) != (n_far > 0):
        raise AssertionError(f"{label} far_reinsert: far-step counter "
                             f"{int(counter)} with {n_far} movers")
    if n_far == 0:
        bitwise(got[:5], rb[:5], f"{label} far_reinsert, no mover")
    res = dict(grid=list(gs.pos_x.shape), n_far=n_far, far_capacity=cap,
               dropped=int(dropped), max_abs_err=0.0)
    log(f"{label} far_reinsert {tuple(gs.pos_x.shape)}: bitwise equal to "
        f"plain ({n_far} far movers, capacity {cap}, {res['dropped']} "
        f"dropped)")
    if timed:
        grids = [t.clone() for t in rb[:5]]
        lost = lost0.clone()
        kern = lambda: resident.far_reinsert(
            gs, *grids, far_n, lost, params.delta, step.settings, cap,
            counter)
        plain = lambda: resident._reinsert_far(
            gs, *rb[:4], far_n.sum(), params.delta, step.settings, cap)
        res["ms"], res["plain_ms"], raw = timed_pair(kern, plain)
        res["bound_ms"], res["bound_by"] = bound(
            far_bytes(gs, n_far, step.settings.cell_capacity), 0)
        res["library_ms"] = None
        log(f"{label} far_reinsert: kernel {res['ms']:.4f} ms ({raw[0]:.4f},"
            f" {raw[1]:.4f}), plain {res['plain_ms']:.3f} ms ({raw[2]:.3f}, "
            f"{raw[3]:.3f}), bound {res['bound_ms']:.6f} ms "
            f"({res['bound_by']})")
    return res


def far_gates(s8, params, dev):
    """Phase 27's far-mover kernel cases: scene_1m's seeded state (256 far
    movers; timed), the lattice at rest (none; timed), the seeded state
    over a capacity of 100, the wall movers after one wrap step (timed),
    and config 4's stack [544, 8, 512] with movers in every world."""
    import tpufluid_torch as tt
    from tpufluid_torch.ops import resident

    seeded = resident.from_particles(seeded_state(s8, dev), s8)
    out = {"seeded": far_case(seeded, s8, params, "scene_1m K=8 seeded",
                              timed=True)}
    out["none"] = far_case(resident.init_grid_state(s8, dev), s8, params,
                           "scene_1m K=8 lattice", timed=True)
    if out["none"]["n_far"] != 0 or out["seeded"]["n_far"] < 200:
        raise AssertionError(f"far movers: {out}")
    out["over"] = far_case(seeded, s8, params, "scene_1m K=8 seeded",
                           far_capacity=100)
    if out["over"]["dropped"] < out["over"]["n_far"] - 100:
        raise AssertionError(f"over capacity: {out['over']}")
    vkw = dict(x_boundary="wrap")
    wst, _ = wall_state(s8, dev)
    wgs = resident.make_grid_step(s8, **vkw)(
        resident.from_particles(wst, s8), params)
    out["wrap"] = far_case(wgs, s8, params, "scene_1m K=8 wall movers, "
                           "wrapped", timed=True, **vkw)
    if out["wrap"]["n_far"] < 1000:
        raise AssertionError(f"wrap: {out['wrap']}")
    bs, plist = config4(dev)
    bgs = resident.init_batched_grid_state(bs, CONFIG4_WORLDS, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    live = bgs.pos_x < 5e8
    fling = live & (torch.rand(live.shape, generator=g, device=dev) < 2e-3)
    kick = (torch.rand(live.shape, generator=g, device=dev) - 0.5) * 600.0
    bgs = dataclasses.replace(
        bgs, vel_x=torch.where(fling, kick, bgs.vel_x),
        vel_y=torch.where(fling, kick.flip(2), bgs.vel_y))
    out["config4"] = far_case(bgs, bs, resident.batched_params(plist),
                              "config 4", n_worlds=CONFIG4_WORLDS)
    if out["config4"]["n_far"] < 100:
        raise AssertionError(f"config 4: {out['config4']}")
    return out


def burst_times(graphed, eager, args, n_steps: int):
    """ms/step of a graphed and an eager burst (CUDA events from the
    first enqueue to the burst's end, synchronised; in turns eager,
    graphed, graphed, eager; means of each pair)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def one(fn):
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n_steps

    e1, g1, g2, e2 = one(eager), one(graphed), one(graphed), one(eager)
    return (g1 + g2) / 2, (e1 + e2) / 2, [e1, g1, g2, e2]


def graph_case(label, graphed, eager, args, fields, n_steps: int):
    """A graphed burst against its eager burst from the same inputs,
    bitwise on every field, then both timed; the capture's seconds and
    node count (the step's graph, captured here or by an earlier phase)."""
    from tpufluid_torch import graphs

    n0 = len(graphs.CAPTURES)
    got = graphed(*args)
    want = eager(*args)
    for f in fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{label}: graphed burst {f} != eager")
    cap = graphs.CAPTURES[-1] if len(graphs.CAPTURES) > n0 else None
    g_ms, e_ms, raw = burst_times(graphed, eager, args, n_steps)
    res = dict(graphed_ms_per_step=g_ms, eager_ms_per_step=e_ms,
               readings=raw, capture=cap, steps=n_steps)
    log(f"{label}: graphed burst of {n_steps} bitwise its eager burst; "
        f"graphed {g_ms:.4f} ms/step, eager {e_ms:.4f} ms/step (e g g e "
        + ", ".join(f"{r:.4f}" for r in raw) + ")"
        + ("" if cap is None else f"; {capture_text(cap)}"))
    return res, got


def graph_gates(s8, params, dev, card):
    """Phase 27's graphed bursts, each bitwise its eager burst and timed:
    the resident step (64 steps at scene_1m from the seeded state; the
    wrap + surface tension + adaptive variant from the wall movers;
    config 4's stack; obstacles, 16 steps under one field and 16 under a
    swapped one), one resident burst replayed under
    ``torch.cuda.set_sync_debug_mode("error")`` with its launches counted,
    and the grid, dense and pallas engines' bursts (4 steps) on the CLI's
    default scene."""
    import tpufluid_torch as tt
    from tpufluid_torch import cli, graphs
    from tpufluid_torch import step as steps
    from tpufluid_torch._build import LAUNCHES
    from tpufluid_torch.ops import forcefield, resident

    grid_fields = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick",
                   "lost")
    out = {}
    seeded = resident.from_particles(seeded_state(s8, dev), s8)
    run64 = resident.make_grid_multi_step(s8, 64)
    eager64 = resident.make_eager_grid_multi_step(s8, 64)
    out["resident"], _ = graph_case("scene_1m resident", run64, eager64,
                                    (seeded, params), grid_fields, 64)
    # replays with no host sync; the launches of the burst
    want = eager64(seeded, params)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run64(seeded, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    far = LAUNCHES["far_reinsert"]
    for f in grid_fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"burst under sync debug: {f} != eager")
    if counts != dict.fromkeys(("rebin", "density", "forces_integrate"),
                               64) or far != 64:
        raise AssertionError(f"graphed burst launches {counts}, "
                             f"far_reinsert {far}")
    log(f"scene_1m resident burst of 64 replayed under sync debug mode "
        f"'error': no sync, bitwise; launches {counts}, far_reinsert {far}")
    out["resident"]["launches"] = dict(counts, far_reinsert=far)

    vkw = dict(x_boundary="wrap", surface_tension=True,
               adaptive_subsampling=True)
    p_st = tt.TickParams.default(dev, **ST_PARAMS)
    wst, _ = wall_state(s8, dev)
    out["wrap"], _ = graph_case(
        "scene_1m resident wrap + surface tension + adaptive",
        resident.make_grid_multi_step(s8, 64, **vkw),
        resident.make_eager_grid_multi_step(s8, 64, **vkw),
        (resident.from_particles(wst, s8), p_st), grid_fields, 64)

    bs, plist = config4(dev)
    out["config4"], _ = graph_case(
        "config 4 [544, 8, 512]",
        resident.make_grid_multi_step(bs, 64, n_worlds=CONFIG4_WORLDS),
        resident.make_eager_grid_multi_step(bs, 64,
                                            n_worlds=CONFIG4_WORLDS),
        (resident.init_batched_grid_state(bs, CONFIG4_WORLDS, dev),
         resident.batched_params(plist)), grid_fields, 64)

    shifted = [(kind, (c[0] + 8.0, c[1] - 5.0), *rest)
               for kind, c, *rest in OBSTACLES_1M]
    fields = [forcefield.obstacle_force_field(
        forcefield.Objects.from_list(o, dev), s8)
        for o in (OBSTACLES_1M, shifted)]
    run16 = resident.make_grid_multi_step(s8, 16, has_force_field=True)
    eager16 = resident.make_eager_grid_multi_step(s8, 16,
                                                  has_force_field=True)
    gs = seeded
    for i, fld in enumerate(fields):
        res, gs = graph_case(f"scene_1m resident, obstacles, field {i}",
                             run16, eager16, (gs, params, fld), grid_fields,
                             16)
        out[f"obstacles_{i}"] = res

    for mode in ("grid", "dense", "pallas"):
        app = cli.build_app(cli.parser().parse_args(
            ["run", "--device", "cuda", "--neighbor-mode", mode]))
        out[mode], _ = graph_case(
            f"CLI default scene (100k, K={app.settings.cell_capacity}) "
            f"{mode}", steps.make_multi_step(app.settings, 4,
                                             neighbor_mode=mode),
            steps.make_eager_multi_step(app.settings, 4, neighbor_mode=mode),
            (app.state, app.params),
            ("position", "predicted", "velocity", "density", "cell", "tick"),
            4)
    # every capture of the run so far (phases 3-27), by step
    caps = {}
    for c in graphs.CAPTURES:
        caps.setdefault(c["what"], []).append(c)
    out["captures"] = {
        w: dict(count=len(cs), nodes=sorted({c["nodes"] for c in cs},
                                            key=str),
                capture_s=[min(c["capture_s"] for c in cs),
                           max(c["capture_s"] for c in cs)],
                instantiate_s=[min(c["instantiate_s"] for c in cs),
                               max(c["instantiate_s"] for c in cs)])
        for w, cs in caps.items()}
    for w, c in out["captures"].items():
        log(f"captured {c['count']}x: {w}: {c['nodes']} nodes, capture "
            f"{c['capture_s'][0]:.3f}-{c['capture_s'][1]:.3f} s, "
            f"instantiate {c['instantiate_s'][0]:.3f}-"
            f"{c['instantiate_s'][1]:.3f} s")
    return out


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
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    app.run(200)
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    far_launches = _build.LAUNCHES["far_reinsert"]
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
    if launches != {**dict.fromkeys(launches, 0), "rebin": 200,
                    "density": 200, "forces_integrate": 200}:
        raise AssertionError(f"kernel launches in the run: {launches}")
    if far_launches != 200:  # the far-mover pass: every step, gate or not
        raise AssertionError(f"far_reinsert launches in the run: "
                             f"{far_launches}")
    resident_prof = profile_steps(app, 20, "scene_1m resident")

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

    # 5. the metaball coarse kernel against its plain version: scene_1m at
    # K=8 and K=32, and phase 4's grid (high occupancy, large K)
    torch.use_deterministic_algorithms(True)
    coarse = {}
    for label, st, reps in (("scene_1m K=8", s8, 3), ("scene_1m K=32", s32, 2)):
        gs = resident.from_particles(seeded_state(st, dev), st)
        coarse[label] = compare_coarse(gs, st, label, reps)
    coarse["default scene"] = compare_coarse(
        app100.grid_state, app100.settings,
        f"default scene after 512 steps (K={app100.settings.cell_capacity})",
        1)
    gs192, s192 = app100.grid_state, app100.settings  # phase 15
    del app100

    # 6. the obstacle variant: forces_integrate with ff_cells at scene_1m,
    # then 20 synced obstacle steps
    from tpufluid_torch.ops import forcefield
    field = forcefield.obstacle_force_field(
        forcefield.Objects.from_list(OBSTACLES_1M, dev), s8)
    has_ff = compare_has_ff(s8, scene.params, field, "scene_1m K=8")
    synced_steps(s8, scene.params, 20, field)
    torch.use_deterministic_algorithms(False)
    del field

    # 7. the render path through the CLI (its own launch counts)
    render_res, render_launches = render_cli()

    # 8. the frame at full size on phase 3's scene_1m state
    frame = frame_breakdown(app, card)
    del app

    # 9. the dense engine's kernels against their plain versions: scene_1m
    # at K=8 (the main path's shapes) and K=32, surface tension at h = 1.5,
    # adaptive subsampling on a clump above density 200
    import tpufluid_torch as tt
    torch.use_deterministic_algorithms(True)
    sph_res, sph_calls, _ = compare_sph(seeded_state(s8, dev), s8,
                                        scene.params, "scene_1m K=8")
    sph32, sph32_calls, _ = compare_sph(seeded_state(s32, dev), s32,
                                        scene.params, "scene_1m K=32")
    s_st = tt.SimSettings(particle_count=65536, particle_spacing=0.75,
                          smoothing_radius=1.5, size=(200.0, 200.0),
                          cell_capacity=8)
    p_st = tt.TickParams.default(dev, surface_tension_threshold=0.05,
                                 surface_tension_coefficient=5.0)
    st9 = seeded_state(s_st, dev)
    st_res, st_calls, _ = compare_sph(st9, s_st, p_st, "h=1.5 65536",
                                      dict(surface_tension=True))
    s16 = dataclasses.replace(s8, cell_capacity=16)
    clump = clumped_state(s16, dev)
    ad_res, ad_calls, _ = compare_sph(clump, s16, scene.params,
                                      "scene_1m clump K=16",
                                      dict(adaptive_subsampling=True))
    # the dense engine's kernels where each flag acts
    dense_flags = {}
    for key, (st9_, s9, p9, label) in (
            ("surface_tension", (st9, s_st, p_st, "h=1.5 65536")),
            ("adaptive_subsampling", (clump, s16, scene.params,
                                      "scene_1m clump K=16"))):
        fres, _ = compare_dense(dense_grid_of(st9_, s9, p9), s9, p9,
                                f"{label} dense", {key: True})
        if fres["dense_forces"]["flag_changes_fx"] == 0:
            raise AssertionError(f"{label} dense: {key} changed no force")
        dense_flags[key] = fres["dense_forces"]
    del st9, clump

    # 10. synced pallas-mode steps, kernel step against plain step
    synced_pallas_steps(s8, scene.params, 20)
    torch.use_deterministic_algorithms(False)
    time_kernels(sph_calls, sph_res, "scene_1m K=8")
    time_kernels(sph32_calls, sph32, "scene_1m K=32")
    for label, calls, vres in (("h=1.5 65536 surface_tension", st_calls,
                                st_res),
                               ("scene_1m clump K=16 adaptive", ad_calls,
                                ad_res)):
        time_kernels({"sph_forces": calls["sph_forces"]}, vres, label)
    del sph_calls, sph32_calls, st_calls, ad_calls

    # 11. the slice's main path: FluidApp(scene_1m, pallas, cuda).run(200)
    warm = FluidApp(s8, scenes.scene_1m(dev).params, device=dev,
                    neighbor_mode="pallas")
    warm.run(20)
    torch.cuda.synchronize()
    del warm
    papp = FluidApp(s8, scene.params, device=dev, neighbor_mode="pallas")
    torch.cuda.synchronize()
    reset_counts()
    start.record()
    papp.run(200)
    end.record()
    torch.cuda.synchronize()
    p_launches = read_counts()
    ms_pallas = start.elapsed_time(end) / 200
    m = papp.metrics(deep=True)
    finite = bool(torch.isfinite(papp.state.position).all()
                  and torch.isfinite(papp.state.velocity).all())
    log(f"scene_1m FluidApp(pallas).run(200): tick {m['tick']}, K "
        f"{papp.settings.cell_capacity}, finite {finite}, NaN "
        f"{m['nan_positions']}, out of bounds {m['out_of_bounds']}, max "
        f"occupancy {m['max_cell_occupancy']} (capacity exceeded "
        f"{m['capacity_exceeded']}), launches {p_launches}")
    log(f"scene_1m pallas: {ms_pallas:.4f} ms/step, "
        f"{1e3 * s8.particle_count / ms_pallas:.4e} particle-steps/s (CUDA "
        f"events over 200 steps after a 20-step warm-up; {card})")
    if not (m["tick"] == 200 and finite and m["nan_positions"] == 0
            and not m["capacity_exceeded"]):
        raise AssertionError(f"scene_1m pallas run failed: {m}")
    if p_launches != {**dict.fromkeys(p_launches, 0), "sph_density": 200,
                      "sph_forces": 200, "dense_build": 200,
                      "dense_readback": 200}:
        raise AssertionError(f"pallas run launches: {p_launches}")
    pallas_prof = profile_steps(papp, 16, "scene_1m pallas")
    del papp
    if pallas_prof is not None:
        scans = [k for k in pallas_prof["top_ms_per_step"]
                 if "tensor_kernel_scan" in k]
        if scans:
            raise AssertionError(f"a scan among the pallas step's top "
                                 f"kernels: {scans}")
        log("scene_1m pallas profile: no torch.cummax scan among its top "
            "kernels")
    cli_pallas = cli_pallas_run(card)

    # 12. engine parity, and the CLI's default run (the dense engine)
    parity = engine_parity()
    cli_res, dense_res = cli_default_run(card)

    # 13. forces_integrate's variants at scene_1m, then the app with all
    # three
    variants = {}
    wst, n_edge = wall_state(s8, dev)
    log(f"scene_1m wall movers: {n_edge} particles at 0.05 from an x wall "
        f"moving out at 60")
    variants["wrap"] = compare_variant(
        resident.from_particles(wst, s8), s8, scene.params,
        dict(x_boundary="wrap"), "scene_1m K=8")
    if variants["wrap"]["wrapped"] < n_edge // 2:
        raise AssertionError(f"wrap: {variants['wrap']['wrapped']} wrapped")
    p_st = tt.TickParams.default(dev, **ST_PARAMS)
    variants["surface_tension"] = compare_variant(
        resident.from_particles(seeded_state(s8, dev), s8), s8, p_st,
        dict(surface_tension=True), "scene_1m K=8")
    st_acts = compare_variant(
        resident.from_particles(seeded_state(s_st, dev), s_st), s_st, p_st,
        dict(surface_tension=True), "h=1.5 65536", timed=False)
    if st_acts["changed"] < 1000:
        raise AssertionError(f"surface tension at h 1.5: {st_acts}")
    variants["adaptive"] = compare_variant(
        resident.from_particles(clumped_state(s16, dev), s16), s16,
        scene.params, dict(adaptive_subsampling=True), "scene_1m clump K=16")
    if not (variants["adaptive"]["rho_200"] > 0
            and variants["adaptive"]["rho_150_200"] > 0
            and variants["adaptive"]["changed"] > 0):
        raise AssertionError(f"adaptive: {variants['adaptive']}")
    vkw = dict(x_boundary="wrap", surface_tension=True,
               adaptive_subsampling=True)
    vapp = FluidApp(s8, tt.TickParams.default(dev, **ST_PARAMS), device=dev,
                    neighbor_mode="resident", **vkw)
    vapp.run(16)
    vstep = resident.make_grid_step(vapp.settings, **vkw)
    far0 = vstep.far_steps
    torch.cuda.synchronize()
    reset_counts()
    start.record()
    vapp.run(200)
    end.record()
    torch.cuda.synchronize()
    v_launches = read_counts()
    ms_variants = start.elapsed_time(end) / 200
    far_steps = vstep.far_steps - far0
    m = vapp.metrics()
    ps, live = resident.to_particles(vapp.grid_state, vapp.settings)
    finite = bool(torch.isfinite(ps.position[:int(live)]).all()
                  and torch.isfinite(ps.velocity[:int(live)]).all())
    log(f"scene_1m FluidApp(resident, wrap, surface tension, adaptive).run("
        f"200) after 16: tick {m['tick']}, lost {m['lost_particles']}, live "
        f"{int(live)}, finite {finite}, K {m['cell_capacity']}, far-mover "
        f"path in {far_steps} of 200 steps; {ms_variants:.4f} ms/step (CUDA "
        f"events; {card}); launches {v_launches}")
    if not (m["tick"] == 216 and finite
            and v_launches == {**dict.fromkeys(v_launches, 0),
                               **dict.fromkeys(
                                   ("rebin", "density", "forces_integrate",
                                    "forces_integrate_wrap",
                                    "forces_integrate_surface_tension",
                                    "forces_integrate_adaptive"), 200)}):
        raise AssertionError(f"variant run: {m}, launches {v_launches}")
    del vapp

    # 14. BASELINE config 4: eight 128k worlds in one row stack
    bs, plist = config4(dev)
    bp = resident.batched_params(plist)
    batched, c4_grids, c4_wid = compare_batched(bs, bp, dev)
    batched_vs_single(bs, plist, bp, dev, 10)
    c4_lost = loss_probe(bs, bp, dev)
    warm = resident.make_grid_multi_step(bs, 20, n_worlds=CONFIG4_WORLDS)
    brun = resident.make_grid_multi_step(bs, 200, n_worlds=CONFIG4_WORLDS)
    gsb = resident.init_batched_grid_state(bs, CONFIG4_WORLDS, dev)
    if tuple(gsb.pos_x.shape) != (544, 8, 512):
        raise AssertionError(f"config 4 stack {tuple(gsb.pos_x.shape)}")
    warm(gsb, bp)
    bfar0 = brun.step.far_steps
    torch.cuda.synchronize()
    reset_counts()
    start.record()
    gsb = brun(gsb, bp)
    end.record()
    torch.cuda.synchronize()
    b_launches = read_counts()
    ms_c4 = start.elapsed_time(end) / 200
    c4_stats = resident.batched_world_stats(gsb, bs, CONFIG4_WORLDS)
    c4_finite = bool(torch.isfinite(
        gsb.pos_x[gsb.pos_x < 5e8]).all())
    log(f"config 4 (8 x 131072, [544, 8, 512]): {ms_c4:.4f} ms/step, "
        f"{1e3 * CONFIG4_WORLDS * bs.particle_count / ms_c4:.4e} "
        f"particle-steps/s (CUDA events over 200 steps after a 20-step "
        f"warm-up; {card}); lost {int(gsb.lost)}, far-mover path in "
        f"{brun.step.far_steps - bfar0} steps, finite {c4_finite}; world "
        f"stats {c4_stats}; launches {b_launches}")
    if not (c4_finite and b_launches == {
            **dict.fromkeys(b_launches, 0), **dict.fromkeys(
                ("rebin", "rebin_row_shift", "density", "density_wid",
                 "forces_integrate", "forces_integrate_wid"), 200)}):
        raise AssertionError(f"config 4 run: launches {b_launches}")

    # 15. the fused physics kernel against the split pair
    from tpufluid_torch.ops import forcefield
    g8 = resident.from_particles(seeded_state(s8, dev), s8)
    grids8 = (*rebinned(g8, s8, scene.params), g8.tick + 1)
    compare_physics(grids8, s8, scene.params, "scene_1m K=8")
    g32 = resident.from_particles(seeded_state(s32, dev), s32)
    compare_physics((*rebinned(g32, s32, scene.params), g32.tick + 1), s32,
                    scene.params, "scene_1m K=32")
    compare_physics((gs192.pos_x, gs192.pos_y, gs192.vel_x, gs192.vel_y,
                     gs192.occ_row, gs192.tick + 1), s192,
                    tt.TickParams.default(dev, gravity=(0.0, -9.8)),
                    "default scene after 512 steps")
    field = forcefield.obstacle_force_field(
        forcefield.Objects.from_list(OBSTACLES_1M, dev), s8)
    compare_physics(grids8, s8, scene.params, "scene_1m K=8",
                    ff_cells=resident.forcefield_cells(field, s8))
    del field
    gcl = resident.from_particles(clumped_state(s16, dev), s16)
    compare_physics((*rebinned(gcl, s16, p_st), gcl.tick + 1), s16, p_st,
                    "scene_1m clump K=16", **vkw)
    compare_physics(c4_grids, bs, bp, "config 4", wid=c4_wid)
    # phase 18's grids: 41 rows (ragged for every tile height) with a row
    # at full occupancy, at K=8 and at the largest K the physics tile
    # takes (a 1 x 1 tile), and sparse at K=8 (halo rows of one slot)
    p_g = tt.TickParams.default(dev, gravity=(0.0, -9.8), **ST_PARAMS)
    # a multiple of 8, as the resident grid rounds K
    k_max = fused.physics_max_capacity() // 8 * 8
    for label, k, n_random, fill, kw in (
            ("full row", 8, 1500, True, {}),
            ("full row", 8, 1500, True, vkw),
            ("full row", k_max, 1500, True, {}),
            ("sparse", 8, 60, False, vkw)):
        sk, gk = small_state(dev, k, n_random, fill)
        compare_physics((gk.pos_x, gk.pos_y, gk.vel_x, gk.vel_y, gk.occ_row,
                         gk.tick + 1), sk, p_g, f"{label} K={k}", **kw)
    del gk
    physics_res = time_physics(grids8, s8, scene.params)
    ms_split1, l_split, end_split = resident_run(s8, scene.params, False,
                                                 200, dev)
    ms_fused1, l_fused, end_fused = resident_run(s8, scene.params, True,
                                                 200, dev)
    ms_fused2, _, _ = resident_run(s8, scene.params, True, 200, dev)
    ms_split2, _, _ = resident_run(s8, scene.params, False, 200, dev)
    for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "lost"):
        if not torch.equal(getattr(end_split, f), getattr(end_fused, f)):
            raise AssertionError(f"resident run: split and fused {f} differ")
    if not (l_fused == {**dict.fromkeys(l_fused, 0), "rebin": 200,
                        "physics": 200}
            and l_split["physics"] == 0 and l_split["density"] == 200):
        raise AssertionError(f"physics launches: split {l_split}, fused "
                             f"{l_fused}")
    resident_physics = dict(split_ms_per_step=(ms_split1 + ms_split2) / 2,
                            fused_ms_per_step=(ms_fused1 + ms_fused2) / 2,
                            readings=[ms_split1, ms_fused1, ms_fused2,
                                      ms_split2])
    log(f"scene_1m resident 200 steps from the lattice: split "
        f"{resident_physics['split_ms_per_step']:.4f} ms/step ({ms_split1:.4f},"
        f" {ms_split2:.4f}), fused physics "
        f"{resident_physics['fused_ms_per_step']:.4f} ({ms_fused1:.4f}, "
        f"{ms_fused2:.4f}); end states bitwise equal ({card})")

    # 16. the CLI with the resident engine's variant flags
    cli_variants = cli_variant_run()

    # 17. kernel 8: the round-1 rebin with a valid mask (no caller), on
    # scene_1m's seeded grid (valid_f 1 at the live slots, the empty ones
    # keeping their SENTINEL data as stale data; timed), the same mask
    # with holes, phase 4's K=192 grid and the edge grid. Its plain
    # version scatters each (y, x) into distinct slots (and a spare slot
    # it drops), so it needs no deterministic mode.
    g8 = resident.from_particles(seeded_state(s8, dev), s8)
    rv8 = (g8.pos_x, g8.pos_y, g8.vel_x, g8.vel_y,
           (g8.pos_x < 5e8).float())
    rebin_valid = compare_rebin_valid(rv8, s8, scene.params, "scene_1m K=8",
                                      timed=True)
    compare_rebin_valid(with_holes(rv8), s8, scene.params,
                        "scene_1m K=8 with holes")
    del g8, rv8
    compare_rebin_valid((gs192.pos_x, gs192.pos_y, gs192.vel_x, gs192.vel_y,
                         (gs192.pos_x < 5e8).float()), s192, scene.params,
                        "default scene after 512 steps", far=False)
    se, ge = valid_edge_grid(dev)
    compare_rebin_valid(ge, se, scene.params, "edge rows and columns")

    # 18. the tile kernels of density and forces at every tile shape; at
    # K=192 and 256 with many particles, where the plain versions take
    # seconds, "wid" (base flags, two worlds) stands in for "base"
    gates = [tile_gates("scene_1m", s8, grids8,
                        ["adaptive", "has_ff", "wid"])]
    gates.append(tile_gates("scene_1m clump", s16, (
        *rebinned(gcl, s16, p_st), gcl.tick + 1), ["base", "has_ff", "wid"]))
    g32 = resident.from_particles(seeded_state(s32, dev), s32)
    gates.append(tile_gates("scene_1m", s32, (
        *rebinned(g32, s32, scene.params), g32.tick + 1),
        ["base", "wrap", "surface_tension", "adaptive", "has_ff", "wid"]))
    del g32
    g192 = (gs192.pos_x, gs192.pos_y, gs192.vel_x, gs192.vel_y,
            gs192.occ_row, gs192.tick + 1)
    del gs192
    # the gates on the 64 rows from the densest one on (the plain forces
    # takes seconds a call on the whole grid); the tile depends on K only
    y0 = min(int(g192[4].argmax()), g192[0].shape[0] - 64)
    gates.append(tile_gates("default scene after 512 steps, 64 densest rows",
                            s192, (*(a[y0:y0 + 64].contiguous()
                                     for a in g192[:5]), g192[5]),
                            ["all", "wid"]))
    big_k = time_big_k(g192, s192,
                       tt.TickParams.default(dev, gravity=(0.0, -9.8)),
                       "default scene after 512 steps")
    del g192
    for label, k, n_random, fill in (("full row", 8, 1500, True),
                                     ("full row", 256, 1500, True),
                                     ("sparse", 8, 60, False),
                                     ("sparse", 192, 60, False)):
        sk, gk = small_state(dev, k, n_random, fill)
        gates.append(tile_gates(label, sk, (
            gk.pos_x, gk.pos_y, gk.vel_x, gk.vel_y, gk.occ_row, gk.tick + 1),
            ["all", "wid"] if k > 128 and fill else ["base", "all", "wid"]))
        if k > 128:  # supersample 8 on the full row, 1 on the sparse grid
            gates.append(coarse_gate(gk, sk, 8 if fill else 1,
                                     f"{label} K={k}"))

    gates += sph_tile_gates(dev)

    # 19. FluidApp.set_mouse: 16 resident ticks at scene_1m, mouse on
    mouse = mouse_run(dev, card)

    # 20. the chamfer field of a video frame, compiled against NumPy
    vframes, discs = video_frames()
    chamfer = chamfer_check(vframes, dev, card)

    # 21. render --video-field on the default scene
    video = video_render(vframes, discs, card)
    del vframes

    # 22. the NaN-provenance tools at scene_1m
    debug = debugging_check(s8, scene.params, dev, card)

    # 23. the row-band sharded step, D = 2 and 4 on one card: its far
    # kernels against their plain versions, then the step
    torch.use_deterministic_algorithms(True)
    band_far = band_far_gates(s8, scene.params, dev)
    torch.use_deterministic_algorithms(False)
    sharded = sharded_runs(s8, scene.params, shear_field(s8, dev), dev, card)

    # 24. the slab-sharded step, D = 2 and 4 on one card
    slab = slab_runs(s8, dev, card)

    # 25. the bench harness: the CLI's bench command, bench_sharded, and
    # the CPU-vs-card step divergence (run_parity ran in phase 12)
    bench_res = bench_phase(dev, card)

    # 26. config 5's derived 4M/8-card estimate (the audited 4M step on 8
    # shards of the card)
    config5 = config5_phase(card)

    # 27. the far-mover kernel against its plain version, and the graphed
    # bursts against their eager bursts
    torch.use_deterministic_algorithms(True)
    far = far_gates(s8, scene.params, dev)
    torch.use_deterministic_algorithms(False)
    bursts = graph_gates(s8, scene.params, dev, card)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name == "metaball_coarse":
            c8 = coarse["scene_1m K=8"]
            entry = dict(launches=render_launches[name], **{
                k: c8[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")},
                library_ms=None, k32=coarse["scene_1m K=32"],
                default_scene=coarse["default scene"])
        elif name == "rebin_valid":
            entry = dict(launches=launches[name], **rebin_valid)
        elif name == "far_reinsert":
            entry = dict(launches=far_launches, **{
                k: far["none"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")},
                cases=far, burst_launches=bursts["resident"]["launches"])
        elif name in ("far_collect", "far_insert"):
            half = name.split("_")[1]
            entry = dict(
                launches=round(32 * sharded["plain"][2]["launches_per_step"]
                               [name]), max_abs_err=0.0,
                **{k: band_far[2]["seeded"][half][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                sharded_path_launches={
                    f"D={d}": round(32 * sharded["plain"][d]
                                    ["launches_per_step"][name])
                    for d in (2, 4)},
                cases={f"D={d}": {c: {k: v for k, v in r.items()
                                      if k not in ("collect", "insert")}
                                  | ({half: r[half]} if half in r else {})
                                  for c, r in band_far[d].items()}
                       for d in (2, 4)})
        elif name == "physics":
            entry = dict(launches=l_fused["physics"],
                         split_path_launches=l_split["physics"],
                         tile=list(fused.physics_tile(8)), **physics_res)
        elif name.startswith("dense_"):
            entry = dict(launches=cli_res["launches"][name], **{
                k: dense_res[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "grid")}, library_ms=None)
            if name == "dense_forces":
                entry["surface_tension"] = dense_res[name]["surface_tension"]
                entry["adaptive"] = dense_res[name]["adaptive"]
                entry["flag_grids"] = dense_flags
            entry["sharded_path_launches"] = {
                f"D={d}": slab[d]["dense"]["launches"][name] for d in (2, 4)}
        elif name.startswith("sph_"):
            entry = dict(launches=p_launches[name],
                         resident_path_launches=launches[name],
                         render_path_launches=render_launches[name], **{
                             k: sph_res[name][k] for k in (
                                 "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")},
                         library_ms=None, k32=sph32[name],
                         cli_pallas=cli_pallas[name])
        else:
            entry = dict(launches=launches[name],
                         render_path_launches=render_launches[name], **{
                             k: res[name][k] for k in (
                                 "max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")},
                         library_ms=None, k32=res32[name])
        if name == "forces_integrate":
            entry["has_ff"] = dict(
                launches=render_launches["forces_integrate_has_ff"],
                **has_ff)
            for v, vres in variants.items():
                entry[v] = dict(launches=v_launches[f"forces_integrate_{v}"],
                                **vres)
        if name == "rebin":
            entry["k192"] = big_k[name]
            entry["tile"] = list(fused.rebin_tile(8))
        if name in ("density", "forces_integrate"):
            entry["k192"] = big_k[name]
            entry["tile"] = list(getattr(fused, {
                "density": "density_tile",
                "forces_integrate": "forces_tile"}[name])(8))
        if name in ("rebin", "density", "forces_integrate"):
            entry["sharded_path_launches"] = {
                f"D={d}": round(32 * sharded["plain"][d][
                    "launches_per_step"].get(name, 0)) for d in (2, 4)}
            key = {"rebin": "row_shift"}.get(name, "wid")
            entry[key] = dict(launches=b_launches[f"{name}_{key}"],
                              grid=[544, 8, 512], **batched[name])
        if name.startswith("sph_"):
            entry["sharded_path_launches"] = {
                f"D={d}": slab[d]["pallas"]["launches"][name]
                for d in (2, 4)}
            entry["slab_grids"] = {f"D={d}": slab[d]["grid"] for d in (2, 4)}
        if name == "sph_forces":
            entry["surface_tension"] = st_res[name]
            entry["adaptive"] = ad_res[name]
        entry["pallas_path_launches"] = p_launches.get(name, 0)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **entry))
    print(card)
    print(json.dumps({"kernels": kernels, "ms_per_step": ms_step,
                      "resident_profile": resident_prof,
                      "pallas_ms_per_step": ms_pallas,
                      "pallas_profile": pallas_prof,
                      "cli_pallas": cli_pallas, "render": render_res,
                      "frame": frame, "parity": parity,
                      "cli_default": cli_res,
                      "variants_ms_per_step": ms_variants,
                      "variants_far_steps": far_steps,
                      "config4": dict(ms_per_step=ms_c4, lost=int(gsb.lost),
                                      lost_at_step=c4_lost,
                                      world_stats=c4_stats),
                      "resident_physics": resident_physics,
                      "cli_variants": cli_variants, "tile_gates": gates,
                      "mouse": mouse, "chamfer": chamfer,
                      "video_render": video, "debugging": debug,
                      "sharded": {tag: {f"D={d}": r for d, r in row.items()}
                                  for tag, row in sharded.items()},
                      "slab": {f"D={d}": r for d, r in slab.items()},
                      "bench": bench_res, "config5_model": config5,
                      "bursts": bursts}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
