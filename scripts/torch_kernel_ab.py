"""Time the CUDA kernels of one checkout of the port.

    python scripts/torch_kernel_ab.py [--only PARTS] PATH/TO/CHECKOUT [...]

Each checkout runs in its own process (its own ``tpufluid_torch/_build``):
the script re-runs itself once per path and prints, per checkout, the
registers and spills ptxas reports for the resident kernels, the
metaball coarse kernel and the dense engine's sph kernels, then the device
ms (CUDA events around 50 calls behind a sleep kernel, twice; the mean and
both readings) of these parts (``--only``, comma-separated, picks some; all
by default):

* ``pair``: density and forces_integrate at scene_1m K=8 and K=32 (seeded
  state: the spawn lattice with random velocities, far movers and
  coincident pairs) and on the reference's default scene after 512 steps
  under gravity (100k particles; the capacity grows to K=192 there);
  forces_integrate with each variant at scene_1m: x wrap with movers
  across the walls, surface tension, adaptive subsampling on the clumped
  K=16 state, an obstacle field (has_ff); density and forces with wid on
  BASELINE config 4's stack of eight seeded worlds; and on the same four
  grids (K=8, K=32, the default scene's K=192, config 4 with wid) the
  fused physics kernel beside the split pair (density then
  forces_integrate, timed as one call);
* ``rebin_valid``: the round-1 rebin with a valid mask on scene_1m's
  seeded K=8 grid (valid_f at the live slots), the same mask with a tenth
  of its valid slots set to 0 (``chip_smoke.with_holes``), and on the
  default scene's K=192 grid;
* ``rebin``: rebin at scene_1m K=8 and K=32, with row_shift on config 4's
  stack, and on the default scene's K=192 grid;
* ``coarse``: the metaball coarse kernel at scene_1m K=8 and K=32 and on
  the default scene's K=192 grid;
* ``step``: the resident step, ``FluidApp(scene_1m,
  neighbor_mode="resident")``: ms/step over 200 steps of ``run`` five
  times after a 20-step warm-up (CUDA events; the median and each
  reading), the device's busy time per step over 20 more (torch.profiler,
  ``chip_smoke.profile_steps``), and the frame at 960x540 with its parts
  (``chip_smoke.frame_breakdown``: coarse kernel, resample, shading,
  ``render_frame``, and 16 ticks plus the render);
* ``sph``: the dense engine's sph_density and sph_forces on the slot grid
  of the pallas step (``chip_smoke.dense_grid_of``) at scene_1m K=8 and
  K=32 (seeded state), sph_forces with surface tension on the h = 1.5
  scene of 65,536 particles and with adaptive subsampling on the clumped
  K=16 state, each beside its bound (``chip_smoke.sph_bound``); and the
  pallas step, ``FluidApp(scene_1m, neighbor_mode="pallas")``: ms/step
  over 100 steps of ``run`` three times after a 20-step warm-up (CUDA
  events; the median and each reading) and the device's busy time per
  step over 16 more (torch.profiler) with its top kernels.

The states come from ``chip_smoke.py`` of the tree this script lies in, so
every checkout times the same inputs. Give the paths as parent, change,
change, parent to compare two versions within one call. The card's SM
clock and power draw are sampled every half second (``nvidia-smi``) while
each checkout runs, and their range is printed after its line. Needs a
CUDA device; imports no JAX.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def registers(log: str):
    """(kernel, registers, spill stores) of the resident kernels' base
    instantiations, from the build's ptxas output."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif "Used" in line and "registers" in line and name:
            if ("ILb" not in name or "ILb0ELb0ELb0ELb0E" in name
                    or "sph_forces_kernelILb0ELb0E" in name):
                regs = line.split("Used")[1].split(",")[0].strip()
                out.append((name[:40], regs, spill))
            name = None
    return out


PARTS = ("pair", "rebin_valid", "rebin", "coarse", "step", "sph")


def bench(root: str, parts) -> None:
    sys.path.insert(0, root)
    import torch

    # chip_smoke.py of this tree makes the states, whatever the checkout
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tpufluid_torch as tt
    from tpufluid_torch import _build, cli
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.models import scenes
    from tpufluid_torch.ops import forcefield, fused, render_coarse, resident

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    _build.load()
    for row in registers(_build.build_log()):
        print("  ", *row)
    scene = scenes.scene_1m(dev)
    s8, p = scene.settings, scene.params
    res = {}

    def timed(name, fn):
        a, b = cs.time_ms(fn, 50), cs.time_ms(fn, 50)
        res[name] = f"{(a + b) / 2:.4f} ({a:.4f}, {b:.4f})"

    def grids(gs, s, prm, **kw):
        px, py, vx, vy, occ = cs.rebinned(gs, s, prm, **kw)
        return px, py, vx, vy, occ, gs.tick + 1

    def pair(label, g, s, prm, **kw):
        """density and forces_integrate (with flags ``kw``) on grids g."""
        px, py, vx, vy, occ, fr = g
        wid = kw.get("wid")
        dargs = (px, py, vx, vy, occ, prm.mass, prm.delta,
                 prm.pressure_constant, prm.rest_density, s)
        pres, invr = fused.density(*dargs, wid=wid)
        if kw.pop("density", True):
            timed(f"{label} density", lambda: fused.density(*dargs, wid=wid))
        fargs = (px, py, vx, vy, pres, invr, occ, prm, s, fr)
        timed(f"{label} forces", lambda: fused.forces_integrate(*fargs, **kw))

    def physics(label, g, s, prm, **kw):
        """physics and the split pair it replaces on grids g."""
        px, py, vx, vy, occ, fr = g

        def split():
            pr, ir = fused.density(px, py, vx, vy, occ, prm.mass, prm.delta,
                                   prm.pressure_constant, prm.rest_density,
                                   s, **kw)
            fused.forces_integrate(px, py, vx, vy, pr, ir, occ, prm, s, fr,
                                   **kw)

        timed(f"{label} physics", lambda: fused.physics(
            px, py, vx, vy, occ, prm, s, fr, **kw))
        timed(f"{label} split pair", split)

    def rebin_valid(label, gs, s, prm, holes=False):
        from tpufluid_torch.ops import rebin as rv

        g = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
             (gs.pos_x < 5e8).float())
        if holes:
            g = cs.with_holes(g)
        timed(f"{label} rebin_valid", lambda: rv.rebin_valid(
            *g, prm.delta, s))

    def rebin(label, gs, s, prm, **kw):
        timed(f"{label} rebin", lambda: fused.rebin(
            gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, prm.delta, s,
            **kw))

    def coarse(label, gs, s):
        speed = torch.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
        timed(f"{label} metaball_coarse",
              lambda: render_coarse.coarse_metaball_fields(
                  gs.pos_x, gs.pos_y, speed, gs.occ_row, s, 2))

    s32 = dataclasses.replace(s8, cell_capacity=32)
    s16 = dataclasses.replace(s8, cell_capacity=16)
    gs8 = resident.from_particles(cs.seeded_state(s8, dev), s8)
    gs32 = resident.from_particles(cs.seeded_state(s32, dev), s32)
    g8 = grids(gs8, s8, p)
    if "pair" in parts:
        g32 = grids(gs32, s32, p)
        pair("K=8", g8, s8, p)
        pair("K=32", g32, s32, p)
        physics("K=8", g8, s8, p)
        physics("K=32", g32, s32, p)
        del g32
    if "rebin_valid" in parts:
        rebin_valid("K=8", gs8, s8, p)
        rebin_valid("K=8 with holes", gs8, s8, p, holes=True)
    if "rebin" in parts:
        rebin("K=8", gs8, s8, p)
        rebin("K=32", gs32, s32, p)
    if "coarse" in parts:
        coarse("K=8", gs8, s8)
        coarse("K=32", gs32, s32)
    if parts & {"pair", "rebin_valid", "rebin", "coarse"}:
        with contextlib.redirect_stdout(io.StringIO()):
            app = cli.run(cli.parser().parse_args([
                "run", "--device", "cuda", "--neighbor-mode", "resident",
                "--cell-capacity", "8", "--gravity", "0", "-9.8", "--steps",
                "512", "--report-every", "512"]))
        label = f"default scene K={app.settings.cell_capacity}"
        pg = tt.TickParams.default(dev, gravity=(0.0, -9.8))
        if "pair" in parts:
            g192 = grids(app.grid_state, app.settings, pg)
            pair(label, g192, app.settings, pg)
            physics(label, g192, app.settings, pg)
            del g192
        if "rebin_valid" in parts:
            rebin_valid(label, app.grid_state, app.settings, pg)
        if "rebin" in parts:
            rebin(label, app.grid_state, app.settings, pg)
        if "coarse" in parts:
            coarse(label, app.grid_state, app.settings)
        del app

    if "pair" in parts:
        wst, _ = cs.wall_state(s8, dev)
        pair("K=8 wrap", grids(resident.from_particles(wst, s8), s8, p), s8,
             p, density=False, x_boundary="wrap")
        p_st = tt.TickParams.default(dev, **cs.ST_PARAMS)
        pair("K=8 surface_tension", g8, s8, p_st, density=False,
             surface_tension=True)
        pair("K=16 clump adaptive",
             grids(resident.from_particles(cs.clumped_state(s16, dev), s16),
                   s16, p), s16, p, density=False, adaptive_subsampling=True)
        field = forcefield.obstacle_force_field(
            forcefield.Objects.from_list(cs.OBSTACLES_1M, dev), s8)
        pair("K=8 has_ff", g8, s8, p, density=False,
             ff_cells=resident.forcefield_cells(field, s8))
    if parts & {"pair", "rebin"}:
        bs, plist = cs.config4(dev)
        bp = resident.batched_params(plist)
        gsb = cs.stacked([resident.from_particles(
            cs.seeded_state(bs, dev, cs.SEED + w), bs)
            for w in range(cs.CONFIG4_WORLDS)])
        rows = resident._rows(bs)
        wid = torch.arange(cs.CONFIG4_WORLDS, dtype=torch.int32,
                           device=dev).repeat_interleave(rows)
        if "pair" in parts:
            gw = grids(gsb, bs, bp, row_shift=-(wid * rows))
            pair("config 4 wid", gw, bs, bp, wid=wid)
            physics("config 4 wid", gw, bs, bp, wid=wid)
            del gw
        if "rebin" in parts:
            rebin("config 4 row_shift", gsb, bs, bp,
                  row_shift=-(wid * rows))
    if "sph" in parts:
        sph_part(cs, res, timed, dev, s8, p)
    if "step" in parts:
        app = FluidApp(s8, p, device=dev, neighbor_mode="resident")
        app.run(20)
        steps = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            app.run(200)
            b.record()
            torch.cuda.synchronize()
            steps.append(a.elapsed_time(b) / 200)
        res["resident ms/step"] = (f"median {sorted(steps)[2]:.4f} ("
                                   + ", ".join(f"{x:.4f}" for x in steps)
                                   + ")")
        prof = cs.profile_steps(app, 20, "resident")
        if prof is not None:
            res["resident device busy ms/step"] = (
                f"{prof['busy_ms_per_step']:.4f} of "
                f"{prof['window_ms_per_step']:.4f}")
        frame = cs.frame_breakdown(app, cs.card_line())
        res["frame"] = {k: round(v, 4) for k, v in frame.items()}
    print(root, cs.card_line(), res, flush=True)


def sph_part(cs, res, timed, dev, s8, p) -> None:
    """The ``sph`` part (the module docstring)."""
    import torch
    import tpufluid_torch as tt
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.ops import sph

    def kernels(label, st, s, prm, flags, density=True):
        g = cs.dense_grid_of(st, s, prm)
        h, n = s.smoothing_radius, s.kernel_norms()
        rho = sph.density(g, prm.mass, h)
        d = torch.clamp(torch.clamp(rho, min=cs.EPSILON), min=0.1)
        fargs = (g, d, prm, h, s.sqr_radius, n.spiky_derivative,
                 n.viscosity, torch.tensor(9, device=dev))
        pairs = cs.sph_pairs(g, s)
        if density:
            timed(f"{label} sph_density", lambda: sph.density(g, prm.mass, h))
            res[f"{label} sph_density"] += (
                " bound %.4f (%s)" % cs.sph_bound("sph_density", g, pairs))
        timed(f"{label} sph_forces", lambda: sph.forces(*fargs, **flags))
        res[f"{label} sph_forces"] += (
            " bound %.4f (%s)" % cs.sph_bound("sph_forces", g, pairs))

    for k in (8, 32):
        s = dataclasses.replace(s8, cell_capacity=k)
        kernels(f"sph K={k}", cs.seeded_state(s, dev), s, p, {})
    s_st = tt.SimSettings(particle_count=65536, particle_spacing=0.75,
                          smoothing_radius=1.5, size=(200.0, 200.0),
                          cell_capacity=8)
    kernels("sph h=1.5 surface_tension", cs.seeded_state(s_st, dev), s_st,
            tt.TickParams.default(dev, **cs.ST_PARAMS),
            dict(surface_tension=True), density=False)
    s16 = dataclasses.replace(s8, cell_capacity=16)
    kernels("sph K=16 clump adaptive", cs.clumped_state(s16, dev), s16, p,
            dict(adaptive_subsampling=True), density=False)

    app = FluidApp(s8, p, device=dev, neighbor_mode="pallas")
    app.run(20)
    steps = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        app.run(100)
        b.record()
        torch.cuda.synchronize()
        steps.append(a.elapsed_time(b) / 100)
    res["pallas ms/step"] = (f"median {sorted(steps)[1]:.4f} ("
                             + ", ".join(f"{x:.4f}" for x in steps) + ")")
    prof = cs.profile_steps(app, 16, "pallas")
    if prof is not None:
        res["pallas device busy ms/step"] = (
            f"{prof['busy_ms_per_step']:.4f} of "
            f"{prof['window_ms_per_step']:.4f}; top "
            + ", ".join(f"{k} {v:.4f}"
                        for k, v in prof["top_ms_per_step"].items()))


def main() -> int:
    args = sys.argv[1:]
    parts = set(PARTS)
    if args[:1] == ["--only"]:
        parts = set(args[1].split(","))
        if not parts <= set(PARTS):
            raise SystemExit(f"--only takes some of {','.join(PARTS)}")
        args = args[2:]
    if os.environ.get("TORCH_KERNEL_AB_CHILD"):
        bench(os.path.abspath(args[0]), parts)
        return 0
    env = dict(os.environ, TORCH_KERNEL_AB_CHILD="1")
    rc = 0
    with ClockSampler() as clock:
        for root in args:
            print(f"== {root}", flush=True)
            n0 = len(clock.samples)
            rc |= subprocess.run([sys.executable, __file__, "--only",
                                  ",".join(sorted(parts)), root],
                                 env=env).returncode
            print(f"   clock during {root}: {clock.summary(n0)}", flush=True)
    return rc


class ClockSampler:
    """The card's SM clock (MHz) and power draw (W), sampled every half
    second by ``nvidia-smi`` in a process of its own, which ``__exit__``
    stops."""

    def __init__(self):
        self.samples = []
        self.proc = None

    def __enter__(self):
        import threading

        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self

        def read():
            for line in self.proc.stdout:
                try:
                    mhz, watts = (float(v) for v in line.split(","))
                except ValueError:
                    continue
                self.samples.append((mhz, watts))

        threading.Thread(target=read, daemon=True).start()
        return self

    def summary(self, start: int, load_watts: float = 150.0) -> str:
        """The samples since ``start``: the SM clock's range over all and
        over those drawing more than ``load_watts`` (the timed loops)."""
        got = self.samples[start:]
        if not got:
            return "not sampled"
        mhz = sorted(m for m, _ in got)
        busy = sorted(m for m, w in got if w > load_watts)
        load = (f"{busy[0]:.0f}-{busy[-1]:.0f} MHz in {len(busy)}"
                if busy else "none")
        return (f"SM clock {mhz[0]:.0f}-{mhz[-1]:.0f} MHz over {len(got)} "
                f"samples; above {load_watts:.0f} W: {load}; power "
                f"{min(w for _, w in got):.1f}-{max(w for _, w in got):.1f} W")

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait()
        return False


if __name__ == "__main__":
    sys.exit(main())
