"""Command line: ``python -m tpufluid_torch <run|render|info|bench>``.

The flags of ``python -m tpufluid``, plus ``--device`` (default ``cuda``).
Every engine runs (``--neighbor-mode``, default ``dense``) with every
variant flag, obstacles and video force fields (``--video-field``).
``bench --config N`` runs BASELINE config N (1-5; default all) of the
port's harness (``tpufluid_torch.bench``), one JSON line a config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _add_common(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--particles", type=int, default=100_000)
    p.add_argument("--spacing", type=float, default=0.1)
    p.add_argument("--radius", type=float, default=0.2,
                   help="smoothing radius h")
    p.add_argument("--size", type=float, nargs=2, default=(53.0, 53.0))
    p.add_argument("--cell-capacity", type=int, default=16)
    p.add_argument("--capacity-policy",
                   choices=("grow", "strict", "fixed"), default="grow",
                   help="grow = auto-size + regrow-and-replay, never loses "
                        "mass (default); strict = refuse undersized scenes; "
                        "fixed = keep the given capacity, count losses")
    p.add_argument("--no-strict-capacity", action="store_true",
                   help="deprecated alias for --capacity-policy fixed")
    p.add_argument("--texture-size", type=int, nargs=2, default=(1024, 1024),
                   help="obstacle force-field resolution (W H)")
    p.add_argument("--dt", type=float, default=1.0 / 120.0)
    p.add_argument("--gravity", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--pressure", type=float, default=50.0)
    p.add_argument("--rest-density", type=float, default=0.0)
    p.add_argument("--damping", type=float, default=0.1)
    p.add_argument("--viscosity", type=float, default=25.0)
    p.add_argument("--surface-tension", action="store_true")
    p.add_argument("--neighbor-mode",
                   choices=("resident", "grid", "dense", "pallas", "naive"),
                   default="dense",
                   help="engine: resident keeps the slot grid between "
                        "steps; grid/naive/dense/pallas rebuild their "
                        "neighbours every step (grid/naive in plain "
                        "PyTorch); dense runs its two roll passes as CUDA "
                        "kernels, pallas the TPU kernels' passes (their "
                        "plain versions on the CPU). Default dense")
    p.add_argument("--x-boundary", choices=("bounce", "wrap"),
                   default="bounce")
    p.add_argument("--adaptive-subsampling", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resume from (if it exists) and save to this .npz")
    p.add_argument("--circle", type=float, nargs=3, action="append",
                   default=[], metavar=("X", "Y", "R"),
                   help="add a circle obstacle (repeatable)")
    p.add_argument("--rect", type=float, nargs=5, action="append",
                   default=[], metavar=("X", "Y", "W", "H", "ROT"),
                   help="add a rotated rect obstacle (repeatable)")
    p.add_argument("--video-field", type=str, default=None,
                   help="grayscale frames (.npy/.npz or any ffmpeg input) "
                        "of the texture's size driving the obstacle force "
                        "field; dark = obstacle")


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return dev


def build_app(args):
    from .app import FluidApp
    from .ops.forcefield import Objects
    from .params import SimSettings, TickParams
    from .utils import io as ioutils

    device = _device(args.device)
    settings = SimSettings(
        particle_count=args.particles, particle_spacing=args.spacing,
        smoothing_radius=args.radius, size=tuple(args.size),
        cell_capacity=args.cell_capacity,
        texture_size=tuple(args.texture_size),
    )
    params = TickParams.default(
        device, delta=args.dt, gravity=tuple(args.gravity), mass=args.mass,
        pressure_constant=args.pressure, rest_density=args.rest_density,
        damping_factor=args.damping, viscosity_coefficient=args.viscosity,
    )
    objs = [("circle", (x, y), r) for x, y, r in args.circle]
    objs += [("rect", (x, y), (w, h), rot) for x, y, w, h, rot in args.rect]
    objects = Objects.from_list(objs, device) if objs else None
    policy = "fixed" if args.no_strict_capacity else args.capacity_policy
    app = FluidApp(settings, params, objects, capacity_policy=policy,
                   device=device, neighbor_mode=args.neighbor_mode,
                   x_boundary=args.x_boundary,
                   surface_tension=args.surface_tension,
                   adaptive_subsampling=args.adaptive_subsampling)
    if args.video_field:
        app.set_video_field(ioutils.load_gray_frames(args.video_field))
    if args.checkpoint and os.path.exists(args.checkpoint):
        app.load(args.checkpoint)
    return app


def run(args):
    """The ``run`` command: advance ``--steps`` ticks, printing rates.
    Returns the app."""
    from .utils.profiling import synchronize

    app = build_app(args)
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        chunk = min(args.report_every, args.steps - done)
        app.run(chunk)
        done += chunk
        if app.timer.last_rate:
            rate = app.timer.last_rate
            print(f"step {done}/{args.steps}  {rate:.1f} steps/s  "
                  f"{rate * app.settings.particle_count:.3e} particle-steps/s")
    synchronize(app.device)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.2f}s "
          f"({args.steps / dt:.1f} steps/s)")
    if args.checkpoint:
        app.save(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")
    return app


def render(args):
    """The ``render`` command: the offline render mode, 16 ticks per frame,
    to PNGs in ``--out`` and/or an mp4. Returns the app."""
    from .utils import io as ioutils

    app = build_app(args)
    t0 = time.perf_counter()

    def progress(i):
        elapsed = time.perf_counter() - t0
        eta = elapsed / (i + 1) * (args.frames - i - 1)
        print(f"saved frame {i + 1}/{args.frames}, elapsed {elapsed:.1f}s, "
              f"eta {eta:.1f}s")

    if args.mp4 and args.out is None:
        # no PNGs: frames stream straight into the encoder
        app.render_mp4(args.mp4, args.frames, args.width, args.height,
                       mode=args.mode, fps=args.fps, progress=progress)
        print(f"encoded {args.mp4}")
    else:
        out = args.out or "output"
        paths = app.render_sequence(out, args.frames, args.width,
                                    args.height, mode=args.mode,
                                    progress=progress)
        print(f"wrote {len(paths)} frames to {out}/")
        if args.mp4:
            ioutils.save_mp4(args.mp4, (ioutils.read_png(p) for p in paths),
                             fps=args.fps)
            print(f"encoded {args.mp4}")
    if args.checkpoint:
        app.save(args.checkpoint)
    return app


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpufluid_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run", help="advance the simulation N steps")
    _add_common(run_p)
    run_p.add_argument("--steps", type=int, default=1200)
    run_p.add_argument("--report-every", type=int, default=120)
    render_p = sub.add_parser("render", help="offline render mode")
    _add_common(render_p)
    render_p.add_argument("--frames", type=int, default=60)
    render_p.add_argument("--out", type=str, default=None,
                          help="PNG output dir (default 'output'; omitted "
                               "when --mp4 is given: frames stream straight "
                               "to the encoder)")
    render_p.add_argument("--width", type=int, default=960)
    render_p.add_argument("--height", type=int, default=540)
    render_p.add_argument("--mode",
                          choices=("metaball", "metaball_exact", "particles"),
                          default="metaball")
    render_p.add_argument("--mp4", type=str, default=None,
                          help="also encode the frames to this mp4 (needs "
                               "an ffmpeg binary)")
    render_p.add_argument("--fps", type=int, default=30)
    sub.add_parser("info", help="print torch / device info")
    bench_p = sub.add_parser("bench", help="run the benchmark ladder")
    bench_p.add_argument("--config", type=int, default=None,
                         choices=(1, 2, 3, 4, 5),
                         help="BASELINE config number (1-5); default: all")
    bench_p.add_argument("--device", type=str, default="cuda",
                         help="torch device to run on (default cuda)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.cmd == "info":
        cuda = torch.cuda.is_available()
        print(json.dumps(dict(
            torch=torch.__version__,
            cuda=torch.version.cuda,
            cuda_available=cuda,
            devices=[torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())] if cuda else [],
        ), indent=2))
        return 0
    if args.cmd == "bench":
        from .bench import run_configs

        run_configs(args.config, device=args.device)
        return 0
    (render if args.cmd == "render" else run)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
