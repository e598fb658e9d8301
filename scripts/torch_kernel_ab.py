"""Time the resident engine's CUDA kernels of one checkout of the port.

    python scripts/torch_kernel_ab.py PATH/TO/CHECKOUT [PATH/TO/OTHER ...]

Each checkout runs in its own process (its own ``tpufluid_torch/_build``):
the script re-runs itself once per path and prints, per checkout, the
registers and spills ptxas reports for the resident kernels and the device
ms of rebin, density, forces_integrate (and physics, where the checkout
has it) at scene_1m, K=8, on the spawn lattice with seeded random
velocities: CUDA events around 50 calls behind a sleep kernel, twice. Give
the paths as parent, change, change, parent to compare two versions within
one call. Needs a CUDA device; imports no JAX.
"""

import dataclasses
import os
import subprocess
import sys


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
            if ("sph" not in name and "metaball" not in name
                    and ("ILb" not in name or "ILb0ELb0ELb0ELb0E" in name
                         or "forces_kernelILb0EE" in name)):
                regs = line.split("Used")[1].split(",")[0].strip()
                out.append((name[:40], regs, spill))
            name = None
    return out


def time_ms(fn, reps=50):
    import torch

    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bench(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from tpufluid_torch import _build
    from tpufluid_torch.models import scenes
    from tpufluid_torch.ops import fused, resident
    from tpufluid_torch.state import init_state

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    _build.load()
    for row in registers(_build.build_log()):
        print("  ", *row)
    scene = scenes.scene_1m(dev)
    s, p = scene.settings, scene.params
    st = init_state(s, "cpu")
    g = torch.Generator().manual_seed(1234)
    vel = torch.randn((s.particle_count, 2), generator=g) * 2.0
    st = dataclasses.replace(
        st, position=st.position.to(dev), predicted=st.predicted.to(dev),
        velocity=vel.to(dev), density=st.density.to(dev),
        cell=st.cell.to(dev), tick=st.tick.to(dev))
    gs = resident.from_particles(st, s)
    px, py, vx, vy, occ = fused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                                      gs.occ_row, p.delta, s)[:5]
    dargs = (px, py, vx, vy, occ, p.mass, p.delta, p.pressure_constant,
             p.rest_density, s)
    pres, invr = fused.density(*dargs)
    calls = {
        "rebin": lambda: fused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                                     gs.occ_row, p.delta, s),
        "density": lambda: fused.density(*dargs),
        "forces": lambda: fused.forces_integrate(
            px, py, vx, vy, pres, invr, occ, p, s, gs.tick + 1),
    }
    if hasattr(fused, "physics"):
        calls["physics"] = lambda: fused.physics(px, py, vx, vy, occ, p, s,
                                                 gs.tick + 1)
    res = {n: (time_ms(f), time_ms(f)) for n, f in calls.items()}
    print(root, torch.cuda.get_device_name(0),
          {n: f"{(x + y) / 2:.4f} ({x:.4f}, {y:.4f})"
           for n, (x, y) in res.items()})


def main() -> int:
    if os.environ.get("TORCH_KERNEL_AB_CHILD"):
        bench(os.path.abspath(sys.argv[1]))
        return 0
    env = dict(os.environ, TORCH_KERNEL_AB_CHILD="1")
    rc = 0
    for root in sys.argv[1:]:
        print(f"== {root}", flush=True)
        rc |= subprocess.run([sys.executable, __file__, root],
                             env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
