"""The reference step's float32 predicted positions and its coincident
predicted pairs (CPU).

* A corner column under gravity: after its front hits the far wall, the
  float32 reference held to the float64 reference reads far past the
  ``vel_gap`` limit when the float64 step predicts in float64 (the step
  as it was, kept below as ``_old_step``), and at the quiet steps' level
  with both predicting in float32.
* Particles that land on a wall within a float32 rounding: the walls
  take them as the float32 step does.
* Particles on one predicted point: the port's resident step, handed the
  same state at the same tick, reads within the per-step bounds of the
  reference's upstream terms at r = 0 (the viscosity kernel's norm, the
  push along the drawn direction in the engine's visit order).
* Where the predicted positions are exact (zero velocities) and no two
  coincide, the step is bitwise the old one."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import inputs
from benchmark.reference import check, compare, sph
from benchmark.reference.sph import (DENSITY_FLOOR, EPSILON, MAX_SPEED,
                                     pairs_within)

HERE = Path(__file__).resolve().parents[1]
LIMITS = json.loads((HERE / "limits" / "sph1m-steps.json").read_text())
# the few-ulp per-step bounds of a float32 step (BASELINE.md, "Cross-backend
# determinism")
DPOS, DVEL = 4.8e-7, 3.8e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _physics(size, gravity=(0.0, -9.8)):
    ph = sph.physics(json.loads((HERE / "configs" / "sph-1m.json")
                                .read_text()))
    ph.update(gravity=gravity, size=size)
    return ph


def _old_step(pos, vel, ph, dtype=torch.float64):
    """``sph.step`` as it was: the predicted positions in ``dtype``, a
    coincident pair's terms evaluated at a distance of 1."""
    r = lambda x: x.to(dtype)
    pos, vel = r(pos), r(vel)
    dev = pos.device
    h, dt, m = ph["h"], ph["dt"], ph["mass"]
    half = r(torch.tensor(ph["size"], dtype=torch.float32, device=dev) * 0.5)
    pred = torch.maximum(torch.minimum(pos + vel * dt, half), -half)
    i, j = pairs_within(pred, h, ph["size"], with_self=True)
    d = pred[j] - pred[i]
    r2 = (d * d).sum(1)
    w = (h * h - r2).clamp(min=0) ** 3
    acc = torch.zeros(pos.shape[0], dtype=dtype, device=dev).index_add_(
        0, i, w)
    rho = m * (4.0 / (math.pi * h ** 8)) * acc
    rho = rho.clamp(min=EPSILON).clamp(min=DENSITY_FLOOR)
    pres = ph["k"] * (rho - ph["rho0"])
    other = i != j
    i, j, d, r2 = i[other], j[other], d[other], r2[other]
    dst = torch.sqrt(r2)
    safe = torch.where(dst == 0, torch.ones_like(dst), dst)
    spiky = -(h - dst) * (12.0 / (math.pi * h ** 4))
    fp = (spiky * (pres[i] + pres[j]) * 0.5 / rho[j] / safe)[:, None] * d
    kv = (-(r2 * safe) / (2.0 * h ** 3) + r2 / (h * h) + h / (2.0 * safe)
          - 1.0) * (15.0 / (2.0 * math.pi * h ** 3))
    fv = (kv / rho[j])[:, None] * (vel[j] - vel[i]) * ph["viscosity"]
    accel = torch.zeros_like(pos).index_add_(0, i, fp + fv)
    g = r(torch.tensor(ph["gravity"], dtype=torch.float64, device=dev))
    vel = vel + accel / rho[:, None] * dt + g * dt
    vel = torch.where(torch.isnan(vel).any(1, keepdim=True),
                      torch.zeros_like(vel), vel)
    speed = torch.sqrt((vel * vel).sum(1, keepdim=True))
    vel = torch.where(speed > MAX_SPEED, vel / speed * MAX_SPEED, vel)
    pos = pos + vel * dt
    out = pos.abs() > half
    pos = torch.where(out, half * torch.sign(pos), pos)
    vel = torch.where(out, vel * -ph["damping"], vel)
    return pos, vel


def test_a_corner_column_after_the_impact_reads_within_the_limit():
    """8,192 particles in 64 columns at the lower left corner of a 20 x 30
    box. Its front hits the right wall by step 150; steps 150-167 of the
    float32 reference are each held to the float64 reference."""
    ph = _physics((20.0, 30.0))
    pos = torch.from_numpy(inputs.lattice(8192, 0.1, 64))
    pos = pos - pos.min(0).values + torch.tensor([-9.95, -14.95])
    pos, vel = sph.run(pos, torch.zeros_like(pos), ph, 150, torch.float32)
    old = new = 0.0
    for t in range(150, 168):
        gaps = lambda f: compare.state_gaps(
            *f(pos, vel, ph, torch.float32), *f(pos, vel, ph), ph["h"],
            ph["size"])["vel_gap"]
        old = max(old, gaps(_old_step))
        new = max(new, gaps(lambda *a: sph.step(*a, tick=t)))
        pos, vel = sph.step(pos, vel, ph, torch.float32, t)
    # the old step read 296.7 (at step 162), 0.0682 at step 150
    assert old > LIMITS["vel_gap"]
    assert new <= 1e-3


def test_particles_landing_on_a_wall_bounce_as_in_float32():
    """40 particles 417 float32 ulps inside the right wall of the 1M dam
    break's box (half width 102.175), moving into it at 0.3-0.5 units/s:
    some land within a float32 rounding of the wall, bounce under the
    old float64 step and not under any float32 step."""
    ph = _physics((204.35, 208.3), gravity=(0.0, 0.0))
    half = float(torch.tensor(204.35, dtype=torch.float32) * 0.5)
    n = 40
    pos = torch.stack([torch.full((n,), half - 417 * 2.0 ** -17),
                       torch.arange(n) * 0.5 - 10.0], 1)
    vel = torch.stack([torch.linspace(0.3, 0.5, n), torch.zeros(n)], 1)

    def gap(f):
        return compare.state_gaps(*f(pos, vel, ph, torch.float32),
                                  *f(pos, vel, ph), ph["h"],
                                  ph["size"])["vel_gap"]

    # 1.1 times the speed of the one that bounces on one side only
    assert gap(_old_step) > LIMITS["vel_gap"]
    assert gap(sph.step) <= 1e-6


def _port_step(pos, vel, ph, tick):
    """The port's resident step (CPU, policy ``grow``) from (pos, vel) at
    ``tick``: the check's states before and after it."""
    from benchmark.run import check_state, held_state
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.params import SimSettings, TickParams
    from tpufluid_torch.state import ParticleState

    n = pos.shape[0]
    params = TickParams.default(
        "cpu", delta=ph["dt"], gravity=ph["gravity"], mass=ph["mass"],
        pressure_constant=ph["k"], rest_density=ph["rho0"],
        damping_factor=ph["damping"], viscosity_coefficient=ph["viscosity"])
    app = FluidApp(SimSettings(particle_count=n, smoothing_radius=ph["h"],
                               size=ph["size"], cell_capacity=32),
                   params, capacity_policy="grow", device="cpu",
                   neighbor_mode="resident")
    app.state = ParticleState(
        position=pos.clone(), predicted=pos.clone(), velocity=vel.clone(),
        density=torch.zeros(n), cell=torch.zeros(n, dtype=torch.int32),
        tick=torch.tensor(tick, dtype=torch.int64))
    before = check_state(held_state(app))
    app.run(1)
    return before, check_state(held_state(app))


# into the corner (-2, -2) of a 4 x 4 box from four cells, the fifth
# (-1.2, -1.9) a far mover: their predicted positions all clamp to it
CORNER = [((-1.95, -1.95), (-30.0, -30.0)), ((-1.97, -1.93), (-20.0, -40.0)),
          ((-1.75, -1.96), (-50.0, -20.0)), ((-1.93, -1.72), (-20.0, -50.0)),
          ((-1.2, -1.9), (-150.0, -30.0)), ((-1.99, -1.99), (-5.0, -5.0)),
          ((-1.85, -1.85), (-40.0, -40.0)), ((-1.62, -1.98), (-60.0, -10.0))]


@pytest.mark.parametrize("m", [2, 3, 8])
def test_a_coincident_group_is_the_ports(m):
    """``m`` particles on one predicted corner point amid 400 others, and
    three copies of one particle inside the box, against the port."""
    ph = _physics((4.0, 4.0))
    g = torch.Generator().manual_seed(m)
    pos = torch.cat([(torch.rand((400, 2), generator=g) - 0.5) * 3.0,
                     torch.tensor([p for p, _ in CORNER[:m]]),
                     torch.tensor([[0.3, 0.1]] * 3)])
    vel = torch.cat([(torch.rand((400, 2), generator=g) - 0.5) * 2.0,
                     torch.tensor([v for _, v in CORNER[:m]]),
                     torch.tensor([[0.5, 0.0]] * 3)])
    tick = 1000 + m
    before, after = _port_step(pos, vel, ph, tick)
    assert before[2] == tick
    _, count = torch.unique(sph.predict(before[0], before[1], ph), dim=0,
                            return_counts=True)
    assert sorted(count[count > 1].tolist()) == sorted([m, 3])

    def gaps(state):
        return compare.state_gaps(*after[:2], *check.reference_step(
            state, ph), ph["h"], ph["size"])

    g = gaps(before)
    assert g["pos_gap"] <= DPOS and g["vel_gap"] <= DVEL, g
    assert check.step_gaps([before, after], ph)["pred_tie_max"] == max(m, 3)
    # the drawn direction turns with the frame
    assert gaps((*before[:2], tick + 1, before[3]))["vel_gap"] > DVEL
    if m > 2:  # the members' order is the engine's, not the list's
        assert gaps((*before[:3], None))["vel_gap"] > DVEL


def test_the_viscosity_of_a_coincident_pair_is_its_norm():
    """Two particles driven into one corner, no pressure, no gravity: each
    moves by the viscosity kernel's norm over the density, times the
    difference of their velocities, then bounces off both walls."""
    ph = _physics((4.0, 4.0), gravity=(0.0, 0.0))
    ph["k"] = 0.0
    pos = torch.tensor([[-1.9, -1.9], [-1.95, -1.95]])
    vel = torch.tensor([[-30.0, -30.0], [-20.0, -20.0]])
    got_pos, got_vel = sph.step(pos, vel, ph)
    h, dt = ph["h"], ph["dt"]
    rho = ph["mass"] * 4.0 / (math.pi * h ** 8) * 2 * h ** 6
    norm = 15.0 / (2.0 * math.pi * h ** 3)
    v = vel.double()
    dv = norm / rho * (v.flip(0) - v) * ph["viscosity"] / rho * dt
    assert torch.equal(got_pos, torch.full((2, 2), -2.0, dtype=torch.float64))
    assert torch.allclose(got_vel, (v + dv) * -ph["damping"], rtol=1e-12,
                          atol=0)


@pytest.mark.parametrize("gravity", [(0.0, 0.0), (0.0, -9.8)])
def test_exact_predicted_positions_step_as_before(gravity):
    """A jittered lattice at rest: the predicted positions are the
    positions, so the step is bitwise the old one."""
    cfg = json.loads((HERE / "configs" / "sph-1m.json").read_text())
    cfg["domain"].update(particle_count=1024, spawn_columns=32,
                         size=[4.35, 4.35])
    ph = _physics((4.35, 4.35), gravity)
    pos, vel = inputs.jittered(cfg, 2**31 + 5, "cpu")
    assert torch.equal(sph.predict(pos, vel, ph), pos)
    assert torch.unique(pos, dim=0).shape[0] == pos.shape[0]
    for dtype in (torch.float64, torch.float32):
        new, old = sph.step(pos, vel, ph, dtype), _old_step(pos, vel, ph,
                                                             dtype)
        assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
