"""The pairing of ``compare.state_gaps`` (CPU, seconds): particles that sit
at one point are paired one to one by velocity; every other pairing reads
bitwise as the nearest-partner pairing it replaced (kept below as
``_old_state_gaps``), in any order of either side's particles.

The states are a 4,096-particle lattice dropped into a 16 x 16 box under
gravity (``models/scenes.py:dam_break_4k``, the upstream physics): by step
200 the walls have clamped two or three particles into each lower corner,
on both sides, at exactly (+-8, -8)."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import inputs
from benchmark.reference import check, compare, sph
from benchmark.reference.sph import pairs_within

HERE = Path(__file__).resolve().parents[1]
LIMITS = json.loads((HERE / "limits" / "sph1m-steps.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _physics(gravity=(0.0, -9.8), size=(16.0, 16.0)):
    ph = sph.physics(json.loads((HERE / "configs" / "sph-1m.json")
                                .read_text()))
    ph.update(gravity=gravity, size=size)
    return ph


def _dropped(n_steps):
    """The reference's float32 dam break after ``n_steps`` steps."""
    pos = torch.from_numpy(inputs.lattice(4096, 0.1))
    return sph.run(pos, torch.zeros_like(pos), _physics(), n_steps,
                   torch.float32)


@pytest.fixture(scope="module")
def corner():
    """(physics, float32 step, float64 step) from the dam break at step
    200: the float32 step stands in the program's place; both keep the
    particles' order, so particle k is the same particle on both sides."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ph = _physics()
        pos, vel = _dropped(200)
        return (ph, sph.step(pos, vel, ph, torch.float32),
                sph.step(pos, vel, ph))
    finally:
        torch.set_num_threads(n)


def _gaps(ph, prog, ref):
    return compare.state_gaps(*prog, *ref, ph["h"], ph["size"])


def _old_state_gaps(prog_pos, prog_vel, ref_pos, ref_vel, radius, size):
    """The pairing ``compare.state_gaps`` had before: each particle's
    nearest partner, the last write winning among equally near ones."""
    def nearest(a_pos, b_pos):
        na = a_pos.shape[0]
        pts = torch.cat([a_pos, b_pos]).to(torch.float64)
        i, j = pairs_within(pts, radius, size, with_self=False)
        keep = (i < na) & (j >= na)
        i, j = i[keep], j[keep] - na
        d = torch.sqrt(((pts[na:][j] - pts[:na][i]) ** 2).sum(1))
        gap = torch.full((na,), float(radius), dtype=torch.float64)
        gap.scatter_reduce_(0, i, d, "amin")
        partner = torch.full((na,), -1, dtype=torch.int64)
        best = d == gap[i]
        partner[i[best]] = j[best]
        return gap, partner

    gap_p, part_p = nearest(prog_pos, ref_pos)
    gap_r, _ = nearest(ref_pos, prog_pos)
    ok = part_p >= 0
    dv = (prog_vel[ok].to(torch.float64)
          - ref_vel[part_p[ok]].to(torch.float64))
    return dict(pos_gap=max(float(gap_p.max()), float(gap_r.max())),
                vel_gap=float(torch.sqrt((dv * dv).sum(1)).max()))


def _corner_members(pos):
    """Indices of the particles at the lower left corner."""
    at = (pos == torch.tensor([-8.0, -8.0])).all(1)
    return at.nonzero()[:, 0]


def test_coincident_corner_particles_pair_one_to_one(corner):
    ph, prog, ref = corner
    g = _gaps(ph, prog, ref)
    assert g["tie_groups"], "no particles share a corner"
    assert len(_corner_members(prog[0])) >= 2
    # the same particles, paired by identity
    by_index = float((prog[1].double() - ref[1]).norm(dim=1).max())
    assert g["vel_gap"] <= 1e-3, g
    assert g["vel_gap"] <= by_index
    assert g["pos_gap"] < 1e-5, g
    # the nearest-partner pairing read 0.334 here: velocities of different
    # particles in one corner
    assert _old_state_gaps(*prog, *ref, ph["h"], ph["size"])["vel_gap"] \
        > LIMITS["vel_gap"]


def test_a_corner_velocity_altered_by_0_1_reads_it(corner):
    ph, (pos, vel), ref = corner
    k = int(_corner_members(pos)[0])
    vel = vel.clone()
    away = 1.0 if float(vel[k, 0]) >= float(ref[1][k, 0]) else -1.0
    vel[k, 0] += 0.1 * away  # on the program's side, away from its own
    g = _gaps(ph, (pos, vel), ref)
    assert g["vel_gap"] >= 0.1, g


def test_a_duplicated_corner_particle_fails(corner):
    ph, (pos, vel), ref = corner
    a, b = _corner_members(pos)[:2].tolist()
    pos, vel = pos.clone(), vel.clone()
    pos[b], vel[b] = pos[a], vel[a]  # b replaced by a copy of a
    g = _gaps(ph, (pos, vel), ref)
    assert g["vel_gap"] > LIMITS["vel_gap"], g


@pytest.mark.parametrize("prog_vx, ref_vx, want", [
    # one reference particle short: the two it has pair with 1 and 3
    # (largest 0.1); the left-over 2 reads its nearest, 1.1 or 3: 0.9
    ((1.0, 2.0, 3.0), (1.1, 3.0), 0.9),
    # one program particle short: 1 and 3 pair with 1.1 and 3
    ((1.0, 3.0), (1.1, 2.0, 3.0), 0.1),
])
def test_a_group_with_sides_of_unequal_size(prog_vx, ref_vx, want):
    """A corner group of 3 and 2 particles, beside one particle that sits
    at the same point on both sides with the same velocity."""
    ph = _physics(size=(4.0, 4.0))

    def side(vx):
        pos = torch.tensor([[-2.0, -2.0]] * len(vx) + [[0.0, 0.0]])
        vel = torch.tensor([[v, 0.0] for v in vx] + [[0.0, 0.0]])
        return pos, vel

    prog, ref = side(prog_vx), side(ref_vx)
    g = _gaps(ph, prog, ref)
    assert g["tie_groups"] == [(len(prog_vx), len(ref_vx))]
    assert g["vel_gap"] == pytest.approx(want)
    flip = torch.arange(len(prog_vx) + 1).flip(0)
    assert _gaps(ph, (prog[0][flip], prog[1][flip]), ref) == g


@pytest.mark.parametrize("side", ["program", "reference"])
def test_the_readings_do_not_depend_on_order(corner, side):
    ph, prog, ref = corner
    want = _gaps(ph, prog, ref)
    perm = torch.randperm(prog[0].shape[0],
                          generator=torch.Generator().manual_seed(5))
    if side == "program":
        prog = (prog[0][perm], prog[1][perm])
    else:
        ref = (ref[0][perm], ref[1][perm])
    assert _gaps(ph, prog, ref) == want


@pytest.mark.parametrize("ref_from", ["float64", "program"])
def test_without_ties_the_readings_are_the_old_pairings(ref_from):
    """A jittered lattice with no gravity after 20 float32 steps, against
    the float64 step; or against the program's own positions, where every
    particle has exactly one partner at distance 0 (not a group)."""
    cfg = json.loads((HERE / "configs" / "sph-1m.json").read_text())
    cfg["domain"].update(particle_count=1024, spawn_columns=32,
                         size=[4.35, 4.35])
    ph = sph.physics(cfg)
    pos, vel = sph.run(*inputs.jittered(cfg, 2**31 + 9, "cpu"), ph, 20,
                       torch.float32)
    prog = sph.step(pos, vel, ph, torch.float32)
    ref = sph.step(pos, vel, ph)
    if ref_from == "program":
        ref = (prog[0].double(), ref[1])
    g = _gaps(ph, prog, ref)
    assert g["tie_groups"] == []
    old = _old_state_gaps(*prog, *ref, ph["h"], ph["size"])
    assert (g["pos_gap"], g["vel_gap"]) == (old["pos_gap"], old["vel_gap"])


def test_the_ports_step_under_gravity_reads_within_the_limits():
    """The port's resident step (``FluidApp``, policy ``grow``) on
    ``dam_break_4k``, handed the reference's float32 dam break at step 180
    (the port's own first 180 steps take minutes on the CPU at K = 32),
    stepped until its own state holds particles at one point, then its
    next step held to the reference as a run's check holds it."""
    from benchmark.run import check_state, hand_state, held_state, particles
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.models.scenes import dam_break_4k

    scene = dam_break_4k("cpu")
    app = FluidApp(scene.settings, scene.params, capacity_policy="grow",
                   device="cpu", neighbor_mode="resident")
    hand_state(app, *_dropped(180))  # its reading assumes zero velocities
    assert particles(held_state(app))[0].shape == (4096, 2)
    for _ in range(4):
        app.run(1)
        before = check_state(held_state(app))
        pos, vel = before[:2]
        if torch.unique(pos, dim=0).shape[0] < pos.shape[0]:
            break
    else:
        pytest.fail("no particles met at one point")
    app.run(1)
    states = [before, check_state(held_state(app))]
    ph = _physics()
    gaps = check.step_gaps(states, ph)
    assert gaps["pos_gap"] <= LIMITS["pos_gap"], gaps
    assert gaps["vel_gap"] <= LIMITS["vel_gap"], gaps
    # the nearest-partner pairing read 0.389 on this step
    ref = check.reference_step(states[0], ph)
    old = _old_state_gaps(*states[1][:2], *ref, ph["h"], ph["size"])
    assert old["vel_gap"] > LIMITS["vel_gap"], old
