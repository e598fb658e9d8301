"""PyTorch port on the card: each CUDA kernel (the resident engine's three,
forces with an obstacle field, the metaball coarse fields) against its
plain PyTorch version on the same CUDA tensors, and the kernel step against
the plain step. Marked ``cuda``; every test skips without a
CUDA device. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Rebin must be bitwise; density and forces within BASELINE.md's per-step
bounds (|drho| <= 9.2e-5, |dpos| <= 4.8e-7, |dvel| <= 3.8e-5, relative
where the value exceeds 1) on live slots, with dead slots exact; the
metaball fields within 1e-5 * max(1, |plain|).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpufluid_torch as tt
from tpufluid_torch.ops import fused, resident

pytestmark = pytest.mark.cuda

POS_TOL, VEL_TOL, RHO_TOL = 4.8e-7, 3.8e-5, 9.2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(False)


def _state(settings, device, seed):
    """Random positions and velocities, with far movers and coincident
    pairs, binned into the slot grid."""
    rng = np.random.default_rng(seed)
    n = settings.particle_count
    half = np.asarray(settings.size, np.float32) / 2
    pos = rng.uniform(-half, half, (n, 2)).astype(np.float32)
    vel = rng.normal(size=(n, 2)).astype(np.float32) * 2.0
    vel[:16] = rng.uniform(-300.0, 300.0, (16, 2))
    pos[16:32], vel[16:32] = pos[32:48], vel[32:48]
    st = tt.init_state(settings, device)
    st = dataclasses.replace(
        st, position=torch.from_numpy(pos).to(device),
        predicted=torch.from_numpy(pos).to(device),
        velocity=torch.from_numpy(vel).to(device))
    return resident.from_particles(st, settings)


def _rel(a, b, mask):
    a, b = a[mask].double(), b[mask].double()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


@pytest.mark.parametrize("k", [8, 32])
def test_kernels_match_plain(cuda, k):
    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=k)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8), mouse_state=1,
                              mouse_pos=(0.5, 0.5), mouse_force_radius=2.0)
    gs = _state(s, cuda, k)
    before = dict(fused.LAUNCHES)
    rargs = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, p.delta, s)
    got, want = fused.rebin(*rargs), fused.rebin_plain(*rargs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[5].sum()) > 0  # far movers exercised
    px, py, vx, vy, occ = got[:5]
    dargs = (px, py, vx, vy, occ, p.mass, p.delta, p.pressure_constant,
             p.rest_density, s)
    pres, invr = fused.density(*dargs)
    pres_p, invr_p = fused.density_plain(*dargs)
    live = px < fused.SENTINEL_HALF
    assert _rel(1.0 / invr, 1.0 / invr_p, live) <= RHO_TOL
    assert _rel(pres, pres_p, live) <= RHO_TOL
    fargs = (px, py, vx, vy, pres, invr, occ, p, s, gs.tick + 1)
    new = fused.forces_integrate(*fargs)
    new_p = fused.forces_integrate_plain(*fargs)
    for a, b, tol in zip(new, new_p, [POS_TOL, POS_TOL, VEL_TOL, VEL_TOL]):
        assert _rel(a, b, live) <= tol
        assert torch.equal(a[~live], b[~live])
    torch.cuda.synchronize()
    assert {n: fused.LAUNCHES[n] - before[n] for n in before} == {
        "rebin": 1, "density": 1, "forces_integrate": 1,
        "forces_integrate_has_ff": 0}


def test_kernel_step_matches_plain_step(cuda):
    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=8)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    kstep = resident.make_grid_step(s)
    pstep = resident.make_plain_grid_step(s)
    gs = _state(s, cuda, 7)
    for _ in range(5):
        a, b = kstep(gs, p), pstep(gs, p)
        for f in ("occ_row", "tick", "lost"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        live = b.pos_x < fused.SENTINEL_HALF
        assert torch.equal(a.pos_x < fused.SENTINEL_HALF, live)
        for f, tol in (("pos_x", POS_TOL), ("pos_y", POS_TOL),
                       ("vel_x", VEL_TOL), ("vel_y", VEL_TOL)):
            assert _rel(getattr(a, f), getattr(b, f), live) <= tol
        gs = b


def test_wrappers_check_their_inputs(cuda):
    s = tt.SimSettings(particle_count=64, size=(3.2, 3.2))
    gs = resident.init_grid_state(s, cuda)
    with pytest.raises(ValueError):
        fused.rebin(gs.pos_x[:, :, :64].contiguous(), gs.pos_y, gs.vel_x,
                    gs.vel_y, gs.occ_row, 0.01, s)
    with pytest.raises(ValueError):
        fused.density(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                      gs.occ_row.long(), 1.0, 0.01, 50.0, 0.0, s)


def _scene_1m_state(cuda, k, seed):
    """scene_1m's grid (512 x 523 cells) at capacity ``k``, holding the
    spawn lattice jittered by up to half a spacing, random velocities."""
    from tpufluid_torch.models import scenes

    scene = scenes.scene_1m(cuda)
    s = dataclasses.replace(scene.settings, cell_capacity=k)
    g = torch.Generator(device="cpu").manual_seed(seed)
    st = tt.init_state(s, "cpu")
    pos = st.position + (torch.rand(st.position.shape, generator=g) - 0.5) \
        * 0.1
    vel = torch.randn(st.position.shape, generator=g) * 2.0
    st = dataclasses.replace(st, position=pos.to(cuda),
                             predicted=pos.to(cuda), velocity=vel.to(cuda),
                             density=st.density.to(cuda),
                             cell=st.cell.to(cuda), tick=st.tick.to(cuda))
    return s, scene.params, resident.from_particles(st, s)


@pytest.mark.parametrize("k", [8, 32])
def test_coarse_metaball_matches_plain(cuda, k):
    """The metaball coarse-field kernel against its plain version at
    scene_1m, within 1e-5 * max(1, |plain|)."""
    from tpufluid_torch.ops import render_coarse

    s, _, gs = _scene_1m_state(cuda, k, 3)
    speed = torch.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
    args = (gs.pos_x, gs.pos_y, speed, gs.occ_row, s, 2)
    before = render_coarse.LAUNCHES["metaball_coarse"]
    got = render_coarse.coarse_metaball_fields(*args)
    want = render_coarse.coarse_metaball_fields_plain(*args)
    torch.cuda.synchronize()
    assert render_coarse.LAUNCHES["metaball_coarse"] == before + 1
    for a, b in zip(got, want):
        assert a.shape == (2 * 524, 2 * 512)
        full = torch.ones_like(b, dtype=torch.bool)
        assert _rel(a, b, full) <= 1e-5
    assert float(want[0].max()) > 1.0


def test_forces_has_ff_matches_plain(cuda):
    """forces_integrate with an obstacle field (three circles and a
    rotated rect at texture 1024) against its plain version at scene_1m."""
    from tpufluid_torch.ops import forcefield

    s, p, gs = _scene_1m_state(cuda, 8, 5)
    objs = forcefield.Objects.from_list(
        [("circle", (0.0, 0.0), 6.0), ("circle", (-20.0, 10.0), 4.0),
         ("circle", (15.0, -12.0), 3.0), ("rect", (5.0, 20.0), (12.0, 5.0),
                                          0.5)], cuda)
    field = forcefield.obstacle_force_field(objs, s)
    ffc = resident.forcefield_cells(field, s)
    args = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, p.delta, s)
    px, py, vx, vy, occ = fused.rebin(*args)[:5]
    pres, invr = fused.density(px, py, vx, vy, occ, p.mass, p.delta,
                               p.pressure_constant, p.rest_density, s)
    fargs = (px, py, vx, vy, pres, invr, occ, p, s, gs.tick + 1)
    before = dict(fused.LAUNCHES)
    new = fused.forces_integrate(*fargs, ff_cells=ffc)
    new_p = fused.forces_integrate_plain(*fargs, ff_cells=ffc)
    base = fused.forces_integrate(*fargs)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["forces_integrate"] == before["forces_integrate"] + 2
    assert (fused.LAUNCHES["forces_integrate_has_ff"]
            == before["forces_integrate_has_ff"] + 1)
    live = px < fused.SENTINEL_HALF
    for a, b, tol in zip(new, new_p, [POS_TOL, POS_TOL, VEL_TOL, VEL_TOL]):
        assert _rel(a, b, live) <= tol
        assert torch.equal(a[~live], b[~live])
    assert int(((new[0] != base[0]) & live).sum()) > 1000  # pushed
