"""PyTorch port on the card: each CUDA kernel (the resident engine's three,
forces with an obstacle field and the other variant flags, batched world
stacks, the fused physics pass, the metaball coarse fields, the dense
engine's density and forces with both variant flags) against its plain
PyTorch version on the same CUDA tensors, and the kernel step against the
plain step. Marked ``cuda``; every test skips without a CUDA device. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Rebin must be bitwise; density and forces within BASELINE.md's per-step
bounds (|drho| <= 9.2e-5, |dpos| <= 4.8e-7, |dvel| <= 3.8e-5, relative
where the value exceeds 1) on live slots, with dead slots exact; the
metaball fields bitwise. The dense engine's kernels are held bitwise to
their plain versions over the whole grid, also on tile gates (ragged and
sparse grids, K up to 256, live slots in the clamped edge rows and the
wrapped edge columns, empty slots at nonzero positions), and raise above
the largest K they stage. The resident engine's variants, its batched
stacks and the physics pass are held bitwise: to their plain versions, the
physics kernel to the split kernel pair, a batched step to the
single-world steps. The tile kernels of
density and forces are also held bitwise to their plain versions at every
tile shape the wrappers pick (K=8 to 256, sparse and ragged grids, each
flag, an obstacle field, two worlds), and so is rebin's (with far movers,
an overflow past K and row_shift stacks); the round-1 rebin with a valid
mask (ops.rebin) bitwise to its plain version (a prefix mask, one with
holes over stale data, K=192, valid slots in the clamped edge rows and
columns); the physics kernel also on ragged and sparse
grids and at the largest K its tile takes; FluidApp.set_mouse
drives 16 resident ticks at scene_1m without loss; and both sharded steps
(row-band resident, slab pallas on a grid with dead columns) are bitwise
their plain versions on D shards of one card; config 5's audited bytes
of one sharded step at scene_4m on 8 shards of the card equal the formula;
the resident step's far-mover pass (csrc/far_reinsert.cu, gated on the
device) bitwise its plain version, and every burst replayed as a CUDA
graph bitwise its eager burst, the resident one with no host sync; the
row-band sharded step's far-mover kernels (csrc/far_sharded.cu) bitwise
their plain versions, and both sharded steps replayed as a CUDA graph a
call bitwise their eager twins (a swapped field, no host sync, audited).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import tpufluid_torch as tt
from tpufluid_torch.ops import dense, fused, grid, resident, sph

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
    before = {**fused.LAUNCHES, **sph.LAUNCHES}
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
    after = {**fused.LAUNCHES, **sph.LAUNCHES}
    want = dict.fromkeys(before, 0)
    want.update(rebin=1, density=1, forces_integrate=1)
    assert {n: after[n] - before[n] for n in before} == want


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
    scene_1m, bitwise (the same f32 operations in the same order, and
    the accurate expf that torch.exp runs)."""
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
        assert torch.equal(a, b)
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


def _dense_grid(cuda, k, case):
    """(settings, params, DenseGrid, floored density) on the card: random
    particles with coincident pairs and an over-full cell ("base"), the
    h = 1.5 surface-tension scene ("st"), or a clump above density 200
    ("clump")."""
    rng = np.random.default_rng(k)
    if case == "st":
        s = tt.SimSettings(particle_count=400, particle_spacing=0.75,
                           smoothing_radius=1.5, size=(30.0, 30.0),
                           cell_capacity=k)
        pos = rng.uniform(-8.0, 8.0, (400, 2)).astype(np.float32)
    elif case == "clump":
        s = tt.SimSettings(particle_count=600, size=(9.0, 8.0),
                           cell_capacity=k)
        pos = rng.uniform(-4.0, 4.0, (600, 2)).astype(np.float32)
        pos[:40] = rng.uniform(-0.1, 0.1, (40, 2))
    else:
        s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0),
                           cell_capacity=k)
        pos = rng.uniform(-4.5, 4.0, (3000, 2)).astype(np.float32)
        pos[16:32] = pos[32:48]
        pos[100:140] = (1.05, 1.05) + rng.uniform(0, 0.1, (40, 2))
    p = tt.TickParams.default(cuda, surface_tension_threshold=0.05,
                              surface_tension_coefficient=5.0)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    pos, vel = torch.from_numpy(pos).to(cuda), torch.from_numpy(vel).to(cuda)
    b = grid.bin_particles(grid.cell_id(pos, s), s)
    g = dense.build_grid(pos[b.perm], vel[b.perm], b.sorted_cells, s)
    d = dense.density_pass(g, p.mass, s.smoothing_radius)
    return s, p, g, torch.clamp(torch.clamp(d, min=tt.EPSILON), min=0.1)


@pytest.mark.parametrize("case", ["k8", "k32", "surface_tension",
                                  "adaptive_subsampling"])
def test_sph_kernels_match_plain(cuda, case):
    """sph_density and sph_forces against their plain versions, bitwise
    over the whole grid, base flags at K=8 and K=32 and each variant
    flag."""
    k = 32 if case == "k32" else 8
    scene = {"surface_tension": "st", "adaptive_subsampling": "clump"}
    s, p, g, d = _dense_grid(cuda, k, scene.get(case, "base"))
    h, n = s.smoothing_radius, s.kernel_norms()
    before = dict(sph.LAUNCHES)
    rho = sph.density(g, p.mass, h)
    rho_p = sph.density_plain(g, p.mass, h)
    assert torch.equal(rho, rho_p)
    flags = {case: True} if case in scene else {}
    args = (g, d, p, h, s.sqr_radius, n.spiky_derivative, n.viscosity,
            torch.tensor(9, device=cuda))
    got = sph.forces(*args, **flags)
    want = sph.forces_plain(*args, **flags)
    torch.cuda.synchronize()
    assert {n_: sph.LAUNCHES[n_] - before[n_] for n_ in before} == {
        "sph_density": 1, "sph_forces": 1}
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    if flags:
        base = sph.forces_plain(*args)
        assert not torch.equal(want[0][g.valid], base[0][g.valid])
    if case == "adaptive_subsampling":
        assert float(d[g.valid].max()) > 200.0


# ------------------------------------------- resident variants, batching

VARIANTS = {"wrap": dict(x_boundary="wrap"),
            "surface_tension": dict(surface_tension=True),
            "adaptive": dict(adaptive_subsampling=True),
            "all": dict(x_boundary="wrap", surface_tension=True,
                        adaptive_subsampling=True)}


def _variant_case(cuda, k, seed=11):
    """h 1.5 (surface tension acts above h 1), mass 60 (densities past the
    adaptive strides' 150 and 200), movers out across the x walls, far
    movers and coincident pairs; rebinned. (settings, params, grids)."""
    s = tt.SimSettings(particle_count=2400, particle_spacing=0.75,
                       smoothing_radius=1.5, size=(48.0, 40.0),
                       cell_capacity=k)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8), mass=60.0,
                              surface_tension_threshold=0.05,
                              surface_tension_coefficient=5.0)
    gs = _state(s, cuda, seed)
    rng = np.random.default_rng(seed)
    st, _ = resident.to_particles(gs, s)
    pos, vel = st.position.cpu().numpy(), st.velocity.cpu().numpy()
    side = np.where(np.arange(40) % 2 == 0, 1.0, -1.0)
    pos[60:100, 0] = side * 23.99
    vel[60:100, 0] = side * rng.uniform(3.0, 9.0, 40)
    st.position = torch.from_numpy(pos).to(cuda)
    st.predicted = st.position.clone()
    st.velocity = torch.from_numpy(vel).to(cuda)
    gs = resident.from_particles(st, s)
    out = fused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row,
                      p.delta, s)
    return s, p, gs.tick + 1, out[:5]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forces_variants_match_plain(cuda, variant):
    """forces_integrate with each variant flag (and all three) against its
    plain version, bitwise, and the launch counted under the variant."""
    kw = VARIANTS[variant]
    s, p, frame, (px, py, vx, vy, occ) = _variant_case(cuda, 16)
    pres, invr = fused.density(px, py, vx, vy, occ, p.mass, p.delta,
                               p.pressure_constant, p.rest_density, s)
    fargs = (px, py, vx, vy, pres, invr, occ, p, s, frame)
    before = dict(fused.LAUNCHES)
    got = fused.forces_integrate(*fargs, **kw)
    want = fused.forces_integrate_plain(*fargs, **kw)
    base = fused.forces_integrate(*fargs)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    live = px < fused.SENTINEL_HALF
    assert int(((got[2] != base[2]) & live).sum()) > 0
    rho = 1.0 / invr[live]
    assert bool((rho >= 200.0).any()) and bool(
        ((rho >= 150.0) & (rho < 200.0)).any())
    names = {"x_boundary": "wrap", "surface_tension": "surface_tension",
             "adaptive_subsampling": "adaptive"}
    for flag, name in names.items():
        n = fused.LAUNCHES[f"forces_integrate_{name}"]
        assert n == before[f"forces_integrate_{name}"] + (flag in kw)


def _stack(cuda, n_worlds):
    """A batched stack of the seeded grid, each world's velocities scaled
    by its own factor, with per-world gravity and viscosity."""
    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=8)
    gs = _state(s, cuda, 3)
    rows = gs.pos_x.shape[0]
    cat = lambda f: torch.cat([f(w) for w in range(n_worlds)])
    stack = resident.GridState(
        pos_x=cat(lambda w: gs.pos_x), pos_y=cat(lambda w: gs.pos_y),
        vel_x=cat(lambda w: gs.vel_x * (1.0 + 0.1 * w)),
        vel_y=cat(lambda w: gs.vel_y), occ_row=cat(lambda w: gs.occ_row),
        tick=gs.tick, lost=gs.lost)
    plist = [tt.TickParams.default(cuda, gravity=(0.5 * w, -4.9 * w),
                                   viscosity_coefficient=10.0 + 5 * w)
             for w in range(n_worlds)]
    wid = torch.arange(n_worlds, dtype=torch.int32,
                       device=cuda).repeat_interleave(rows)
    return s, stack, resident.batched_params(plist), wid, rows


def test_batched_kernels_match_plain(cuda):
    """rebin with row_shift, density and forces_integrate with wid on a
    3-world stack against their plain versions, bitwise."""
    s, g, bp, wid, rows = _stack(cuda, 3)
    before = dict(fused.LAUNCHES)
    rargs = (g.pos_x, g.pos_y, g.vel_x, g.vel_y, g.occ_row, bp.delta, s)
    got = fused.rebin(*rargs, row_shift=-(wid * rows))
    want = fused.rebin_plain(*rargs, row_shift=-(wid * rows))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    px, py, vx, vy, occ = got[:5]
    dargs = (px, py, vx, vy, occ, bp.mass, bp.delta, bp.pressure_constant,
             bp.rest_density, s)
    pres, invr = fused.density(*dargs, wid=wid)
    pres_p, invr_p = fused.density_plain(*dargs, wid=wid)
    assert torch.equal(pres, pres_p) and torch.equal(invr, invr_p)
    fargs = (px, py, vx, vy, pres, invr, occ, bp, s, g.tick + 1)
    new = fused.forces_integrate(*fargs, wid=wid)
    new_p = fused.forces_integrate_plain(*fargs, wid=wid)
    torch.cuda.synchronize()
    for a, b in zip(new, new_p):
        assert torch.equal(a, b)
    assert not torch.equal(new[3][:rows], new[3][rows:2 * rows])
    for n in ("rebin_row_shift", "density_wid", "forces_integrate_wid"):
        assert fused.LAUNCHES[n] == before[n] + 1


@pytest.mark.parametrize("k,flags", [
    (8, "base"), (32, "base"), (16, "all"), (8, "has_ff"), (8, "wid"),
    (8, "ragged"), ("max", "ragged"), (8, "sparse")])
def test_physics_matches_split(cuda, k, flags):
    """The fused physics kernel against the split density +
    forces_integrate kernels and against physics_plain, bitwise. "ragged":
    _tile_state's 41 rows (ragged for every tile height) with a row at
    full occupancy, at K=8 (base flags) and at the largest K the physics
    tile takes (a 1 x 1 tile); "sparse": 60 particles at K=8 (halo rows of
    at most one slot), with the three variant flags."""
    kw, extra = {}, {}
    if flags in ("ragged", "sparse"):
        if k == "max":  # a multiple of 8, as the resident grid rounds K
            k = fused.physics_max_capacity() // 8 * 8
        sparse = flags == "sparse"
        s, gs = _tile_state(cuda, k, 5, n_random=60 if sparse else 1500,
                            fill_row=not sparse)
        p = tt.TickParams.default(cuda, gravity=(0.0, -9.8),
                                  **ST_PARAMS_CUDA)
        px, py, vx, vy, occ = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                               gs.occ_row)
        frame = gs.tick + 1
        if sparse:
            kw = VARIANTS["all"]
    elif flags == "all":
        s, p, frame, (px, py, vx, vy, occ) = _variant_case(cuda, k)
        kw = VARIANTS["all"]
    elif flags == "wid":
        s, g, p, wid, rows = _stack(cuda, 3)
        px, py, vx, vy, occ = fused.rebin(
            g.pos_x, g.pos_y, g.vel_x, g.vel_y, g.occ_row, p.delta, s,
            row_shift=-(wid * rows))[:5]
        frame = g.tick + 1
        extra = dict(wid=wid)
    else:
        s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0),
                           cell_capacity=k)
        p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
        gs = _state(s, cuda, k)
        px, py, vx, vy, occ = fused.rebin(
            gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, p.delta,
            s)[:5]
        frame = gs.tick + 1
        if flags == "has_ff":
            gen = torch.Generator(device="cpu").manual_seed(2)
            ff = torch.randn((2,) + tuple(occ.shape) + (px.shape[2],),
                             generator=gen) * 3.0
            ff[:, :, :20] = 0.0
            extra = dict(ff_cells=tuple(f.contiguous().to(cuda) for f in ff))
    before = fused.LAUNCHES["physics"]
    got = fused.physics(px, py, vx, vy, occ, p, s, frame, **kw, **extra)
    wid = extra.get("wid")
    pres, invr = fused.density(px, py, vx, vy, occ, p.mass, p.delta,
                               p.pressure_constant, p.rest_density, s,
                               wid=wid)
    split = fused.forces_integrate(px, py, vx, vy, pres, invr, occ, p, s,
                                   frame, **kw, **extra)
    plain = fused.physics_plain(px, py, vx, vy, occ, p, s, frame, **kw,
                                **extra)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["physics"] == before + 1
    for a, b, c in zip(got, split, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_physics_tile_fits_shared_memory(cuda):
    """The physics kernel's tiles (the library picks them): 8 x 32 at
    K=8, tiles that shrink as K grows, a tile at every K up to 240 (the
    old kernel's largest) and beyond, and a refusal naming the split pair
    past the largest K whose +-2 halo fits, from physics_tile and from the
    wrapper's launch."""
    assert fused.physics_tile(8) == (8, 32)
    cells = [r * c for r, c in (fused.physics_tile(k)
                                for k in (8, 16, 32, 64, 128, 192, 240, 256))]
    assert cells == sorted(cells, reverse=True)
    k_max = fused.physics_max_capacity()
    assert k_max >= 512 and fused.physics_tile(k_max) == (1, 1)
    with pytest.raises(ValueError, match="split density"):
        fused.physics_tile(k_max + 1)
    s, gs = _tile_state(cuda, k_max + 1, 5, n_random=60, fill_row=False)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    before = fused.LAUNCHES["physics"]
    with pytest.raises(ValueError, match=f"{k_max}; use the split density"):
        fused.physics(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, p,
                      s, gs.tick + 1)
    assert fused.LAUNCHES["physics"] == before


def test_batched_step_matches_single_worlds(cuda):
    """A 3-world resident stack steps bitwise like three single worlds,
    split and fused physics alike."""
    import os

    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=8)
    plist = [tt.TickParams.default(cuda, gravity=(0.3 * w, -4.9 * w))
             for w in range(3)]
    for fused_physics in ("", "1"):
        os.environ["TPUFLUID_FUSED_PHYSICS"] = fused_physics
        try:
            gs = resident.init_batched_grid_state(s, 3, cuda)
            step = resident.make_grid_step(s, n_worlds=3, x_boundary="wrap")
            bp = resident.batched_params(plist)
            for _ in range(5):
                gs = step(gs, bp)
            single = resident.make_grid_step(s, x_boundary="wrap")
            for w, p in enumerate(plist):
                ref = resident.init_grid_state(s, cuda)
                for _ in range(5):
                    ref = single(ref, p)
                got = resident.world_state(gs, s, w)
                for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row"):
                    assert torch.equal(getattr(got, f), getattr(ref, f))
        finally:
            del os.environ["TPUFLUID_FUSED_PHYSICS"]


def _tile_state(device, k, seed, n_random=1500, fill_row=True):
    """A 9 x 8 world (47 x 42 cells, Gxp 128) at capacity ``k``:
    ``n_random`` random particles, a coincident pair, and with
    ``fill_row`` eight neighbouring cells of row 20 filled to ``k``, so
    that the row sits at full occupancy; the grid is cut to its first 41
    rows (the rows dropped are empty), which no tile height of 2, 4 or 8
    divides. With few particles most tiles stage halo rows of at most one
    slot."""
    s, st = _tile_particles(device, k, seed, n_random, fill_row)
    gs = resident.from_particles(st, s)
    return s, dataclasses.replace(gs, **{
        f: getattr(gs, f)[:41].contiguous()
        for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row")})


def _tile_particles(device, k, seed, n_random, fill_row):
    """(settings, State) of ``_tile_state``'s particles."""
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


ST_PARAMS_CUDA = dict(surface_tension_threshold=0.05,
                      surface_tension_coefficient=5.0)
TILE_VARIANTS = {"base": {}, "wrap": dict(x_boundary="wrap"),
                 "surface_tension": dict(surface_tension=True),
                 "adaptive": dict(adaptive_subsampling=True),
                 "has_ff": {}, "wid": {}}


@pytest.mark.parametrize("variant", list(TILE_VARIANTS))
@pytest.mark.parametrize("k", [8, 16, 32, 192, 256, "sparse8", "sparse192"])
def test_tile_kernels_bitwise(cuda, k, variant):
    """The tile kernels of density and forces_integrate against their
    plain versions, bitwise, at every tile shape the kernels pick from K
    (above 240 too), on a grid whose rows every tile height leaves
    ragged, with a row at full occupancy K, with each variant flag, an
    obstacle field (random push-outs) and two worlds (wid); "sparse" at
    K=8 and 192 holds 60 particles, so most tiles stage halo rows of at
    most one slot. Grid widths are multiples of 128, which every tile
    width divides."""
    sparse = isinstance(k, str)
    if sparse:
        k = int(k[len("sparse"):])
        s, gs = _tile_state(cuda, k, k, n_random=60, fill_row=False)
    else:
        s, gs = _tile_state(cuda, k, k)
    occ = gs.occ_row
    assert int(gs.lost) == 0
    if sparse:  # most rows hold at most one particle a cell
        assert int((occ <= 1).sum()) > len(occ) // 2
    else:
        assert int(occ.max()) == k
    plist = [tt.TickParams.default(cuda, gravity=(0.0, -9.8),
                                   **ST_PARAMS_CUDA),
             tt.TickParams.default(cuda, gravity=(0.0, -2.0),
                                   viscosity_coefficient=25.0,
                                   **ST_PARAMS_CUDA)]
    p, kw = plist[0], dict(TILE_VARIANTS[variant])
    if variant == "wid":
        p = resident.batched_params(plist)
        kw["wid"] = (torch.arange(gs.pos_x.shape[0], device=cuda)
                     >= gs.pos_x.shape[0] // 2).to(torch.int32)
    if variant == "has_ff":
        g = torch.Generator(device="cpu").manual_seed(k)
        ff = (torch.rand((2, *gs.pos_x.shape[::2]), generator=g) - 0.5) * 4
        ff[torch.rand(ff.shape, generator=g) < 0.7] = 0.0
        kw["ff_cells"] = (ff[0].to(cuda), ff[1].to(cuda))
    dargs = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, occ, p.mass, p.delta,
             p.pressure_constant, p.rest_density, s)
    wid = kw.get("wid")
    before = dict(fused.LAUNCHES)
    got = fused.density(*dargs, wid=wid)
    want = fused.density_plain(*dargs, wid=wid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fargs = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, *want, occ, p, s,
             gs.tick + 1)
    got = fused.forces_integrate(*fargs, **kw)
    want = fused.forces_integrate_plain(*fargs, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused.LAUNCHES["density"] == before["density"] + 1
    assert (fused.LAUNCHES["forces_integrate"]
            == before["forces_integrate"] + 1)



def _sph_tile_grid(device, case):
    """(settings, DenseGrid) of a tile gate of the dense kernels:
    "ragged8" / "ragged256": ``_tile_state``'s particles at K=8 / 256 (a
    row of full cells) binned by ``dense.build_grid``, cut to 41 rows;
    "sparse8" / "sparse192": 60 of them (halo cells of at most one slot);
    "edges": a hand-made [6, 4, 128] grid with live slots in rows 0 and 5
    and columns 0 and 127 (each cell's valid slots a prefix) and every
    position within 0.15 of the origin, so that the clamped rows and the
    wrapped columns meet pairs in range; "dead_bits": "ragged8" with its
    empty slots at (0.5, -0.25), a tenth of them elsewhere, and nonzero
    velocities."""
    rng = np.random.default_rng(21)
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
        g = dense.DenseGrid(torch.zeros(0, dtype=torch.int64),
                            *(a.to(device) for a in f), valid.to(device),
                            torch.tensor(0, dtype=torch.int32))
        return s, g
    k = {"ragged256": 256, "sparse192": 192}.get(case, 8)
    s, st = _tile_particles(device, k, k, 60 if "sparse" in case else 1500,
                            "sparse" not in case)
    b = grid.bin_particles(grid.cell_id(st.position, s), s)
    g = dense.build_grid(st.position[b.perm], st.velocity[b.perm],
                         b.sorted_cells, s)
    g = g._replace(**{f: getattr(g, f)[:41].contiguous()
                      for f in ("px", "py", "vx", "vy", "valid")})
    assert int(g.n_dropped) == 0
    if case == "dead_bits":
        gen = torch.Generator(device="cpu").manual_seed(21)
        dead = ~g.valid
        other = dead & (torch.rand(dead.shape, generator=gen) < 0.1).to(
            device)
        px = torch.where(dead, 0.5, g.px)
        py = torch.where(dead, -0.25, g.py)
        rand = ((torch.rand((2, *dead.shape), generator=gen) - 0.5)
                * 8.0).to(device)
        g = g._replace(px=torch.where(other, rand[0], px),
                       py=torch.where(other, rand[1], py),
                       vx=torch.where(dead, 3.0, g.vx),
                       vy=torch.where(dead, -1.0, g.vy))
    return s, g


@pytest.mark.parametrize("flag", ["base", "surface_tension",
                                  "adaptive_subsampling"])
@pytest.mark.parametrize("case", ["ragged8", "ragged256", "sparse8",
                                  "sparse192", "edges", "dead_bits"])
def test_sph_tile_kernels_bitwise(cuda, case, flag):
    """The tile kernels of sph_density and sph_forces against their plain
    versions, bitwise over the whole grid, on grids that take every
    staging path: a tile height that leaves rows ragged, a cell at full
    occupancy K (K=256), halo cells of at most one slot, live slots in the
    clamped first and last rows and the wrapped first and last columns,
    and empty slots whose positions are nonzero (shared and own sums)."""
    s, g = _sph_tile_grid(cuda, case)
    occ = g.valid.sum(dim=1)
    k = g.px.shape[1]
    if case.startswith("ragged"):
        assert int(occ.max()) == k
    if case.startswith("sparse"):
        assert int((occ <= 1).sum()) > occ.numel() // 2
    if case == "edges":
        assert bool(g.valid[0].any() and g.valid[-1].any()
                    and g.valid[:, :, 0].any() and g.valid[:, :, -1].any())
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8), **ST_PARAMS_CUDA)
    h, n = s.smoothing_radius, s.kernel_norms()
    before = dict(sph.LAUNCHES)
    rho_p = sph.density_plain(g, p.mass, h)
    assert torch.equal(sph.density(g, p.mass, h), rho_p)
    d = torch.clamp(torch.clamp(rho_p, min=tt.EPSILON), min=0.1)
    flags = {} if flag == "base" else {flag: True}
    args = (g, d, p, h, s.sqr_radius, n.spiky_derivative, n.viscosity,
            torch.tensor(9, device=cuda))
    got = sph.forces(*args, **flags)
    want = sph.forces_plain(*args, **flags)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert {n_: sph.LAUNCHES[n_] - before[n_] for n_ in before} == {
        "sph_density": 1, "sph_forces": 1}


def test_sph_kernels_refuse_k_above_limit(cuda):
    """Each dense kernel runs at the largest K whose 1 x 1 tile fits
    shared memory, and its wrapper raises, naming that K, one above it."""
    s = tt.SimSettings(particle_count=64, size=(9.0, 8.0))
    p = tt.TickParams.default(cuda)
    h, n = s.smoothing_radius, s.kernel_norms()
    k_d, k_f = sph.max_capacity("sph_density"), sph.max_capacity("sph_forces")
    assert k_d >= k_f >= 256
    assert sph.density_tile(k_d) == sph.forces_tile(k_f) == (1, 1)

    def grid_at(k):
        z = torch.zeros((3, k, 128), device=cuda)
        valid = torch.zeros((3, k, 128), dtype=torch.bool, device=cuda)
        valid[1, :2, 5] = True
        px = z.clone()
        px[1, 1, 5] = 0.05
        return dense.DenseGrid(torch.zeros(0, dtype=torch.int64), px, z, z,
                               z, valid, torch.tensor(0))

    rho = sph.density(grid_at(k_d), p.mass, h)
    assert bool(torch.isfinite(rho).all()) and float(rho[1, 0, 5]) > 0.0
    forces = lambda g: sph.forces(g, torch.ones_like(g.px), p, h,
                                  s.sqr_radius, n.spiky_derivative,
                                  n.viscosity, torch.tensor(1))
    assert all(bool(torch.isfinite(o).all()) for o in forces(grid_at(k_f)))
    with pytest.raises(ValueError, match=f"largest .*, {k_d}$"):
        sph.density(grid_at(k_d + 1), p.mass, h)
    with pytest.raises(ValueError, match=f"largest .*, {k_f}$"):
        forces(grid_at(k_f + 1))


def _valid_edge_grid(device):
    """chip_smoke.valid_edge_grid: (settings, (px, py, vx, vy, valid_f)) of
    a hand-made grid with valid slots in the clamped edge rows and
    columns. The script at the repo root holds the one copy of it."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.valid_edge_grid(device)


@pytest.mark.parametrize("case", ["holes", "prefix", "k192", "edges"])
def test_rebin_valid_matches_plain(cuda, case):
    """The round-1 rebin with a valid mask against its plain version,
    bitwise: "holes", a seeded grid with far movers, coincident pairs and
    a tenth of its valid slots at valid_f = 0 with their stale data kept;
    "prefix", the same grid's live slots; "k192", _tile_state's full row
    at K=192; "edges", _valid_edge_grid (valid slots in the clamped edge
    rows and columns)."""
    from tpufluid_torch.ops import rebin as trebin

    dt = 0.01
    if case == "edges":
        s, (px, py, vx, vy, valid) = _valid_edge_grid(cuda)
    else:
        if case == "k192":
            s, gs = _tile_state(cuda, 192, 11)
        else:
            s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0),
                               cell_capacity=8)
            gs = _state(s, cuda, 11)
        px, py, vx, vy = gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y
        valid = (px < fused.SENTINEL_HALF).float()
    if case == "holes":
        g = torch.Generator(device="cpu").manual_seed(11)
        stale = (torch.rand(valid.shape, generator=g) < 0.1).to(cuda) & (
            valid > 0)
        valid[stale] = 0.0
        assert int(stale.sum()) > 0
    args = (px, py, vx, vy, valid, dt, s)
    before = trebin.LAUNCHES["rebin_valid"]
    got = trebin.rebin_valid(*args)
    want = trebin.rebin_valid_plain(*args)
    torch.cuda.synchronize()
    assert trebin.LAUNCHES["rebin_valid"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[4].sum()) > 0
    if case != "k192":
        assert float(want[5].sum()) > 0


def _rebin_grid(device, k, seed, sparse):
    """_tile_state's grid (41 rows, ragged for every tile height) with
    far movers (a tenth of the live slots at up to 300 a side, two to
    twelve cells a step) and, with the full row, its particles at rest
    and the slots of the rows either side moving into it at 30 (a quarter
    cell a step), so that its cells overflow K."""
    s, gs = (_tile_state(device, k, seed, n_random=60, fill_row=False)
             if sparse else _tile_state(device, k, seed))
    live = gs.pos_x < fused.SENTINEL_HALF
    g = torch.Generator(device="cpu").manual_seed(seed)
    fast = live & (torch.rand(live.shape, generator=g) < 0.1).to(device)
    kick = ((torch.rand((2, *live.shape), generator=g) - 0.5) * 600.0).to(
        device)
    cols = torch.zeros(live.shape[2], dtype=torch.bool, device=device)
    cols[10:18] = True
    if not sparse:  # the full row and its feeders keep their course
        fast[19:22] &= ~cols
    vx = torch.where(fast, kick[0], gs.vel_x)
    vy = torch.where(fast, kick[1], gs.vel_y)
    if not sparse:
        for row, v in ((19, 30.0), (20, 0.0), (21, -30.0)):
            into = live[row] & cols
            vy[row] = torch.where(into, torch.full_like(vy[row], v),
                                  vy[row])
            if v == 0.0:
                vx[row] = torch.where(into, torch.zeros_like(vx[row]),
                                      vx[row])
    return s, dataclasses.replace(gs, vel_x=vx.contiguous(),
                                  vel_y=vy.contiguous())


@pytest.mark.parametrize("stack", [False, True])
@pytest.mark.parametrize("k", [8, 16, 32, 192, 256, "sparse8", "sparse192"])
def test_rebin_tiles_bitwise(cuda, k, stack):
    """The tile kernel of rebin against its plain version, bitwise (all
    four grids and occ_row', far_n, over_n), at every tile shape it picks
    from K, on grids whose rows every tile height leaves ragged, with far
    movers, a row whose cells overflow K and the grid's border rows and
    columns; "sparse" at K=8 and 192 holds 60 particles (halo rows of at
    most one slot). ``stack``: two such worlds stacked by rows, with
    row_shift as the batched engine passes it."""
    sparse = isinstance(k, str)
    k = int(k[len("sparse"):]) if sparse else k
    s, gs = _rebin_grid(cuda, k, k, sparse)
    shift = None
    if stack:
        _, gs2 = _rebin_grid(cuda, k, k + 1, sparse)
        rows = gs.pos_x.shape[0]
        gs = dataclasses.replace(gs, **{
            f: torch.cat([getattr(gs, f), getattr(gs2, f)]).contiguous()
            for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row")})
        shift = -(torch.arange(2, device=cuda, dtype=torch.int32)
                  .repeat_interleave(rows) * rows)
    args = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row,
            1.0 / 120.0, s)
    before = dict(fused.LAUNCHES)
    got = fused.rebin(*args, row_shift=shift)
    want = fused.rebin_plain(*args, row_shift=shift)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused.LAUNCHES["rebin"] == before["rebin"] + 1
    assert (fused.LAUNCHES["rebin_row_shift"]
            == before["rebin_row_shift"] + int(stack))
    assert int(want[5].sum()) > 0  # far movers
    if not sparse:
        assert int(want[6].sum()) > 0 and int(want[4].max()) == k


def _coarse_case(device, case):
    """(settings, GridState, supersample) of a coarse-field case."""
    if case.startswith("scene_1m"):
        s, _, gs = _scene_1m_state(device, int(case[len("scene_1m"):]), 5)
        return s, gs, 2
    k, sparse, sup, width = {
        "full192": (192, False, 2, 128), "full8_sup8": (8, False, 8, 128),
        "sparse8": (8, True, 2, 128), "sparse192": (192, True, 1, 128),
        "full32_sup4": (32, False, 4, 128),
        "ragged100": (32, False, 2, 100)}[case]
    s, gs = (_tile_state(device, k, k, n_random=60, fill_row=False)
             if sparse else _tile_state(device, k, k))
    # 40 rows (any supersample fits); columns from 47 on are empty, so a
    # cut to 100 keeps every particle and leaves a ragged column tile
    cut = lambda a: a[:40, :, :width] if a.dim() == 3 else a[:40]
    return s, dataclasses.replace(gs, **{
        f: cut(getattr(gs, f)).contiguous()
        for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row")}), sup


@pytest.mark.parametrize("case", ["scene_1m192", "full192", "full8_sup8",
                                  "sparse8", "sparse192", "full32_sup4",
                                  "ragged100"])
def test_coarse_metaball_tiles_match_plain(cuda, case):
    """The metaball coarse-field kernel against its plain version,
    bitwise: at K=192 (scene_1m's grid at K=192 and a row
    of cells at full occupancy), sparse grids (60 particles) at K=8 and
    192, supersample 1, 4 and 8 (other tile widths in cells), and a grid
    100 cells wide, whose 200 coarse columns leave the last 64-column
    tile ragged (the kernel takes any width)."""
    from tpufluid_torch.ops import render_coarse

    s, gs, sup = _coarse_case(cuda, case)
    speed = torch.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
    args = (gs.pos_x, gs.pos_y, speed, gs.occ_row, s, sup)
    before = render_coarse.LAUNCHES["metaball_coarse"]
    got = render_coarse.coarse_metaball_fields(*args)
    want = render_coarse.coarse_metaball_fields_plain(*args)
    torch.cuda.synchronize()
    assert render_coarse.LAUNCHES["metaball_coarse"] == before + 1
    gy, _, gx = gs.pos_x.shape
    for a, b in zip(got, want):
        assert a.shape == (sup * gy, sup * gx)
        assert torch.equal(a, b)
    assert float(want[0].max()) > 0.5


def test_set_mouse_on_card(cuda):
    """FluidApp.set_mouse on the card: 16 resident ticks at scene_1m with
    the mouse repelling at the centre, at power 0.5 (an attracting mouse
    is a sink that packs its cell past K=8 at any power, and the default
    150 packs the front of a repelled ring past it too; the loss audit
    that regrows comes at tick 256); nothing is lost, every tick launches
    forces_integrate, and the particles within the mouse radius gain
    velocity away from it."""
    from tpufluid_torch.app import FluidApp
    from tpufluid_torch.models import scenes

    scene = scenes.scene_1m(cuda)
    app = FluidApp(scene.settings,
                   tt.TickParams.default(cuda, mouse_force_power=0.5),
                   device=cuda, neighbor_mode="resident")
    pos_t = app.params.mouse_pos
    app.set_mouse(pos=(0.0, 0.0), state=-1)
    assert app.params.mouse_pos is pos_t and pos_t.device.type == "cuda"
    before = fused.LAUNCHES["forces_integrate"]
    app.run(16)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["forces_integrate"] == before + 16
    m = app.metrics()
    assert m["tick"] == 16 and m["lost_particles"] == 0
    st = app.state
    r = torch.linalg.norm(st.position, dim=1)
    near = (r < 4.0) & (r > 0.5)
    outward = (st.position * st.velocity).sum(dim=1)[near] / r[near]
    assert int(near.sum()) > 1000 and float(outward.mean()) > 0.2


def test_chamfer_compiled_matches_numpy(cuda):
    """The chamfer field's compiled host copy (csrc/distfield.cpp, built
    with the kernels) against its NumPy plain version, bitwise: random
    masks, one with no source (the border seeds), non-square ones."""
    from tpufluid_torch.native import distfield

    rng = np.random.default_rng(7)
    masks = [(rng.random((64, 64)) < 0.05).astype(np.uint8) * 255,
             rng.integers(0, 256, (37, 53)).astype(np.uint8),
             np.zeros((30, 30), np.uint8),
             (rng.random((21, 70)) < 0.1).astype(np.uint8) * 200]
    for m in masks:
        before = distfield.CALLS["chamfer"]
        got = distfield.chamfer_push_field(m, cuda)
        assert got.device.type == "cuda"
        assert distfield.CALLS["chamfer"] == before + 1
        want = distfield._chamfer_numpy(m)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("d,has_ff", [(2, False), (4, True)])
def test_sharded_step_matches_plain_on_card(cuda, d, has_ff):
    """The row-band sharded step on D shards of one card against the same
    step on the kernels' plain versions, bitwise over 4 synced steps, with
    far movers crossing bands; each shard launches rebin (with its row
    shift), density and forces once a step."""
    from tpufluid_torch.parallel import (
        build_resident_spec, make_plain_sharded_resident_step,
        make_resident_mesh, make_sharded_resident_step, shard_grid_state,
        unshard_grid_state)

    s = tt.SimSettings(particle_count=2048, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(8.0, 8.0),
                       cell_capacity=8, texture_size=(72, 72))
    gs = _state(s, cuda, seed=21)
    spec = build_resident_spec(s, d)
    mesh = make_resident_mesh(spec, [cuda] * d)
    params = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    extra = ()
    if has_ff:
        g = torch.Generator().manual_seed(5)
        extra = ((torch.rand((72, 72, 2), generator=g) - 0.5).to(cuda),)
    kstep = make_sharded_resident_step(spec, mesh, has_force_field=has_ff)
    pstep = make_plain_sharded_resident_step(spec, mesh,
                                             has_force_field=has_ff)
    sgs = shard_grid_state(gs, spec, mesh)
    for i in range(4):
        before = dict(fused.LAUNCHES)
        k, kst = kstep(sgs, params, *extra)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["rebin_row_shift"] == before[
            "rebin_row_shift"] + d
        assert fused.LAUNCHES["forces_integrate"] == before[
            "forces_integrate"] + d
        p, pst = pstep(sgs, params, *extra)
        kg, pg = unshard_grid_state(k), unshard_grid_state(p)
        for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick",
                  "lost"):
            assert torch.equal(getattr(kg, f), getattr(pg, f)), (i, f)
        assert torch.equal(kst["n_valid"], pst["n_valid"])
        sgs = p


def test_diagnose_on_card_matches_cpu(cuda):
    """diagnose_resident_step through the kernels on the card reports what
    it reports through their plain versions on the CPU (the kernels are
    bitwise), clean and with an inf in a live velocity."""
    from tpufluid_torch.utils.debugging import diagnose_resident_step

    s = tt.SimSettings(particle_count=2048, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(8.0, 8.0),
                       cell_capacity=8)
    gs = _state(s, cuda, seed=3)
    live = torch.nonzero(resident.valid_mask(gs))
    y, k, x = (int(v) for v in live[live.shape[0] // 2])
    vx = gs.vel_x.clone()
    vx[y, k, x] = float("inf")
    cpu = torch.device("cpu")
    for g in (gs, dataclasses.replace(gs, vel_x=vx)):
        on_card = diagnose_resident_step(g, tt.TickParams.default(cuda), s)
        on_cpu = diagnose_resident_step(
            resident.GridState(**{f.name: getattr(g, f.name).to(cpu)
                                  for f in dataclasses.fields(g)}),
            tt.TickParams.default(cpu), s)
        assert on_card == on_cpu


def test_slab_pallas_step_matches_plain_on_card(cuda):
    """The slab-sharded step in pallas mode on D = 2 shards of one card
    against the same step on the two kernels' plain versions, bitwise over
    4 synced steps (state, valid mask, stats). The world is 20 interior
    columns wide, so a slab's local grid is 10 + 2 x 2 = 14 columns,
    padded to 128: the kernels' column wrap runs through 114 dead
    columns. Each shard launches sph_density and sph_forces once a step."""
    from tpufluid_torch.parallel import (
        build_shard_spec, init_sharded, make_mesh, make_plain_sharded_step,
        make_sharded_step)

    s = tt.SimSettings(particle_count=512, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(4.0, 8.0),
                       cell_capacity=8)
    spec = build_shard_spec(s, 2)
    assert spec.col_bounds == (1, 11, 21)
    mesh = make_mesh(spec, [cuda] * 2)
    params = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    st = init_sharded(spec, mesh)
    rng = np.random.default_rng(11)
    for slab in st.slabs:  # seeded velocities, some across the slab edge
        v = rng.normal(0.0, 3.0, tuple(slab.velocity.shape))
        v[::9, 0] = 30.0 * np.sign(v[::9, 0])
        slab.velocity = torch.where(
            slab.valid[:, None], torch.from_numpy(v.astype(np.float32))
            .to(cuda), 0.0)
    kstep = make_sharded_step(spec, mesh, debug=True, neighbor_mode="pallas")
    pstep = make_plain_sharded_step(spec, mesh, debug=True)
    moved = 0
    for i in range(4):
        before = dict(sph.LAUNCHES)
        k, kst = kstep(st, params)
        torch.cuda.synchronize()
        assert {n: sph.LAUNCHES[n] - before[n] for n in before} == {
            "sph_density": 2, "sph_forces": 2}
        p, pst = pstep(st, params)
        for a, b in zip(k.slabs, p.slabs):
            for f in ("position", "velocity", "valid", "tick"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (i, f)
        assert kst.keys() == pst.keys()
        for name in kst:
            assert torch.equal(kst[name], pst[name]), (i, name)
        moved += int((kst["n_valid"].cpu()
                      != torch.tensor([int(x.valid.sum())
                                       for x in st.slabs])).any())
        st = p
    assert int(kst["n_valid"].sum()) == 512 and moved > 0


def test_config5_measured_bytes_at_scene_4m(cuda):
    """The harness's audited bytes of one sharded resident step at
    scene_4m, on 8 shards of the card, equal the formula's 397,320."""
    from tpufluid_torch import bench
    from tpufluid_torch.models import scenes
    from tpufluid_torch.parallel import build_resident_spec, comm_audit

    spec = build_resident_spec(scenes.scene_4m(cuda).settings, 8)
    formula = comm_audit.resident_comm_formula(spec)["bytes_per_dir"]
    assert bench._measured_comm_bytes_per_dir(spec, cuda) == formula \
        == 397_320


# ------------------------------------- the far-mover pass and the bursts

FAR_CASES = {"movers": {}, "none": {}, "over": dict(far_capacity=5),
             "wrap": dict(x_boundary="wrap"), "worlds": dict(n_worlds=2),
             "many": {}}


def _far_input(case, cuda):
    """(settings, state, params, step kwargs) of a far-mover case."""
    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=8)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    kw = FAR_CASES[case]
    if case == "none":
        return s, resident.init_grid_state(s, cuda), p, kw
    if case == "many":  # more movers than the insert pass sorts in shared
        # memory (16,384): its sort runs in global memory
        s = tt.SimSettings(particle_count=30000, size=(30.0, 30.0),
                           cell_capacity=64)
        gs = _state(s, cuda, 4)
        g = torch.Generator(device=cuda).manual_seed(4)
        kick = (torch.rand(gs.vel_x.shape, generator=g, device=cuda)
                - 0.5) * 600.0
        return s, dataclasses.replace(gs, vel_x=kick,
                                      vel_y=kick.flip(2)), p, kw
    gs = _state(s, cuda, 3)
    if case == "wrap":  # every particle near an x wall moving out, wrapped
        near = (gs.pos_x.abs() > 4.0) & (gs.pos_x < fused.SENTINEL_HALF)
        gs = dataclasses.replace(gs, vel_x=torch.where(
            near, torch.sign(gs.pos_x) * 60.0, gs.vel_x))
        gs = resident.make_grid_step(s, **kw)(gs, p)
    if case == "worlds":
        gs = dataclasses.replace(
            gs, **{f: torch.cat([getattr(gs, f), getattr(gs, f)])
                   for f in ("pos_x", "pos_y", "vel_x", "occ_row")},
            vel_y=torch.cat([gs.vel_y, gs.vel_y * 0.5]))
        p = resident.batched_params([p, tt.TickParams.default(
            cuda, gravity=(0.0, -4.9), viscosity_coefficient=10.0)])
    return s, gs, p, kw


@pytest.mark.parametrize("case", list(FAR_CASES))
def test_far_reinsert_matches_plain(cuda, case):
    """csrc/far_reinsert.cu against its plain version (``_reinsert_far``,
    run whatever the count) on the kernel rebin's outputs: grids, occ_row
    and lost bitwise; with no mover the rebin's outputs untouched and the
    far-step counter unmoved, else the counter 1; "over" (capacity 5)
    drops the rest into lost ("wrap" piles its crossers into the first
    column, whose cells may overflow); "many" sorts its movers in global
    memory; one launch counted either way."""
    s, gs, p, kw = _far_input(case, cuda)
    step = resident.make_grid_step(s, **kw)
    _, row_shift = step._world_tables(cuda)
    rb = fused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row,
                     p.delta, step.settings, row_shift=row_shift)
    n_far = int(rb[5].sum())
    lost0 = gs.lost + rb[6].sum().to(torch.int32)
    counter = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = resident.LAUNCHES["far_reinsert"]
    got = resident.far_reinsert(gs, *(t.clone() for t in rb[:5]), rb[5],
                                lost0.clone(), p.delta, step.settings,
                                step.far_capacity, counter)
    assert resident.LAUNCHES["far_reinsert"] == before + 1
    *want, dropped = resident._reinsert_far(gs, *rb[:4], rb[5].sum(), p.delta,
                                            step.settings, step.far_capacity)
    for a, b in zip(got, (*want, lost0 + dropped)):
        assert torch.equal(a, b)
    assert int(counter) == (n_far > 0)
    if case == "none":
        assert n_far == 0
        for a, b in zip(got[:5], rb[:5]):
            assert torch.equal(a, b)
    else:
        assert n_far >= 8
    if case == "over":
        assert int(dropped) >= n_far - 5
    if case == "many":
        assert min(n_far, step.far_capacity) > 16384


BURSTS = {"base": {}, "wrap": dict(x_boundary="wrap", surface_tension=True,
                                   adaptive_subsampling=True),
          "worlds": dict(n_worlds=2), "obstacles": dict(has_force_field=True)}


@pytest.mark.parametrize("case", list(BURSTS))
def test_graphed_resident_burst_matches_eager(cuda, case):
    """``make_grid_multi_step`` (a CUDA graph replayed once a step) against
    ``make_eager_grid_multi_step``, bitwise every field, over two bursts
    (the first captures, the second only replays; obstacles: the second
    under a new field). The launch counters read one launch of each
    kernel a step, and a burst's result is not overwritten by the next."""
    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=8,
                       texture_size=(90, 80))
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    kw = BURSTS[case]
    gs = _state(s, cuda, 5)
    if case == "worlds":
        gs = dataclasses.replace(
            gs, **{f: torch.cat([getattr(gs, f), getattr(gs, f)])
                   for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row")})
        p = resident.batched_params([p, tt.TickParams.default(
            cuda, gravity=(0.0, -4.9), viscosity_coefficient=10.0)])
    extra = [(), ()]
    if case == "obstacles":
        from tpufluid_torch.ops import forcefield
        extra = [(forcefield.obstacle_force_field(
            forcefield.Objects.from_list([("circle", c, 1.0)], cuda), s),)
            for c in ((0.0, 0.0), (2.0, -1.0))]
    if case == "wrap":
        p = tt.TickParams.default(cuda, surface_tension_threshold=0.05,
                                  surface_tension_coefficient=5.0)
    run = resident.make_grid_multi_step(s, 6, **kw)
    eager = resident.make_eager_grid_multi_step(s, 6, **kw)
    fields = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")
    for i in range(2):
        before = dict(fused.LAUNCHES)
        far0 = resident.LAUNCHES["far_reinsert"]
        got = run(gs, p, *extra[i])
        torch.cuda.synchronize()
        assert {n: fused.LAUNCHES[n] - before[n] for n in ("rebin", "density",
                "forces_integrate")} == dict.fromkeys(
            ("rebin", "density", "forces_integrate"), 6)
        assert resident.LAUNCHES["far_reinsert"] == far0 + 6
        want = eager(gs, p, *extra[i])
        for f in fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (i, f)
        kept = {f: getattr(got, f).clone() for f in fields}
        nxt = run(got, p, *extra[i])
        for f in fields:
            assert torch.equal(getattr(got, f), kept[f]), (i, f)
        assert int(nxt.tick) == int(got.tick) + 6
        gs = got


@pytest.mark.parametrize("mode", ["grid", "naive", "dense", "pallas"])
def test_graphed_step_burst_matches_eager(cuda, mode):
    """``step.make_multi_step`` (a CUDA graph) against
    ``make_eager_multi_step``, bitwise every field, over two bursts;
    burst sizes of one step share its graph."""
    from tpufluid_torch import graphs
    from tpufluid_torch import step as steps

    s = tt.SimSettings(particle_count=1000 if mode == "naive" else 3000,
                       size=(9.0, 8.0), cell_capacity=16)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    st = tt.init_state(s, cuda)
    run = steps.make_multi_step(s, 5, neighbor_mode=mode)
    eager = steps.make_eager_multi_step(s, 5, neighbor_mode=mode)
    fields = ("position", "predicted", "velocity", "density", "cell", "tick")
    for _ in range(2):
        got, want = run(st, p), eager(st, p)
        for f in fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        st = got
    n = len(graphs.CAPTURES)
    steps.make_multi_step(s, 2, neighbor_mode=mode)(st, p)
    assert len(graphs.CAPTURES) == n


def test_resident_burst_replays_without_sync(cuda):
    """A captured resident burst with far movers replays under
    ``torch.cuda.set_sync_debug_mode("error")``: no host read."""
    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=8)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    gs = _state(s, cuda, 9)
    run = resident.make_grid_multi_step(s, 4)
    want = run(gs, p)  # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(gs, p)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    assert run.step.far_steps >= 2


# ------------------------ the sharded steps' far pass and one-program form

BAND_FAR_CASES = {"none": 2, "movers": 2, "over": 2, "wrap": 4, "many": 2}


def _band_far_input(case, cuda):
    """(spec, mesh, sharded state, params) of a sharded far-mover case:
    the lattice at rest ("none"), 16 far movers ("movers"), the same over
    a capacity of 8 a band ("over"), the wall movers one wrap step later
    ("wrap"), and more movers into one band than the insert sorts in
    shared memory (16,384; "many")."""
    from tpufluid_torch.parallel import (
        build_resident_spec, make_eager_sharded_resident_step,
        make_resident_mesh, shard_grid_state)

    d = BAND_FAR_CASES[case]
    s = tt.SimSettings(particle_count=2048, size=(8.0, 8.0),
                       cell_capacity=8)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    cap = {"over": 8, "many": 32768}.get(case)
    if case == "many":
        s = tt.SimSettings(particle_count=40000, size=(30.0, 30.0),
                           cell_capacity=64)
    spec = build_resident_spec(s, d, far_capacity=cap)
    mesh = make_resident_mesh(spec, [cuda] * d)
    if case == "none":
        return spec, mesh, shard_grid_state(
            resident.init_grid_state(s, cuda), spec, mesh), p
    gs = _state(spec.settings, cuda, 21)
    if case == "many":
        g = torch.Generator(device=cuda).manual_seed(4)
        kick = (torch.rand(gs.vel_x.shape, generator=g, device=cuda)
                - 0.5) * 600.0
        gs = dataclasses.replace(gs, vel_x=kick, vel_y=kick.flip(2))
    sgs = shard_grid_state(gs, spec, mesh)
    if case == "wrap":
        near = (gs.pos_x.abs() > 3.0) & (gs.pos_x < fused.SENTINEL_HALF)
        gs = dataclasses.replace(gs, vel_x=torch.where(
            near, torch.sign(gs.pos_x) * 60.0, gs.vel_x))
        sgs = make_eager_sharded_resident_step(spec, mesh, x_boundary="wrap")(
            shard_grid_state(gs, spec, mesh), p)[0]
    return spec, mesh, sgs, p


@pytest.mark.parametrize("case", list(BAND_FAR_CASES))
def test_far_sharded_matches_plain(cuda, case):
    """csrc/far_sharded.cu against its plain versions on the kernel
    step's post-merge bands: the collect's packets and drop counts bitwise
    (where the psum'd count is not 0), the insert's grids, occ_row and
    lost bitwise on every band, and with no mover the bands, occ_row and
    lost untouched; one launch of each a band, counted either way."""
    from tpufluid_torch.ops import far_sharded as fs
    from tpufluid_torch.parallel import shard

    spec, mesh, sgs, p = _band_far_input(case, cuda)
    s, rloc, fcap = spec.settings, spec.rows_per_dev, spec.far_capacity
    d_n, dt = spec.n_devices, p.delta
    reb, band4, occ_band, n_lost = shard.rebin_and_merge(
        mesh, sgs.bands, [dt] * d_n, shard.band_shifts(spec, mesh), s)
    total = sum(r[5].sum() for r in reb).to(torch.int32)
    n_far = int(total)
    before = dict(fs.LAUNCHES)
    got = [fs.far_collect(b.pos_x, b.pos_y, b.vel_x, b.vel_y, b.occ_row,
                          reb[d][5][1:rloc + 1], total, dt, s, d * rloc,
                          fcap) for d, b in enumerate(sgs.bands)]
    want = [fs.far_packet_plain(b.pos_x, b.pos_y, b.vel_x, b.vel_y, dt, s,
                                d * rloc, fcap)
            for d, b in enumerate(sgs.bands)]
    if n_far:
        for g, w in zip(got, want):
            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    allp = torch.cat([g[0] for g in got])
    allp_plain = torch.cat([w[0] for w in want])
    mine = []
    for d in range(d_n):
        kg4, kocc, klost = fs.far_insert(
            tuple(a.clone() for a in band4[d]), occ_band[d].clone(),
            n_lost[d].clone(), allp, total, got[d][1], dt, s, d * rloc)
        pg4, pocc, pdrop = fs.insert_far_plain(band4[d], allp_plain, dt, s,
                                               d * rloc)
        for a, b in zip((*kg4, kocc, klost),
                        (*pg4, pocc, n_lost[d] + pdrop + want[d][1])):
            assert torch.equal(a, b), (d, case)
        if n_far == 0:
            for a, b in zip((*kg4, kocc, klost),
                            (*band4[d], occ_band[d], n_lost[d])):
                assert torch.equal(a, b)
        _, gcy = fused._cells(*(allp_plain[:, i] for i in range(4)), dt, s)
        mine.append(int(((allp_plain[:, 4] > 0.5) & (gcy >= d * rloc)
                         & (gcy < (d + 1) * rloc)).sum()))
    assert fs.LAUNCHES == {n: before[n] + d_n for n in before}
    assert (n_far == 0) == (case == "none")
    if case == "over":
        assert sum(int(w[1]) for w in want) > 0
    if case == "wrap":
        assert n_far >= 20
    if case == "many":
        assert max(mine) > 16384


def _sharded_states(s, cuda, d, seed):
    from tpufluid_torch.parallel import (
        build_resident_spec, make_resident_mesh, shard_grid_state)

    spec = build_resident_spec(s, d)
    mesh = make_resident_mesh(spec, [cuda] * d)
    return spec, mesh, shard_grid_state(_state(s, cuda, seed), spec, mesh)


@pytest.mark.parametrize("d,has_ff", [(2, False), (4, True)])
def test_graphed_sharded_step_matches_eager(cuda, d, has_ff):
    """``make_sharded_resident_step`` on ``[cuda] * d`` (a CUDA graph a
    call) against ``make_eager_sharded_resident_step``, bitwise over 6
    steps with far movers crossing bands (with a field: a new field from
    step 3, which refills the graph's static cells); one launch of each
    kernel a band a call; a result not overwritten by the next call; a
    replay under ``torch.cuda.set_sync_debug_mode("error")``; one
    capture."""
    from tpufluid_torch import graphs
    from tpufluid_torch.ops import far_sharded as fs
    from tpufluid_torch.parallel import (
        make_eager_sharded_resident_step, make_sharded_resident_step,
        unshard_grid_state)

    s = tt.SimSettings(particle_count=2048, size=(8.0, 8.0),
                       cell_capacity=8, texture_size=(72, 72))
    spec, mesh, sgs = _sharded_states(s, cuda, d, 21)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    g = torch.Generator().manual_seed(5)
    fields = [((torch.rand((72, 72, 2), generator=g) - 0.5).to(cuda),)
              for _ in range(2)] if has_ff else [(), ()]
    kstep = make_sharded_resident_step(spec, mesh, has_force_field=has_ff)
    estep = make_eager_sharded_resident_step(spec, mesh,
                                             has_force_field=has_ff)
    assert kstep.graphed and not estep.graphed
    n0 = len(graphs.CAPTURES)
    fields_ = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")
    for i in range(6):
        extra = fields[i // 3]
        before = {**fused.LAUNCHES, **fs.LAUNCHES}
        a, ast = kstep(sgs, p, *extra)
        torch.cuda.synchronize()
        after = {**fused.LAUNCHES, **fs.LAUNCHES}
        for n in ("rebin_row_shift", "density", "forces_integrate",
                  "far_collect", "far_insert"):
            assert after[n] == before[n] + d, (i, n)
        b, bst = estep(sgs, p, *extra)
        ag, bg = unshard_grid_state(a), unshard_grid_state(b)
        for f in fields_:
            assert torch.equal(getattr(ag, f), getattr(bg, f)), (i, f)
        assert torch.equal(ast["n_valid"], bst["n_valid"])
        kept = [getattr(ag, f).clone() for f in fields_]
        nxt = kstep(a, p, *extra)[0]
        ag = unshard_grid_state(a)
        for f, k in zip(fields_, kept):
            assert torch.equal(getattr(ag, f), k), (i, f)
        assert int(nxt.tick) == int(a.tick) + 1
        sgs = a
    assert len(graphs.CAPTURES) == n0 + 1
    want = estep(sgs, p, *fields[1])[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kstep(sgs, p, *fields[1])[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for f in fields_:
        assert torch.equal(getattr(unshard_grid_state(got), f),
                           getattr(unshard_grid_state(want), f)), f


def test_audit_of_graphed_sharded_step(cuda):
    """``comm_audit.audit_step`` on a graphed row-band step, around its
    first call (eager, then the capture) and around a replay: one step's
    collectives both times, the formula's bytes; the same for a graphed
    slab step against its eager twin."""
    from tpufluid_torch.parallel import (
        build_shard_spec, comm_audit, init_sharded, make_eager_sharded_step,
        make_mesh, make_sharded_resident_step, make_sharded_step)

    s = tt.SimSettings(particle_count=2048, size=(8.0, 8.0),
                       cell_capacity=8)
    spec, mesh, sgs = _sharded_states(s, cuda, 4, 8)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    step = make_sharded_resident_step(spec, mesh)
    model = comm_audit.resident_comm_formula(spec)
    for _ in range(2):  # capture, then replay
        audit = comm_audit.audit_step(step, sgs, p)
        assert audit["ppermute_bytes_per_dir"] == model["bytes_per_dir"]
        assert audit["all_gather_bytes_conditional"] == \
            model["far_packet_bytes"]
    sspec = build_shard_spec(s, 2)
    smesh = make_mesh(sspec, [cuda] * 2)
    st = init_sharded(sspec, smesh)
    want = comm_audit.audit_step(make_eager_sharded_step(sspec, smesh), st, p)
    kstep = make_sharded_step(sspec, smesh)
    for _ in range(2):
        got = comm_audit.audit_step(kstep, st, p)
        assert got["ppermute_bytes_per_dir"] == \
            want["ppermute_bytes_per_dir"] > 0
        assert [o.shape for o in got["ops"]] == [o.shape for o in want["ops"]]


@pytest.mark.parametrize("mode", ["grid", "dense", "pallas"])
def test_graphed_slab_step_matches_eager(cuda, mode):
    """``make_sharded_step`` on ``[cuda] * 2`` (a CUDA graph a call)
    against ``make_eager_sharded_step``, bitwise over 4 steps with debug
    stats, the field swapped after 2 (the static copy refilled), and one
    replay under sync debug "error"."""
    from tpufluid_torch.parallel import (
        build_shard_spec, init_sharded, make_eager_sharded_step, make_mesh,
        make_sharded_step)

    s = tt.SimSettings(particle_count=512, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(4.0, 8.0),
                       cell_capacity=8, texture_size=(72, 72))
    spec = build_shard_spec(s, 2)
    mesh = make_mesh(spec, [cuda] * 2)
    p = tt.TickParams.default(cuda, gravity=(0.0, -9.8))
    g = torch.Generator().manual_seed(6)
    fields = [(torch.rand((72, 72, 2), generator=g) - 0.5).to(cuda)
              for _ in range(2)]
    kw = dict(neighbor_mode=mode, debug=True, has_force_field=True)
    kstep = make_sharded_step(spec, mesh, **kw)
    estep = make_eager_sharded_step(spec, mesh, **kw)
    assert kstep.graphed and not estep.graphed
    a = b = init_sharded(spec, mesh)
    for i in range(5):
        if i < 4:
            a, ast = kstep(a, p, fields[i // 2])
        else:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                a, ast = kstep(a, p, fields[1])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        b, bst = estep(b, p, fields[min(i // 2, 1)])
        for x, y in zip(a.slabs, b.slabs):
            for f in ("position", "velocity", "valid", "tick"):
                assert torch.equal(getattr(x, f), getattr(y, f)), (i, f)
        assert ast.keys() == bst.keys()
        for k in ast:
            assert torch.equal(ast[k], bst[k]), (i, k)


def test_app_run_syncs_only_in_the_audit(cuda):
    """FluidApp.run(512) at a small resident scene under
    ``torch.cuda.set_sync_debug_mode("error")``: the only host syncs are
    the loss audit's reads (its two calls run with the mode lifted), and
    the step timer's rate appears from its CUDA events without a sync."""
    import time

    from tpufluid_torch.app import FluidApp

    s = tt.SimSettings(particle_count=3000, size=(9.0, 8.0), cell_capacity=8)
    app = FluidApp(s, device=cuda, neighbor_mode="resident")
    app.run(64)  # captures the burst
    torch.cuda.synchronize()
    audits = []
    audit = app._audit_loss

    def lifted():
        torch.cuda.set_sync_debug_mode(0)
        try:
            audit()
        finally:
            torch.cuda.set_sync_debug_mode("error")
        audits.append(app.grid_state.tick)

    app._audit_loss = lifted
    torch.cuda.set_sync_debug_mode("error")
    try:
        app.run(512)
        deadline = time.perf_counter() + 30.0
        while app.timer.last_rate == 0.0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        rate = app.timer.last_rate
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(audits) == 2
    assert rate > 0.0
    assert int(app.grid_state.tick) == 576
