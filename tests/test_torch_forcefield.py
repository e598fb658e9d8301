"""PyTorch port, obstacles (ops.forcefield, resident.forcefield_cells and
the has_ff variant of fused.forces_integrate) against the JAX package on
the CPU, on the same numpy inputs.

The mask, the jump flood and the per-cell field samples are integer or
boolean results of the same f32 arithmetic and are held bitwise. The
has_ff forces step and the synced resident steps are held to BASELINE.md's
per-step bounds (|dpos| <= 4.8e-7, |dvel| <= 3.8e-5, relative where the
value exceeds 1) on live slots, with occupancy, lost and the slot layout
bitwise. A short FluidApp run is held to the golden trajectory tolerances
(tests/test_golden.py: position rtol/atol 1e-5, velocity rtol 1e-4 /
atol 1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.app import FluidApp as JFluidApp
from tpufluid.ops import forcefield as jff
from tpufluid.ops import resident as jresident
from tpufluid.ops.pallas import fused as jfused
from tpufluid.state import ParticleState as JParticleState

from tpufluid_torch import interop
from tpufluid_torch.app import FluidApp
from tpufluid_torch.ops import forcefield as tff
from tpufluid_torch.ops import fused as tfused
from tpufluid_torch.ops import resident as tresident


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them and each
    small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POS_TOL, VEL_TOL = 4.8e-7, 3.8e-5
GRID_FIELDS = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")
OBJECTS = [("circle", (0.3, -0.4), 0.7), ("rect", (-1.2, 0.9), (1.1, 0.5), 0.6),
           ("circle", (1.5, 1.4), 0.35)]


def _settings(**kw):
    # texture 72 over a 4.8 world: every cell centre samples the field 0.5
    # texel from a texel edge (at 64, every third centre lies on an edge,
    # where the jitted JAX step and eager code may truncate apart)
    base = dict(particle_count=600, size=(4.8, 4.8), texture_size=(72, 72),
                cell_capacity=8)
    base.update(kw)
    return tpufluid.SimSettings(**base)


def _bitwise(got, want, what=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype.itemsize == want.dtype.itemsize, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _within(got, want, bound, mask, what):
    got = got.cpu().numpy()[mask]
    want = np.asarray(want)[mask]
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= bound, f"{what}: max rel err {err.max()} > {bound}"


def _objects(objs=OBJECTS):
    jo = jff.Objects.from_list(objs)
    return jo, interop.objects_from(jo, "cpu")


@pytest.mark.parametrize("which", ["circle", "rect", "all"])
def test_point_in_objects_bitwise(which):
    objs = {"circle": OBJECTS[:1], "rect": OBJECTS[1:2], "all": OBJECTS}[which]
    jo, to = _objects(objs)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2.4, 2.4, (40, 50, 2)).astype(np.float32)
    want = np.asarray(jff.point_in_objects(jnp.asarray(pts), jo))
    got = tff.point_in_objects(torch.from_numpy(pts), to)
    _bitwise(got, want, which)
    assert 0 < want.sum() < want.size


def test_objects_from_list_and_empty():
    to = tff.Objects.from_list(OBJECTS, "cpu")
    jo = jff.Objects.from_list(OBJECTS)
    for f in ("kind", "position", "radius", "extents", "rotation"):
        _bitwise(getattr(to, f), getattr(jo, f), f)
    empty = tff.Objects.empty("cpu")
    assert len(empty) == 0
    assert not tff.point_in_objects(torch.zeros(3, 2), empty).any()
    with pytest.raises(ValueError):
        tff.Objects.from_list([("triangle", (0, 0), 1)], "cpu")


@pytest.mark.parametrize("tex", [(72, 72), (48, 40)])
def test_rasterize_outside_mask_bitwise(tex):
    s = _settings(texture_size=tex)
    jo, to = _objects()
    want = np.asarray(jff.rasterize_outside_mask(jo, s))
    got = tff.rasterize_outside_mask(to, interop.settings_from(s))
    assert got.shape == (tex[1], tex[0])
    _bitwise(got, want)


@pytest.mark.parametrize("dy,dx", [(0, 1), (-3, 2), (5, -7), (40, 0)])
def test_shift2d_bitwise(dy, dx):
    a = np.arange(12 * 9 * 2, dtype=np.int32).reshape(12, 9, 2)
    _bitwise(tff.shift2d(torch.from_numpy(a), dy, dx, -1),
             jff.shift2d(jnp.asarray(a), dy, dx, -1))


@pytest.mark.parametrize("case", ["objects", "scatter", "border_seeds"])
def test_jump_flood_field_bitwise(case):
    if case == "objects":
        jo, _ = _objects()
        mask = np.array(jff.rasterize_outside_mask(jo, _settings()))
    elif case == "scatter":  # integer seeds scattered over a 37x53 image
        mask = np.random.default_rng(11).uniform(size=(37, 53)) < 0.01
    else:  # nothing outside: the image border seeds the flood
        mask = np.zeros((30, 44), bool)
    want = np.asarray(jax.jit(jff.jump_flood_field)(jnp.asarray(mask)))
    got = tff.jump_flood_field(torch.from_numpy(mask))
    _bitwise(got, want, case)
    assert np.abs(want).max() > 0


def test_obstacle_force_field_and_cells_bitwise():
    s = _settings()
    jo, to = _objects()
    ts = interop.settings_from(s)
    jfield = jff.obstacle_force_field(jo, s)
    tfield = tff.obstacle_force_field(to, ts)
    _bitwise(tfield, jfield, "field")
    want = jresident.forcefield_cells(jfield, s, n_rows=jresident._rows(s))
    got = tresident.forcefield_cells(tfield, ts)
    for g, w, n in zip(got, want, ("ffx", "ffy")):
        _bitwise(g, w, n)
        assert g.is_contiguous()
    assert (np.asarray(want[0]) != 0).sum() > 20


@pytest.mark.parametrize("row_start,n_rows", [(-2, 10), (5, 9), (20, 12)])
def test_forcefield_cells_row_window_bitwise(row_start, n_rows):
    """The row window of a sharded band (``gxp``, ``row_start``,
    ``n_rows``): a band's halo reaches past the first and last grid rows,
    where the ring mask is taken in global rows."""
    s = _settings()
    jo, to = _objects()
    ts = interop.settings_from(s)
    jfield = jff.obstacle_force_field(jo, s)
    tfield = tff.obstacle_force_field(to, ts)
    want = jresident.forcefield_cells(jfield, s, 128, row_start=row_start,
                                      n_rows=n_rows)
    got = tresident.forcefield_cells(tfield, ts, 128, row_start=row_start,
                                     n_rows=n_rows)
    for g, w, n in zip(got, want, ("ffx", "ffy")):
        assert g.shape == (n_rows, 128)
        _bitwise(g, w, n)
    # the window is the matching rows of the whole grid's samples
    whole = tresident.forcefield_cells(tfield, ts, 128, row_start=-2,
                                       n_rows=40)
    for g, w in zip(got, whole):
        assert torch.equal(g, w[row_start + 2:row_start + 2 + n_rows])


_jdensity = jax.jit(
    lambda px, py, vx, vy, occ, p, s: jfused.density(
        px, py, vx, vy, occ, p.mass, p.delta, p.pressure_constant,
        p.rest_density, s), static_argnums=(6,))
_jforces_ff = jax.jit(
    lambda px, py, vx, vy, pres, invr, occ, p, frame, ffc, s:
    jfused.forces_integrate(px, py, vx, vy, pres, invr, occ, p, s, frame,
                            ff_cells=ffc), static_argnums=(10,))


@functools.lru_cache(maxsize=None)
def _scene():
    """(settings, JAX GridState, params, field): 600 particles in cells
    under and around the obstacles, with random velocities."""
    s = _settings()
    rng = np.random.default_rng(21)
    h, half = 0.2, 2.4
    cells = rng.integers(3, 22, (600, 2))
    pos = (((cells - 1) + rng.uniform(0.05, 0.95, (600, 2))) * h
           - half).astype(np.float32)
    vel = (rng.normal(size=pos.shape) * 2.0).astype(np.float32)
    st = JParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.zeros(600),
        cell=jnp.zeros(600, jnp.uint32), tick=jnp.asarray(9, jnp.uint32))
    gs = jresident.from_particles(st, s)
    jo, _ = _objects()
    field = jff.obstacle_force_field(jo, s)
    return s, gs, tpufluid.TickParams.default(gravity=(0.0, -9.8)), field


def test_forces_integrate_has_ff_matches_jax():
    s, gs, p, field = _scene()
    ffc = jresident.forcefield_cells(field, s, n_rows=jresident._rows(s))
    frame = gs.tick + 1
    pres, invr = _jdensity(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                           gs.occ_row, p, s)
    want = _jforces_ff(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, pres, invr,
                       gs.occ_row, p, frame, ffc, s)
    base = _jforces_ff(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, pres, invr,
                       gs.occ_row, p, frame, None, s)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfused.forces_integrate(
        tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, t(pres), t(invr), tg.occ_row,
        interop.tick_params_from_numpy(p, "cpu"), interop.settings_from(s),
        torch.tensor(int(frame)), ff_cells=(t(ffc[0]), t(ffc[1])))
    live = np.asarray(gs.pos_x) < jfused.SENTINEL_HALF
    for g, w, n, tol in zip(got, want, ["pos_x", "pos_y", "vel_x", "vel_y"],
                            [POS_TOL, POS_TOL, VEL_TOL, VEL_TOL]):
        _within(g, w, tol, live, n)
        _bitwise(g[torch.from_numpy(~live)], np.asarray(w)[~live], n + " dead")
    # the obstacles pushed some particles
    pushed = live & (np.asarray(want[0]) != np.asarray(base[0]))
    assert pushed.sum() > 10


def test_synced_obstacle_steps_match_jax():
    s, jgs, jp, field = _scene()
    ts = interop.settings_from(s)
    tp = interop.tick_params_from_numpy(jp, "cpu")
    tfield = interop.forcefield_from_numpy(field, "cpu")
    jstep = jresident.make_grid_step(s, has_force_field=True)
    tstep = tresident.make_grid_step(ts, has_force_field=True)
    with pytest.raises(ValueError, match="forcefield"):
        tstep(interop.grid_state_from_numpy(jgs, "cpu"), tp)
    for i in range(2):
        tgs = tstep(interop.grid_state_from_numpy(jgs, "cpu"), tp, tfield)
        jgs = jax.block_until_ready(jstep(jgs, jp, field))
        assert int(tgs.tick) == int(jgs.tick)
        for f in ("occ_row", "lost"):
            _bitwise(getattr(tgs, f), getattr(jgs, f), f"step {i} {f}")
        live = np.asarray(jresident.valid_mask(jgs))
        _bitwise(tresident.valid_mask(tgs), live, f"step {i} layout")
        for f, tol in (("pos_x", POS_TOL), ("pos_y", POS_TOL),
                       ("vel_x", VEL_TOL), ("vel_y", VEL_TOL)):
            _within(getattr(tgs, f), getattr(jgs, f), tol, live,
                    f"step {i} {f}")
    # the multi-step runner takes the field too
    g0 = interop.grid_state_from_numpy(jgs, "cpu")
    a = tresident.make_grid_multi_step(ts, 2, has_force_field=True)(
        g0, tp, tfield)
    b = tstep(tstep(g0, tp, tfield), tp, tfield)
    for f in GRID_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))


def _inside(pos, cx, cy, r):
    d = np.hypot(pos[:, 0] - cx, pos[:, 1] - cy)
    return int((d < r).sum())


def test_fluid_app_objects_match_jax_and_push_out():
    """600 particles spawn on a circle obstacle and both apps push them
    out. After one tick the states agree to the golden tolerances; over
    the next ticks the push packs particles into near-coincident pairs,
    whose force direction turns ulp differences into visible ones, so
    from there the apps are held to the same push-out (the count left
    inside) and the same loss count. The JAX app ticks one step at a time:
    its step is the one the synced test above compiled already."""
    s = _settings()
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    objs = [("circle", (0.0, 0.0), 0.5)]
    japp = JFluidApp(s, jp, jff.Objects.from_list(objs),
                     neighbor_mode="resident")
    tapp = FluidApp(interop.settings_from(s),
                    interop.tick_params_from_numpy(jp, "cpu"),
                    tff.Objects.from_list(objs, "cpu"), device="cpu",
                    neighbor_mode="resident")
    free = FluidApp(interop.settings_from(s),
                    interop.tick_params_from_numpy(jp, "cpu"), device="cpu",
                    neighbor_mode="resident")
    before = _inside(tapp.state.position.numpy(), 0.0, 0.0, 0.3)
    japp.tick()
    tapp.tick()
    jstate = japp.state
    np.testing.assert_allclose(tapp.state.position.numpy(),
                               np.asarray(jstate.position), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tapp.state.velocity.numpy(),
                               np.asarray(jstate.velocity), rtol=1e-4,
                               atol=1e-3)
    for _ in range(3):
        japp.tick()
    tapp.run(3)
    free.run(4)
    # the push can pack a boundary cell past K=8: counted alike
    assert (tapp.metrics()["lost_particles"]
            == japp.metrics()["lost_particles"])
    # the obstacle emptied its interior; without it the fluid stays there
    inside = _inside(tapp.state.position.numpy(), 0.0, 0.0, 0.3)
    assert inside == _inside(np.asarray(japp.state.position), 0.0, 0.0, 0.3)
    inside_free = _inside(free.state.position.numpy(), 0.0, 0.0, 0.3)
    assert before > 20 and inside_free > 20
    assert inside < inside_free // 4
    # removing the obstacles rebuilds the base step
    tapp.set_objects(tff.Objects.empty("cpu"))
    tapp.run(1)
    assert tapp.metrics()["tick"] == 5
    # a video field (tests/test_torch_video.py) turns the field back on
    tapp.set_video_field(np.full((1, 72, 72), 255, np.uint8))
    tapp.run(1)
    assert tapp.metrics()["tick"] == 6
    with pytest.raises(ValueError):
        tapp.set_video_field(np.zeros((1, 64, 64), np.uint8))
