"""PyTorch port, the resident engine's variant flags, batched world stacks
and fused physics pass (ops.fused, ops.resident, models.batch_scenes)
against the JAX package on the CPU (its Pallas kernels in interpret mode).

Kernels: rebin is held bitwise; density and forces to BASELINE.md's
per-step bounds on live slots, relative where the value exceeds 1
(|drho| <= 9.2e-5, |dpos| <= 4.8e-7, |dvel| <= 3.8e-5), with dead slots
exact. Velocities are compared as the step's increment, the new velocity
minus the old, which is f dt / rho plus gravity: the bound is the one the
per-step velocity bound sets on it. Within the port, physics_plain is by
definition density_plain then forces_integrate_plain, and batched steps
equal single-world steps bitwise.

The variant scene has h = 1.5: the colour-field gradient takes the unit
direction as its radius (compute.wgsl:303-498, as the JAX kernel does), so
surface tension acts only where h exceeds 1. Its mass of 64 lifts the
densities above the adaptive strides' 150 and 200, and particles at the x
walls move out, so wrap teleports them. Every predicted coordinate sits at
least 0.05 h from a cell edge (XLA contracts FMAs on the CPU).
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.models import scenes as jscenes
from tpufluid.ops import resident as jresident
from tpufluid.ops.pallas import fused as jfused
from tpufluid.state import ParticleState as JParticleState

import tpufluid_torch as tt
from tpufluid_torch import interop
from tpufluid_torch.models import scenes as tscenes
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


POS_TOL, VEL_TOL, RHO_TOL = 4.8e-7, 3.8e-5, 9.2e-5
DT = np.float32(1.0 / 120.0)
GRID_FIELDS = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")
# the resident engine's variant flag sets
FLAG_SETS = {
    "wrap": dict(x_boundary="wrap"),
    "surface_tension": dict(surface_tension=True),
    "adaptive": dict(adaptive_subsampling=True),
    "all": dict(x_boundary="wrap", surface_tension=True,
                adaptive_subsampling=True),
}


def _points_in_cells(rng, cells, n, h, half):
    """n positions inside the given interior cells, each coordinate
    0.05..0.95 of the way across its cell."""
    c = cells[rng.integers(0, len(cells), n)]
    u = rng.uniform(0.05, 0.95, (n, 2))
    return (((c - 1) + u) * h - half).astype(np.float32)


def _region(x0, x1, y0, y1):
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    return np.stack([xs.ravel(), ys.ravel()], axis=1)


def _jstate(pos, vel, tick):
    n = len(pos)
    return JParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.zeros(n),
        cell=jnp.zeros(n, jnp.uint32), tick=jnp.asarray(tick, jnp.uint32))


@functools.lru_cache(maxsize=None)
def scene(name="variants"):
    """(JAX settings, GridState, TickParams, frame). ``variants``: h 1.5,
    24 x 24, K=16: a dense block (densities up to ~250 at mass 64), a
    coincident triple, and wall movers in both directions. ``small``:
    h 0.2, 4.8 x 4.8, K=8, the same features at rest density. ``k64``:
    h 0.2, 4.8 x 2.4, K=64, the same features with ~19 particles a cell
    over a block of 8 x 4 cells (up to ~30), so that each target meets
    a few hundred candidates."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "variants":
        h, size, k, n = 1.5, (24.0, 24.0), 16, 300
        cells = _region(5, 12, 5, 12)
        params = dict(mass=64.0, surface_tension_threshold=0.05,
                      surface_tension_coefficient=5.0)
    elif name == "k64":
        h, size, k, n = 0.2, (4.8, 2.4), 64, 600
        cells = _region(9, 17, 4, 8)
        params = {}
    else:
        h, size, k, n = 0.2, (4.8, 4.8), 8, 400
        cells = _region(3, 23, 3, 23)
        params = {}
    half = np.asarray(size, np.float64) / 2
    grid_h = int(size[1] / h) + 2
    pred = _points_in_cells(rng, cells, n, h, half)
    vel = (rng.normal(size=pred.shape) * 2.0).astype(np.float32)
    pred[1:3], vel[1:3] = pred[0], vel[0]  # coincident triple
    # wall movers: predicted at the wall (clamped), moving out
    rows = rng.integers(3, grid_h - 3, 8)
    pred[3:11, 1] = _points_in_cells(
        rng, np.stack([rows, rows], axis=1), 8, h, half)[:, 1]
    pred[3:11, 0] = np.where(np.arange(8) % 2 == 0, half[0], -half[0])
    vel[3:11, 0] = np.where(np.arange(8) % 2 == 0, 6.0, -6.0)
    pos = (pred - vel * DT).astype(np.float32)
    pos[3:11, 0] = pred[3:11, 0] - np.sign(pred[3:11, 0]) * 0.01
    settings = tpufluid.SimSettings(
        particle_count=n, particle_spacing=h / 2, smoothing_radius=h,
        size=size, cell_capacity=k)
    gs = jresident.from_particles(_jstate(pos, vel, 41), settings)
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8), **params)
    return settings, gs, jp, gs.tick + 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _within(got, want, bound, mask, what):
    got = got.cpu().numpy()[mask]
    want = np.asarray(want)[mask]
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= bound, f"{what}: max rel err {err.max()} > {bound}"


def _bitwise(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _check_new_state(got, want, vel0, live, what):
    """pos within the position bound, the velocity increment within the
    velocity bound, dead slots exact."""
    for i, (g, w, n) in enumerate(zip(got, want, ("pos_x", "pos_y", "vel_x",
                                                  "vel_y"))):
        if i < 2:
            _within(g, w, POS_TOL, live, f"{what} {n}")
        else:
            v0 = np.asarray(vel0[i - 2])
            _within(g - _t(v0), np.asarray(w) - v0, VEL_TOL, live,
                    f"{what} {n} increment")
        _bitwise(g[torch.from_numpy(~live)], np.asarray(w)[~live],
                 f"{what} {n} dead")


@functools.lru_cache(maxsize=None)
def _jax_density(name):
    s, gs, p, _ = scene(name)
    return jax.jit(
        lambda px, py, vx, vy, occ, p: jfused.density(
            px, py, vx, vy, occ, p.mass, p.delta, p.pressure_constant,
            p.rest_density, s))(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                                gs.occ_row, p)


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_forces_integrate_variants_match_jax(flags):
    kw = FLAG_SETS[flags]
    s, gs, p, frame = scene()
    pres, invr = _jax_density("variants")
    fn = jax.jit(lambda px, py, vx, vy, pr, ir, occ, p, fr, **k:
                 jfused.forces_integrate(px, py, vx, vy, pr, ir, occ, p, s,
                                         fr, **k), static_argnames=tuple(kw))
    args = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, pres, invr, gs.occ_row,
            p, frame)
    want = fn(*args, **kw)
    base = fn(*args)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    targs = (tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, _t(pres), _t(invr),
             tg.occ_row, interop.tick_params_from_numpy(p, "cpu"),
             interop.settings_from(s), torch.tensor(int(frame)))
    got = tfused.forces_integrate(*targs, **kw)
    live = np.asarray(gs.pos_x) < jfused.SENTINEL_HALF
    _check_new_state(got, want, (gs.vel_x, gs.vel_y), live, flags)
    # each flag of the set acts on this scene
    for flag, changed in (
            ("x_boundary", np.asarray(want[0]) * np.asarray(base[0]) < 0),
            ("surface_tension", np.asarray(want[2]) != np.asarray(base[2])),
            ("adaptive_subsampling",
             np.asarray(want[2]) != np.asarray(base[2]))):
        if flag in kw:
            assert (changed & live).sum() > 0, flag
    rho = 1.0 / np.asarray(invr)[live]
    assert (rho >= 200.0).sum() > 0 and ((rho >= 150.0) & (rho < 200.0)).any()


def _stack(name, n_worlds):
    """A 3-world stack of the small scene, each world's velocities shifted
    by its own offset, with per-world gravity and viscosity."""
    s, gs, p, frame = scene(name)
    rows = gs.pos_x.shape[0]
    vx, vy = np.asarray(gs.vel_x), np.asarray(gs.vel_y)
    live = np.asarray(gs.pos_x) < jfused.SENTINEL_HALF
    stack = {}
    for f in ("pos_x", "pos_y"):
        stack[f] = np.tile(np.asarray(getattr(gs, f)), (n_worlds, 1, 1))
    stack["vel_x"] = np.concatenate(
        [np.where(live, vx * (1.0 + 0.1 * w), 0.0) for w in range(n_worlds)]
    ).astype(np.float32)
    stack["vel_y"] = np.tile(vy, (n_worlds, 1, 1))
    stack["occ_row"] = np.tile(np.asarray(gs.occ_row), n_worlds)
    plist = [tpufluid.TickParams.default(gravity=(0.5 * w, -4.9 * w),
                                         viscosity_coefficient=10.0 + 5 * w)
             for w in range(n_worlds)]
    wid = np.repeat(np.arange(n_worlds, dtype=np.int32), rows)
    return s, stack, jresident.batched_params(plist), frame, wid, rows


def test_batched_kernels_match_jax():
    s, g, jp, frame, wid, rows = _stack("small", 3)
    shift = -(wid * rows)
    ts = interop.settings_from(s)
    tp = interop.tick_params_from_numpy(jp, "cpu")
    tg = {k: _t(v) for k, v in g.items()}
    names = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row")
    jin = [jnp.asarray(g[n]) for n in names]

    want = jax.jit(lambda *a: jfused.rebin(*a, jp.delta, s,
                                           row_shift=shift))(*jin)
    got = tfused.rebin(*(tg[n] for n in names), tp.delta, ts,
                       row_shift=torch.from_numpy(shift))
    for a, b, n in zip(got, want, names + ("far_n", "over_n")):
        _bitwise(a, b, f"rebin {n}")
    assert np.asarray(want[4]).reshape(3, rows).max(axis=1).min() > 0
    # no row_shift: each world's slots would land in world 0's rows
    plain = tfused.rebin(*(tg[n] for n in names), tp.delta, ts)
    assert not torch.equal(plain[4], got[4])

    px, py, vx, vy, occ = (np.asarray(a) for a in want[:5])
    jw = jnp.asarray(wid)
    pres, invr = jax.jit(lambda *a: jfused.density(
        *a, jp.mass, jp.delta, jp.pressure_constant, jp.rest_density, s,
        wid=jw))(px, py, vx, vy, occ)
    tw = torch.from_numpy(wid)
    tpres, tinvr = tfused.density(
        _t(px), _t(py), _t(vx), _t(vy), _t(occ), tp.mass, tp.delta,
        tp.pressure_constant, tp.rest_density, ts, wid=tw)
    live = px < jfused.SENTINEL_HALF
    _within(1.0 / tinvr, 1.0 / np.asarray(invr), RHO_TOL, live, "rho")
    _within(tpres, pres, RHO_TOL, live, "pres")

    new = jax.jit(lambda *a: jfused.forces_integrate(
        *a, jp, s, frame, wid=jw))(px, py, vx, vy, pres, invr, occ)
    tnew = tfused.forces_integrate(
        _t(px), _t(py), _t(vx), _t(vy), _t(pres), _t(invr), _t(occ), tp, ts,
        torch.tensor(int(frame)), wid=tw)
    _check_new_state(tnew, new, (vx, vy), live, "batched forces")
    # the worlds' gravities differ: the same slot moves differently
    vy1 = tnew[3].numpy()
    assert not np.array_equal(vy1[:rows], vy1[rows:2 * rows])


@pytest.mark.parametrize("flags", ["base", "has_ff", "wrap_st_adaptive",
                                   "st"])
def test_physics_matches_jax_and_split(flags):
    """The four flag sets of tests/test_resident.py's physics test, on the
    small scene (h 0.2, as there)."""
    s, gs, p, frame = scene("small")
    kw = dict(base={}, has_ff={}, st=dict(surface_tension=True),
              wrap_st_adaptive=FLAG_SETS["all"])[flags]
    tg = interop.grid_state_from_numpy(gs, "cpu")
    ts = interop.settings_from(s)
    tp = interop.tick_params_from_numpy(p, "cpu")
    gy, _, gxp = tg.pos_x.shape
    ff = None
    if flags == "has_ff":  # a push-out band over the dense block
        rng = np.random.default_rng(7)
        f = np.zeros((2, gy, gxp), np.float32)
        f[:, 8:12, 6:14] = rng.normal(size=(2, 4, 8)) * 3.0
        ff = tuple(_t(a) for a in f)
        kw = dict(ff_cells=ff)
    jkw = dict(kw)
    if ff is not None:
        jkw["ff_cells"] = tuple(jnp.asarray(a.numpy()) for a in ff)
    want = jax.jit(lambda px, py, vx, vy, occ, p, fr: jfused.physics(
        px, py, vx, vy, occ, p, s, fr, rows_per_program=1, **jkw))(
        gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, p, frame)
    targs = (tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, tg.occ_row, tp, ts,
             torch.tensor(int(frame)))
    got = tfused.physics(*targs, **kw)
    live = np.asarray(gs.pos_x) < jfused.SENTINEL_HALF
    _check_new_state(got, want, (gs.vel_x, gs.vel_y), live, flags)
    pres, invr = tfused.density_plain(
        tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, tg.occ_row, tp.mass,
        tp.delta, tp.pressure_constant, tp.rest_density, ts)
    split = tfused.forces_integrate_plain(
        tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, pres, invr, tg.occ_row, tp,
        ts, torch.tensor(int(frame)), **kw)
    for a, b in zip(got, split):
        assert torch.equal(a, b)


def test_physics_matches_jax_k64():
    """physics at K=64 against the JAX kernel (one row a program), on a
    block of cells holding ~19 particles each, with the three variant
    flags: the capacity at which the card kernel's tiles shrink and its
    ring density weighs most."""
    s, gs, p, frame = scene("k64")
    kw = FLAG_SETS["all"]
    want = jax.jit(lambda px, py, vx, vy, occ, p, fr: jfused.physics(
        px, py, vx, vy, occ, p, s, fr, rows_per_program=1, **kw))(
        gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, p, frame)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    got = tfused.physics(tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, tg.occ_row,
                         interop.tick_params_from_numpy(p, "cpu"),
                         interop.settings_from(s), torch.tensor(int(frame)),
                         **kw)
    live = np.asarray(gs.pos_x) < jfused.SENTINEL_HALF
    _check_new_state(got, want, (gs.vel_x, gs.vel_y), live, "k64")
    occ = np.asarray(gs.occ_row)
    assert gs.pos_x.shape[1] == 64 and 20 <= occ.max() < 64


# ------------------------------------------- ports of the resident tests

def _wrap_settings():
    return tt.SimSettings(particle_count=4, particle_spacing=0.1,
                          smoothing_radius=0.2, size=(6.0, 6.0),
                          cell_capacity=8)


def test_resident_wrap_boundary():
    """tests/test_resident.py::test_resident_wrap_boundary: x wrap
    teleports across the x walls with the velocity kept; the next step
    re-inserts the teleported particles through the far-mover path."""
    s = _wrap_settings()
    pos = torch.tensor([[2.95, 0.0], [-2.95, 0.5], [0.0, 1.0], [0.5, 1.5]])
    vel = torch.tensor([[30.0, 0.0], [-30.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
    st = tt.init_state(s, "cpu")
    st.position, st.predicted, st.velocity = pos, pos.clone(), vel
    gs = tresident.from_particles(st, s)
    step = tresident.make_grid_step(s, x_boundary="wrap")
    params = tt.TickParams.default("cpu", pressure_constant=0.0,
                                   viscosity_coefficient=0.0)
    gs = step(gs, params)
    ps, live = tresident.to_particles(gs, s)
    p, v = ps.position[:4].numpy(), ps.velocity[:4].numpy()
    assert int(live) == 4
    crossed = p[np.argsort(p[:, 1])][:2]  # the two movers, by y
    assert crossed[0, 0] < 0.0 < crossed[1, 0]  # teleported to far wall
    assert np.abs(v).max() == 30.0  # velocity untouched by the wrap
    before = step.far_steps
    gs = step(gs, params)
    assert step.far_steps == before + 1 and int(gs.lost) == 0
    assert int(tresident.to_particles(gs, s)[1]) == 4


def _batched_run(s, plist, n_steps, **kw):
    B = len(plist)
    gs = tresident.init_batched_grid_state(s, B, "cpu")
    step = tresident.make_grid_step(s, n_worlds=B, **kw)
    bp = tresident.batched_params(plist)
    for _ in range(n_steps):
        gs = step(gs, bp)
    return gs


def _single_runs_match(s, gs, plist, n_steps, **kw):
    rstep = tresident.make_grid_step(s, **kw)
    for w, p in enumerate(plist):
        ref = tresident.init_grid_state(s, "cpu")
        for _ in range(n_steps):
            ref = rstep(ref, p)
        got = tresident.world_state(gs, s, w)
        for f in GRID_FIELDS[:5]:
            assert torch.equal(getattr(got, f), getattr(ref, f)), (w, f)
        assert torch.equal(got.tick, ref.tick)


def test_batched_worlds_match_single_world_steps():
    """tests/test_resident.py::test_batched_worlds_match_single_world_steps:
    B worlds stacked along the rows step bitwise like B single runs."""
    s = tt.SimSettings(particle_count=128, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(6.0, 6.0), cell_capacity=8)
    plist = [tt.TickParams.default("cpu", gravity=(0.0, -g))
             for g in (0.0, 4.9, 9.8)]
    gs = _batched_run(s, plist, 4)
    assert gs.pos_x.shape == (3 * 32, 8, 128) and int(gs.lost) == 0
    _single_runs_match(s, gs, plist, 4)
    with pytest.raises(ValueError, match="delta"):
        tresident.batched_params([tt.TickParams.default("cpu"),
                                  tt.TickParams.default("cpu", delta=0.01)])


@pytest.mark.parametrize("variant", ["wrap", "surface_tension", "adaptive"])
def test_batched_worlds_variants_match_single_runs(variant):
    """tests/test_resident.py::test_batched_worlds_variants_match_single_runs
    on the port: each variant on a 3-world stack steps bitwise like three
    single-world runs with the same flags."""
    kw = FLAG_SETS[variant]
    s = tt.SimSettings(particle_count=96, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(5.0, 5.0), cell_capacity=8)
    extra = {}
    if variant == "surface_tension":
        extra = dict(surface_tension_threshold=0.05,
                     surface_tension_coefficient=5.0)
    plist = [tt.TickParams.default("cpu", gravity=(0.3 * w, -4.9 * w),
                                   **extra) for w in range(3)]
    gs = _batched_run(s, plist, 4, **kw)
    assert int(gs.lost) == 0
    _single_runs_match(s, gs, plist, 4, **kw)


def test_batched_world_stats_match_jax():
    s = tt.SimSettings(particle_count=128, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(6.0, 6.0), cell_capacity=8)
    plist = [tt.TickParams.default("cpu", gravity=(0.0, -g))
             for g in (0.0, 4.9, 9.8)]
    for gs in (tresident.init_batched_grid_state(s, 3, "cpu"),
               _batched_run(s, plist, 6)):
        jgs = jresident.GridState(**{
            k: jnp.asarray(v)
            for k, v in interop.grid_state_to_numpy(gs).items()})
        js = tpufluid.SimSettings(particle_count=128, size=(6.0, 6.0))
        assert (tresident.batched_world_stats(gs, s, 3)
                == jresident.batched_world_stats(jgs, js, 3))
    st = tresident.batched_world_stats(gs, s, 3)
    assert st["particles"] == [128] * 3
    assert st["rowmax_max"][2] >= st["rowmax_max"][0]


def test_batch_scenes_match_jax_vmap():
    """models.batch_scenes: the port steps each world in turn; JAX vmaps
    the step. Two steps of three worlds, per-step bounds."""
    n = 256
    js = tpufluid.SimSettings(particle_count=n, size=(3.2, 3.2))
    jscene = jscenes.Scene("tiny", js, tpufluid.TickParams.default())
    grav = [[0.0, 0.0], [0.0, -4.9], [1.0, -9.8]]
    visc = [10.0, 25.0, 40.0]
    jst, jparams, jstep = jscenes.batch_scenes(jscene, grav, visc)
    tscene = tscenes.Scene("tiny", interop.settings_from(js),
                           tt.TickParams.default("cpu"))
    tst, tparams, tstep = tscenes.batch_scenes(tscene, grav, visc)
    assert len(tst) == 3 and torch.equal(tparams.gravity,
                                         torch.tensor(grav))
    for i in range(2):
        want = jstep(jst, jparams)
        got = tstep(tst, tparams)
        for w in range(3):
            for f, tol in (("position", POS_TOL), ("velocity", VEL_TOL)):
                g = getattr(got[w], f).numpy()
                wv = np.asarray(getattr(want, f))[w]
                err = np.abs(g - wv) / np.maximum(1.0, np.abs(wv))
                assert err.max() <= tol, (i, w, f, err.max())
        # synced: both go on from the JAX states
        jst = want
        tst = [interop.particle_state_from_numpy(
            jax.tree.map(lambda a: a[w], want), "cpu") for w in range(3)]
