"""PyTorch port, the resident step's far-mover pass without its host gate
and the resident burst, against the JAX package on the CPU, on the same
numpy inputs.

On a CUDA device the port's resident step launches its far-mover pass
(csrc/far_reinsert.cu) every step and the kernel reads the gate, the
rebin's far-mover count, on the device; the JAX step branches on it with
``lax.cond``. Both rest on the pass giving the rebin's outputs unchanged
when there is no far mover, and on the rebin counting exactly the slots the
pass selects. So here the pass's plain version (``far_reinsert`` on the
CPU, which runs whatever the count) drives the step, synced against the
JAX step: with no far mover (the rebin's grids, occ_row and lost bitwise),
a few, more than ``far_capacity`` (the drops counted in ``lost``), under
``x_boundary="wrap"`` and on a two-world stack. Occupancy, the slot
layout, tick and lost are held bitwise, positions and the velocity
increment within BASELINE.md's per-step bounds (|dpos| <= 4.8e-7, |dvel|
<= 3.8e-5, relative where the value exceeds 1). The burst on the CPU (a
Python loop; a CUDA graph on the card, held bitwise to this loop there) is
held to the JAX package's ``make_grid_multi_step`` across a swap of the
params and of the obstacle field, each burst started from the JAX state.
The JAX kernels run one row a program (the same outputs; a third of the
interpret-mode compile time).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops import forcefield as jff
from tpufluid.ops import resident as jresident
from tpufluid.state import ParticleState as JParticleState

import tpufluid_torch as tt
from tpufluid_torch import interop
from tpufluid_torch import step as tstep
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


@pytest.fixture(autouse=True)
def _one_row_a_program(monkeypatch):
    monkeypatch.setattr(jresident, "rows_per_program", lambda s: 1)


POS_TOL, VEL_TOL = 4.8e-7, 3.8e-5
GRID_FIELDS = ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick", "lost")


def _bitwise(got, want, what=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _within(got, want, bound, mask, what):
    got = got.cpu().numpy()[mask]
    want = np.asarray(want)[mask]
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= bound, f"{what}: max rel err {err.max()} > {bound}"


def _jstate(pos, vel, tick=0):
    n = len(pos)
    return JParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.zeros(n),
        cell=jnp.zeros(n, jnp.uint32), tick=jnp.asarray(tick, jnp.uint32))


def _lattice(n_far: int):
    """512 particles on the spawn lattice under gravity, ``n_far`` of them
    flung several cells in one step (two towards the same cell, so their
    order in it counts), and a coincident pair."""
    s = tpufluid.SimSettings(particle_count=512, size=(4.8, 4.8),
                             cell_capacity=8)
    pos = np.array(tpufluid.init_state(s).position)
    vel = np.zeros_like(pos)
    fling = [(150.0, 90.0), (150.0, 90.0), (-120.0, 60.0), (90.0, -150.0)]
    for i, v in zip([0, 1, 40, 300][:n_far], fling):
        vel[i] = v
    pos[5] = pos[6]
    return s, _jstate(pos, vel, tick=4)


def _wall_movers():
    """110 particles at h 1.5, four of them just inside an x wall moving
    out: wrap teleports them, and the next step re-inserts them as far
    movers."""
    h, half = 1.5, 6.0
    rng = np.random.default_rng(11)
    cells = np.stack(np.meshgrid(np.arange(2, 8), np.arange(2, 8)),
                     axis=-1).reshape(-1, 2)
    c = cells[rng.integers(0, len(cells), 110)]
    pos = (((c - 1) + rng.uniform(0.05, 0.95, c.shape)) * h
           - half).astype(np.float32)
    vel = (rng.normal(size=pos.shape) * 2.0).astype(np.float32)
    pos[2:6, 0] = (half - 0.02, -half + 0.02, half - 0.03, -half + 0.03)
    vel[2:6, 0] = (6.0, -6.0, 6.0, -6.0)
    s = tpufluid.SimSettings(particle_count=110, particle_spacing=0.75,
                             smoothing_radius=h, size=(2 * half, 2 * half),
                             cell_capacity=8)
    return s, _jstate(pos, vel, tick=3)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX settings, JAX GridState, JAX params, step kwargs)."""
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    if name == "none":
        s, st = _lattice(0)
        return s, jresident.from_particles(st, s), jp, {}
    if name in ("few", "over"):
        s, st = _lattice(4)
        kw = dict(far_capacity=3) if name == "over" else {}
        return s, jresident.from_particles(st, s), jp, kw
    if name == "wrap":
        s, st = _wall_movers()
        return (s, jresident.from_particles(st, s), jp,
                dict(x_boundary="wrap"))
    # two worlds: world 1 a copy of the "few" world, half as fast, under
    # its own gravity and viscosity
    s, st = _lattice(4)
    g = jresident.from_particles(st, s)
    stack = {f: jnp.concatenate([getattr(g, f), getattr(g, f)])
             for f in ("pos_x", "pos_y", "occ_row")}
    for f in ("vel_x", "vel_y"):
        v = getattr(g, f)
        stack[f] = jnp.concatenate([v, v * 0.5])
    gs = jresident.GridState(tick=g.tick, lost=g.lost, **stack)
    bp = jresident.batched_params([
        jp, tpufluid.TickParams.default(gravity=(0.0, -4.9),
                                        viscosity_coefficient=10.0)])
    return s, gs, bp, dict(n_worlds=2)


@functools.lru_cache(maxsize=None)
def _jstep(name):
    s, _, _, kw = _case(name)
    return jresident.make_grid_step(s, **kw)


def _ungated_step(step, gs, tp):
    """One CPU step with its far-mover pass run whatever the rebin
    counted, as the CUDA step runs it: the rebin, ``far_reinsert`` (its
    plain version here), density, forces. Returns (the rebin's outputs,
    the far pass's outputs, the new state)."""
    s = step.settings
    wid, row_shift = step._world_tables(gs.pos_x.device)
    rb = tfused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row,
                      tp.delta, s, row_shift=row_shift)
    lost = gs.lost + rb[6].sum().to(torch.int32)
    far = tresident.far_reinsert(gs, *rb[:5], rb[5], lost, tp.delta, s,
                                 step.far_capacity)
    px, py, vx, vy, occ, lost = far
    pres, invr = tfused.density(px, py, vx, vy, occ, tp.mass, tp.delta,
                                tp.pressure_constant, tp.rest_density, s,
                                wid=wid)
    new = tfused.forces_integrate(px, py, vx, vy, pres, invr, occ, tp, s,
                                  gs.tick + 1, wid=wid, **step.variant)
    return rb, far, tresident.GridState(*new, occ_row=occ,
                                        tick=gs.tick + 1, lost=lost)


def _check_step(tgs, jgs, prev, what, dt=1.0 / 120.0):
    """Occupancy, layout, tick and lost bitwise; the velocity increment
    within VEL_TOL; positions within POS_TOL plus the distance the
    velocity's bound lets a particle move in the step, dt * VEL_TOL *
    max(1, |v|). A far mover landing beside a resting particle kicks it to
    ~200 in one step (pressure terms of ~1e4 that cancel), whose f32 sums
    then differ by a few ulps between any two evaluations: a few 1e-4 of
    velocity, a few 1e-6 of position (its share of the velocity bound)."""
    for f in ("occ_row", "tick", "lost"):
        _bitwise(getattr(tgs, f), getattr(jgs, f), f"{what} {f}")
    live = np.asarray(jresident.valid_mask(jgs))
    _bitwise(tresident.valid_mask(tgs), live, f"{what} layout")
    for f, v in (("pos_x", "vel_x"), ("pos_y", "vel_y")):
        got = getattr(tgs, f).numpy()[live]
        want = np.asarray(getattr(jgs, f))[live]
        speed = np.abs(np.asarray(getattr(jgs, v))[live])
        bound = (POS_TOL * np.maximum(1.0, np.abs(want))
                 + dt * VEL_TOL * np.maximum(1.0, speed))
        err = np.abs(got - want)
        assert (err <= bound).all(), (
            f"{what} {f}: max err {err.max()} beyond its bound at "
            f"{np.argmax(err - bound)}")
    for f in ("vel_x", "vel_y"):
        v0 = np.array(getattr(prev, f))
        _within(getattr(tgs, f) - torch.from_numpy(v0),
                np.asarray(getattr(jgs, f)) - v0, VEL_TOL, live,
                f"{what} {f} increment")


@pytest.mark.parametrize("name", ["none", "few", "over", "wrap", "worlds"])
def test_ungated_far_pass_matches_jax(name):
    """Two synced steps with the far pass ungated against the JAX step.
    With no far mover the pass hands back the rebin's grids, occ_row and
    lost bitwise; "over" (far_capacity 3, four movers) drops one into
    ``lost``; "wrap" re-inserts the teleported particles in its second
    step; "worlds" moves both worlds' movers within their own rows."""
    js, jgs, jp, kw = _case(name)
    ts = interop.settings_from(js)
    tp = interop.tick_params_from_numpy(jp, "cpu")
    step = tresident.make_grid_step(ts, **kw)
    n_far = []
    for i in range(2):
        tgs0 = interop.grid_state_from_numpy(jgs, "cpu")
        rb, far, tgs = _ungated_step(step, tgs0, tp)
        n_far.append(int(rb[5].sum()))
        if n_far[-1] == 0:
            for a, b in zip(far[:5], rb[:5]):
                assert torch.equal(a, b)
            assert torch.equal(far[5], tgs0.lost + rb[6].sum())
        prev = jgs
        jgs = jax.block_until_ready(_jstep(name)(jgs, jp))
        _check_step(tgs, jgs, prev, f"{name} step {i}")
    if name == "wrap":  # the movers cross in step 1, re-insert in step 2
        assert n_far[0] == 0 and n_far[1] >= 2
    else:
        assert n_far[0] == {"none": 0, "worlds": 8}.get(name, 4)
        assert (n_far[1] > 0) == (name != "none")
    # only the movers past far_capacity are lost
    cap = kw.get("far_capacity", 10**9)
    assert int(jgs.lost) == sum(max(n - cap, 0) for n in n_far)


@pytest.mark.parametrize("name", ["none", "few", "wrap", "worlds"])
def test_rebin_far_count_is_the_far_predicate(name):
    """The rebin's per-row far-mover count equals, row by row, the slots
    the far pass selects (``far_movers``: every live slot, whatever its
    row's occupancy): the offsets of the card's per-row collect rest on
    it. Over three steps of the scene."""
    js, jgs, jp, kw = _case(name)
    ts = interop.settings_from(js)
    tp = interop.tick_params_from_numpy(jp, "cpu")
    step = tresident.make_grid_step(ts, **kw)
    gs = interop.grid_state_from_numpy(jgs, "cpu")
    seen = 0
    for _ in range(3):
        _, row_shift = step._world_tables(gs.pos_x.device)
        far_n = tfused.rebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                             gs.occ_row, tp.delta, step.settings,
                             row_shift=row_shift)[5]
        far, _, _ = tresident.far_movers(gs, tp.delta, step.settings)
        assert torch.equal(far.sum(dim=(1, 2)).to(torch.int32), far_n)
        seen += int(far_n.sum())
        gs = step(gs, tp)
    assert (seen > 0) == (name != "none")


def test_far_steps_reads_as_an_int():
    """``GridStep.far_steps`` counts the steps whose far pass had movers;
    on the CPU the count is the host's, read as an int."""
    js, jgs, jp, _ = _case("few")
    ts = interop.settings_from(js)
    tp = interop.tick_params_from_numpy(jp, "cpu")
    step = tresident.make_grid_step(ts)
    before = step.far_steps
    assert isinstance(before, int)
    gs = step(interop.grid_state_from_numpy(jgs, "cpu"), tp)
    assert isinstance(step.far_steps, int) and step.far_steps == before + 1
    assert int(gs.lost) == 0
    _, still, _, _ = _case("none")  # the same settings, no far mover
    step(interop.grid_state_from_numpy(still, "cpu"), tp)
    assert step.far_steps == before + 1


OBJECTS_A = [("circle", (0.3, -0.4), 0.7)]
OBJECTS_B = [("rect", (-1.2, 0.9), (1.1, 0.5), 0.6),
             ("circle", (1.0, -1.0), 0.5)]


@functools.lru_cache(maxsize=None)
def _obstacle_scene():
    """600 particles in cells around the obstacles with random velocities
    (texture 72 over a 4.8 world: no cell centre on a texel edge), two
    params (the second with other gravity and the mouse pressed) and two
    fields."""
    s = tpufluid.SimSettings(particle_count=600, size=(4.8, 4.8),
                             texture_size=(72, 72), cell_capacity=8)
    rng = np.random.default_rng(21)
    h, half = 0.2, 2.4
    cells = rng.integers(3, 22, (600, 2))
    pos = (((cells - 1) + rng.uniform(0.05, 0.95, (600, 2))) * h
           - half).astype(np.float32)
    vel = (rng.normal(size=pos.shape) * 2.0).astype(np.float32)
    vel[7] = (140.0, 100.0)  # a far mover
    gs = jresident.from_particles(_jstate(pos, vel, tick=9), s)
    params = [tpufluid.TickParams.default(gravity=(0.0, -9.8)),
              tpufluid.TickParams.default(gravity=(3.0, -4.0), mouse_state=1,
                                          mouse_pos=(0.5, 0.5),
                                          mouse_force_radius=1.5)]
    fields = [jff.obstacle_force_field(jff.Objects.from_list(o), s)
              for o in (OBJECTS_A, OBJECTS_B)]
    return s, gs, params, fields


def test_burst_across_params_and_field_swaps_matches_jax():
    """Two bursts of two steps, ``make_grid_multi_step`` against the JAX
    package's, the second under new params and a new field, each from the
    JAX state: occupancy, layout, tick and lost bitwise, positions and
    the velocity increment within the per-step bounds. The new field is
    sampled anew (the old one's cells would give other states), and
    ``FluidApp.set_mouse``'s in-place writes reach a burst too."""
    js, jgs, jps, jfields = _obstacle_scene()
    ts = interop.settings_from(js)
    tps = [interop.tick_params_from_numpy(p, "cpu") for p in jps]
    tfields = [interop.forcefield_from_numpy(f, "cpu") for f in jfields]
    jrun = jresident.make_grid_multi_step(js, 2, has_force_field=True)
    trun = tresident.make_grid_multi_step(ts, 2, has_force_field=True)
    for i in range(2):
        tgs = trun(interop.grid_state_from_numpy(jgs, "cpu"), tps[i],
                   tfields[i])
        prev = jgs
        jgs = jax.block_until_ready(jrun(jgs, jps[i], jfields[i]))
        _check_step(tgs, jgs, prev, f"burst {i}")
        assert int(jgs.tick) == 11 + 2 * i
    stale = trun(interop.grid_state_from_numpy(prev, "cpu"), tps[1],
                 tfields[0])
    assert not torch.equal(stale.pos_x, tgs.pos_x)
    # params written in place, as FluidApp.set_mouse does
    p = dataclasses.replace(tps[0])
    p.mouse_pos = tps[0].mouse_pos.clone()
    p.mouse_state = tps[0].mouse_state.clone()
    g0 = interop.grid_state_from_numpy(prev, "cpu")
    before = trun(g0, p, tfields[1])
    p.mouse_pos.copy_(torch.tensor([0.5, 0.5]))
    p.mouse_state.fill_(1)
    after = trun(g0, p, tfields[1])
    assert not torch.equal(before.vel_x, after.vel_x)


def test_eager_burst_is_the_burst_on_the_cpu():
    """``make_eager_grid_multi_step`` (what the card's graphed burst is
    held to) and ``make_grid_multi_step`` are one loop on the CPU, and the
    step is shared: bitwise, every field."""
    s = tt.SimSettings(particle_count=256, size=(3.2, 3.2))
    p = tt.TickParams.default("cpu", gravity=(0.0, -9.8))
    gs = tresident.init_grid_state(s, "cpu")
    a = tresident.make_grid_multi_step(s, 3)(gs, p)
    eager = tresident.make_eager_grid_multi_step(s, 3)
    b = eager(gs, p)
    assert eager.step is tresident.make_grid_step(s)
    for f in GRID_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    st = tt.init_state(s, "cpu")
    c = tt.make_multi_step(s, 3, neighbor_mode="dense")(st, p)
    d = tstep.make_eager_multi_step(s, 3, neighbor_mode="dense")(st, p)
    for f in ("position", "velocity", "density", "cell", "tick"):
        assert torch.equal(getattr(c, f), getattr(d, f))
