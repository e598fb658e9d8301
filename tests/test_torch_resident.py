"""PyTorch port, the resident engine as a whole (ops.resident, app, cli)
against the JAX package on the CPU.

Boundary conversions and capacity changes are held bitwise. The step is
compared SYNCED: each step starts both engines from the JAX state, so
roundoff never compounds; occupancy, the lost counter and the slot layout
must be bitwise, floats within BASELINE.md's per-step bounds (|dpos| <=
4.8e-7, |dvel| <= 3.8e-5, relative where the value exceeds 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops import resident as jresident
from tpufluid.state import ParticleState as JParticleState

import tpufluid_torch as tt
from tpufluid_torch import cli, interop
from tpufluid_torch.app import FluidApp
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


def _states(name):
    """(JAX settings, JAX ParticleState) for the conversion cases."""
    if name == "lattice":
        s = tpufluid.SimSettings(particle_count=512, size=(4.8, 4.8))
        return s, tpufluid.init_state(s)
    if name == "random":
        s = tpufluid.SimSettings(particle_count=700, size=(4.8, 4.8),
                                 cell_capacity=12)  # pads to 16
        rng = np.random.default_rng(5)
        pos = rng.uniform(-2.4, 2.4, (700, 2)).astype(np.float32)
        pos[:3] = [(2.4, 2.4), (-2.4, -2.4), (2.4, 0.0)]  # walls
        vel = rng.normal(size=(700, 2)).astype(np.float32)
        return s, _jstate(pos, vel, tick=7)
    # tests/test_resident.py:82: 32 particles in one cell at capacity 2
    s = tpufluid.SimSettings(particle_count=32, size=(6.0, 6.0),
                             cell_capacity=2)
    return s, _jstate(np.zeros((32, 2), np.float32),
                      np.zeros((32, 2), np.float32))


@pytest.mark.parametrize("name", ["lattice", "random", "overflow"])
def test_from_and_to_particles_bitwise(name):
    js, jstate = _states(name)
    ts = interop.settings_from(js)
    jgs = jresident.from_particles(jstate, js)
    tgs = tresident.from_particles(
        interop.particle_state_from_numpy(jstate, "cpu"), ts)
    for f in GRID_FIELDS:
        _bitwise(getattr(tgs, f), getattr(jgs, f), f)
    jps, jlive = jresident.to_particles(jgs, js)
    tps, tlive = tresident.to_particles(tgs, ts)
    assert int(tlive) == int(jlive)
    for f in ("position", "predicted", "velocity", "density", "cell", "tick"):
        _bitwise(getattr(tps, f), getattr(jps, f), f)
    if name == "overflow":
        assert int(tgs.lost) == 30 and int(tlive) == 2


def test_grow_and_shrink_capacity_bitwise():
    js, jstate = _states("lattice")
    jgs = jresident.from_particles(jstate, js)
    tgs = interop.grid_state_from_numpy(jgs, "cpu")
    jg, tg = jresident.grow_capacity(jgs, 24), tresident.grow_capacity(tgs, 24)
    assert tg.pos_x.shape == (28, 24, 128)
    for f in GRID_FIELDS:
        _bitwise(getattr(tg, f), getattr(jg, f), f)
    jsh = jresident.shrink_capacity(jg, 8)
    tsh = tresident.shrink_capacity(tg, 8)
    for f in GRID_FIELDS:
        _bitwise(getattr(tsh, f), getattr(jsh, f), f)
        _bitwise(getattr(tsh, f), getattr(tgs, f), f)
    with pytest.raises(ValueError):
        tresident.grow_capacity(tgs, 12)


def _synced_scene():
    """512 particles under gravity, with a far mover and a coincident pair."""
    s = tpufluid.SimSettings(particle_count=512, size=(4.8, 4.8),
                             cell_capacity=8)
    st = tpufluid.init_state(s)
    pos = np.array(st.position)
    vel = np.zeros_like(pos)
    vel[0] = (150.0, 90.0)   # ~6 cells in one step: the far-mover fallback
    pos[1] = pos[2]          # coincident pair: the tie-break path
    return s, _jstate(pos, vel)


def test_synced_steps_match_jax():
    js, jstate = _synced_scene()
    ts = interop.settings_from(js)
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    tp = interop.tick_params_from_numpy(jp, "cpu")
    jstep = jresident.make_grid_step(js)
    tstep = tresident.make_grid_step(ts)
    jgs = jresident.from_particles(jstate, js)

    t0 = interop.grid_state_from_numpy(jgs, "cpu")
    far_n = tfused.rebin(t0.pos_x, t0.pos_y, t0.vel_x, t0.vel_y, t0.occ_row,
                         tp.delta, ts)[5]
    assert int(far_n.sum()) == 1  # step 1 runs the far-mover fallback

    for i in range(6):
        tgs = tstep(interop.grid_state_from_numpy(jgs, "cpu"), tp)
        jgs = jax.block_until_ready(jstep(jgs, jp))
        for f in ("occ_row", "tick", "lost"):
            _bitwise(getattr(tgs, f), getattr(jgs, f), f"step {i} {f}")
        live = np.asarray(jresident.valid_mask(jgs))
        _bitwise(tresident.valid_mask(tgs), live, f"step {i} layout")
        for f, tol in (("pos_x", POS_TOL), ("pos_y", POS_TOL),
                       ("vel_x", VEL_TOL), ("vel_y", VEL_TOL)):
            _within(getattr(tgs, f), getattr(jgs, f), tol, live,
                    f"step {i} {f}")
            _bitwise(getattr(tgs, f)[torch.from_numpy(~live)],
                     np.asarray(getattr(jgs, f))[~live], f"step {i} {f} dead")
    assert int(jgs.lost) == 0


def test_multi_step_is_the_step_loop():
    s = tt.SimSettings(particle_count=256, size=(3.2, 3.2))
    p = tt.TickParams.default("cpu", gravity=(0.0, -9.8))
    gs = tresident.init_grid_state(s, "cpu")
    a = tresident.make_grid_multi_step(s, 3)(gs, p)
    b = gs
    for _ in range(3):
        b = tresident.make_grid_step(s)(b, p)
    for f in GRID_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert int(a.tick) == 3


def test_fluid_app_grow_regrows_lossless():
    """A gravity spike the spawn-sized capacity (8) cannot hold: the grow
    policy regrows and replays, loses nothing, and ends bitwise on the
    always-wide trajectory (kernel work tracks occupancy, not K)."""
    n = 384
    s = tt.SimSettings(particle_count=n, size=(4.8, 4.8), cell_capacity=8)
    app = FluidApp(s, tt.TickParams.default("cpu"), device="cpu",
                   neighbor_mode="resident")
    assert app.settings.cell_capacity == 8
    app.LOSS_CHECK_EVERY = 8  # tight audits keep the test short
    st0 = tt.init_state(s, "cpu")
    st0.velocity[:, 1] -= 20.0
    app.state = st0
    app.params.gravity = torch.tensor([0.0, -60.0])
    app.run(24, max_burst=4)
    m = app.metrics()
    assert m["tick"] == 24 and m["lost_particles"] == 0
    assert app.settings.cell_capacity > 8 and app.n_regrows >= 1
    pos = app.state.position
    assert pos.shape == (n, 2) and torch.isfinite(pos).all()

    big = dataclasses.replace(s, cell_capacity=app.settings.cell_capacity)
    ref = tresident.from_particles(st0, big)
    step = tresident.make_grid_step(big)
    params = tt.TickParams.default("cpu", gravity=(0.0, -60.0))
    for _ in range(24):
        ref = step(ref, params)
    want, live = tresident.to_particles(ref, big)
    assert int(live) == n
    assert torch.equal(pos, want.position)


def test_shrink_hysteresis_logic():
    s = tt.SimSettings(particle_count=128, size=(3.2, 3.2), cell_capacity=16)
    app = FluidApp(s, device="cpu")
    assert app.settings.cell_capacity == 16
    app._audit_loss()
    assert app.settings.cell_capacity == 16
    app._audit_loss()  # second clean audit: 16 -> 8
    assert app.settings.cell_capacity == 8
    assert app.grid_state.pos_x.shape[1] == 8
    app._audit_loss()
    app._audit_loss()  # 8 is the floor
    assert app.settings.cell_capacity == 8
    _, live = tresident.to_particles(app.grid_state, app.settings)
    assert int(live) == 128 and int(app.grid_state.lost) == 0


def test_strict_policy_refuses_undersized_scene():
    s = tt.SimSettings(particle_count=16384, size=(13.0, 26.0),
                       cell_capacity=8)
    with pytest.raises(ValueError, match="undersized"):
        FluidApp(s, tt.TickParams.default("cpu", gravity=(0.0, -9.8)),
                 capacity_policy="strict", device="cpu")


def _variant_scene():
    """h 1.5 (surface tension acts only above h 1), mass 150 (densities
    past the adaptive strides' 150 and 200), particles at the x walls
    moving out (wrap teleports them, and the next step re-inserts them as
    far movers), a coincident pair; predicted coordinates 0.05 h or more
    from cell edges."""
    h, half = 1.5, 6.0
    rng = np.random.default_rng(11)
    cells = np.stack(np.meshgrid(np.arange(2, 8), np.arange(2, 8)),
                     axis=-1).reshape(-1, 2)
    c = cells[rng.integers(0, len(cells), 110)]
    pred = (((c - 1) + rng.uniform(0.05, 0.95, c.shape)) * h
            - half).astype(np.float32)
    vel = (rng.normal(size=pred.shape) * 2.0).astype(np.float32)
    pred[1], vel[1] = pred[0], vel[0]
    pred[2:6, 0] = (half, -half, half, -half)
    vel[2:6, 0] = (6.0, -6.0, 6.0, -6.0)
    pos = (pred - vel * np.float32(1.0 / 120.0)).astype(np.float32)
    pos[2:6, 0] = pred[2:6, 0] - np.sign(pred[2:6, 0]) * 0.01
    s = tpufluid.SimSettings(particle_count=110, particle_spacing=0.75,
                             smoothing_radius=h, size=(2 * half, 2 * half),
                             cell_capacity=8)
    p = tpufluid.TickParams.default(gravity=(0.0, -9.8), mass=150.0,
                                    surface_tension_threshold=0.05,
                                    surface_tension_coefficient=5.0)
    return s, _jstate(pos, vel, tick=3), p


@pytest.mark.parametrize("kw", [
    dict(x_boundary="wrap", surface_tension=True), dict(x_boundary="wrap"),
    dict(surface_tension=True), dict(adaptive_subsampling=True),
    dict(adaptive_subsampling=True, x_boundary="wrap"),
])
def test_resident_variants_match_jax(kw, monkeypatch):
    """The resident engine's variant flags, two synced steps against the
    JAX engine (the second re-inserts the wrapped particles): occupancy,
    layout, tick and lost bitwise, positions and the velocity increment
    within the per-step bounds. FluidApp takes the flags too. The JAX
    kernels run one row per program (the same outputs; a third of the
    interpret-mode compile time)."""
    monkeypatch.setattr(jresident, "rows_per_program", lambda s: 1)
    js, jstate, jp = _variant_scene()
    ts = interop.settings_from(js)
    tp = interop.tick_params_from_numpy(jp, "cpu")
    jstep = jresident.make_grid_step(js, **kw)
    tstep = tresident.make_grid_step(ts, **kw)
    jgs = jresident.from_particles(jstate, js)
    for i in range(2):
        tgs = tstep(interop.grid_state_from_numpy(jgs, "cpu"), tp)
        prev = jgs
        jgs = jax.block_until_ready(jstep(jgs, jp))
        for f in ("occ_row", "tick", "lost"):
            _bitwise(getattr(tgs, f), getattr(jgs, f), f"step {i} {f}")
        live = np.asarray(jresident.valid_mask(jgs))
        _bitwise(tresident.valid_mask(tgs), live, f"step {i} layout")
        for f in ("pos_x", "pos_y"):
            _within(getattr(tgs, f), getattr(jgs, f), POS_TOL, live,
                    f"step {i} {f}")
        for f in ("vel_x", "vel_y"):
            v0 = np.array(getattr(prev, f))
            _within(getattr(tgs, f) - torch.from_numpy(v0),
                    np.asarray(getattr(jgs, f)) - v0, VEL_TOL, live,
                    f"step {i} {f} increment")
    if kw.get("x_boundary") == "wrap":
        assert tstep.far_steps >= 1  # the wrapped particles re-inserted
    app = FluidApp(interop.settings_from(js), tp, device="cpu",
                   neighbor_mode="resident", **kw)
    app.run(2)
    assert app.metrics()["tick"] == 2


def test_cli_run_on_cpu(capsys, tmp_path):
    args = ["run", "--device", "cpu", "--neighbor-mode", "resident",
            "--particles", "256", "--size", "3.2", "3.2", "--steps", "8",
            "--report-every", "4", "--cell-capacity", "8"]
    app = cli.run(cli.parser().parse_args(args))
    assert app.metrics()["tick"] == 8
    assert "done: 8 steps" in capsys.readouterr().out
    assert cli.main(["info"]) == 0
    frames = np.full((2, 64, 64), 255, np.uint8)
    frames[:, 20:40, 20:40] = 0
    np.save(tmp_path / "v.npy", frames)
    assert cli.main(args[:-4] + ["--steps", "1", "--texture-size", "64",
                                 "64", "--video-field",
                                 str(tmp_path / "v.npy")]) == 0
    # the default engine (dense) runs
    assert cli.main(["run", "--device", "cpu", "--particles", "64",
                     "--size", "1.6", "1.6", "--steps", "1"]) == 0
