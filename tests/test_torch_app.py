"""PyTorch port, the app shell's remaining surface against the JAX package
on the CPU: ``FluidApp.set_mouse`` (one resident tick with the mouse on,
synced with the JAX app), ``Scene.make_step``, ``utils.profiling.trace``
and the ``predict_positions`` export.

The tick is compared as in tests/test_torch_resident.py: occupancy, tick,
lost and the slot layout bitwise, positions within BASELINE.md's per-step
bound (|dpos| <= 4.8e-7) and velocities as the step's increment within
|dvel| <= 3.8e-5, relative where the value exceeds 1.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.app import FluidApp as JFluidApp
from tpufluid.ops import resident as jresident

import tpufluid_torch as tt
from tpufluid_torch import interop
from tpufluid_torch.app import FluidApp
from tpufluid_torch.models import scenes
from tpufluid_torch.ops import resident as tresident
from tpufluid_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POS_TOL, VEL_TOL = 4.8e-7, 3.8e-5
MOUSE_POS = (0.3, -0.2)  # inside the spawn block


def _scene():
    """The golden scenario (512 particles, 8 x 8, K=32, g -9.8) with
    seeded velocities: JAX settings, params and state."""
    js = tpufluid.SimSettings(particle_count=512, particle_spacing=0.1,
                              smoothing_radius=0.2, size=(8.0, 8.0),
                              cell_capacity=32)
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    st = tpufluid.init_state(js)
    vel = np.random.default_rng(6).normal(size=(512, 2)).astype(np.float32)
    return js, jp, dataclasses.replace(
        st, velocity=jax.numpy.asarray(vel * 0.5))


def _rel_max(got, want, mask):
    got, want = np.asarray(got)[mask], np.asarray(want)[mask]
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def _port_app(js, jp, jstate, mouse_state):
    app = FluidApp(interop.settings_from(js),
                   interop.tick_params_from_numpy(jp, "cpu"), device="cpu",
                   neighbor_mode="resident", capacity_policy="fixed")
    app.state = interop.particle_state_from_numpy(jstate, "cpu")
    app.set_mouse(pos=MOUSE_POS, state=mouse_state)
    return app


@pytest.mark.parametrize("mouse_state", [-1, 1])
def test_set_mouse_tick_matches_jax(mouse_state, monkeypatch):
    """One resident tick with the mouse on (repel, then attract), the port
    app against the JAX app from the same state; the impulse shows against
    a mouse-off tick. The JAX kernels run one row per program (the same
    outputs; a third of the interpret-mode compile time)."""
    monkeypatch.setattr(jresident, "rows_per_program", lambda s: 1)
    js, jp, jstate = _scene()
    japp = JFluidApp(js, jp, neighbor_mode="resident",
                     capacity_policy="fixed")
    japp.state = jstate
    japp.set_mouse(pos=MOUSE_POS, state=mouse_state)
    app = _port_app(js, jp, jstate, mouse_state)
    assert int(app.params.mouse_state) == mouse_state
    np.testing.assert_array_equal(app.params.mouse_pos.numpy(),
                                  np.float32(MOUSE_POS))
    g0 = japp._grid_state
    for f in ("pos_x", "vel_x", "vel_y", "occ_row"):
        np.testing.assert_array_equal(getattr(app.grid_state, f).numpy(),
                                      np.asarray(getattr(g0, f)))
    japp.tick()
    app.tick()
    jg = jax.block_until_ready(japp._grid_state)
    tg = app.grid_state
    for f in ("occ_row", "tick", "lost"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    live = np.asarray(jresident.valid_mask(jg))
    np.testing.assert_array_equal(tresident.valid_mask(tg).numpy(), live)
    for f in ("pos_x", "pos_y"):
        assert _rel_max(getattr(tg, f).numpy(), getattr(jg, f), live) \
            <= POS_TOL, f
    for f in ("vel_x", "vel_y"):
        v0 = np.asarray(getattr(g0, f))
        assert _rel_max(getattr(tg, f).numpy() - v0,
                        np.asarray(getattr(jg, f)) - v0, live) <= VEL_TOL, f

    # mouse off: the impulse (radius 5 covers the block) moves every live
    # particle's velocity by far more than the bound
    off = _port_app(js, jp, jstate, 0)
    off.tick()
    og = off.grid_state
    np.testing.assert_array_equal(tresident.valid_mask(og).numpy(), live)
    dv = np.hypot(tg.vel_x.numpy() - og.vel_x.numpy(),
                  tg.vel_y.numpy() - og.vel_y.numpy())[live]
    scale = np.maximum(1.0, np.hypot(og.vel_x.numpy(),
                                     og.vel_y.numpy())[live])
    assert (dv / scale > VEL_TOL).all()
    # attract pulls toward the mouse, repel pushes away
    toward = ((MOUSE_POS[0] - tg.pos_x.numpy()[live])
              * (tg.vel_x.numpy() - og.vel_x.numpy())[live]
              + (MOUSE_POS[1] - tg.pos_y.numpy()[live])
              * (tg.vel_y.numpy() - og.vel_y.numpy())[live])
    assert np.sign(np.median(toward)) == mouse_state


def test_set_mouse_writes_in_place():
    """set_mouse writes into the params' own tensors (a captured graph
    keeps seeing them), keeps what it is not given, and refuses a
    position that is not (x, y)."""
    app = FluidApp(tt.SimSettings(particle_count=64, size=(3.2, 3.2)),
                   device="cpu", neighbor_mode="resident")
    pos_t, state_t = app.params.mouse_pos, app.params.mouse_state
    app.set_mouse(pos=(1.0, 2.0), state=-1)
    assert app.params.mouse_pos is pos_t
    assert app.params.mouse_state is state_t
    assert pos_t.tolist() == [1.0, 2.0] and int(state_t) == -1
    assert state_t.dtype == torch.int32 and pos_t.dtype == torch.float32
    app.set_mouse(state=1)
    assert pos_t.tolist() == [1.0, 2.0] and int(state_t) == 1
    app.set_mouse(pos=torch.tensor([-0.5, 0.25]))
    assert pos_t.tolist() == [-0.5, 0.25] and int(state_t) == 1
    for bad in ((1.0, 2.0, 3.0), [[1.0, 2.0]], 1.0):
        with pytest.raises(ValueError):
            app.set_mouse(pos=bad)
    assert pos_t.tolist() == [-0.5, 0.25]


def test_scene_make_step():
    """Scene.make_step(**kw) builds make_step(scene.settings, **kw), as in
    the JAX package: the same step, bitwise, with and without flags."""
    scene = scenes.default_scene("cpu", particle_count=256, size=(3.2, 3.2))
    p = tt.TickParams.default("cpu", gravity=(0.0, -9.8))
    st = tt.init_state(scene.settings, "cpu")
    for kw in ({}, dict(neighbor_mode="naive", x_boundary="wrap")):
        got = scene.make_step(**kw)(st, p)
        want = tt.make_step(scene.settings, **kw)(st, p)
        for f in ("position", "velocity", "density", "cell", "tick"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (kw, f)
        assert int(got.tick) == 1


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    """A CPU step inside profiling.trace leaves a Chrome trace in logdir
    that names the step's operators."""
    s = tt.SimSettings(particle_count=256, size=(3.2, 3.2))
    step = tt.make_step(s)
    st = tt.init_state(s, "cpu")
    with profiling.trace(str(tmp_path / "prof")):
        st = step(st, tt.TickParams.default("cpu", gravity=(0.0, -9.8)))
    files = sorted((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert int(st.tick) == 1


def test_predict_positions_export_matches_jax():
    """``from tpufluid_torch import predict_positions``, as in the JAX
    package, clamps to the box as tpufluid.predict_positions does."""
    from tpufluid_torch import predict_positions

    assert "predict_positions" in tt.__all__
    js = tpufluid.SimSettings(particle_count=64, size=(3.2, 3.2))
    rng = np.random.default_rng(2)
    pos = rng.uniform(-1.6, 1.6, (64, 2)).astype(np.float32)
    vel = rng.normal(size=(64, 2)).astype(np.float32) * 40.0
    want = tpufluid.predict_positions(jax.numpy.asarray(pos),
                                      jax.numpy.asarray(vel),
                                      np.float32(1 / 120), js)
    got = predict_positions(torch.from_numpy(pos), torch.from_numpy(vel),
                            torch.tensor(1 / 120, dtype=torch.float32),
                            interop.settings_from(js))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.abs(got.numpy()) == 1.6).any()
