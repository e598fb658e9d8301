"""PyTorch port, video force fields (native.distfield, utils.io's frame
loading, FluidApp.set_video_field / advance_video_frame and the CLI's
--video-field) against the JAX package on the CPU.

The chamfer field is held bitwise to the JAX package's NumPy copy. The
synced tick is compared as in tests/test_torch_resident.py: occupancy,
tick, lost and the slot layout bitwise, positions within BASELINE.md's
per-step bound (|dpos| <= 4.8e-7) and velocities as the step's increment
within |dvel| <= 3.8e-5, relative where the value exceeds 1.
"""

import jax
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.app import FluidApp as JFluidApp
from tpufluid.native import distfield as jdistfield
from tpufluid.ops import resident as jresident
from tpufluid.utils import io as jio

import tpufluid_torch as tt
from tpufluid_torch import cli, interop
from tpufluid_torch.app import FluidApp
from tpufluid_torch.native import distfield
from tpufluid_torch.ops import resident as tresident
from tpufluid_torch.utils import io as tio


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POS_TOL, VEL_TOL = 4.8e-7, 3.8e-5


def _masks():
    rng = np.random.default_rng(3)
    disc = np.full((48, 48), 255, np.uint8)
    yy, xx = np.mgrid[:48, :48]
    disc[(xx - 30) ** 2 + (yy - 20) ** 2 < 100] = 0
    one = np.zeros((20, 31), np.uint8)
    one[7, 19] = 129
    return {
        "sparse": (rng.random((40, 40)) < 0.05).astype(np.uint8) * 255,
        "noise": rng.integers(0, 256, (33, 33)).astype(np.uint8),
        "no_source": np.zeros((24, 24), np.uint8),   # seeds from the border
        "non_square": (rng.random((17, 45)) < 0.1).astype(np.uint8) * 200,
        "tall": (rng.random((45, 9)) < 0.1).astype(np.uint8) * 200,
        "disc": disc,
        "one_source": one,
        "threshold": np.full((12, 12), 128, np.uint8),  # 128 is inside
    }


@pytest.mark.parametrize("name", list(_masks()))
def test_chamfer_bitwise_jax(name):
    mask = _masks()[name]
    want = jdistfield._chamfer_numpy(mask)
    for got in (distfield._chamfer_numpy(mask),
                distfield.chamfer_push_field(mask, "cpu").numpy()):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    assert distfield.CALLS["chamfer"] == 0  # the CPU runs the NumPy copy


def test_chamfer_rejects_bad_input():
    with pytest.raises(ValueError):
        distfield.chamfer_push_field(np.zeros((2, 4, 4), np.uint8), "cpu")


def test_load_gray_frames_and_mask(tmp_path):
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (3, 16, 24)).astype(np.uint8)
    np.save(tmp_path / "f.npy", frames)
    np.savez(tmp_path / "f.npz", frames=frames.astype(np.int32))
    np.save(tmp_path / "flat.npy", frames[0])
    for path in ("f.npy", "f.npz"):
        for max_frames in (None, 2):
            got = tio.load_gray_frames(str(tmp_path / path), max_frames)
            want = jio.load_gray_frames(str(tmp_path / path), max_frames)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=r"\[T, H, W\]"):
        tio.load_gray_frames(str(tmp_path / "flat.npy"))
    np.testing.assert_array_equal(tio.gray_frame_to_outside_mask(frames[1]),
                                  jio.gray_frame_to_outside_mask(frames[1]))


def test_ffmpeg_decode_gated(tmp_path, monkeypatch):
    """Any other container decodes through an ffmpeg binary; without one
    the load raises and names the .npy/.npz way."""
    if tio.ffmpeg_available():
        frames = [np.full((16, 16, 4), v, np.uint8) for v in (0, 128, 255)]
        path = tio.save_mp4(str(tmp_path / "v.mp4"), frames, fps=10)
        got = tio.load_gray_frames(path, max_frames=2)
        assert got.shape == (2, 16, 16) and got.dtype == np.uint8
    monkeypatch.setattr(tio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="npy"):
        tio.load_gray_frames(str(tmp_path / "v.mp4"))


def _settings(n, k=32):
    return tt.SimSettings(particle_count=n, particle_spacing=0.1,
                          smoothing_radius=0.2, size=(8.0, 8.0),
                          texture_size=(64, 64), cell_capacity=k)


def test_video_field_pushes_particles_out():
    app = FluidApp(_settings(256, k=16), device="cpu")
    frames = np.full((2, 64, 64), 255, np.uint8)
    frames[:, 24:40, 24:40] = 0  # central dark block = obstacle
    app.set_video_field(frames)
    for _ in range(10):
        app.tick()
    pos = app.state.position.numpy()
    assert np.all(np.isfinite(pos))
    # the obstacle square is world [-1, 1]^2: no particle inside (margin)
    inside = (np.abs(pos[:, 0]) < 0.8) & (np.abs(pos[:, 1]) < 0.8)
    assert inside.sum() == 0
    app.advance_video_frame()  # cycles without error
    app.tick()


def _quadrant_frames():
    """4 distinct frames: the obstacle block in another quadrant each."""
    frames = np.full((4, 64, 64), 255, np.uint8)
    frames[0, 0:16, 0:16] = 0
    frames[1, 0:16, 48:64] = 0
    frames[2, 48:64, 0:16] = 0
    frames[3, 48:64, 48:64] = 0
    return frames


def test_video_frame_to_field_alignment():
    """Rendered frame i consumes video frame i, from 0: the reference
    decodes one packet per rendered frame from the first frame on
    (src/main.rs:154-197)."""
    app = FluidApp(_settings(64, k=8), device="cpu")
    frames = _quadrant_frames()
    app.set_video_field(frames)
    fields = [f.numpy() for f in app._video_fields]
    for f, frame in zip(fields, frames):
        np.testing.assert_array_equal(
            f, jdistfield._chamfer_numpy(frame))
    seen = []
    for _ in app.iter_frames(5, width=64, height=64):
        cur = app._forcefield.numpy()
        matches = [j for j, f in enumerate(fields) if np.array_equal(cur, f)]
        assert len(matches) == 1
        seen.append(matches[0])
    assert seen == [0, 1, 2, 3, 0]


def test_step_follows_the_video_frame():
    """The resident step keeps the field's cell samples while the same
    field comes back: each tick must run on the current frame's field, so
    it equals a fresh step given that field, through a whole cycle."""
    s = _settings(256, k=8)
    app = FluidApp(s, device="cpu", capacity_policy="fixed")
    # each frame darkens another half of the texels under the spawn block
    # (world [-0.8, 0.8]^2, texels 25..38)
    frames = np.full((4, 64, 64), 255, np.uint8)
    frames[0, 24:40, 24:32] = 0
    frames[1, 24:40, 32:40] = 0
    frames[2, 24:32, 24:40] = 0
    frames[3, 32:40, 24:40] = 0
    app.set_video_field(frames)
    fields = list(app._video_fields)
    params = app.params
    for i in [0, 1, 2, 3, 0, 1]:
        before = app.grid_state
        fresh = tresident.make_plain_grid_step(app.settings,
                                               has_force_field=True)
        want = fresh(before, params, fields[i])
        app.tick()
        got = app.grid_state
        for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(want, f).numpy(), f)
        app.advance_video_frame()
    # the frames push differently: a tick under another frame differs
    a = fresh(app.grid_state, params, fields[0])
    b = fresh(app.grid_state, params, fields[1])
    assert not torch.equal(a.pos_x, b.pos_x)


def test_video_field_size_mismatch_rejected():
    app = FluidApp(_settings(16), device="cpu")
    with pytest.raises(ValueError):
        app.set_video_field(np.zeros((1, 32, 32), np.uint8))
    with pytest.raises(ValueError):
        app.set_video_field(np.zeros((32, 32), np.uint8))


def _rel_max(got, want, mask):
    got, want = np.asarray(got)[mask], np.asarray(want)[mask]
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def test_synced_video_tick_matches_jax(monkeypatch):
    """One resident tick under a video field, the port app against the
    JAX app from the same state. Texture 72 over the 4.8 world puts no
    texel edge on a cell centre (ROADMAP queue 3 item 2). The JAX kernels
    run one row per program (the same outputs; a third of the
    interpret-mode compile time)."""
    monkeypatch.setattr(jresident, "rows_per_program", lambda s: 1)
    js = tpufluid.SimSettings(particle_count=400, particle_spacing=0.1,
                              smoothing_radius=0.2, size=(4.8, 4.8),
                              texture_size=(72, 72), cell_capacity=8)
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    rng = np.random.default_rng(11)
    jstate = tpufluid.init_state(js)
    jstate = jstate.__class__(**{
        **{f: getattr(jstate, f) for f in
           ("position", "predicted", "density", "cell", "tick")},
        "velocity": jax.numpy.asarray(
            rng.normal(0.0, 2.0, (400, 2)).astype(np.float32))})
    frames = np.full((2, 72, 72), 255, np.uint8)
    yy, xx = np.mgrid[:72, :72]
    frames[0][(xx - 36) ** 2 + (yy - 30) ** 2 < 150] = 0
    frames[1][(xx - 30) ** 2 + (yy - 40) ** 2 < 150] = 0
    japp = JFluidApp(js, jp, neighbor_mode="resident",
                     capacity_policy="fixed")
    japp.state = jstate
    japp.set_video_field(frames)
    app = FluidApp(interop.settings_from(js),
                   interop.tick_params_from_numpy(jp, "cpu"), device="cpu",
                   neighbor_mode="resident", capacity_policy="fixed")
    app.state = interop.particle_state_from_numpy(jstate, "cpu")
    app.set_video_field(frames)
    for jf, tf in zip(japp._video_fields, app._video_fields):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    japp.advance_video_frame()
    app.advance_video_frame()
    g0 = japp._grid_state
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


def test_cli_video_field(tmp_path):
    frames = np.full((3, 64, 64), 255, np.uint8)
    frames[:, 20:40, 20:40] = 0
    path = str(tmp_path / "frames.npy")
    np.save(path, frames)
    common = ["--device", "cpu", "--particles", "64", "--size", "8", "8",
              "--texture-size", "64", "64", "--cell-capacity", "8",
              "--neighbor-mode", "resident", "--video-field", path]
    app = cli.run(cli.parser().parse_args(["run", *common, "--steps", "4",
                                           "--report-every", "4"]))
    assert len(app._video_fields) == 3
    np.testing.assert_array_equal(app._forcefield.numpy(),
                                  jdistfield._chamfer_numpy(frames[0]))
    out = tmp_path / "frames_out"
    app = cli.render(cli.parser().parse_args(
        ["render", *common, "--frames", "2", "--width", "32",
         "--height", "32", "--out", str(out)]))
    assert sorted(p.name for p in out.iterdir()) == [
        "frame_00000.png", "frame_00001.png"]
    assert app._video_index == 2
