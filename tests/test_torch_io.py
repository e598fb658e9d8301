"""PyTorch port, files and the render entry points on the CPU: PNG frames
(stdlib zlib/struct codec), checkpoints shared with the JAX package,
``FluidApp.render_sequence`` and ``python -m tpufluid_torch render``, and
the mp4 gate without ffmpeg."""

import os
import struct
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.utils import io as jio

import tpufluid_torch as tt
from tpufluid_torch import cli
from tpufluid_torch.app import FluidApp, SimState
from tpufluid_torch.ops.forcefield import Objects
from tpufluid_torch.utils import io as tio


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them and each
    small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_png_round_trip(tmp_path):
    rgba = np.random.default_rng(0).integers(0, 256, (37, 53, 4), np.uint8)
    path = tio.write_png(str(tmp_path / "a.png"), rgba)
    np.testing.assert_array_equal(tio.read_png(path), rgba)
    np.testing.assert_array_equal(np.asarray(jio.read_png(path)), rgba)
    with pytest.raises(ValueError):
        tio.write_png(str(tmp_path / "b.png"), rgba[..., :3])


def _filtered_png(path, px, ctype):
    """A PNG whose row y uses filter type y % 5 (the encoder's side of
    each filter), to hold the decoder to every filter."""
    h, w, ch = px.shape
    a = px.astype(np.int32).reshape(h, w * ch)
    rows = []
    for y in range(h):
        up = a[y - 1] if y else np.zeros(w * ch, np.int32)
        left = np.concatenate([np.zeros(ch, np.int32), a[y, :-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        kind = y % 5
        if kind == 0:
            f = a[y]
        elif kind == 1:
            f = a[y] - left
        elif kind == 2:
            f = a[y] - up
        elif kind == 3:
            f = a[y] - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            f = a[y] - np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,ch", [(6, 4), (2, 3), (0, 1), (4, 2)])
def test_read_png_every_filter_and_colour_type(tmp_path, ctype, ch):
    px = np.random.default_rng(ctype).integers(0, 256, (11, 7, ch), np.uint8)
    path = str(tmp_path / "f.png")
    _filtered_png(path, px, ctype)
    got = tio.read_png(path)
    assert got.shape == (11, 7, 4)
    rgb = px[..., :3] if ch >= 3 else px[..., :1].repeat(3, axis=2)
    alpha = px[..., -1] if ch in (2, 4) else np.full((11, 7), 255, np.uint8)
    np.testing.assert_array_equal(got[..., :3], rgb)
    np.testing.assert_array_equal(got[..., 3], alpha)


def _states():
    s = tpufluid.SimSettings(particle_count=300, size=(4.8, 4.8))
    st = tpufluid.init_state(s)
    rng = np.random.default_rng(2)
    vel = rng.normal(size=(300, 2)).astype(np.float32)
    return s, tpufluid.state.ParticleState(
        position=st.position, predicted=st.position + 0.01,
        velocity=jnp.asarray(vel), density=jnp.linspace(0, 1, 300),
        cell=jnp.arange(300, dtype=jnp.uint32),
        tick=jnp.asarray(4_000_000_000, jnp.uint32))


FIELDS = ("position", "predicted", "velocity", "density", "cell", "tick")


def test_checkpoints_move_between_the_packages(tmp_path):
    _, jst = _states()
    jpath = str(tmp_path / "jax.npz")
    jio.save_checkpoint(jpath, jst)
    tst = tio.load_checkpoint(jpath, "cpu")
    assert tst.cell.dtype == torch.int32 and tst.tick.dtype == torch.int64
    assert int(tst.tick) == 4_000_000_000  # u32 widened, not wrapped
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    tpath = str(tmp_path / "torch.npz")
    tio.save_checkpoint(tpath, tst)
    back = jio.load_checkpoint(tpath)
    for f in FIELDS:
        a, b = np.asarray(getattr(back, f)), np.asarray(getattr(jst, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


def test_app_save_load_resumes(tmp_path):
    s = tt.SimSettings(particle_count=256, size=(3.2, 3.2))
    p = tt.TickParams.default("cpu", gravity=(0.0, -9.8))
    a = FluidApp(s, p, device="cpu")
    a.run(5)
    path = str(tmp_path / "ck.npz")
    a.save(path)
    b = FluidApp(s, tt.TickParams.default("cpu", gravity=(0.0, -9.8)),
                 device="cpu")
    b.load(path)
    assert b.metrics()["tick"] == 5
    a.run(3)
    b.run(3)
    assert torch.equal(a.state.position, b.state.position)


def test_render_sequence_and_state_machine(tmp_path):
    s = tt.SimSettings(particle_count=256, size=(3.2, 3.2))
    objs = Objects.from_list([("circle", (0.0, -1.0), 0.4)], "cpu")
    app = FluidApp(s, tt.TickParams.default("cpu", gravity=(0.0, -9.8)),
                   objs, device="cpu")
    seen = []
    paths = app.render_sequence(str(tmp_path / "out"), 2, 64, 36,
                                progress=seen.append)
    assert seen == [0, 1] and app.sim_state is SimState.STOPPED
    assert [os.path.basename(p) for p in paths] == ["frame_00000.png",
                                                    "frame_00001.png"]
    for pth in paths:
        img = tio.read_png(pth)
        assert img.shape == (36, 64, 4) and img[..., 2].max() > 0
    assert app.metrics()["tick"] == 32  # 16 ticks per frame
    for mode in ("metaball_exact", "particles"):
        frame = app.render_frame(64, 36, mode=mode)
        assert frame.shape == (36, 64, 4)
    with pytest.raises(ValueError, match="render mode"):
        app.render_frame(64, 36, mode="voxels")
    # Space / N / Enter
    app.request_step()
    assert app.advance(0.0) == 1 and app.sim_state is SimState.STOPPED
    app.toggle_running()
    assert app.sim_state is SimState.RUNNING
    app.FRAME_BUDGET = 60.0  # no frame-drop bailout on a slow CPU
    assert app.advance(2.5 / 120.0) == 2
    app.start_render()
    assert app.sim_state is SimState.RENDER and app.metrics()["tick"] == 0


def _render_args(frames, out, ck):
    return ["render", "--device", "cpu", "--neighbor-mode", "resident",
            "--particles", "256", "--size", "3.2", "3.2",
            "--cell-capacity", "8", "--gravity", "0", "-9.8",
            "--circle", "0", "-1", "0.4", "--rect", "1", "0.5", "0.6", "0.3",
            "0.4", "--frames", str(frames), "--width", "48", "--height",
            "27", "--out", str(out), "--checkpoint", str(ck)]


def test_cli_render_writes_frames_and_checkpoint(tmp_path):
    out = tmp_path / "frames"
    ck = tmp_path / "ck.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "tpufluid_torch", *_render_args(2, out, ck)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 2 frames" in proc.stdout
    assert sorted(os.listdir(out)) == ["frame_00000.png", "frame_00001.png"]
    assert tio.read_png(str(out / "frame_00001.png")).shape == (27, 48, 4)
    assert int(tio.load_checkpoint(str(ck), "cpu").tick) == 32
    # in process, resuming from the checkpoint
    app = cli.render(cli.parser().parse_args(
        _render_args(1, out / "more", ck)))
    assert app.metrics()["tick"] == 48
    assert len(app.objects) == 2


def test_mp4_raises_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg on it
    assert not tio.ffmpeg_available()
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tio.save_mp4(str(tmp_path / "a.mp4"), [np.zeros((4, 4, 4), np.uint8)])
    s = tt.SimSettings(particle_count=64, size=(3.2, 3.2))
    app = FluidApp(s, device="cpu")
    with pytest.raises(RuntimeError, match="ffmpeg"):
        app.render_mp4(str(tmp_path / "b.mp4"), 2, 32, 18)
    assert app.metrics()["tick"] == 0  # refused before any frame
    with pytest.raises(RuntimeError, match="ffmpeg"):
        cli.main(["render", "--device", "cpu", "--neighbor-mode", "resident",
                  "--particles", "64", "--size", "3.2", "3.2", "--frames",
                  "1", "--mp4", str(tmp_path / "c.mp4")])
