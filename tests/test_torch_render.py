"""PyTorch port, rendering (ops.render_coarse, render_grid, render_binned,
render, utils.io.read_png) against the JAX package on the CPU, on the same
numpy inputs.

* The coarse metaball fields: the plain version against the JAX Pallas
  kernel (interpret mode), |d| <= 1e-5 * max(1, |ref|). XLA on the CPU
  contracts products into FMAs where the port rounds each op, which moves
  the sums by a few ulp: the measured worst here is about 5e-6.
* Frames, compared as to_rgba8 images: at most 1e-3 of the pixels may
  differ by more than 1 in any channel (a rounding tie at .5 or a sprite
  tie can flip a pixel); on these scenes every pixel is equal.
* The committed golden PNGs (tests/golden/render_*.png), on the state
  tests/test_render_golden.py builds, with its criteria.
* The render's constants (``ops.render.table``): made once per key of
  values, frames bitwise those rendered from cleared tables.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpufluid
from tpufluid.ops import grid as jgrid
from tpufluid.ops import render as jrender
from tpufluid.ops import render_binned as jbinned
from tpufluid.ops import render_grid as jrgrid
from tpufluid.ops import resident as jresident
from tpufluid.ops.pallas import render as jpallas_render
from tpufluid.state import ParticleState as JParticleState
from tpufluid.utils import io as jio

from tpufluid_torch import interop
from tpufluid_torch.ops import render as trender
from tpufluid_torch.ops import render_binned as tbinned
from tpufluid_torch.ops import render_coarse as tcoarse
from tpufluid_torch.ops import render_grid as trgrid
from tpufluid_torch.ops import resident as tresident
from tpufluid_torch.utils import io as tio
from tpufluid_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them and each
    small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELD_TOL = 1e-5
PIXEL_FRAC = 1e-3
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

_jcoarse = jax.jit(jpallas_render.coarse_metaball_fields,
                   static_argnums=(4, 5))


def _jstate(pos, vel):
    n = len(pos)
    return JParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.zeros(n),
        cell=jnp.zeros(n, jnp.uint32), tick=jnp.asarray(0, jnp.uint32))


@functools.lru_cache(maxsize=None)
def coarse_case(name):
    """(JAX settings, JAX GridState) for a coarse-field case."""
    rng = np.random.default_rng(len(name) * 7 + ord(name[0]))
    size, k = (4.8, 4.8), 8
    if name == "k8":  # a jittered lattice
        pos = rng.uniform(-1.6, 1.6, (500, 2))
    elif name == "k16":  # 8-16 per cell: the second slot block
        pos = rng.uniform(-0.6, 0.6, (400, 2))
        k = 16
    elif name == "k32":  # over 16 per cell: the third and fourth blocks
        pos = rng.uniform(-0.4, 0.4, (380, 2))
        k = 32
    elif name == "ring":  # on the walls: rows and columns by the ring
        pos = rng.uniform(-2.4, 2.4, (500, 2))
        pos[:250, 1] = np.where(pos[:250, 1] > 0, 2.4, -2.4)
        pos[250:, 0] = np.where(pos[250:, 0] > 0, 2.4, -2.4)
    else:  # "wrap": grid_w 127 in Gxp 128, fluid on both side walls, so
        # the right edge's samples reach the left wall through the wrap
        size = (25.0, 3.2)
        pos = rng.uniform(-1.6, 1.6, (600, 2))
        pos[:300, 0] = -12.5 + rng.uniform(0.0, 0.5, 300)
        pos[300:, 0] = 12.5 - rng.uniform(0.0, 0.5, 300)
    pos = pos.astype(np.float32)
    vel = (rng.normal(size=pos.shape) * 3.0).astype(np.float32)
    s = tpufluid.SimSettings(particle_count=len(pos), size=size,
                             cell_capacity=k)
    return s, jresident.from_particles(_jstate(pos, vel), s)


@pytest.mark.parametrize("name", ["k8", "k16", "k32", "ring", "wrap"])
def test_coarse_fields_plain_match_jax(name):
    s, gs = coarse_case(name)
    occ = np.asarray(gs.occ_row)
    if name == "k32":
        assert occ.max() > 24
    if name == "k16":
        assert 8 < occ.max() <= 16
    if name == "ring":
        assert occ[1] > 0 and occ[s.grid_h - 2] > 0
    speed = jnp.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
    want = _jcoarse(gs.pos_x, gs.pos_y, speed, gs.occ_row, s, 2)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    tspeed = torch.sqrt(tg.vel_x * tg.vel_x + tg.vel_y * tg.vel_y)
    got = tcoarse.coarse_metaball_fields(tg.pos_x, tg.pos_y, tspeed,
                                         tg.occ_row, interop.settings_from(s),
                                         2)
    for g, w, what in zip(got, want, ("density", "velocity factor")):
        w = np.asarray(w)
        assert g.shape == w.shape == (2 * gs.pos_x.shape[0], 2 * 128)
        err = np.abs(g.numpy() - w) / np.maximum(1.0, np.abs(w))
        assert err.max() <= FIELD_TOL, f"{name} {what}: {err.max()}"
        assert w.max() > 1.0
    if name == "wrap":  # the right edge sees the left wall's fluid
        assert np.asarray(want[0])[:, -4:].max() > 1e-3


def test_coarse_fields_check_supersample():
    s, gs = coarse_case("k8")
    tg = interop.grid_state_from_numpy(gs, "cpu")
    with pytest.raises(ValueError, match="supersample"):
        tcoarse.coarse_metaball_fields(tg.pos_x, tg.pos_y, tg.vel_x,
                                       tg.occ_row, interop.settings_from(s),
                                       3)


def _compare_frames(got, want, what):
    got = trender.to_rgba8(got).numpy()
    want = np.asarray(jrender.to_rgba8(want))
    assert got.shape == want.shape, what
    off = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    frac = float((off > 1).mean())
    assert frac <= PIXEL_FRAC, f"{what}: {frac:.2e} of pixels differ by > 1"
    assert got[..., :3].max() > 0, f"{what}: blank frame"


W, H = 160, 90


@functools.lru_cache(maxsize=None)
def frame_scene():
    """(JAX settings, JAX ParticleState with cells, JAX GridState)."""
    s, gs = coarse_case("k8")
    jps, _ = jresident.to_particles(gs, s)
    return s, jps, gs


def _cams(s):
    kw = dict(center=(0.1, -0.2), view_size=(s.size[0], s.size[0] * H / W))
    return jrender.Camera(**kw), trender.Camera(**kw)


def test_render_metaball_grid_matches_jax():
    s, _, gs = frame_scene()
    jcam, tcam = _cams(s)
    want = jrgrid.render_metaball_grid(gs, s, W, H, jcam)
    got = trgrid.render_metaball_grid(interop.grid_state_from_numpy(gs, "cpu"),
                                      interop.settings_from(s), W, H, tcam)
    _compare_frames(got, want, "render_metaball_grid")


@pytest.mark.parametrize("renderer", ["metaball_binned", "particles_binned",
                                      "metaball", "particles"])
def test_particle_renderers_match_jax(renderer):
    s, jps, _ = frame_scene()
    jcam, tcam = _cams(s)
    tps = interop.particle_state_from_numpy(jps, "cpu")
    ts = interop.settings_from(s)
    jfn, tfn = {
        "metaball_binned": (jbinned.render_metaball_binned,
                            tbinned.render_metaball_binned),
        "particles_binned": (jbinned.render_particles_binned,
                             tbinned.render_particles_binned),
        "metaball": (jrender.render_metaball, trender.render_metaball),
        "particles": (jrender.render_particles, trender.render_particles),
    }[renderer]
    _compare_frames(tfn(tps, ts, W, H, tcam), jfn(jps, s, W, H, jcam),
                    renderer)


def test_shade_metaball_clamp_blue_matches_jax():
    rng = np.random.default_rng(4)
    dens = rng.uniform(0.0, 80.0, (40, 60)).astype(np.float32)
    dens[:, :20] = rng.uniform(0.0, 2.0, (40, 20))  # the edge band
    velf = rng.uniform(0.0, 400.0, (40, 60)).astype(np.float32)
    for clamp in (False, True):
        want = jbinned.shade_metaball(jnp.asarray(dens), jnp.asarray(velf),
                                      (0.1, 0.1, 0.2), clamp)
        got = tbinned.shade_metaball(torch.from_numpy(dens),
                                     torch.from_numpy(velf), (0.1, 0.1, 0.2),
                                     clamp)
        _compare_frames(got, want, f"shade clamp={clamp}")
    blue = trender.to_rgba8(got).numpy()
    assert ((blue[..., :3] == (0, 0, 255)).all(-1) == (dens > 50.0)).all()


def test_render_metaball_state_matches_grid():
    s, jps, _ = frame_scene()
    ts = interop.settings_from(s)
    tps = interop.particle_state_from_numpy(jps, "cpu")
    _, tcam = _cams(s)
    a = trgrid.render_metaball_state(tps, ts, W, H, tcam)
    b = trgrid.render_metaball_grid(tresident.from_particles(tps, ts), ts,
                                    W, H, tcam)
    assert torch.equal(a, b)


def test_render_tables_made_once_a_key():
    """render_metaball_grid over two cameras at two sizes, in turns and
    each time through a new but equal Camera: every frame is bitwise the
    frame rendered after clearing the tables, ``render_tables`` counts one
    build per distinct key (four cameras' matrices, one shading table),
    and a SimSettings that differs only in cell_capacity finds the same
    tables. The cache keeps the newest ``MAX_TABLES`` keys."""
    s, _, gs = frame_scene()
    ts = interop.settings_from(s)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    _, cam_a = _cams(s)
    cam_b = trender.Camera(center=(-0.3, 0.2), view_size=(3.0, 3.0 * H / W))
    cases = [(cam, w, h) for cam in (cam_a, cam_b)
             for w, h in ((W, H), (96, 54))]
    fresh = []
    for cam, w, h in cases:
        trender.clear_tables()
        fresh.append(trgrid.render_metaball_grid(tg, ts, w, h, cam))
    trender.clear_tables()

    def turns(settings):
        for (cam, w, h), want in zip(cases, fresh):
            got = trgrid.render_metaball_grid(tg, settings, w, h,
                                              dataclasses.replace(cam))
            assert torch.equal(got, want), (cam, w, h)

    builds = []
    for settings in (ts, ts, dataclasses.replace(ts, cell_capacity=16)):
        with profile(activities=[ProfilerActivity.CPU]):
            turns(settings)
        builds.append(profiling.record().counts.get("render_tables", 0))
    assert builds == [len(cases) + 1, 0, 0]

    for i in range(trender.MAX_TABLES + 2):
        assert trender.table(("test", i), lambda: i) == i
    assert len(trender._TABLES) == trender.MAX_TABLES
    assert trender.table(("test", trender.MAX_TABLES + 1), None) == (
        trender.MAX_TABLES + 1)
    trender.clear_tables()


# ------------------------------------------------------------- goldens

GW, GH = 240, 135


@functools.lru_cache(maxsize=None)
def golden_state():
    """The state tests/test_render_golden.py renders: 512 particles, 30
    grid-engine steps under gravity (built by the JAX package)."""
    s = tpufluid.SimSettings(particle_count=512, particle_spacing=0.1,
                             smoothing_radius=0.2, size=(8.0, 8.0),
                             cell_capacity=32)
    params = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    step = tpufluid.make_step(s, neighbor_mode="grid")
    state = tpufluid.init_state(s)
    for _ in range(30):
        state = step(state, params)
    return s, state


def _check_golden(name, frame):
    rgba8 = trender.to_rgba8(frame).numpy()
    gold = tio.read_png(os.path.join(GOLDEN_DIR, f"render_{name}.png"))
    assert gold.shape == rgba8.shape
    diff = np.abs(rgba8.astype(np.int32) - gold.astype(np.int32))
    mean_abs = float(diff.mean())
    frac_big = float((diff.max(axis=-1) > 8).mean())
    assert mean_abs < 1.0, f"{name}: mean abs diff {mean_abs}"
    assert frac_big < 0.01, f"{name}: {frac_big:.2%} pixels off by >8"


@pytest.mark.parametrize("name", ["metaball", "metaball_clamp_blue",
                                  "particles", "grid"])
def test_goldens_with_port_renderers(name):
    js, jstate = golden_state()
    if name == "metaball_clamp_blue":  # as test_render_golden.py squeezes
        jstate = dataclasses.replace(jstate, position=jstate.position * 0.12,
                                     predicted=jstate.predicted * 0.12)
        jstate = dataclasses.replace(jstate, cell=jgrid.cell_id(
            jstate.predicted, js).astype(jnp.uint32))
    s = interop.settings_from(js)
    st = interop.particle_state_from_numpy(jstate, "cpu")
    cam = trender.Camera(view_size=(s.size[0], s.size[0] * GH / GW))
    if name == "metaball":
        frame = tbinned.render_metaball_binned(st, s, GW, GH, cam)
    elif name == "metaball_clamp_blue":
        frame = tbinned.render_metaball_binned(st, s, GW, GH, cam,
                                               density_clamp_blue=True)
    elif name == "particles":
        frame = tbinned.render_particles_binned(st, s, GW, GH, cam)
    else:
        frame = trgrid.render_metaball_state(st, s, GW, GH, cam)
    _check_golden(name, frame)


@pytest.mark.parametrize("name", ["metaball", "metaball_clamp_blue",
                                  "particles", "grid"])
def test_read_png_matches_jax(name):
    path = os.path.join(GOLDEN_DIR, f"render_{name}.png")
    got = tio.read_png(path)
    want = np.asarray(jio.read_png(path))
    assert got.dtype == np.uint8 and got.shape == (GH, GW, 4)
    np.testing.assert_array_equal(got, want)
