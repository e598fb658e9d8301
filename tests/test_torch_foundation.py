"""PyTorch port, foundation layer: parameters, spawn lattice, binning,
slot-grid construction, PRNG and interop, each held BITWISE against the
JAX package on the same numpy inputs (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid import params as jparams
from tpufluid.models import scenes as jscenes
from tpufluid.ops import dense as jdense
from tpufluid.ops import grid as jgrid
from tpufluid.ops import prng as jprng
from tpufluid.ops import resident as jresident
from tpufluid.ops.pallas import sph as jsph

import tpufluid_torch as tt
from tpufluid_torch import interop
from tpufluid_torch import params as tparams
from tpufluid_torch.models import scenes as tscenes
from tpufluid_torch.ops import dense as tdense
from tpufluid_torch.ops import fused as tfused
from tpufluid_torch.ops import grid as tgrid
from tpufluid_torch.ops import prng as tprng
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


def _eq(got, want):
    """Bitwise equality of a torch result and a JAX/numpy reference."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.float32:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


SETTINGS = [
    dict(particle_count=512, size=(4.8, 4.8), cell_capacity=8),
    dict(particle_count=1000, size=(6.0, 4.0), cell_capacity=32,
         spawn_columns=40),
    dict(particle_count=10, smoothing_radius=0.5, size=(4.0, 4.0)),
]


@pytest.mark.parametrize("kw", SETTINGS)
def test_settings_properties_match(kw):
    js = tpufluid.SimSettings(**kw)
    ts = interop.settings_from(js)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for name in ("grid_w", "grid_h", "num_cells", "sqr_radius"):
        assert getattr(ts, name) == getattr(js, name)
    assert dataclasses.asdict(ts.kernel_norms()) == dataclasses.asdict(
        js.kernel_norms())
    assert tresident.pad_capacity(ts).cell_capacity == \
        jresident.pad_capacity(js).cell_capacity
    assert tresident._rows(ts) == jresident._rows(js)
    assert tresident._gxp(ts) == jresident._gxp(js)


@pytest.mark.parametrize("spawn_columns", [None, 40])
def test_init_state_bitwise(spawn_columns):
    js = tpufluid.SimSettings(particle_count=1500, size=(8.0, 8.0),
                              spawn_columns=spawn_columns)
    want = tpufluid.init_state(js)
    got = tt.init_state(interop.settings_from(js), "cpu")
    for name in ("position", "predicted", "velocity", "density", "cell"):
        _eq(getattr(got, name), getattr(want, name))
    assert int(got.tick) == int(want.tick) == 0


def test_cell_xy_and_id_bitwise_incl_exact_division_wall():
    # 4.0 / 0.5 == 8.0 exactly in f32: wall points must stay off the
    # sentinel ring (tests/test_sentinel_ring.py)
    js = tpufluid.SimSettings(particle_count=8, smoothing_radius=0.5,
                              size=(4.0, 4.0))
    ts = interop.settings_from(js)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.0, 2.0, (64, 2)).astype(np.float32)
    pts[:4] = [(2.0, 2.0), (-2.0, -2.0), (2.0, -2.0), (0.0, 2.0)]
    _eq(tgrid.cell_xy(torch.from_numpy(pts), ts),
        jgrid.cell_xy(jnp.asarray(pts), js))
    _eq(tgrid.cell_id(torch.from_numpy(pts), ts),
        jgrid.cell_id(jnp.asarray(pts), js))
    xy = tgrid.cell_xy(torch.from_numpy(pts[:2]), ts).numpy()
    np.testing.assert_array_equal(xy, [[8, 8], [1, 1]])


def _random_points(n, half, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-half, half, (n, 2)).astype(np.float32)
    pts[n // 2:n // 2 + 20] = pts[0]  # a crowded cell
    return pts


def test_bin_particles_ranks_build_grid_bitwise():
    js = tpufluid.SimSettings(particle_count=400, size=(3.0, 3.0),
                              cell_capacity=8)
    ts = interop.settings_from(js)
    pts = _random_points(400, 1.5, 1)
    vel = np.random.default_rng(2).normal(size=(400, 2)).astype(np.float32)
    jb = jgrid.bin_particles(jgrid.cell_id(jnp.asarray(pts), js), js)
    tb = tgrid.bin_particles(tgrid.cell_id(torch.from_numpy(pts), ts), ts)
    for a, b in zip(tb, jb):
        _eq(a, b)
    _eq(tdense.ranks(tb.sorted_cells), jdense.ranks(jb.sorted_cells))

    dims = (tresident._rows(ts), ts.grid_w)
    cols = [pts[:, 0], pts[:, 1], vel[:, 0], vel[:, 1]]
    perm = np.asarray(jb.perm)
    jg = jdense.build_grid_cols(*(jnp.asarray(c[perm]) for c in cols),
                                jb.sorted_cells, js, dims=dims)
    tg = tdense.build_grid_cols(*(torch.from_numpy(c[perm]) for c in cols),
                                tb.sorted_cells, ts, dims=dims)
    for name in ("flat", "px", "py", "vx", "vy", "valid", "n_dropped"):
        _eq(getattr(tg, name), getattr(jg, name))
    assert int(tg.n_dropped) > 0  # the crowded cell overflows


def test_prng_bitwise():
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    seeds[:3] = [0, 1, 2**32 - 1]
    t_seeds = torch.from_numpy(seeds.astype(np.int64))
    _eq(tprng.xorshift32(t_seeds), jprng.xorshift32(jnp.asarray(seeds)))
    _eq(tprng.xorshift32(t_seeds), jsph._xorshift32(jnp.asarray(seeds)))
    _eq(tprng.u32_to_uniform01(t_seeds),
        jprng.u32_to_uniform01(jnp.asarray(seeds)))
    _eq(tprng.u32_to_uniform01(t_seeds), jsph._u01(jnp.asarray(seeds)))
    f = rng.normal(size=4096).astype(np.float32) * 10.0
    f[:3] = [0.0, -0.0, 1e9]
    _eq(tprng.bitcast_u32(torch.from_numpy(f)),
        jsph._bitcast_u32(jnp.asarray(f)))
    pts = rng.normal(size=(2048, 2)).astype(np.float32)
    _eq(tprng.position_seed(torch.from_numpy(pts)),
        jprng.position_seed(jnp.asarray(pts)))
    seed = tprng.position_seed(torch.from_numpy(pts))
    # the draws are bitwise; XLA's fused norm + divide differs by <= 1 ulp
    np.testing.assert_allclose(
        tprng.rand_unit_vector(seed).numpy(),
        np.asarray(jprng.rand_unit_vector(jprng.position_seed(
            jnp.asarray(pts)))), rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("kw,gravity,k", [
    (dict(particle_count=100_000), (0.0, -9.8), 50.0),
    (dict(particle_count=4096, size=(16.0, 16.0)), (0.0, -9.8), 50.0),
    (dict(particle_count=16384, size=(13.0, 26.0)), (3.0, -30.0), 20.0),
    (dict(particle_count=64, size=(3.2, 3.2)), (0.0, 0.0), 50.0),
])
def test_suggest_cell_capacity_matches(kw, gravity, k):
    js = tpufluid.SimSettings(**kw)
    ts = interop.settings_from(js)
    jp = tpufluid.TickParams.default(gravity=gravity, pressure_constant=k)
    tp = interop.tick_params_from_numpy(jp, "cpu")
    assert tparams.suggest_cell_capacity(ts) == \
        jparams.suggest_cell_capacity(js)
    assert tparams.suggest_cell_capacity(ts, tp) == \
        jparams.suggest_cell_capacity(js, jp)
    assert tparams.suggest_cell_capacity(ts, tp, safety=1.0, rounded=False) \
        == jparams.suggest_cell_capacity(js, jp, safety=1.0, rounded=False)


@pytest.mark.parametrize("name", ["default_scene", "dam_break_4k",
                                  "scene_64k", "scene_256k", "scene_1m",
                                  "scene_4m"])
def test_scenes_match(name):
    js = getattr(jscenes, name)()
    ts = getattr(tscenes, name)("cpu")
    assert ts.name == js.name
    assert dataclasses.asdict(ts.settings) == dataclasses.asdict(js.settings)
    for f in dataclasses.fields(ts.params):
        _eq(getattr(ts.params, f.name), getattr(js.params, f.name))


def test_interop_round_trips():
    js = tpufluid.SimSettings(particle_count=300, size=(3.0, 3.0))
    jstate = tpufluid.init_state(js)
    tstate = interop.particle_state_from_numpy(jstate, "cpu")
    for name in ("position", "predicted", "velocity", "density", "cell"):
        _eq(getattr(tstate, name), getattr(jstate, name))
    jgs = jresident.from_particles(jstate, js)
    tgs = interop.grid_state_from_numpy(jgs, "cpu")
    back = interop.grid_state_to_numpy(tgs)
    for name in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "tick",
                 "lost"):
        _eq(back[name], getattr(jgs, name))
    assert back["tick"].dtype == np.asarray(jgs.tick).dtype
    jp = tpufluid.TickParams.default(gravity=(1.0, -2.0), mouse_state=-1,
                                     mouse_pos=(0.5, 0.25))
    tp = interop.tick_params_from_numpy(jp, "cpu")
    for f in dataclasses.fields(tp):
        _eq(getattr(tp, f.name), getattr(jp, f.name))


def test_tick_params_are_live_and_on_their_device():
    tp = tt.TickParams.default("cpu")
    assert all(getattr(tp, f.name).device.type == "cpu"
               for f in dataclasses.fields(tp))
    assert tp.mouse_state.dtype == torch.int32
    with pytest.raises(TypeError):
        tt.TickParams.default("cpu", gravitation=1.0)

    # assigning a tunable changes the next step of an already-built step
    s = tt.SimSettings(particle_count=64, size=(3.2, 3.2))
    step = tresident.make_grid_step(s)
    gs = tresident.init_grid_state(s, "cpu")
    a = step(gs, tp)
    tp.gravity = torch.tensor([0.0, -50.0])
    b = step(gs, tp)
    assert step is tresident.make_grid_step(s)
    live = tresident.valid_mask(gs)
    assert (b.vel_y[live] < a.vel_y[live]).all()


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 8, 128), device="meta")
    occ = torch.empty((4,), dtype=torch.int32, device="meta")
    s = tt.SimSettings(particle_count=8, size=(0.8, 0.4))
    with pytest.raises(NotImplementedError):
        tfused.rebin(meta, meta, meta, meta, occ, 0.01, s)
    with pytest.raises(ValueError):
        tfused.rebin(meta, meta, meta, torch.zeros(4, 8, 128), occ, 0.01, s)
