"""PyTorch port, the slab sharding of the per-step engines
(parallel.shard: ShardSpec .. gather_state) against the JAX package's on
the CPU, and the semantics of tests/test_shard.py on D CPU shards.

The JAX step runs on the virtual 8-device CPU mesh of conftest.py; the
port's mesh is D CPU shards in one process. Spec and init are bitwise;
one synced step from the same ShardedState (numpy seeded particles
spread over the whole world, some crossing a slab edge in the step) has
valid masks, stats, the sorted combined set's cells and local flags
bitwise, and positions and velocities within BASELINE.md's per-step
bounds (|dpos| <= 4.8e-7, |dvel| <= 3.8e-5, relative where the value
exceeds 1). The pallas mode's JAX step runs its kernels in interpret
mode, so it has a file of its own (test_torch_shard_slab_pallas.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import tpufluid
from tpufluid.ops import grid as jgrid
from tpufluid.parallel import comm_audit as jaudit
from tpufluid.parallel import shard as jshard

from tpufluid_torch import TickParams, init_state, interop, make_step
from tpufluid_torch.native.distfield import chamfer_push_field
from tpufluid_torch.params import SimSettings
from tpufluid_torch.parallel import (
    build_shard_spec, comm_audit, gather_state, init_sharded, make_mesh,
    make_sharded_step)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POS_TOL, VEL_TOL = 4.8e-7, 3.8e-5
CPU = torch.device("cpu")


def shard_settings(n=512, cell_capacity=32, **kw):
    """tests/test_shard.py's world: 16 x 8, h 0.2 (82 x 42 cells; at D=8
    slabs of 10 columns, a slab-local grid 14 wide, padded to 128)."""
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(16.0, 8.0),
                       cell_capacity=cell_capacity, **kw)


def _jax(settings):
    return tpufluid.SimSettings(**dataclasses.asdict(settings))


def _mesh(spec):
    return make_mesh(spec, [CPU] * spec.n_devices)


def sorted_points(pos):
    pos = np.asarray(pos)
    return pos[np.lexsort((pos[:, 1], pos[:, 0]))]


# ------------------------------------------------------- against JAX

@pytest.mark.parametrize("d,kw", [
    (2, {}), (8, {}),
    (8, dict(capacity_factor=3.0, halo_capacity=100, migration_capacity=20)),
])
def test_spec_matches_jax(d, kw):
    for s in (shard_settings(), shard_settings(2048, spawn_columns=150)):
        got = build_shard_spec(s, d, **kw)
        want = jshard.build_shard_spec(_jax(s), d, **kw)
        for f in ("n_devices", "capacity", "halo_capacity",
                  "migration_capacity", "col_bounds"):
            assert getattr(got, f) == getattr(want, f), f


def test_spec_and_init_refuse_as_jax():
    s = shard_settings()
    for build in (build_shard_spec, jshard.build_shard_spec):
        with pytest.raises(ValueError, match="grid too narrow"):
            build(s if build is build_shard_spec else _jax(s), 27)
    spec = build_shard_spec(s, 2, capacity_factor=0.5)
    jspec = jshard.build_shard_spec(_jax(s), 2, capacity_factor=0.5)
    assert spec.capacity == jspec.capacity
    with pytest.raises(ValueError, match="init overflow"):
        init_sharded(spec, _mesh(spec))
    with pytest.raises(ValueError, match="init overflow"):
        jshard.init_sharded(jspec)


@pytest.mark.parametrize("d", [2, 8])
def test_init_matches_jax(d):
    s = shard_settings(2048, spawn_columns=150)  # a lattice over all slabs
    spec = build_shard_spec(s, d)
    got = interop.sharded_state_to_numpy(init_sharded(spec, _mesh(spec)))
    want = jshard.init_sharded(jshard.build_shard_spec(_jax(s), d))
    for f in ("position", "velocity", "valid"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    assert got["tick"] == np.asarray(want.tick)
    assert got["valid"].reshape(d, -1).sum(axis=1).min() > 0


def _obstacle_field(tex):
    """A push-out field f32[tex, tex, 2] (pixels) around a dark disc."""
    frame = np.full((tex, tex), 255, np.uint8)
    yy, xx = np.mgrid[:tex, :tex]
    frame[(xx - 0.6 * tex) ** 2 + (yy - 0.4 * tex) ** 2 < (0.15 * tex) ** 2] = 0
    return chamfer_push_field(frame, CPU).numpy()


def synced_case(d, mode, seed=7, n=512, fast=32, speed=30.0, field=False,
                **spec_kw):
    """Both packages' sharded step of ``mode`` once from the same state:
    ``n`` particles at seeded positions over the whole world, seeded
    velocities, ``fast`` of them moving at ``speed`` in x (30: 1.25 cells
    a step, across slab edges), tick 5; with ``field`` an obstacle's
    push-out field too (texture 72: texels off the cell centres). Returns
    a dict: the JAX step's output and stats
    (``jout``, ``jstats``), the port's as numpy and its stats (``got``,
    ``tstats``), each step with its state and params (``jax``, ``port``)
    and the particles whose cell column after a move of v dt belongs to
    another slab (``crossing``)."""
    ts = shard_settings(n, cell_capacity=8,
                        **(dict(texture_size=(72, 72)) if field else {}))
    js = _jax(ts)
    jspec = jshard.build_shard_spec(js, d, **spec_kw)
    rng = np.random.default_rng(seed)
    half = np.asarray(ts.size, np.float32) * np.float32(0.5)
    pos = rng.uniform(-half + 0.05, half - 0.05, (n, 2)).astype(np.float32)
    vel = rng.normal(0.0, 3.0, (n, 2)).astype(np.float32)
    vel[:fast, 0] = np.where(rng.random(fast) < 0.5, -speed, speed)
    cx = np.asarray(jgrid.cell_xy(jnp.asarray(pos), js))[:, 0]
    owner = np.clip(np.searchsorted(np.asarray(jspec.col_bounds)[1:-1], cx,
                                    side="right"), 0, d - 1)
    c = jspec.capacity
    gpos = np.zeros((d * c, 2), np.float32)
    gvel = np.zeros((d * c, 2), np.float32)
    gvalid = np.zeros((d * c,), bool)
    for i in range(d):
        sel = np.nonzero(owner == i)[0]
        assert len(sel) <= c
        gpos[i * c:i * c + len(sel)] = pos[sel]
        gvel[i * c:i * c + len(sel)] = vel[sel]
        gvalid[i * c:i * c + len(sel)] = True
    jmesh = jshard.make_mesh(jspec)
    shard = NamedSharding(jmesh, P("x"))
    rep = NamedSharding(jmesh, P())
    jst = jshard.ShardedState(
        position=jax.device_put(jnp.asarray(gpos), shard),
        velocity=jax.device_put(jnp.asarray(gvel), shard),
        valid=jax.device_put(jnp.asarray(gvalid), shard),
        tick=jax.device_put(jnp.uint32(5), rep))
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    jstep = jshard.make_sharded_step(jspec, mesh=jmesh, debug=True,
                                     neighbor_mode=mode,
                                     has_force_field=field)
    extra = (_obstacle_field(72),) if field else ()
    jout, jstats = jstep(jst, jp, *(jnp.asarray(f) for f in extra))

    spec = build_shard_spec(ts, d, **spec_kw)
    assert spec.capacity == c
    tst = interop.sharded_state_from_numpy(jst, [CPU] * d)
    tp = interop.tick_params_from_numpy(jp, CPU)
    tstep = make_sharded_step(spec, _mesh(spec), debug=True,
                              neighbor_mode=mode, has_force_field=field)
    tout, tstats = tstep(tst, tp, *(torch.from_numpy(f) for f in extra))
    ncx = np.asarray(jgrid.cell_xy(jnp.asarray(pos + vel / 120.0), js))[:, 0]
    crossing = int((np.clip(np.searchsorted(
        np.asarray(jspec.col_bounds)[1:-1], ncx, side="right"), 0, d - 1)
        != owner).sum())
    return dict(jout=jout, jstats=jstats,
                got=interop.sharded_state_to_numpy(tout), tstats=tstats,
                jax=(jstep, jst, jp, *(jnp.asarray(f) for f in extra)),
                port=(tstep, tst, tp, *(torch.from_numpy(f) for f in extra)),
                crossing=crossing)


def _within(got, want, bound, what):
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= bound, f"{what}: max rel err {err.max()} > {bound}"


def check_synced(case):
    """Valid masks, stats, the combined set's sorted cells and local
    flags bitwise; invalid slots zero in both; positions and velocities
    within the per-step bounds."""
    jout, jstats, got, tstats = (case[k] for k in ("jout", "jstats", "got",
                                                    "tstats"))
    valid = np.asarray(jout.valid)
    np.testing.assert_array_equal(got["valid"], valid)
    assert int(got["tick"]) == int(jout.tick)
    for k in ("n_valid", "halo_dropped", "migration_dropped", "dbg_cells",
              "dbg_local"):
        np.testing.assert_array_equal(tstats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)
    for f, bound in (("position", POS_TOL), ("velocity", VEL_TOL)):
        want = np.asarray(getattr(jout, f))
        assert not got[f][~valid].any() and not want[~valid].any()
        _within(got[f][valid], want[valid], bound, f)


@pytest.mark.parametrize("mode", ["grid", "dense"])
@pytest.mark.parametrize("d", [2, 8])
def test_synced_step_matches_jax(d, mode):
    case = synced_case(d, mode)
    check_synced(case)
    assert int(case["tstats"]["n_valid"].sum()) == 512
    assert case["crossing"] > 0  # particles move across slab edges


def test_synced_step_with_field_matches_jax():
    """An obstacle force field, sampled at each slab's predicted positions
    (the field on every shard's device)."""
    case = synced_case(2, "grid", seed=5, field=True)
    check_synced(case)
    assert int(case["tstats"]["n_valid"].sum()) == 512


def test_synced_step_with_drops_matches_jax():
    """Undersized halo and migration buffers (8 slots) and half the
    particles moving 10 cells a step: the deterministic drops (the first
    slots by index survive) and their counts match JAX."""
    case = synced_case(2, "grid", seed=3, fast=256, speed=240.0,
                       halo_capacity=8, migration_capacity=8)
    check_synced(case)
    assert int(case["tstats"]["halo_dropped"].sum()) > 0
    assert int(case["tstats"]["migration_dropped"].sum()) > 0


@pytest.mark.parametrize("d", [2, 8])
def test_audit_matches_jax(d):
    """The port's audited ppermute bytes a direction equal JAX's on the
    same spec: the halo and migration packs, (8 + 8 + 1) B a slot."""
    case = synced_case(d, "grid")
    want = jaudit.audit_step(*case["jax"])
    got = comm_audit.audit_step(*case["port"])
    spec = build_shard_spec(shard_settings(cell_capacity=8), d)
    formula = (spec.halo_capacity + spec.migration_capacity) * (8 + 8 + 1)
    assert got["ppermute_bytes_per_dir"] == want["ppermute_bytes_per_dir"]
    assert got["ppermute_bytes_per_dir"] == formula
    assert got["all_gather_bytes_unconditional"] == 0
    assert got["psum_scalars"] == want["psum_scalars"] == 0


# ----------------------------------- tests/test_shard.py's semantics

def test_init_preserves_all_particles():
    s = shard_settings()
    spec = build_shard_spec(s, 8)
    st = init_sharded(spec, _mesh(spec))
    assert int(sum(int(sl.valid.sum()) for sl in st.slabs)) == 512
    np.testing.assert_array_equal(
        sorted_points(gather_state(st).position.numpy()),
        sorted_points(init_state(s, CPU).position.numpy()))


def test_sharded_dense_matches_single_device_dense():
    """The slab-local dense grids reproduce the single-device dense step
    (same summation order per cell => near-bitwise). K=8: the dense
    passes run thousands of small PyTorch calls a step on the CPU."""
    s = shard_settings(cell_capacity=8)
    spec = build_shard_spec(s, 8)
    params = TickParams.default(CPU, gravity=(0.0, -9.8))
    sh, single = init_sharded(spec, _mesh(spec)), init_state(s, CPU)
    sh_step = make_sharded_step(spec, _mesh(spec), neighbor_mode="dense")
    single_step = make_step(s, neighbor_mode="dense")
    for _ in range(2):
        sh, stats = sh_step(sh, params)
        single = single_step(single, params)
    assert int(stats["n_valid"].sum()) == 512
    np.testing.assert_allclose(
        sorted_points(gather_state(sh).position.numpy()),
        sorted_points(single.position.numpy()), atol=1e-6)


def test_sharded_matches_single_device():
    s = shard_settings()
    spec = build_shard_spec(s, 8)
    params = TickParams.default(CPU, gravity=(0.0, -9.8))
    sh, single = init_sharded(spec, _mesh(spec)), init_state(s, CPU)
    sh_step = make_sharded_step(spec, _mesh(spec))
    single_step = make_step(s)
    for i in range(5):
        sh, stats = sh_step(sh, params)
        single = single_step(single, params)
        assert int(stats["halo_dropped"].sum()) == 0, f"step {i}"
        assert int(stats["migration_dropped"].sum()) == 0
        assert int(stats["n_valid"].sum()) == 512
        np.testing.assert_allclose(
            sorted_points(gather_state(sh).position.numpy()),
            sorted_points(single.position.numpy()), atol=5e-4,
            err_msg=f"step {i}")


def test_migration_across_slabs():
    """Strong sideways gravity pushes the block across slab edges; every
    shard has room for the whole set (the pile-up fills the last slab)."""
    s = shard_settings()
    spec = build_shard_spec(s, 8, capacity_factor=3.0)
    params = TickParams.default(CPU, gravity=(30.0, 0.0))
    st = init_sharded(spec, _mesh(spec))
    step = make_sharded_step(spec, _mesh(spec))
    occ = lambda st: np.array([int(sl.valid.sum()) for sl in st.slabs])
    before = occ(st)
    for _ in range(40):
        st, stats = step(st, params)
    assert int(stats["n_valid"].sum()) == 512
    after = occ(st)
    assert after[-2:].sum() > before[-2:].sum()
    pos = gather_state(st).position.numpy()
    assert np.all(np.isfinite(pos))
    assert pos[:, 0].mean() > 0.5


def test_sharded_determinism():
    s = shard_settings(256)
    spec = build_shard_spec(s, 8)
    params = TickParams.default(CPU, gravity=(3.0, -9.8))
    step = make_sharded_step(spec, _mesh(spec))

    def run():
        st = init_sharded(spec, _mesh(spec))
        for _ in range(10):
            st, _ = step(st, params)
        return interop.sharded_state_to_numpy(st)

    a, b = run(), run()
    np.testing.assert_array_equal(a["position"], b["position"])
    np.testing.assert_array_equal(a["velocity"], b["velocity"])
    np.testing.assert_array_equal(a["valid"], b["valid"])


def test_two_device_mesh():
    s = shard_settings(128)
    spec = build_shard_spec(s, 2)
    step = make_sharded_step(spec, _mesh(spec))
    st = init_sharded(spec, _mesh(spec))
    for _ in range(3):
        st, stats = step(st, TickParams.default(CPU))
    assert int(stats["n_valid"].sum()) == 128
    assert gather_state(st).position.shape == (128, 2)
