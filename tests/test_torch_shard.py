"""PyTorch port, the row-band sharded resident step (parallel.shard,
parallel.comm_audit) on the CPU: the spec, the sharded grid and the
traffic audit against the JAX package (its virtual 8-device CPU mesh of
conftest.py), and the step against the port's single-device step. The
port's mesh is D CPU shards in one process, whose kernels run their plain
versions. (One synced step against JAX's sharded step:
test_torch_shard_jax.py.)

Against the single-device step, several steps: the same live count, no
loss, and sorted positions within 1e-5 (a merged edge row or a far mover
packs its slots in another order than the single-device rebin, so sums
may round apart by an ulp a step).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.parallel import comm_audit as jaudit
from tpufluid.parallel import shard as jshard

from tpufluid_torch import interop
from tpufluid_torch.ops import resident as tresident
from tpufluid_torch.params import SimSettings, TickParams
from tpufluid_torch.parallel import (
    build_resident_spec, comm_audit, gather_resident, init_sharded_resident,
    make_resident_mesh, make_sharded_resident_step, shard_grid_state,
    unshard_grid_state)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SORTED_POS_TOL = 1e-5
CPU = torch.device("cpu")


def _mesh(spec):
    return make_resident_mesh(spec, [CPU] * spec.n_devices)


def _sorted(pos):
    pos = np.asarray(pos)
    return pos[np.lexsort((pos[:, 1], pos[:, 0]))]


def _settings(n=512, **kw):
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(8.0, 8.0),
                       cell_capacity=8, **kw)


def _tstate(pos, vel):
    n = len(pos)
    pos = torch.from_numpy(np.asarray(pos, np.float32))
    return tresident.ParticleState(
        position=pos, predicted=pos.clone(),
        velocity=torch.from_numpy(np.asarray(vel, np.float32)),
        density=torch.ones(n), cell=torch.zeros(n, dtype=torch.int32),
        tick=torch.tensor(0, dtype=torch.int64))


# ------------------------------------------------------------------ spec

@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_build_resident_spec_matches_jax(d):
    ts = _settings(n=100_000)
    js = tpufluid.SimSettings(**dataclasses.asdict(ts))
    got = build_resident_spec(ts, d)
    want = jshard.build_resident_spec(js, d)
    assert (got.n_devices, got.rows_per_dev, got.gy_pad, got.far_capacity) \
        == (want.n_devices, want.rows_per_dev, want.gy_pad,
            want.far_capacity)
    assert got.settings == interop.settings_from(want.settings)
    assert build_resident_spec(ts, d, far_capacity=13).far_capacity == 16


def test_build_resident_spec_too_flat():
    s = SimSettings(particle_count=64, smoothing_radius=0.2,
                    size=(8.0, 1.2), cell_capacity=8)  # 8 state rows
    assert build_resident_spec(s, 2).rows_per_dev == 4
    with pytest.raises(ValueError, match="too flat"):
        build_resident_spec(s, 4)
    with pytest.raises(ValueError, match="too flat"):
        jshard.build_resident_spec(
            tpufluid.SimSettings(**dataclasses.asdict(s)), 4)


@pytest.mark.parametrize("d", [2, 8])
def test_init_and_gather_preserve_particles(d):
    s = _settings()
    spec = build_resident_spec(s, d)
    mesh = _mesh(spec)
    sgs = init_sharded_resident(spec, mesh)
    assert len(sgs.bands) == d
    assert all(b.pos_x.shape == (spec.rows_per_dev, 8, 128)
               for b in sgs.bands)
    # the bands join into the JAX package's sharded grid, bitwise
    jspec = jshard.build_resident_spec(
        tpufluid.SimSettings(**dataclasses.asdict(s)), d)
    jgs = jshard.init_sharded_resident(jspec)
    joined = unshard_grid_state(sgs)
    for f in ("pos_x", "pos_y", "vel_x", "vel_y", "occ_row"):
        np.testing.assert_array_equal(getattr(joined, f).numpy(),
                                      np.asarray(getattr(jgs, f)), f)
    ps, live = gather_resident(sgs, spec)
    ref, _ = tresident.to_particles(tresident.init_grid_state(s, CPU), s)
    assert int(live) == s.particle_count
    np.testing.assert_array_equal(_sorted(ps.position.numpy()),
                                  _sorted(ref.position.numpy()))


# ----------------------------------------------- port-only behaviours

def test_far_movers_cross_bands_survive():
    s = _settings(n=16)
    pos = np.zeros((16, 2), np.float32)
    pos[:, 0] = np.linspace(-3.5, 3.5, 16)
    pos[:, 1] = -3.5
    vel = np.zeros((16, 2), np.float32)
    vel[0] = (0.0, 240.0)
    vel[1] = (120.0, 120.0)
    spec = build_resident_spec(s, 8)
    mesh = _mesh(spec)
    sgs = shard_grid_state(tresident.from_particles(_tstate(pos, vel), s),
                           spec, mesh)
    step = make_sharded_resident_step(spec, mesh)
    params = TickParams.default(CPU, pressure_constant=0.0,
                                viscosity_coefficient=0.0)
    start = int(sgs.bands[0].occ_row.max())
    assert start > 0
    for _ in range(3):
        sgs, stats = step(sgs, params)
    assert int(stats["n_valid"].sum()) == 16
    assert int(sgs.lost) == 0
    ps, live = gather_resident(sgs, spec)
    assert int(live) == 16
    assert np.all(np.isfinite(ps.position.numpy()))
    # the vertical mover left band 0 for a band several bands up
    top = ps.position.numpy()[:16, 1].max()
    assert top > -3.5 + 3 * spec.rows_per_dev * 0.2


def test_far_capacity_overflow_counted():
    """12 far movers from one band with far_capacity=8: 4 are dropped
    and counted in ``lost``; the 8 sent arrive."""
    s = _settings(n=12)
    pos = np.zeros((12, 2), np.float32)
    pos[:, 0] = np.linspace(-3.0, 3.0, 12)
    pos[:, 1] = -3.5
    vel = np.zeros((12, 2), np.float32)
    vel[:, 1] = 240.0
    spec = build_resident_spec(s, 4, far_capacity=8)
    mesh = _mesh(spec)
    sgs = shard_grid_state(tresident.from_particles(_tstate(pos, vel), s),
                           spec, mesh)
    sgs, stats = make_sharded_resident_step(spec, mesh)(
        sgs, TickParams.default(CPU))
    assert int(sgs.lost) == 4
    assert int(stats["n_valid"].sum()) == 8


def test_merge_past_capacity_counted():
    """A cell on a band's first row fills to K from its own band; one more
    particle arrives from the band below: the merge overflow is counted,
    as the single-device rebin counts it."""
    s = _settings(n=9)
    spec = build_resident_spec(s, 4)
    r = spec.rows_per_dev
    h = s.smoothing_radius
    # global cell row r (band 1's first row) spans [(r-1)h - 4, r h - 4)
    y_in = (r - 0.5) * h - 4.0
    pos = np.zeros((9, 2), np.float32)
    pos[:8, 0] = 0.05 + 0.01 * np.arange(8)
    pos[:8, 1] = y_in
    pos[8] = (0.1, y_in - h)  # band 0's last row, moving up one row
    vel = np.zeros((9, 2), np.float32)
    vel[8, 1] = h / (1.0 / 120.0)
    params = TickParams.default(CPU, pressure_constant=0.0,
                                viscosity_coefficient=0.0)
    gs = tresident.from_particles(_tstate(pos, vel), s)
    assert int(gs.lost) == 0
    mesh = _mesh(spec)
    sgs, stats = make_sharded_resident_step(spec, mesh)(
        shard_grid_state(gs, spec, mesh), params)
    single = tresident.make_grid_step(s)(gs, params)
    assert int(sgs.lost) == int(single.lost) == 1
    assert int(stats["n_valid"].sum()) == 8


@pytest.mark.parametrize("variant", [
    "base", "wrap", "surface_tension", "adaptive", "forcefield"])
def test_sharded_matches_single_device(variant):
    s = _settings(texture_size=(80, 80))
    params = TickParams.default(CPU, gravity=(0.0, -9.8))
    kw, args = {}, ()
    if variant == "wrap":
        kw["x_boundary"] = "wrap"
        params = TickParams.default(CPU, gravity=(9.8, -2.0))
    elif variant == "surface_tension":
        # surface tension acts only where h > 1
        s = dataclasses.replace(s, particle_spacing=1.0,
                                smoothing_radius=1.5, size=(32.0, 32.0))
        kw["surface_tension"] = True
    elif variant == "adaptive":
        kw["adaptive_subsampling"] = True
    elif variant == "forcefield":
        kw["has_force_field"] = True
        f = np.zeros((80, 80, 2), np.float32)
        f[:, 50:, 0] = -3.0
        args = (torch.from_numpy(f),)
    spec = build_resident_spec(s, 4)
    mesh = _mesh(spec)
    step = make_sharded_resident_step(spec, mesh, **kw)
    sgs = init_sharded_resident(spec, mesh)
    ref = tresident.init_grid_state(s, CPU)
    rstep = tresident.make_grid_step(s, **kw)
    for _ in range(4):
        sgs, stats = step(sgs, params, *args)
        ref = rstep(ref, params, *args)
    n = s.particle_count
    assert int(stats["n_valid"].sum()) == n
    assert int(sgs.lost) == 0 and int(ref.lost) == 0
    ps, live = gather_resident(sgs, spec)
    pr, liver = tresident.to_particles(ref, s)
    assert int(live) == int(liver) == n
    np.testing.assert_allclose(_sorted(ps.position.numpy()[:n]),
                               _sorted(pr.position.numpy()[:n]),
                               rtol=0, atol=SORTED_POS_TOL)


# ----------------------------------------------------------- comm audit

@pytest.mark.parametrize("d", [2, 8])
def test_audit_matches_formula_and_jax(d):
    ts = _settings()
    spec = build_resident_spec(ts, d)
    mesh = _mesh(spec)
    step = make_sharded_resident_step(spec, mesh)
    sgs = init_sharded_resident(spec, mesh)
    params = TickParams.default(CPU)
    audit = comm_audit.audit_step(step, sgs, params)
    model = comm_audit.resident_comm_formula(spec)
    assert audit["ppermute_bytes_per_dir"] == model["bytes_per_dir"]
    assert audit["all_gather_bytes_unconditional"] == 0
    assert audit["all_gather_bytes_conditional"] == model["far_packet_bytes"]
    assert audit["ppermute_bytes_conditional"] == 0
    assert all(o.nbytes <= 8 for o in audit["ops"] if o.primitive == "psum")

    # the far packet counts the same whether its gate opens or not
    pos = np.array([[0.0, -3.0], [1.0, -3.0]], np.float32)
    vel = np.array([[0.0, 240.0], [0.0, 0.0]], np.float32)
    s2 = _settings(n=2)
    spec2 = build_resident_spec(s2, d)
    mesh2 = _mesh(spec2)
    far = shard_grid_state(tresident.from_particles(_tstate(pos, vel), s2),
                           spec2, mesh2)
    open_gate = comm_audit.audit_step(
        make_sharded_resident_step(spec2, mesh2), far, params)
    assert open_gate["all_gather_bytes_conditional"] \
        == model["far_packet_bytes"]

    jspec = jshard.build_resident_spec(
        tpufluid.SimSettings(**dataclasses.asdict(ts)), d)
    jmesh = jshard.make_resident_mesh(jspec)
    jaud = jaudit.audit_step(
        jshard.make_sharded_resident_step(jspec, mesh=jmesh),
        jshard.init_sharded_resident(jspec, mesh=jmesh),
        tpufluid.TickParams.default())
    for key in ("ppermute_bytes_total", "ppermute_bytes_per_dir",
                "ppermute_bytes_conditional", "all_gather_bytes_conditional",
                "all_gather_bytes_unconditional", "psum_scalars"):
        assert audit[key] == jaud[key], key
    with pytest.raises(ValueError, match="single-step"):
        def two(sgs, p):
            return step(step(sgs, p)[0], p)
        two.mesh = mesh
        comm_audit.audit_step(two, sgs, params)
