"""PyTorch port, one synced step of the row-band sharded resident step
(parallel.shard) against the JAX package's on the CPU.

The JAX step runs on the virtual 8-device CPU mesh of conftest.py, its
kernels in interpret mode (about 20 s a case on one worker, hence files
of their own: D = 2 here, D = 8 in test_torch_shard_jax8.py); the port's
mesh is D CPU shards in one process, whose kernels run their plain
versions. Both start from the same state: the
slot layout (which slots are live), ``occ_row``, ``lost``, ``tick`` and
``n_valid`` must be bitwise, positions and velocities within BASELINE.md's
per-step bounds (|dpos| <= 4.8e-7, |dvel| <= 3.8e-5, relative where the
value exceeds 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops import resident as jresident
from tpufluid.ops.pallas.fused import SENTINEL as JSENTINEL
from tpufluid.parallel import shard as jshard
from tpufluid.state import ParticleState as JParticleState

from tpufluid_torch import interop
from tpufluid_torch.native.distfield import chamfer_push_field
from tpufluid_torch.ops.fused import SENTINEL_HALF
from tpufluid_torch.params import SimSettings
from tpufluid_torch.parallel import (
    build_resident_spec, make_resident_mesh, make_sharded_resident_step,
    shard_grid_state, unshard_grid_state)


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


def _mesh(spec):
    return make_resident_mesh(spec, [CPU] * spec.n_devices)


def _settings(n, **kw):
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(8.0, 8.0),
                       cell_capacity=8, **kw)


def _far_mover_scene():
    """tests/test_shard.py::test_resident_sharded_far_movers' shape: 16
    particles on the floor, two far movers (one crosses several bands), and
    a seeded cloud for pressure and band-edge merges."""
    rng = np.random.default_rng(9)
    pos = np.zeros((64, 2), np.float32)
    pos[:16, 0] = np.linspace(-3.5, 3.5, 16)
    pos[:16, 1] = -3.5
    pos[16:] = rng.uniform(-3.9, 3.9, (48, 2)).astype(np.float32)
    vel = rng.normal(0.0, 3.0, (64, 2)).astype(np.float32)
    vel[0] = (0.0, 240.0)   # ~10 rows per step: crosses several bands
    vel[1] = (120.0, 120.0)
    return pos, vel


def _obstacle_field(tex):
    frame = np.full((tex, tex), 255, np.uint8)
    yy, xx = np.mgrid[:tex, :tex]
    r2 = (xx - 0.6 * tex) ** 2 + (yy - 0.4 * tex) ** 2
    frame[r2 < (0.15 * tex) ** 2] = 0
    return chamfer_push_field(frame, CPU).numpy()


def _jax_sharded(jgs_global, jspec, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    shard = NamedSharding(mesh, P("x"))
    rep = NamedSharding(mesh, P())
    pad = jspec.gy_pad - jgs_global.pos_x.shape[0]

    def padrow(a, fill):
        p = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, p], axis=0)

    return jresident.GridState(
        pos_x=jax.device_put(padrow(jgs_global.pos_x, JSENTINEL), shard),
        pos_y=jax.device_put(padrow(jgs_global.pos_y, JSENTINEL), shard),
        vel_x=jax.device_put(padrow(jgs_global.vel_x, 0.0), shard),
        vel_y=jax.device_put(padrow(jgs_global.vel_y, 0.0), shard),
        occ_row=jax.device_put(padrow(jgs_global.occ_row, 0), shard),
        tick=jax.device_put(jgs_global.tick, rep),
        lost=jax.device_put(jgs_global.lost, rep))


def _within(got, want, bound, mask, what):
    got, want = got[mask], want[mask]
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= bound, f"{what}: max rel err {err.max()} > {bound}"


@pytest.mark.parametrize("has_ff", [False, True])
def test_synced_step_matches_jax(has_ff):
    check_synced_step(2, has_ff)


def check_synced_step(d, has_ff):
    """One step of both sharded steps on D shards from the same state
    (tests/test_torch_shard_jax8.py runs D = 8)."""
    tex = 72  # texels off the cell centres (ROADMAP queue 3 item 2)
    ts = _settings(n=64, texture_size=(tex, tex))
    js = tpufluid.SimSettings(**dataclasses.asdict(ts))
    pos, vel = _far_mover_scene()
    jpos, jvel = jnp.asarray(pos), jnp.asarray(vel)
    jstate = JParticleState(
        position=jpos, predicted=jpos, velocity=jvel, density=jnp.ones(64),
        cell=jnp.zeros(64, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    jspec = jshard.build_resident_spec(js, d)
    jmesh = jshard.make_resident_mesh(jspec)
    jgs = _jax_sharded(jresident.from_particles(jstate, js), jspec, jmesh)
    jp = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    jstep = jshard.make_sharded_resident_step(jspec, mesh=jmesh,
                                              has_force_field=has_ff)

    spec = build_resident_spec(ts, d)
    tgs = shard_grid_state(interop.grid_state_from_numpy(jgs, CPU), spec,
                           _mesh(spec))
    tp = interop.tick_params_from_numpy(jp, CPU)
    tstep = make_sharded_resident_step(spec, _mesh(spec),
                                       has_force_field=has_ff)
    args = ()
    if has_ff:
        field = _obstacle_field(tex)
        args = (torch.from_numpy(field),)
        jout, jstats = jstep(jgs, jp, jnp.asarray(field))
    else:
        jout, jstats = jstep(jgs, jp)
    tout, tstats = tstep(tgs, tp, *args)
    got = unshard_grid_state(tout)
    np.testing.assert_array_equal(tstats["n_valid"].numpy(),
                                  np.asarray(jstats["n_valid"]))
    assert int(tout.lost) == int(jout.lost) == 0
    assert int(tout.tick) == int(jout.tick)
    np.testing.assert_array_equal(got.occ_row.numpy(),
                                  np.asarray(jout.occ_row))
    live = np.asarray(jout.pos_x) < float(SENTINEL_HALF)
    np.testing.assert_array_equal(got.pos_x.numpy() < SENTINEL_HALF, live)
    for f, bound in (("pos_x", POS_TOL), ("pos_y", POS_TOL),
                     ("vel_x", VEL_TOL), ("vel_y", VEL_TOL)):
        _within(getattr(got, f).numpy(), np.asarray(getattr(jout, f)),
                bound, live, f)
