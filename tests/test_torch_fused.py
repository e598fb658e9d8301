"""PyTorch port, the resident engine's three kernels (ops.fused): each plain
PyTorch version against the JAX package's Pallas kernel (interpret mode on
the CPU) on identical grids, at K=8 and K=32, with coincident pairs, a far
mover, a capacity overflow and the mouse impulse (including dist 0).

Rebin is held bitwise. Density and forces are held to BASELINE.md's
measured cross-backend per-step bounds on live slots: |drho| <= 9.2e-5,
|dpos| <= 4.8e-7, |dvel| <= 3.8e-5, relative where the value exceeds 1.
Dead slots of the new state must be exactly SENTINEL / 0. Test inputs keep
every predicted coordinate at least 0.05 h from a cell edge, so XLA's FMA
contraction on the CPU cannot move a particle across one.

The CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops import resident as jresident
from tpufluid.ops.pallas import fused as jfused
from tpufluid.state import ParticleState as JParticleState

from tpufluid_torch import interop
from tpufluid_torch.ops import fused as tfused


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them and each
    small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POS_TOL, VEL_TOL, RHO_TOL = 4.8e-7, 3.8e-5, 9.2e-5
H = 0.2
HALF = 2.4
DT = np.float32(1.0 / 120.0)

_jrebin = jax.jit(jfused.rebin, static_argnums=(6,))
_jdensity = jax.jit(
    lambda px, py, vx, vy, occ, p, s: jfused.density(
        px, py, vx, vy, occ, p.mass, p.delta, p.pressure_constant,
        p.rest_density, s), static_argnums=(6,))
_jforces = jax.jit(
    lambda px, py, vx, vy, pres, invr, occ, p, frame, s:
    jfused.forces_integrate(px, py, vx, vy, pres, invr, occ, p, s, frame),
    static_argnums=(9,))


def _points_in_cells(rng, cells, n):
    """n predicted positions inside the given interior cells, each
    coordinate 0.05..0.95 of the way across its cell."""
    c = cells[rng.integers(0, len(cells), n)]
    u = rng.uniform(0.05, 0.95, (n, 2))
    return (((c - 1) + u) * H - HALF).astype(np.float32)


def _region(x0, x1, y0, y1):
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    return np.stack([xs.ravel(), ys.ravel()], axis=1)


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX settings, JAX GridState, JAX TickParams, frame) for a case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    params = dict(gravity=(0.0, -9.8))
    k = 32 if name.startswith("k32") else 8
    if k == 8:
        pred = _points_in_cells(rng, _region(3, 23, 3, 23), 600)
    else:
        pred = _points_in_cells(rng, _region(6, 16, 6, 16), 1500)
    vel = (rng.normal(size=pred.shape) * 2.0).astype(np.float32)
    # coincident triple: identical position and velocity
    pred[1:3], vel[1:3] = pred[0], vel[0]
    if name == "k8_mixed":
        # a far mover: ~6 cells in one step
        pred[3] = _points_in_cells(rng, np.array([[12, 12]]), 1)[0]
        vel[3] = (150.0, 80.0)
    if name == "k8_overflow":
        # 6 particles resting in cell (8, 8), and 6 from cell (9, 8)
        # arriving there
        pred[3:15] = _points_in_cells(rng, np.array([[8, 8]]), 12)
        vel[3:15] = 0.0
        vel[9:15, 0] = -H / DT
    if name == "k8_mouse":
        vel[3] = 0.0  # pred == pos exactly: the impulse's dist-0 case
        params.update(mouse_state=1, mouse_pos=tuple(pred[3]),
                      mouse_force_radius=1.0)
    pos = (pred - vel * DT).astype(np.float32)
    settings = tpufluid.SimSettings(particle_count=len(pos),
                                    smoothing_radius=H, size=(4.8, 4.8),
                                    cell_capacity=k)
    n = len(pos)
    state = JParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.zeros(n),
        cell=jnp.zeros(n, jnp.uint32), tick=jnp.asarray(41, jnp.uint32))
    gs = jresident.from_particles(state, settings)
    return settings, gs, tpufluid.TickParams.default(**params), gs.tick + 1


CASES = ["k8_mixed", "k8_overflow", "k8_mouse", "k32_dense"]


def _torch(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _within(got, want, bound, mask, what):
    got = got.cpu().numpy()[mask]
    want = np.asarray(want)[mask]
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= bound, f"{what}: max rel err {err.max()} > {bound}"


def _bitwise(got, want, what):
    got = got.cpu().numpy()
    want = np.asarray(want)
    assert got.dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", CASES)
def test_rebin_matches_jax(name):
    s, gs, p, _ = case(name)
    want = _jrebin(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row,
                   p.delta, s)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    got = tfused.rebin(tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, tg.occ_row,
                       _torch(p.delta), interop.settings_from(s))
    names = ["pos_x", "pos_y", "vel_x", "vel_y", "occ_row", "far_n", "over_n"]
    for g, w, n in zip(got, want, names):
        _bitwise(g, w, n)
    far_n, over_n = np.asarray(want[5]), np.asarray(want[6])
    if name == "k8_mixed":
        assert far_n.sum() == 1
    if name == "k8_overflow":
        assert over_n.sum() > 0
    if name == "k32_dense":
        assert np.asarray(want[4]).max() > 16


@pytest.mark.parametrize("name", CASES)
def test_density_matches_jax(name):
    s, gs, p, _ = case(name)
    want = _jdensity(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, p, s)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    tp = interop.tick_params_from_numpy(p, "cpu")
    pres, invr = tfused.density(
        tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, tg.occ_row, tp.mass,
        tp.delta, tp.pressure_constant, tp.rest_density,
        interop.settings_from(s))
    live = np.asarray(gs.pos_x) < jfused.SENTINEL_HALF
    _within(1.0 / invr, 1.0 / np.asarray(want[1]), RHO_TOL, live, "rho")
    _within(pres, want[0], RHO_TOL, live, "pres")


@pytest.mark.parametrize("name", CASES)
def test_forces_integrate_matches_jax(name):
    s, gs, p, frame = case(name)
    pres, invr = _jdensity(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y,
                           gs.occ_row, p, s)
    want = _jforces(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, pres, invr,
                    gs.occ_row, p, frame, s)
    tg = interop.grid_state_from_numpy(gs, "cpu")
    got = tfused.forces_integrate(
        tg.pos_x, tg.pos_y, tg.vel_x, tg.vel_y, _torch(pres), _torch(invr),
        tg.occ_row, interop.tick_params_from_numpy(p, "cpu"),
        interop.settings_from(s), torch.tensor(int(frame)))
    live = np.asarray(gs.pos_x) < jfused.SENTINEL_HALF
    for g, w, n, tol in zip(got, want, ["pos_x", "pos_y", "vel_x", "vel_y"],
                            [POS_TOL, POS_TOL, VEL_TOL, VEL_TOL]):
        _within(g, w, tol, live, n)
        _bitwise(g[torch.from_numpy(~live)], np.asarray(w)[~live], n + " dead")
    if name == "k8_mouse":
        # dist 0 under a press: NaN impulse, then the NaN reset zeroes it
        x0, y0 = np.asarray(p.mouse_pos)
        at = ((np.asarray(gs.pos_x) == x0) & (np.asarray(gs.pos_y) == y0))
        assert at.sum() == 1
        assert float(got[2][torch.from_numpy(at)]) == 0.0
        assert float(got[3][torch.from_numpy(at)]) == 0.0
