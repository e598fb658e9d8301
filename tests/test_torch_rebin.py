"""PyTorch port, the round-1 re-binning kernel with a valid mask
(ops.rebin.rebin_valid) against the JAX package's
``tpufluid.ops.pallas.rebin.rebin`` in Pallas interpret mode on the CPU,
on identical seeded grids. All six outputs are held bitwise.

The grid is small (Gy 10, K 4, Gxp 128: a 4.8 x 1.6 world at h 0.2) and
each case adds one feature to a base of ordinary one-cell moves: far
movers, a capacity overflow, arrivals from the border rows and columns,
and valid_f = 0 slots holding stale data that would otherwise arrive.
Every predicted coordinate sits 0.05..0.95 of the way across its cell (or
beyond a wall, where the clamp decides), so XLA's FMA contraction on the
CPU cannot move a particle across a cell edge.
"""

import functools
import zlib

import jax
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops.pallas import rebin as jrebin

import tpufluid_torch as tt
from tpufluid_torch.ops import rebin as trebin


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H = 0.2
SIZE = (4.8, 1.6)
GY, K, GXP = 10, 4, 128
GW = 26  # ceil(4.8 / 0.2) + 2
DT = np.float32(1.0 / 120.0)
HALF = np.asarray(SIZE, np.float64) / 2

_jrebin = jax.jit(jrebin.rebin, static_argnums=(6, 7))


def _point(rng, cell):
    """A coordinate pair 0.05..0.95 of the way across interior cell
    (cx, cy)."""
    u = rng.uniform(0.05, 0.95, 2)
    return (np.asarray(cell) - 1 + u) * H - HALF


class _Grid:
    """Five [GY, K, GXP] fields filled slot by slot, source cell by cell."""

    def __init__(self, rng):
        self.rng = rng
        self.f = np.zeros((5, GY, K, GXP), np.float32)
        self.used = np.zeros((GY, GXP), np.int64)

    def put(self, src, pred, valid=1.0):
        """A slot in source cell src = (x, y) whose prediction is
        ``pred``: its position lies in src (clamped to the world), its
        velocity takes it to pred in one step."""
        sx, sy = src
        s = self.used[sy, sx]
        if s >= K:
            return False
        cell = (min(max(sx, 1), GW - 2), min(max(sy, 1), GY - 2))
        pos = _point(self.rng, cell).astype(np.float32)
        vel = ((np.asarray(pred) - pos) / DT).astype(np.float32)
        self.f[:, sy, s, sx] = (pos[0], pos[1], vel[0], vel[1], valid)
        self.used[sy, sx] += 1
        return True

    def move(self, src, dst):
        return self.put(src, _point(self.rng, dst))


def _base(g, n=120):
    """Ordinary moves: a particle in a random interior cell goes to one of
    its nine neighbour cells (kept interior)."""
    for _ in range(n):
        sx, sy = g.rng.integers(1, GW - 1), g.rng.integers(1, GY - 1)
        tx = int(np.clip(sx + g.rng.integers(-1, 2), 1, GW - 2))
        ty = int(np.clip(sy + g.rng.integers(-1, 2), 1, GY - 2))
        g.move((sx, sy), (tx, ty))


@functools.lru_cache(maxsize=None)
def case(name):
    g = _Grid(np.random.default_rng(zlib.crc32(name.encode())))
    if name == "far":
        for sx, sy, tx, ty in ((5, 3, 9, 3), (12, 6, 12, 1), (20, 4, 3, 7),
                               (8, 8, 10, 6), (15, 2, 17, 2)):
            g.move((sx, sy), (tx, ty))
    if name == "overflow":
        # 7 arrivals into cell (10, 4) from itself and its neighbours
        for sx, sy in ((10, 4), (10, 4), (9, 4), (11, 4), (10, 3), (10, 5),
                       (9, 3)):
            g.move((sx, sy), (10, 4))
    if name == "border":
        # source rows 0 and GY-1 and columns 0 and GW-1 (the ring)
        g.move((5, 0), (5, 1))
        g.move((6, 0), (7, 1))
        g.move((12, GY - 1), (11, GY - 2))
        g.move((0, 4), (1, 4))
        g.move((0, 0), (1, 1))
        g.move((GW - 1, 5), (GW - 2, 6))
        # predictions beyond the walls: clamped onto the border cells
        g.put((1, 3), (-HALF[0] - 0.3, _point(g.rng, (1, 3))[1]))
        g.put((GW - 2, 2), (HALF[0] + 0.5, HALF[1] + 0.4))
        g.put((7, GY - 2), (_point(g.rng, (7, 1))[0], HALF[1] + 2.0))
    _base(g)
    if name == "stale":
        # stale slots (valid_f 0) whose data would arrive, below and
        # between valid ones
        for _ in range(40):
            sx, sy = g.rng.integers(1, GW - 1), g.rng.integers(1, GY - 1)
            g.put((sx, sy), _point(g.rng, (sx, sy)), valid=0.0)
            g.move((sx, sy), (sx, sy))
    settings = tpufluid.SimSettings(particle_count=256, smoothing_radius=H,
                                    size=SIZE, cell_capacity=K)
    assert (settings.grid_w, settings.grid_h) == (GW, GY)
    return settings, g.f


CASES = ["move", "far", "overflow", "border", "stale"]


@pytest.mark.parametrize("name", CASES)
def test_rebin_valid_matches_jax(name):
    s, f = case(name)
    want = _jrebin(*f, DT, s, GXP)
    ts = tt.SimSettings(particle_count=s.particle_count, smoothing_radius=H,
                        size=SIZE, cell_capacity=K)
    got = trebin.rebin_valid(*(torch.from_numpy(a.copy()) for a in f), DT,
                             ts)
    names = ("pos_x", "pos_y", "vel_x", "vel_y", "valid_f", "lost")
    for a, b, n in zip(got, want, names):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=n)
    valid_out, lost = got[4].numpy(), got[5].numpy()
    n_in = int(f[4].sum())
    moved = int(valid_out.sum())
    dropped = float(lost[:, 0].sum()) * K
    assert moved + dropped == n_in  # every valid slot arrives or is lost
    if name == "move":
        assert dropped == 0 and moved > 100
    if name == "far":
        assert dropped == 5
    if name == "overflow":
        assert valid_out[4, :, 10].sum() == K and lost[4, 0, 10] > 0
    if name == "border":
        assert valid_out[1, :, 5].sum() >= 1 and valid_out[1, :, 1].sum() >= 2
        assert valid_out[GY - 2, :, 11].sum() >= 1
        assert valid_out[6, :, GW - 2].sum() >= 1
    if name == "stale":
        # stale slots with data; the count above shows none arrived
        assert ((f[4] == 0) & (f[0] != 0)).sum() >= 30
