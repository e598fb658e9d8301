"""PyTorch port, the dense engine's physics against the JAX package on the
CPU: ``ops.kernels`` and ``ops.pairs`` on the same arrays, the slot grid
of ``ops.dense``, its roll passes (which ``dense_forces_cols`` runs on CPU
tensors, launching no kernel, unless ``passes=`` replaces them), and the
plain versions of the two CUDA kernels (``ops.sph``) against
``tpufluid.ops.pallas.sph`` in interpret mode on the same DenseGrid (6 x 6
world, 256 particles, K=8).

Integers (cell ids, the sort permutation, the ranks within cell runs,
slots, ``n_dropped``) are held bitwise. Floats are held to BASELINE.md's per-step bounds, relative where
the value exceeds 1: kernel values and densities |d| <= 9.2e-5; velocities
|dv| <= 3.8e-5. Force sums are compared as the velocity increment they
give a particle in one step, f * dt / rho: on a fluid at rest density the
pressure terms of a particle (~1e4 each) cancel to ~1e2, so two f32
evaluations of a force differ by a few ulps of its terms (measured ~5e-3
absolute for the port, and for the JAX package's own XLA and Pallas paths,
against a float64 evaluation), which is a relative error of the sum of up
to ~1e-4, but ~4e-7 of the velocity it moves.

The variant flags (surface tension on an h = 1.5 scene, adaptive
subsampling on a clump above density 200) are held against the JAX
package's XLA ``dense.force_pass``: an interpret-mode ``sph.forces`` call
compiles some five times longer than that pass, and this file keeps one.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid
from tpufluid.ops import dense as jdense
from tpufluid.ops import grid as jgrid
from tpufluid.ops import kernels as jkernels
from tpufluid.ops import pairs as jpairs
from tpufluid.ops.pallas import sph as jsph

from tpufluid_torch import interop
from tpufluid_torch._build import LAUNCHES
from tpufluid_torch.ops import dense as tdense
from tpufluid_torch.ops import grid as tgrid
from tpufluid_torch.ops import kernels as tkernels
from tpufluid_torch.ops import pairs as tpairs
from tpufluid_torch.ops import sph as tsph


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them and each
    small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VEL_TOL, RHO_TOL = 3.8e-5, 9.2e-5
H = 0.2
FRAME = 7
DENSE_KERNELS = ("dense_density", "dense_forces", "dense_build",
                 "dense_readback")


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def _within(got, want, bound, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    err = _rel_err(got, want)
    assert err <= bound, f"{what}: max rel err {err} > {bound}"


def _within_dv(got, want, dens, dt, what):
    """Force grids as the velocity increment f * dt / rho."""
    scale = np.float64(dt) / np.asarray(dens, np.float64)
    _within(np.asarray(got, np.float64) * scale,
            np.asarray(want, np.float64) * scale, VEL_TOL, what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jgrid(settings, pos, vel):
    """The JAX package's DenseGrid of a state (sorted by cell)."""
    cells = jgrid.cell_id(pos, settings)
    b = jgrid.bin_particles(cells, settings)
    return jdense.build_grid(pos[b.perm], vel[b.perm], b.sorted_cells,
                             settings), b


@functools.lru_cache(maxsize=None)
def scene(name):
    """(JAX settings, JAX TickParams, positions, velocities) of a case."""
    rng = np.random.default_rng({"base": 3, "st": 5, "clump": 0}[name])
    if name == "base":
        # a jittered 16 x 16 lattice at spacing 0.1 (rest density), an
        # exactly coincident triple, and a cell over capacity
        xs, ys = np.meshgrid(np.arange(16), np.arange(16))
        pos = (np.stack([xs.ravel(), ys.ravel()], 1) * 0.1 - 0.75
               + rng.uniform(-0.02, 0.02, (256, 2))).astype(np.float32)
        pos[5] = pos[7] = pos[6]
        pos[240:250] = (2.05, 2.05) + rng.uniform(0, 0.1, (10, 2))
        s = tpufluid.SimSettings(particle_count=256, smoothing_radius=H,
                                 size=(6.0, 6.0), cell_capacity=8)
        p = tpufluid.TickParams.default(gravity=(0.0, -9.8))
    elif name == "st":
        # tests/test_variants.py:117: h = 1.5, so the colour gradient of
        # the normalised direction is nonzero
        s = tpufluid.SimSettings(particle_count=36, particle_spacing=0.75,
                                 smoothing_radius=1.5, size=(12.0, 12.0),
                                 cell_capacity=8)
        pos = np.array(tpufluid.init_state(s).position)
        pos = pos + rng.uniform(-0.2, 0.2, pos.shape).astype(np.float32)
        p = tpufluid.TickParams.default(gravity=(0.0, -2.0),
                                        surface_tension_threshold=0.05,
                                        surface_tension_coefficient=5.0)
    else:
        # tests/test_variants.py:175: a clump whose density passes 200
        s = tpufluid.SimSettings(particle_count=16, smoothing_radius=H,
                                 size=(3.2, 3.2), cell_capacity=8)
        pos = rng.uniform(-0.05, 0.05, (16, 2)).astype(np.float32)
        p = tpufluid.TickParams.default()
    vel = rng.normal(size=pos.shape).astype(np.float32)
    return s, p, pos, vel


@functools.lru_cache(maxsize=None)
def jax_grid(name):
    """(DenseGrid, floored density grid) of a scene, built by JAX."""
    s, p, pos, vel = scene(name)
    g, _ = _jgrid(s, jnp.asarray(pos), jnp.asarray(vel))
    d = jdense.density_pass(g, p.mass, jnp.float32(s.smoothing_radius))
    d = jnp.maximum(jnp.maximum(d, tpufluid.EPSILON), 0.1)
    return g, d


def _norms(s):
    n = s.kernel_norms()
    return (float(s.smoothing_radius), s.sqr_radius, n.spiky_derivative,
            n.viscosity)


# ------------------------------------------------------------ kernels

def _radii():
    rng = np.random.default_rng(1)
    r = rng.uniform(0.0, 1.2 * H, 512).astype(np.float32)
    r[:3] = (0.0, np.float32(H), np.float32(H) * np.float32(1.0000001))
    return r


@pytest.mark.parametrize("name", ["poly6", "poly6_gradient",
                                  "poly6_laplacian", "spiky_derivative",
                                  "viscosity", "pressure_eos"])
def test_kernels_match_jax(name):
    r = _radii()
    n = tpufluid.SimSettings(smoothing_radius=H).kernel_norms()
    hj = jnp.float32(H)
    if name == "poly6":
        got, want = tkernels.poly6(H, _t(r * r)), jkernels.poly6(hj, r * r)
    elif name == "poly6_gradient":
        # h = 1.5: lengths up to ~1.7, past h
        rv = np.stack([r, r[::-1] * 0.5], -1) * np.float32(7.0 / 1.2)
        want = jkernels.poly6_gradient(jnp.float32(1.5), rv)
        got = torch.stack(tkernels.poly6_gradient(1.5, _t(rv[:, 0]),
                                                  _t(rv[:, 1])), -1)
    elif name == "poly6_laplacian":
        got, want = tkernels.poly6_laplacian(H, _t(r)), \
            jkernels.poly6_laplacian(hj, r)
    elif name == "spiky_derivative":
        got = tkernels.spiky_derivative(H, _t(r), n.spiky_derivative)
        want = jkernels.spiky_derivative(hj, r,
                                         jnp.float32(n.spiky_derivative))
    elif name == "viscosity":
        got = tkernels.viscosity(H, _t(r), n.viscosity)
        want = jkernels.viscosity(hj, r, jnp.float32(n.viscosity))
    else:
        got = tkernels.pressure_eos(_t(r * 500.0), 50.0, 3.0)
        want = jkernels.pressure_eos(r * 500.0, jnp.float32(50.0),
                                     jnp.float32(3.0))
    assert np.abs(np.asarray(want)).max() > 0.0
    _within(got, want, RHO_TOL, name)


# -------------------------------------------------------------- pairs

@functools.lru_cache(maxsize=None)
def pair_case(h):
    """All-pairs candidate arrays of 64 particles (naive layout) with an
    exactly coincident triple and a random validity mask."""
    rng = np.random.default_rng(int(h * 10))
    n = 64
    pos = rng.uniform(-3.0 * h, 3.0 * h, (n, 2)).astype(np.float32)
    pos[1] = pos[2] = pos[0]
    vel = rng.normal(size=(n, 2)).astype(np.float32)
    dens = rng.uniform(50.0, 150.0, n).astype(np.float32)
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), (n, n))
    valid = rng.uniform(size=(n, n)) < 0.9
    seed = (np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
            + np.uint32(77))
    return dict(pos=pos, vel=vel, dens=dens, idx=idx, valid=valid,
                seed=seed)


@pytest.mark.parametrize("name", ["density", "pressure_force",
                                  "viscosity_force", "color_field_gradient",
                                  "color_field_laplacian",
                                  "surface_tension"])
def test_pairs_match_jax(name):
    h = 1.5 if name in ("color_field_gradient", "surface_tension") else H
    c = pair_case(h)
    n = tpufluid.SimSettings(smoothing_radius=h).kernel_norms()
    pos, vel, dens = c["pos"], c["vel"], c["dens"]
    nb_pos, nb_vel, nb_dens = pos[c["idx"]], vel[c["idx"]], dens[c["idx"]]
    self_idx = np.arange(len(pos), dtype=np.int32)
    sq = h * h
    mass = np.float32(1.0)
    j = dict(point=jnp.asarray(pos), nb_pos=jnp.asarray(nb_pos),
             valid=jnp.asarray(c["valid"]))
    t = dict(point=_t(pos), nb_pos=_t(nb_pos), valid=_t(c["valid"]))
    hj, sqj = jnp.float32(h), jnp.float32(sq)
    if name == "density":
        want = jpairs.density(**j, mass=mass, h=hj)
        got = tpairs.density(**t, mass=torch.tensor(mass), h=h)
    elif name == "pressure_force":
        want = jpairs.pressure_force(
            jnp.asarray(self_idx), j["point"], jnp.asarray(dens),
            jnp.asarray(c["idx"]), j["nb_pos"], jnp.asarray(nb_dens),
            j["valid"], jnp.float32(50.0), jnp.float32(0.0), hj, sqj,
            jnp.float32(n.spiky_derivative), jnp.asarray(c["seed"]))
        got = tpairs.pressure_force(
            _t(self_idx), t["point"], _t(dens), _t(c["idx"]), t["nb_pos"],
            _t(nb_dens), t["valid"], torch.tensor(50.0), torch.tensor(0.0),
            h, sq, n.spiky_derivative, _t(c["seed"].astype(np.int64)))
        dt = 1.0 / 120.0
        _within_dv(got.numpy(), want, dens[:, None], dt, name)
        return
    elif name == "viscosity_force":
        want = jpairs.viscosity_force(
            jnp.asarray(self_idx), j["point"], jnp.asarray(vel),
            jnp.asarray(c["idx"]), j["nb_pos"], jnp.asarray(nb_vel),
            jnp.asarray(nb_dens), j["valid"], jnp.float32(25.0), hj, sqj,
            jnp.float32(n.viscosity))
        got = tpairs.viscosity_force(
            _t(self_idx), t["point"], _t(vel), _t(c["idx"]), t["nb_pos"],
            _t(nb_vel), _t(nb_dens), t["valid"], torch.tensor(25.0), h, sq,
            n.viscosity)
    elif name == "color_field_gradient":
        want = jpairs.color_field_gradient(
            **j, nb_density=jnp.asarray(nb_dens), mass=mass, h=hj,
            sqr_radius=sqj, rand_seed=jnp.asarray(c["seed"]))
        got = tpairs.color_field_gradient(
            **t, nb_density=_t(nb_dens), mass=torch.tensor(mass), h=h,
            sqr_radius=sq, rand_seed=_t(c["seed"].astype(np.int64)))
    elif name == "color_field_laplacian":
        want = jpairs.color_field_laplacian(
            **j, nb_density=jnp.asarray(nb_dens), mass=mass, h=hj,
            sqr_radius=sqj)
        got = tpairs.color_field_laplacian(
            **t, nb_density=_t(nb_dens), mass=torch.tensor(mass), h=h,
            sqr_radius=sq)
    else:
        want = jpairs.surface_tension(
            **j, nb_density=jnp.asarray(nb_dens), mass=mass, h=hj,
            sqr_radius=sqj, threshold=jnp.float32(1e-3),
            coefficient=jnp.float32(5.0), rand_seed=jnp.asarray(c["seed"]))
        got = tpairs.surface_tension(
            **t, nb_density=_t(nb_dens), mass=torch.tensor(mass), h=h,
            sqr_radius=sq, threshold=torch.tensor(1e-3),
            coefficient=torch.tensor(5.0),
            rand_seed=_t(c["seed"].astype(np.int64)))
    assert np.abs(np.asarray(want)).max() > 0.0
    _within(got, want, RHO_TOL, name)


# ---------------------------------------------------------- slot grid

def _sorted_keys(case):
    """Ascending cell keys of a case, as the callers of ``ranks`` pass
    them (the resident engine's far movers end in dropped keys 2**30)."""
    rng = np.random.default_rng(4)
    if case == "one particle":
        return np.array([17])
    if case == "one run":
        return np.full(9, 33)
    if case == "all distinct":
        return np.sort(rng.choice(4096, 64, replace=False))
    if case == "runs at both ends":
        mid = np.sort(rng.integers(10, 90, 40))
        return np.concatenate([np.full(7, 3), mid, np.full(5, 95)])
    keys = np.sort(rng.integers(0, 50, 30))
    return np.concatenate([keys, np.full(6, 2**30)])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["one particle", "one run", "all distinct",
                                  "runs at both ends", "trailing 2**30"])
def test_ranks_bitwise(case, dtype):
    """``ops.dense.ranks`` (a binary search of each key) against the JAX
    package's scan over run starts, on int32 keys (the binning's) and
    int64 keys (the resident engine's far movers)."""
    keys = _sorted_keys(case)
    want = np.asarray(jax.jit(jdense.ranks)(jnp.asarray(keys, jnp.int32)))
    got = tdense.ranks(torch.from_numpy(keys).to(dtype))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_binning_and_slot_grid_bitwise():
    """Cell ids, the stable sort, the slot grid and its overflow count."""
    s, _, pos, vel = scene("base")
    ts = interop.settings_from(s)
    jg, jb = _jgrid(s, jnp.asarray(pos), jnp.asarray(vel))
    cells = tgrid.cell_id(_t(pos), ts)
    np.testing.assert_array_equal(cells.numpy(),
                                  np.asarray(jgrid.cell_id(pos, s)))
    tb = tgrid.bin_particles(cells, ts)
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    np.testing.assert_array_equal(tb.cell_start.numpy(),
                                  np.asarray(jb.cell_start))
    assert int(tgrid.max_cell_occupancy(tb.cell_start)) == int(
        jgrid.max_cell_occupancy(jb.cell_start)) == 10
    tg = tdense.build_grid(_t(pos)[tb.perm], _t(vel)[tb.perm],
                           tb.sorted_cells, ts)
    for f in ("flat", "px", "py", "vx", "vy", "valid"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    assert int(tg.n_dropped) == int(jg.n_dropped) == 2
    back = interop.dense_grid_from_numpy(jg, "cpu")
    for f in tg._fields:
        assert torch.equal(getattr(back, f), getattr(tg, f)), f


# ----------------------------------------------------- the roll passes

def test_dense_passes_match_jax():
    s, p, _, _ = scene("base")
    jg, jd = jax_grid("base")
    h, sq, spiky, visc = _norms(s)
    tg = interop.dense_grid_from_numpy(jg, "cpu")
    tp = interop.tick_params_from_numpy(p, "cpu")
    want = jdense.density_pass(jg, p.mass, jnp.float32(h))
    _within(tdense.density_pass(tg, tp.mass, h), want, RHO_TOL, "rho")
    want = jdense.force_pass(jg, jd, p, jnp.float32(h), jnp.float32(sq),
                             jnp.float32(spiky), jnp.float32(visc),
                             jnp.uint32(FRAME))
    got = tdense.force_pass(tg, _t(jd), tp, h, sq, spiky, visc,
                            torch.tensor(FRAME))
    for g, w, n in zip(got, want, ("fx", "fy", "gx", "gy")):
        _within_dv(g.numpy(), w, jd, p.delta, n)


def _sorted_columns(name):
    """(torch settings, params, sorted px, py, vx, vy, sorted cells) of a
    scene."""
    s, p, pos, vel = scene(name)
    ts = interop.settings_from(s)
    b = tgrid.bin_particles(tgrid.cell_id(_t(pos), ts), ts)
    ps, vs = _t(pos)[b.perm], _t(vel)[b.perm]
    return (ts, interop.tick_params_from_numpy(p, "cpu"), ps[:, 0], ps[:, 1],
            vs[:, 0], vs[:, 1], b.sorted_cells)


def _counted(monkeypatch, module, names, calls):
    """Replace each function ``names`` of ``module`` by one that notes its
    name in ``calls`` and calls it."""
    for name in names:
        fn = getattr(module, name)

        def run(*args, _fn=fn, _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, run)


@pytest.mark.parametrize("flag", ["base", "surface_tension",
                                  "adaptive_subsampling"])
def test_dense_forces_cols_runs_the_roll_passes_on_cpu(flag, monkeypatch):
    """On CPU tensors ``dense_forces_cols`` runs ``density_pass`` and
    ``force_pass`` once each, launches no kernel (``_build.LAUNCHES`` stays
    0), and reads back at each particle's slot what the two passes give,
    bitwise; a particle beyond capacity reads the density floor and zero
    force."""
    name = {"surface_tension": "st",
            "adaptive_subsampling": "clump"}.get(flag, "base")
    ts, tp, px, py, vx, vy, cells = _sorted_columns(name)
    flags = {} if flag == "base" else {flag: True}
    h, sq, spiky, visc = _norms(ts)
    frame = torch.tensor(FRAME)
    g = tdense.build_grid_cols(px, py, vx, vy, cells, ts)
    d = tdense.density_pass(g, tp.mass, h)
    d = torch.clamp(torch.clamp(d, min=tpufluid.EPSILON), min=0.1)
    fields = (d, *tdense.force_pass(g, d, tp, h, sq, spiky, visc, frame,
                                    **flags))
    calls = []
    _counted(monkeypatch, tdense, ("density_pass", "force_pass"), calls)
    before = {n: LAUNCHES[n] for n in DENSE_KERNELS}
    got = tdense.dense_forces_cols(px, py, vx, vy, cells, ts, tp,
                                   ts.kernel_norms(), frame, **flags)
    assert calls == ["density_pass", "force_pass"]
    assert ({n: LAUNCHES[n] for n in DENSE_KERNELS} == before
            == dict.fromkeys(DENSE_KERNELS, 0))
    kept = g.flat < g.px.numel()
    for a, f in zip(got, fields):
        assert torch.equal(a[kept], f.reshape(-1)[g.flat[kept]])
    assert int(got[5]) == int((~kept).sum()) == (2 if name == "base" else 0)
    assert bool((got[0][~kept] == 0.1).all())
    assert all(bool((a[~kept] == 0.0).all()) for a in got[1:5])


def test_dense_forces_cols_passes_override(monkeypatch):
    """``passes=`` replaces the two passes on any device (here the pallas
    engine's plain versions, as ``pallas=True`` runs them on the CPU), and
    the roll passes then run not at all."""
    ts, tp, px, py, vx, vy, cells = _sorted_columns("base")
    frame = torch.tensor(FRAME)
    cols = (px, py, vx, vy, cells, ts, tp, ts.kernel_norms(), frame)
    want = tdense.dense_forces_cols(*cols, pallas=True)
    calls = []
    _counted(monkeypatch, tdense, ("density_pass", "force_pass"), calls)
    _counted(monkeypatch, tsph, ("density_plain", "forces_plain"), calls)
    got = tdense.dense_forces_cols(
        *cols, passes=(tsph.density_plain, tsph.forces_plain))
    assert calls == ["density_plain", "forces_plain"]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ({n: LAUNCHES[n] for n in DENSE_KERNELS}
            == dict.fromkeys(DENSE_KERNELS, 0))


def test_dense_wrappers_refuse_other_devices():
    """``dense.density`` and ``dense.forces`` run on the CPU or the card,
    and raise for any other device."""
    meta = torch.empty((4, 8, 128), device="meta")
    g = tdense.DenseGrid(flat=meta, px=meta, py=meta, vx=meta, vy=meta,
                         valid=meta.bool(), n_dropped=meta)
    m = torch.empty((), device="meta")
    params = type("P", (), {"mass": m})()
    with pytest.raises(NotImplementedError):
        tdense.density(g, m, H)
    with pytest.raises(NotImplementedError):
        tdense.forces(g, meta, params, H, H * H, 1.0, 1.0, m)


# ------------------------------------------- plain versions vs Pallas

@functools.lru_cache(maxsize=None)
def pallas_outputs():
    """JAX's interpret-mode sph.density and sph.forces on scene "base"."""
    s, p, _, _ = scene("base")
    jg, jd = jax_grid("base")
    h, sq, spiky, visc = _norms(s)
    rho = jsph.density(jg, p.mass, h)
    f = jsph.forces(jg, jd, p, h, sq, spiky, visc, jnp.uint32(FRAME))
    return jax.block_until_ready((rho, f))


def test_sph_density_plain_matches_pallas():
    s, p, _, _ = scene("base")
    jg, _ = jax_grid("base")
    tg = interop.dense_grid_from_numpy(jg, "cpu")
    before = {n: LAUNCHES[n] for n in ("sph_density", "sph_forces")}
    got = tsph.density(tg, interop.tick_params_from_numpy(p, "cpu").mass,
                       s.smoothing_radius)
    # the CPU runs the plain version
    assert {n: LAUNCHES[n] for n in ("sph_density", "sph_forces")} == before
    want = pallas_outputs()[0]
    assert got.shape == (32, 8, 128)
    _within(got, want, RHO_TOL, "rho")
    assert float(want.max()) > 100.0


def test_sph_forces_plain_matches_pallas():
    s, p, _, _ = scene("base")
    jg, jd = jax_grid("base")
    h, sq, spiky, visc = _norms(s)
    tg = interop.dense_grid_from_numpy(jg, "cpu")
    tp = interop.tick_params_from_numpy(p, "cpu")
    got = tsph.forces(tg, _t(jd), tp, h, sq, spiky, visc,
                      torch.tensor(FRAME))
    want = pallas_outputs()[1]
    for g, w, n in zip(got, want, ("fx", "fy", "gx", "gy")):
        _within_dv(g.numpy(), w, jd, p.delta, n)
        # empty target slots: exactly zero in both
        dead = ~np.asarray(jg.valid)
        assert (g.numpy()[dead] == 0.0).all() and (np.asarray(w)[dead] == 0).all()
    # the coincident triple's members are pushed apart, not left at rest
    live = np.asarray(jg.valid)
    px, py = np.asarray(jg.px), np.asarray(jg.py)
    x0, y0 = scene("base")[2][6]
    at = live & (px == x0) & (py == y0)
    assert at.sum() == 3
    assert np.all(np.abs(got[0].numpy()[at]) > 0.0)


@pytest.mark.parametrize("flag", ["surface_tension", "adaptive_subsampling"])
def test_sph_forces_variants(flag):
    """Each flag against the JAX package's XLA dense.force_pass with the
    same flag, and against the port without it."""
    name = "st" if flag == "surface_tension" else "clump"
    s, p, _, _ = scene(name)
    jg, jd = jax_grid(name)
    h, sq, spiky, visc = _norms(s)
    tg = interop.dense_grid_from_numpy(jg, "cpu")
    tp = interop.tick_params_from_numpy(p, "cpu")
    live = np.asarray(jg.valid)
    want = jdense.force_pass(jg, jd, p, jnp.float32(h), jnp.float32(sq),
                             jnp.float32(spiky), jnp.float32(visc),
                             jnp.uint32(FRAME), **{flag: True})
    args = (tg, _t(jd), tp, h, sq, spiky, visc, torch.tensor(FRAME))
    got = tsph.forces(*args, **{flag: True})
    base = tsph.forces(*args)
    for g, w, n in zip(got, want, ("fx", "fy", "gx", "gy")):
        _within_dv(g.numpy(), w, jd, p.delta, f"{flag} {n}")
    assert not np.allclose(got[0].numpy()[live], base[0].numpy()[live])
    if flag == "adaptive_subsampling":
        assert float(np.asarray(jd)[live].max()) > 200.0
        # the stride leaves viscosity alone
        assert torch.equal(got[2], base[2]) and torch.equal(got[3], base[3])


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 8, 128), device="meta")
    g = tdense.DenseGrid(flat=meta, px=meta, py=meta, vx=meta, vy=meta,
                         valid=meta.bool(), n_dropped=meta)
    with pytest.raises(NotImplementedError):
        tsph.density(g, torch.empty((), device="meta"), H)
