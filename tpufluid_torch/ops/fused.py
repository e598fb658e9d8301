"""The resident engine's kernels: rebin, density, forces + integrate, and
the fused physics pass.

Port of ``tpufluid.ops.pallas.fused`` (``rebin`` with ``row_shift``,
``density`` with ``wid``, ``forces_integrate`` with every flag: ``has_ff``,
``x_boundary="wrap"``, ``surface_tension``, ``adaptive_subsampling`` and
``wid``; ``physics``). Each function keeps the JAX signature and layout:
slot grids f32[Gy, K, Gxp] (empty slots hold ``pos = SENTINEL``),
``occ_row`` i32[Gy] = the per-row max packed occupancy. Arrivals fill
slots 0..count-1 of a cell, so every slot at or beyond ``occ_row[y]`` in
row y is empty; the kernels bound their loops by it, as the TPU kernels
do.

Batched world stacks (``ops.resident`` with ``n_worlds > 1``): worlds
stack along the row axis. ``row_shift`` i32[Gy] maps a slot's world-frame
cell row to the stacked row (rebin compares ``cell_row - row_shift[y] ==
y``), ``wid`` i32[Gy] names each row's world, and the per-tick tunables
then carry a leading [W] dim (``delta`` stays one scalar).

Each wrapper dispatches on where its tensors lie. On the CPU it runs the
plain PyTorch version beside it (``rebin_plain``, ...). On a CUDA device it
launches the hand-written kernel from ``tpufluid_torch/csrc`` and counts
the launch in ``_build.LAUNCHES``, or raises; it never falls back.

Plain versions and kernels share one reduction order, which is also the
TPU kernels': candidates by slot (ascending, below ``occ3``), and for each
candidate the nine (row, dx) blocks summed into a partial that is then
added to the running total. Every f32 operation rounds on its own (the
kernels build with ``-fmad=false``). The kernels walk each candidate
cell only below its own occupancy; the slots they skip are empty and add
(or pack) nothing, so the bits are the same.

Every kernel here runs one block per tile of cells with all K slots,
staged in shared memory; the kernels pick the tile from K (one design at
every K, smaller tiles as K grows; a launch fails if even a 1 x 1 tile
does not fit), and :func:`rebin_tile`, :func:`density_tile`,
:func:`forces_tile` and :func:`physics_tile` report it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build
from .._build import LAUNCHES, launched, on_cuda, ptr, stream
from ..params import EPSILON, SimSettings
from . import prng

PI = math.pi
# Empty grid slots hold this position; anything beyond SENTINEL_HALF is
# "not a particle". Real positions are bounded by the world half-extent.
SENTINEL = 1.0e9
SENTINEL_HALF = 5.0e8
MAX_SPEED = 500.0  # compute.wgsl:118-122

# variant flag bits of the forces and physics kernels (resident_math.cuh)
_WRAP, _HAS_FF, _ST, _ADAPT = 1, 2, 4, 8


def _tile(fn, k: int, name: str, hint: str = ""):
    """(rows, columns) of the tile the library's ``fn`` picks at capacity
    ``k``; raises if none fits shared memory."""
    packed = fn(k)
    if packed == 0:
        raise ValueError(f"{name}: cell_capacity {k} does not fit the "
                         f"shared memory of a block with a 1 x 1 tile"
                         f"{hint}")
    return packed >> 8, packed & 255


def density_tile(k: int):
    """(rows, columns) of the density kernel's tile at capacity ``k``, as
    ``csrc/density.cu`` picks it (builds the kernels if needed)."""
    return _tile(_build.load().tf_density_tile, k, "density")


def forces_tile(k: int):
    """(rows, columns) of the forces kernel's tile at capacity ``k``, as
    ``csrc/forces.cu`` picks it (builds the kernels if needed)."""
    return _tile(_build.load().tf_forces_tile, k, "forces_integrate")


_USE_SPLIT = "; use the split density + forces_integrate pair"


def physics_tile(k: int):
    """(rows, columns) of the physics kernel's tile at capacity ``k``, as
    ``csrc/physics.cu`` picks it (builds the kernels if needed); raises,
    naming the split pair, above :func:`physics_max_capacity`."""
    return _tile(_build.load().tf_physics_tile, k, "physics", _USE_SPLIT)


def physics_max_capacity() -> int:
    """The largest cell capacity K the physics kernel takes (~600): the
    largest whose +-2 halo fits a block's shared memory with a 1 x 1 tile
    (builds the kernels if needed)."""
    return _build.load().tf_physics_max_k()


def rebin_tile(k: int):
    """(rows, columns) of the rebin kernel's tile of target cells at
    capacity ``k``, as ``csrc/rebin.cu`` picks it (builds the kernels if
    needed)."""
    return _tile(_build.load().tf_rebin_tile, k, "rebin")


def _f32(x: float) -> float:
    """A Python float rounded to f32: how the JAX kernels see constants."""
    return float(np.float32(x))


def occ3_of(occ_row: torch.Tensor) -> torch.Tensor:
    """occ3[y] = max(occ_row[y-1], occ_row[y], occ_row[y+1]), out-of-range
    rows empty."""
    occ = occ_row.reshape(-1)
    z = torch.zeros_like(occ[:1])
    lo = torch.cat([z, occ[:-1]])
    hi = torch.cat([occ[1:], z])
    return torch.maximum(torch.maximum(lo, occ), hi)


def _pred(p, v, dt, half):
    """Clamped predicted coordinate (compute.wgsl:8-30), product and sum
    rounded separately."""
    return torch.clamp(p + v * dt, -half, half)


def _pad(a: torch.Tensor, value) -> torch.Tensor:
    """[Gy, K, Gx] -> [Gy+2, K, Gx+2] with a ring of ``value``, so the
    (row, dx) neighbour block of target (y, x) is a plain slice."""
    return torch.nn.functional.pad(a, (1, 1, 0, 0, 1, 1), value=value)


def _block(a_pad: torch.Tensor, r: int, dx: int, gy: int, gx: int):
    """Neighbour block (source row y+r-1, column x+dx) of a padded grid."""
    return a_pad[r:r + gy, ..., 1 + dx:1 + dx + gx]


def _slot_bound(occ_row: torch.Tensor) -> torch.Tensor:
    """Padded per-row occupancy, shaped to broadcast against [Gy, Gx]."""
    return torch.nn.functional.pad(occ_row.to(torch.int64), (1, 1))[:, None]


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _per_row(v, wid, device):
    """A tunable as each grid row sees it: the value itself for one world
    (``wid`` None, or a value shared by every world), else the row's
    world's entry, shaped [Gy, 1, 1] to broadcast against a grid."""
    v = _as_f32(v, device)
    if wid is None or v.numel() == 1:
        return v.reshape(())
    return v.reshape(-1)[wid.to(torch.int64)].reshape(-1, 1, 1)


def _sc_table(cols, wid, device) -> torch.Tensor:
    """f32[W, n] per-world scalar table, one column per entry of ``cols``:
    a tunable (0-d, or [W] with ``wid``) or a settings constant (a Python
    float, the same in every world)."""
    tens = [_as_f32(c, device).reshape(-1) for c in cols
            if isinstance(c, torch.Tensor)]
    w = max(c.numel() for c in tens) if wid is not None else 1
    out = []
    for c in cols:
        if not isinstance(c, torch.Tensor):
            out.append(torch.full((w,), c, dtype=torch.float32,
                                  device=device))
            continue
        c = _as_f32(c, device).reshape(-1)
        if c.numel() not in (1, w):
            raise ValueError(f"per-world tunables of {c.numel()} and {w} "
                             f"worlds")
        out.append(c.expand(w))
    return torch.stack(out, dim=1).contiguous()


def _one_world(sc: torch.Tensor, wid_t):
    """No world table when every world shares the scalar table's one
    row (the kernel then reads row 0 for every grid row)."""
    return None if sc.shape[0] == 1 else wid_t


# ----------------------------------------------------------------- checks

def _check_grids(shape, *grids):
    for g in grids:
        if g.shape != shape or g.dtype != torch.float32 or not g.is_contiguous():
            raise ValueError(
                f"expected contiguous f32{list(shape)}, got "
                f"{g.dtype}{list(g.shape)} contiguous={g.is_contiguous()}")
    if shape[2] % 128 != 0:
        raise ValueError(f"grid width {shape[2]} is not a multiple of 128")


def _check_occ(occ_row: torch.Tensor, gy: int, name: str = "occ_row"):
    if (occ_row.shape != (gy,) or occ_row.dtype != torch.int32
            or not occ_row.is_contiguous()):
        raise ValueError(f"{name} must be contiguous i32[{gy}], got "
                         f"{occ_row.dtype}{list(occ_row.shape)}")


def _opt_rows(t, gy: int, name: str, device):
    """An optional i32[Gy] row table (wid, row_shift) as a kernel
    argument: its pointer, or None."""
    if t is None:
        return None
    t = torch.as_tensor(t, dtype=torch.int32, device=device).contiguous()
    _check_occ(t, gy, name)
    return t


def _outputs(out, shape, dev):
    """A kernel's four output grids: new ones, or the caller's ``out``
    (checked), which must not be any of the kernel's inputs."""
    if out is None:
        return [torch.empty(shape, dtype=torch.float32, device=dev)
                for _ in range(4)]
    out = list(out)
    if len(out) != 4 or any(o.device != dev for o in out):
        raise ValueError(f"out must be four grids on {dev}")
    _check_grids(shape, *out)
    return out


def _into(out, res):
    """``res`` copied into ``out`` when given (the plain versions)."""
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


# ----------------------------------------------------------------- rebin

def _rebin_consts(settings: SimSettings):
    return (_f32(1.0 / float(settings.smoothing_radius)),
            _f32(float(settings.size[0]) * 0.5),
            _f32(float(settings.size[1]) * 0.5),
            settings.grid_w - 2, settings.grid_h - 2)


def _live_slots(pos_x, occ_row):
    """Live slots: a particle, below its row's occupancy."""
    k = pos_x.shape[1]
    in_occ = (torch.arange(k, device=pos_x.device)[None, :, None]
              < occ_row.to(torch.int64)[:, None, None])
    return (pos_x < SENTINEL_HALF) & in_occ


def _cells(px, py, vx, vy, dt, settings: SimSettings):
    """Clamped predicted cell (x, y) of every slot, in its world's frame,
    i64. Multiplies by 1/h like the TPU rebin (the boundary conversion
    divides by h)."""
    h_inv, half_x, half_y, cx_max, cy_max = _rebin_consts(settings)
    prx = _pred(px, vx, dt, half_x)
    pry = _pred(py, vy, dt, half_y)
    ncx = torch.floor((prx + half_x) * h_inv).to(torch.int64) + 1
    ncy = torch.floor((pry + half_y) * h_inv).to(torch.int64) + 1
    return ncx.clamp(1, cx_max), ncy.clamp(1, cy_max)


def rebin_plain(pos_x, pos_y, vel_x, vel_y, occ_row, dt,
                settings: SimSettings, row_shift=None):
    """Plain PyTorch version of :func:`rebin`: the same walk, vectorised
    over all targets (y, x) at once."""
    gy, k, gx = pos_x.shape
    dev = pos_x.device
    dt = _as_f32(dt, dev)
    live = pos_x < SENTINEL_HALF
    ncx, ncy = _cells(pos_x, pos_y, vel_x, vel_y, dt, settings)
    ty = torch.arange(gy, device=dev)[:, None]
    tx = torch.arange(gx, device=dev)[None, :]
    if row_shift is not None:  # compared in target row y's frame
        ty = ty + torch.as_tensor(row_shift, device=dev).to(
            torch.int64).reshape(gy, 1)
    occ = occ_row.to(torch.int64)

    # far movers of each source row (target beyond the 3x3 neighbourhood)
    far = _live_slots(pos_x, occ_row) & (((ncy - ty[:, None]).abs() > 1)
                                         | ((ncx - tx[:, None]).abs() > 1))
    far_n = far.sum(dim=(1, 2)).to(torch.int32)

    src = [_pad(a, v) for a, v in ((pos_x, SENTINEL), (pos_y, SENTINEL),
                                   (vel_x, 0.0), (vel_y, 0.0))]
    live_p = _pad(live, False)
    ncx_p = _pad(ncx, 0)
    ncy_p = _pad(ncy, 0)
    occ_p = _slot_bound(occ)
    # one spare slot (index k) takes every non-arrival and every overflow
    out = [torch.full((gy, k + 1, gx), SENTINEL, dtype=torch.float32, device=dev),
           torch.full((gy, k + 1, gx), SENTINEL, dtype=torch.float32, device=dev),
           torch.zeros((gy, k + 1, gx), dtype=torch.float32, device=dev),
           torch.zeros((gy, k + 1, gx), dtype=torch.float32, device=dev)]
    count = torch.zeros((gy, gx), dtype=torch.int64, device=dev)
    n_src = min(int(occ.max()), k) if gy else 0
    for r in range(3):
        bound = occ_p[r:r + gy]
        for dx in (-1, 0, 1):
            blk = lambda a: _block(a, r, dx, gy, gx)
            lv, cx, cy = blk(live_p), blk(ncx_p), blk(ncy_p)
            vals = [blk(a) for a in src]
            for s in range(n_src):
                hit = (lv[:, s] & (cy[:, s] == ty) & (cx[:, s] == tx)
                       & (s < bound))
                dest = torch.where(hit & (count < k), count, k)[:, None]
                for f in range(4):
                    out[f].scatter_(1, dest, vals[f][:, s][:, None])
                count = count + hit
    occ_out = torch.clamp(count, max=k).amax(dim=1).to(torch.int32)
    over_n = torch.clamp(count - k, min=0).sum(dim=1).to(torch.int32)
    px, py, vx, vy = (o[:, :k].contiguous() for o in out)
    return px, py, vx, vy, occ_out, far_n, over_n


def rebin(pos_x, pos_y, vel_x, vel_y, occ_row, dt, settings: SimSettings,
          row_shift=None):
    """Re-pack grid slots by next-step predicted cell.

    Returns (pos_x', pos_y', vel_x', vel_y', occ_row', far_n[Gy],
    over_n[Gy]). Arrivals pack in (source row, dx, slot) order. Far
    movers (beyond the 3x3 neighbourhood) are left out of the output and
    counted per source row in ``far_n``; arrivals beyond capacity are
    dropped and counted per target row in ``over_n``. ``row_shift``:
    i32[Gy] for batched world stacks (row y takes the slots whose cell
    row minus ``row_shift[y]`` is y).
    """
    if not on_cuda(pos_x, pos_y, vel_x, vel_y, occ_row):
        return rebin_plain(pos_x, pos_y, vel_x, vel_y, occ_row, dt, settings,
                           row_shift)
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y)
    _check_occ(occ_row, gy)
    dev = pos_x.device
    shift = _opt_rows(row_shift, gy, "row_shift", dev)
    dt = _as_f32(dt, dev).reshape(1)
    outs = [torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
            for _ in range(4)]
    counts = torch.zeros((3, gy), dtype=torch.int32, device=dev)
    h_inv, half_x, half_y, cx_max, cy_max = _rebin_consts(settings)
    lib = _build.load()
    err = lib.tf_rebin(
        ptr(pos_x), ptr(pos_y), ptr(vel_x), ptr(vel_y), ptr(occ_row),
        ptr(shift), ptr(dt), *(ptr(o) for o in outs),
        ptr(counts[0]), ptr(counts[1]), ptr(counts[2]),
        gy, k, gx, h_inv, half_x, half_y, cx_max, cy_max, stream(dev))
    launched("rebin", err)
    if shift is not None:
        LAUNCHES["rebin_row_shift"] += 1
    return (*outs, counts[0], counts[1], counts[2])


# --------------------------------------------------------------- density

def _density_consts(settings: SimSettings):
    h = float(settings.smoothing_radius)
    return (_f32(h * h), _f32(4.0 / (PI * h**8)),
            _f32(float(settings.size[0]) * 0.5),
            _f32(float(settings.size[1]) * 0.5))


def density_plain(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
                  pressure_constant, rest_density, settings: SimSettings,
                  wid=None):
    """Plain PyTorch version of :func:`density`."""
    gy, k, gx = pos_x.shape
    dev = pos_x.device
    mass, dt, kp_c, rho0 = (_per_row(v, wid, dev) for v in
                            (mass, dt, pressure_constant, rest_density))
    h2, norm, half_x, half_y = _density_consts(settings)
    live = pos_x < SENTINEL_HALF
    prx = _pred(pos_x, vel_x, dt, half_x)
    pry = _pred(pos_y, vel_y, dt, half_y)
    prx_p, pry_p = _pad(prx, SENTINEL), _pad(pry, SENTINEL)
    live_p = _pad(live, False)
    occ_p = _slot_bound(occ_row)
    acc = torch.zeros_like(pos_x)
    n3 = int(occ3_of(occ_row).max()) if gy else 0
    for kp in range(n3):
        part = torch.zeros_like(pos_x)
        for r in range(3):
            ok_row = (kp < occ_p[r:r + gy])[:, None]
            for dx in (-1, 0, 1):
                ok = _block(live_p, r, dx, gy, gx)[:, kp:kp + 1] & ok_row
                ddx = _block(prx_p, r, dx, gy, gx)[:, kp:kp + 1] - prx
                ddy = _block(pry_p, r, dx, gy, gx)[:, kp:kp + 1] - pry
                r2 = ddx * ddx + ddy * ddy
                diff = torch.clamp(h2 - r2, min=0.0)
                part = torch.where(ok, part + diff * diff * diff, part)
        acc = acc + part
    rho = mass * (norm * acc)
    rho = torch.clamp(torch.clamp(rho, min=EPSILON), min=0.1)
    act = _live_slots(pos_x, occ_row)
    pres = torch.where(act, kp_c * (rho - rho0), kp_c * (0.1 - rho0))
    invr = torch.where(act, torch.reciprocal(rho), 10.0)
    return pres, invr


def density(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
            pressure_constant, rest_density, settings: SimSettings,
            wid=None):
    """(pres, inv_rho)[Gy, K, Gxp]: poly6 density over the 3x3 cell
    stencil of predicted positions (funcs.wgsl:157-203), then
    ``pres = k (rho - rho0)`` and ``1/rho`` after the EPSILON and 0.1
    floors. Empty slots get the floor-density defaults. ``wid``: i32[Gy]
    world of each row for batched world stacks; the scalars may then be
    [W]. On a CUDA device ``csrc/density.cu`` runs on the tile it picks
    from K (:func:`density_tile`)."""
    if not on_cuda(pos_x, pos_y, vel_x, vel_y, occ_row):
        return density_plain(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
                             pressure_constant, rest_density, settings, wid)
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y)
    _check_occ(occ_row, gy)
    dev = pos_x.device
    wid_t = _opt_rows(wid, gy, "wid", dev)
    h2, norm, half_x, half_y = _density_consts(settings)
    sc = _sc_table([_as_f32(v, dev) for v in
                    (mass, dt, pressure_constant, rest_density)], wid_t, dev)
    wid_t = _one_world(sc, wid_t)
    pres = torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
    invr = torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.tf_density(
        ptr(pos_x), ptr(pos_y), ptr(vel_x), ptr(vel_y), ptr(occ_row),
        ptr(wid_t), ptr(sc), ptr(pres), ptr(invr), gy, k, gx, h2, norm,
        half_x, half_y, stream(dev))
    launched("density", err)
    if wid_t is not None:
        LAUNCHES["density_wid"] += 1
    return pres, invr


# ----------------------------------------------- forces + integration

@functools.lru_cache(maxsize=None)
def _forces_consts(settings: SimSettings):
    h = float(settings.smoothing_radius)
    h2 = h * h
    h3 = h * h2
    norms = settings.kernel_norms()
    return dict(
        h=_f32(h), h2=_f32(h2), sqr_radius=_f32(settings.sqr_radius),
        c_spiky=_f32(0.5 * norms.spiky_derivative),
        visc_norm=_f32(norms.viscosity),
        c_r3=_f32(-1.0 / (2.0 * h3)), c_r2=_f32(1.0 / h2),
        c_inv=_f32(h / 2.0),
        st_grad=_f32(-24.0 / (PI * h**8)), st_lap=_f32(8.0 / (PI * h**8)),
        c3h2=_f32(3.0 * h2),
        half_x=_f32(float(settings.size[0]) * 0.5),
        half_y=_f32(float(settings.size[1]) * 0.5),
        # obstacle push: pixel -> world scale, (bounds * 2) / texture size
        ff_sx=_f32(2.0 * settings.size[0] / settings.texture_size[0]),
        ff_sy=_f32(2.0 * settings.size[1] / settings.texture_size[1]),
    )


# TfForceConsts (resident_math.cuh), in its field order
_CONST_FIELDS = ("h", "h2", "sqr_radius", "c_spiky", "visc_norm", "c_r3",
                 "c_r2", "c_inv", "st_grad", "st_lap", "c3h2")


@functools.lru_cache(maxsize=None)
def _consts_struct(settings: SimSettings):
    c = _forces_consts(settings)
    return (ctypes.c_float * len(_CONST_FIELDS))(*(c[n]
                                                   for n in _CONST_FIELDS))


def _flags(x_boundary, ff_cells, surface_tension, adaptive) -> int:
    if x_boundary not in ("bounce", "wrap"):
        raise ValueError(f"unknown x_boundary {x_boundary!r}")
    return ((_WRAP if x_boundary == "wrap" else 0)
            | (_HAS_FF if ff_cells is not None else 0)
            | (_ST if surface_tension else 0)
            | (_ADAPT if adaptive else 0))


def _tie_directions(prx, pry, frame):
    """Per-target base direction for coincident pairs
    (compute.wgsl:211-215): two xorshift32 draws seeded from the bits of
    the predicted position and the frame, normalised with rsqrt."""
    seed = prng.position_seed(torch.stack([prx, pry], dim=-1))
    seed = (seed + prng.u32(frame) * 69) & prng.U32
    s1 = prng.xorshift32(seed)
    s2 = prng.xorshift32(s1)
    rx = prng.u32_to_uniform01(s1)
    ry = prng.u32_to_uniform01(s2)
    inv = torch.rsqrt(torch.clamp(rx * rx + ry * ry, min=1e-30))
    return rx * inv, ry * inv


def _st_directions(prx, frame):
    """Per-target surface-tension direction for coincident pairs, seeded
    from the predicted x (compute.wgsl:406; u32 of a negative x is 0)."""
    st_i = torch.clamp(prx, min=0.0).to(torch.int32).to(torch.int64)
    seed = (st_i * 324 + prng.u32(frame) * 5632) & prng.U32
    s1 = prng.xorshift32(seed)
    s2 = prng.xorshift32(s1)
    rx = prng.u32_to_uniform01(s1)
    ry = prng.u32_to_uniform01(s2)
    rn = torch.sqrt(rx * rx + ry * ry)
    rn = torch.where(rn == 0.0, 1.0, rn)
    return rx / rn, ry / rn


def _check_ff(ff_cells, gy: int, gx: int):
    for f in ff_cells:
        if (f.shape != (gy, gx) or f.dtype != torch.float32
                or not f.is_contiguous()):
            raise ValueError(f"ff_cells must be contiguous f32[{gy}, {gx}], "
                             f"got {f.dtype}{list(f.shape)}")


def forces_integrate_plain(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row,
                           params, settings: SimSettings, frame,
                           ff_cells=None, x_boundary="bounce",
                           surface_tension: bool = False,
                           adaptive_subsampling: bool = False, wid=None):
    """Plain PyTorch version of :func:`forces_integrate`."""
    _flags(x_boundary, ff_cells, surface_tension, adaptive_subsampling)
    gy, k, gx = pos_x.shape
    dev = pos_x.device
    f32 = torch.float32
    c = _forces_consts(settings)
    h, h2, sqr_radius, c_sp = c["h"], c["h2"], c["sqr_radius"], c["c_spiky"]
    c_r3, c_r2, c_inv = c["c_r3"], c["c_r2"], c["c_inv"]
    half_x, half_y = c["half_x"], c["half_y"]
    row = lambda v: _per_row(v, wid, dev)
    dt = row(params.delta)
    mass = row(params.mass)
    live = pos_x < SENTINEL_HALF
    prx = _pred(pos_x, vel_x, dt, half_x)
    pry = _pred(pos_y, vel_y, dt, half_y)
    frame = torch.as_tensor(frame, device=dev)
    d0x, d0y = _tie_directions(prx, pry, frame)
    if surface_tension:
        st_dx, st_dy = _st_directions(prx, frame)
    if adaptive_subsampling:
        rho_self = torch.reciprocal(invr)

    cand = dict(px=_pad(prx, SENTINEL), py=_pad(pry, SENTINEL),
                vx=_pad(vel_x, 0.0), vy=_pad(vel_y, 0.0),
                p=_pad(pres, 0.0), ir=_pad(invr, 0.0))
    live_p = _pad(live, False)
    occ_p = _slot_bound(occ_row)
    k_self = torch.arange(k, device=dev)[None, :, None]
    zero = torch.zeros_like(pos_x)
    sfx, sfy, sgx, sgy = zero, zero, zero, zero
    scgx, scgy, sclap = zero, zero, zero
    scc = torch.zeros(pos_x.shape, dtype=torch.int64, device=dev)
    n3 = int(occ3_of(occ_row).max()) if gy else 0
    for kp in range(n3):
        fx, fy, gx_, gy_ = zero, zero, zero, zero
        cgx, cgy, cl = zero, zero, zero
        if adaptive_subsampling:
            # pressure stride 1/5/13 as the self density crosses 150/200
            fac = torch.where(rho_self >= 200.0, float(kp % 13 == 0),
                              torch.where(rho_self >= 150.0,
                                          float(kp % 5 == 0), 1.0))
        for r in range(3):
            ok_row = (kp < occ_p[r:r + gy])[:, None]
            for dx in (-1, 0, 1):
                nb = {n: _block(a, r, dx, gy, gx)[:, kp:kp + 1]
                      for n, a in cand.items()}
                ok = _block(live_p, r, dx, gy, gx)[:, kp:kp + 1] & ok_row
                ddx = nb["px"] - prx
                ddy = nb["py"] - pry
                r2 = ddx * ddx + ddy * ddy
                inv_dst = torch.rsqrt(torch.clamp(r2, min=1e-35))
                dst = r2 * inv_dst
                dirx = ddx * inv_dst
                diry = ddy * inv_dst
                centre = (r, dx) == (1, 0)
                if not centre:
                    # off-centre: the kernel-value clamps are the range gates
                    kern_p = torch.clamp(dst - h, max=0.0) * c_sp
                    wp = kern_p * (pres + nb["p"]) * nb["ir"]
                    if adaptive_subsampling:
                        wp = wp * fac
                    s = wp * inv_dst
                    fx = torch.where(ok, fx + ddx * s, fx)
                    fy = torch.where(ok, fy + ddy * s, fy)
                    kv = torch.clamp(r2 * dst * c_r3 + r2 * c_r2
                                     + inv_dst * c_inv - 1.0, min=0.0)
                    wv = kv * nb["ir"]
                    gx_ = torch.where(ok, gx_ + (nb["vx"] - vel_x) * wv, gx_)
                    gy_ = torch.where(ok, gy_ + (nb["vy"] - vel_y) * wv, gy_)
                else:
                    # centre block: explicit range test, self excluded, and
                    # the tie-break direction for coincident pairs
                    in_range = ok & (r2 <= sqr_radius) & (k_self != kp)
                    coincident = in_range & (dst == 0.0)
                    has_prior = scc >= 1
                    salted = kp < k_self
                    tx = torch.where(salted,
                                     torch.where(has_prior, d0y, -d0x),
                                     torch.where(has_prior, -d0y, d0x))
                    ty = torch.where(salted,
                                     torch.where(has_prior, -d0x, -d0y),
                                     torch.where(has_prior, d0x, d0y))
                    dirx = torch.where(coincident, tx, dirx)
                    diry = torch.where(coincident, ty, diry)
                    scc = scc + coincident
                    kern_p = (dst - h) * c_sp
                    in_range_p = in_range
                    if adaptive_subsampling:
                        in_range_p = in_range & (fac > 0.0)
                    wp = torch.where(in_range_p,
                                     kern_p * (pres + nb["p"]) * nb["ir"],
                                     0.0)
                    fx = fx + dirx * wp
                    fy = fy + diry * wp
                    kv = r2 * dst * c_r3 + r2 * c_r2 + inv_dst * c_inv - 1.0
                    kv = torch.where(dst == 0.0, 1.0, kv)
                    wv = torch.where(in_range, kv * nb["ir"], 0.0)
                    gx_ = gx_ + (nb["vx"] - vel_x) * wv
                    gy_ = gy_ + (nb["vy"] - vel_y) * wv
                if surface_tension:
                    # colour field, self pair included; a coincident pair
                    # takes the target's own seeded direction
                    ok_st = r2 <= sqr_radius
                    if centre:
                        co_st = ok_st & (dst == 0.0)
                        dirx = torch.where(co_st, st_dx, dirx)
                        diry = torch.where(co_st, st_dy, diry)
                    rlen2 = dirx * dirx + diry * diry
                    rlen = torch.sqrt(rlen2)
                    gdiff = h2 - rlen2
                    gsc = torch.where((rlen >= h) | (rlen == 0.0), 0.0,
                                      c["st_grad"] * gdiff * gdiff)
                    m_rho = mass * nb["ir"]
                    lap = torch.where(dst > h, 0.0,
                                      c["st_lap"] * (h2 - r2)
                                      * (c["c3h2"] - 4.0 * r2))
                    cgx = torch.where(ok, cgx + torch.where(
                        ok_st, m_rho * gsc * dirx, 0.0), cgx)
                    cgy = torch.where(ok, cgy + torch.where(
                        ok_st, m_rho * gsc * diry, 0.0), cgy)
                    cl = torch.where(ok, cl + torch.where(
                        ok_st, m_rho * lap, 0.0), cl)
        sfx, sfy = sfx + fx, sfy + fy
        sgx, sgy = sgx + gx_, sgy + gy_
        if surface_tension:
            scgx, scgy, sclap = scgx + cgx, scgy + cgy, sclap + cl

    # integration (compute.wgsl:95-155)
    visc_mu = c["visc_norm"] * row(params.viscosity_coefficient)
    grav = torch.as_tensor(params.gravity, dtype=f32, device=dev)
    grav_x, grav_y = row(grav[..., 0]), row(grav[..., 1])
    accel_x = sfx + sgx * visc_mu
    accel_y = sfy + sgy * visc_mu
    if surface_tension:
        # pairs.surface_tension composition (compute.wgsl:303-315)
        n_len = torch.sqrt(scgx * scgx + scgy * scgy)
        safe_len = torch.where(n_len == 0.0, 1.0, n_len)
        k_st = (-sclap) / (n_len + 1e-6)
        apply_st = n_len > row(params.surface_tension_threshold)
        coef = row(params.surface_tension_coefficient)
        accel_x = accel_x + torch.where(apply_st,
                                        -coef * k_st * (scgx / safe_len), 0.0)
        accel_y = accel_y + torch.where(apply_st,
                                        -coef * k_st * (scgy / safe_len), 0.0)
    vx = vel_x + accel_x * invr * dt + grav_x * dt
    vy = vel_y + accel_y * invr * dt + grav_y * dt

    # mouse impulse (compute.wgsl:99-108); dist 0 under a press is the
    # reference's 0/0 = NaN, which the NaN reset below zeroes
    mouse = torch.as_tensor(params.mouse_pos, dtype=f32, device=dev)
    mstate = row(torch.as_tensor(params.mouse_state, device=dev).to(f32))
    mradius = row(params.mouse_force_radius)
    diffx = row(mouse[..., 0]) - prx
    diffy = row(mouse[..., 1]) - pry
    dist = torch.sqrt(diffx * diffx + diffy * diffy)
    msafe = torch.where(dist == 0.0, 1.0, dist)
    iscale = (row(params.mouse_force_power) * mstate
              * (dist / mradius) / (msafe * msafe))
    iscale = torch.where(dist == 0.0, float("nan"), iscale)
    apply_m = (mstate != 0.0) & (dist <= mradius)
    vx = torch.where(apply_m, vx + diffx * iscale, vx)
    vy = torch.where(apply_m, vy + diffy * iscale, vy)

    nan_any = torch.isnan(vx) | torch.isnan(vy)
    vx = torch.where(nan_any, 0.0, vx)
    vy = torch.where(nan_any, 0.0, vy)

    sp = torch.sqrt(vx * vx + vy * vy)
    fast = sp > MAX_SPEED
    # a tensor numerator: scalar / tensor is reciprocal-then-multiply in
    # torch, which rounds twice
    scl = torch.full_like(sp, MAX_SPEED) / torch.where(fast, sp, 1.0)
    vx = torch.where(fast, vx * scl, vx)
    vy = torch.where(fast, vy * scl, vy)

    px = pos_x + vx * dt
    py = pos_y + vy * dt
    damping = row(params.damping_factor)
    if ff_cells is not None:
        # obstacle push-out per target cell (fused.py:1000-1023): the
        # field is in pixels; the normal is normalised in pixel space, the
        # push scaled to world units per axis, the normal velocity
        # reflected with (1 - damping)
        ffx, ffy = (f[:, None, :] for f in ff_cells)
        hit = (ffx != 0.0) | (ffy != 0.0)
        fn = torch.sqrt(ffx * ffx + ffy * ffy)
        fsafe = torch.where(fn == 0.0, 1.0, fn)
        nhx = ffx / fsafe
        nhy = ffy / fsafe
        px = torch.where(hit, px + ffx * c["ff_sx"], px)
        py = torch.where(hit, py + ffy * c["ff_sy"], py)
        vn = vx * nhx + vy * nhy
        refl = 1.0 - damping
        vx = torch.where(hit, vx - refl * vn * nhx, vx)
        vy = torch.where(hit, vy - refl * vn * nhy, vy)
    outx = torch.abs(px) > half_x
    outy = torch.abs(py) > half_y
    if x_boundary == "wrap":  # teleport, velocity kept
        px = torch.where(outx, -half_x * torch.sign(px), px)
    else:
        px = torch.where(outx, half_x * torch.sign(px), px)
        vx = torch.where(outx, vx * -damping, vx)
    py = torch.where(outy, half_y * torch.sign(py), py)
    vy = torch.where(outy, vy * -damping, vy)

    act = _live_slots(pos_x, occ_row)
    return (torch.where(act, px, SENTINEL), torch.where(act, py, SENTINEL),
            torch.where(act, vx, 0.0), torch.where(act, vy, 0.0))


def _forces_sc(params, settings: SimSettings, wid, dev, physics=False):
    """The per-world scalar table of the forces (17 columns) or physics
    (19) kernel, in the JAX ``sc`` column order."""
    c = _forces_consts(settings)
    grav = torch.as_tensor(params.gravity, device=dev)
    mouse = torch.as_tensor(params.mouse_pos, device=dev)
    cols = [params.delta, params.viscosity_coefficient, grav[..., 0],
            grav[..., 1], params.damping_factor, mouse[..., 0],
            mouse[..., 1], params.mouse_force_radius,
            params.mouse_force_power,
            torch.as_tensor(params.mouse_state, device=dev),
            c["half_x"], c["half_y"], c["ff_sx"], c["ff_sy"], params.mass,
            params.surface_tension_threshold,
            params.surface_tension_coefficient]
    if physics:
        cols += [params.pressure_constant, params.rest_density]
    return _sc_table(cols, wid, dev)


def _count_variants(flags: int, wid_t) -> None:
    for bit, name in ((_HAS_FF, "has_ff"), (_WRAP, "wrap"),
                      (_ST, "surface_tension"), (_ADAPT, "adaptive")):
        if flags & bit:
            LAUNCHES[f"forces_integrate_{name}"] += 1
    if wid_t is not None:
        LAUNCHES["forces_integrate_wid"] += 1


def forces_integrate(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row,
                     params, settings: SimSettings, frame, ff_cells=None,
                     x_boundary="bounce", surface_tension: bool = False,
                     adaptive_subsampling: bool = False, wid=None, out=None):
    """Symmetrised spiky pressure and viscosity over the 3x3 stencil,
    fused with the full integration (gravity, mouse impulse, NaN reset,
    speed clamp, bounce or x wrap). Returns (pos_x', pos_y', vel_x',
    vel_y'). ``frame`` seeds the coincident-pair tie-break. ``ff_cells``:
    optional (ffx, ffy) f32[Gy, Gxp] pixel-space obstacle push-out per
    target cell (``resident.forcefield_cells``). ``surface_tension`` adds
    the colour-field force, ``adaptive_subsampling`` strides the pressure
    candidates by the self density. ``wid``: i32[Gy] world of each row for
    batched world stacks; the params may then carry a leading [W]. ``out``:
    four grids that take the result (none of the inputs). On a CUDA device
    ``csrc/forces.cu`` runs on the tile it picks from K
    (:func:`forces_tile`)."""
    flags = _flags(x_boundary, ff_cells, surface_tension,
                   adaptive_subsampling)
    ffs = () if ff_cells is None else tuple(ff_cells)
    if not on_cuda(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row, *ffs):
        return _into(out, forces_integrate_plain(
            pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row, params,
            settings, frame, ff_cells, x_boundary, surface_tension,
            adaptive_subsampling, wid))
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y, pres, invr)
    _check_occ(occ_row, gy)
    if ffs:
        _check_ff(ffs, gy, gx)
    dev = pos_x.device
    wid_t = _opt_rows(wid, gy, "wid", dev)
    sc = _forces_sc(params, settings, wid_t, dev)
    wid_t = _one_world(sc, wid_t)
    fr = torch.as_tensor(frame, dtype=torch.int64, device=dev).reshape(1)
    outs = _outputs(out, (gy, k, gx), dev)
    lib = _build.load()
    err = lib.tf_forces(
        ptr(pos_x), ptr(pos_y), ptr(vel_x), ptr(vel_y), ptr(pres),
        ptr(invr), ptr(occ_row), ptr(wid_t), ptr(sc), ptr(fr),
        *([ptr(f) for f in ffs] if ffs else [None, None]),
        *(ptr(o) for o in outs), gy, k, gx, flags,
        _consts_struct(settings), stream(dev))
    launched("forces_integrate", err)
    _count_variants(flags, wid_t)
    return tuple(outs)


# -------------------------------- density + forces + integration, fused

def physics_plain(pos_x, pos_y, vel_x, vel_y, occ_row, params,
                  settings: SimSettings, frame, ff_cells=None,
                  x_boundary="bounce", surface_tension: bool = False,
                  adaptive_subsampling: bool = False, wid=None):
    """Plain PyTorch version of :func:`physics`: by definition
    ``density_plain`` followed by ``forces_integrate_plain``."""
    pres, invr = density_plain(
        pos_x, pos_y, vel_x, vel_y, occ_row, params.mass, params.delta,
        params.pressure_constant, params.rest_density, settings, wid)
    return forces_integrate_plain(
        pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row, params, settings,
        frame, ff_cells, x_boundary, surface_tension, adaptive_subsampling,
        wid)


def physics(pos_x, pos_y, vel_x, vel_y, occ_row, params,
            settings: SimSettings, frame, ff_cells=None, x_boundary="bounce",
            surface_tension: bool = False,
            adaptive_subsampling: bool = False, wid=None, out=None):
    """Density + 3x3-stencil forces + full integration as one kernel.

    Same contract as :func:`density` followed by
    :func:`forces_integrate`, and bitwise equal to that pair: returns
    (pos_x', pos_y', vel_x', vel_y'), in ``out`` when given (as for
    :func:`forces_integrate`). pres and 1/rho never leave the block
    (``csrc/physics.cu``, on the tile it picks from K:
    :func:`physics_tile`)."""
    flags = _flags(x_boundary, ff_cells, surface_tension,
                   adaptive_subsampling)
    ffs = () if ff_cells is None else tuple(ff_cells)
    if not on_cuda(pos_x, pos_y, vel_x, vel_y, occ_row, *ffs):
        return _into(out, physics_plain(
            pos_x, pos_y, vel_x, vel_y, occ_row, params, settings, frame,
            ff_cells, x_boundary, surface_tension, adaptive_subsampling,
            wid))
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y)
    _check_occ(occ_row, gy)
    if ffs:
        _check_ff(ffs, gy, gx)
    dev = pos_x.device
    wid_t = _opt_rows(wid, gy, "wid", dev)
    sc = _forces_sc(params, settings, wid_t, dev, physics=True)
    wid_t = _one_world(sc, wid_t)
    fr = torch.as_tensor(frame, dtype=torch.int64, device=dev).reshape(1)
    outs = _outputs(out, (gy, k, gx), dev)
    h2, norm, _, _ = _density_consts(settings)
    lib = _build.load()
    err = lib.tf_physics(
        ptr(pos_x), ptr(pos_y), ptr(vel_x), ptr(vel_y), ptr(occ_row),
        ptr(wid_t), ptr(sc), ptr(fr),
        *([ptr(f) for f in ffs] if ffs else [None, None]),
        *(ptr(o) for o in outs), gy, k, gx, flags, h2, norm,
        _consts_struct(settings), stream(dev))
    if err != 0 and k > physics_max_capacity():  # the launcher found no tile
        raise ValueError(f"physics: cell_capacity {k} is above the largest "
                         f"the kernel stages in shared memory, "
                         f"{physics_max_capacity()}{_USE_SPLIT}")
    launched("physics", err)
    return tuple(outs)
