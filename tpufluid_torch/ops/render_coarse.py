"""The metaball coarse fields straight off the resident slot grid (port of
``tpufluid.ops.pallas.render.coarse_metaball_fields``).

The Gaussian density and speed-weighted fields of the fluid surface are
evaluated on a world-aligned lattice of ``supersample`` samples per grid
cell per axis; ``ops.render_grid`` resamples them to the camera and shades
them. The slot grid already is the spatial binning, so nothing is sorted
or re-binned per frame.

Candidate set (the TPU kernel's, kept exactly): coarse rows go in blocks of
8; block p reads the ``n_rows = 7 // sup + 1 + 6`` source rows from
``8p // sup - 3`` on (skipping rows out of range or empty), the 8-slot
sub-blocks below each row's occupancy, and for every sample the columns
``(l // sup + dx) mod Gxp``, dx in -3..3 (the TPU's lane roll wraps).
Per (row, sub-block, dx) a partial sum starts at 0 and is then added to
the field.

On the CPU :func:`coarse_metaball_fields` runs the plain version beside
it; on a CUDA device it launches ``csrc/metaball_coarse.cu`` and counts
the launch in ``_build.LAUNCHES``, or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..params import SimSettings
from .._build import launched, on_cuda, ptr, stream
from .fused import _check_occ, _f32

# cells of horizontal reach: the 2.5h influence radius fits in +-3 cells
DX_REACH = 3


def _consts(settings: SimSettings, sup: int):
    """(neg_inv_tau, h_s, off_x, off_y, n_rows): constants computed in
    Python doubles and rounded to f32 once, as the JAX kernel bakes them.
    Lane 0 sits in the sentinel cell, at -half - h."""
    h = float(settings.smoothing_radius)
    return (_f32(-1.0 / (float(settings.sqr_radius) * 0.5)), _f32(h / sup),
            _f32(float(settings.size[0]) * 0.5 + h),
            _f32(float(settings.size[1]) * 0.5 + h),
            7 // sup + 1 + 2 * DX_REACH)


def _check_fields(shape, *grids) -> None:
    """Contiguous f32 grids of one shape; the kernel takes any width."""
    for g in grids:
        if (g.shape != shape or g.dtype != torch.float32
                or not g.is_contiguous()):
            raise ValueError(
                f"expected contiguous f32{list(shape)}, got "
                f"{g.dtype}{list(g.shape)} contiguous={g.is_contiguous()}")


def _check_supersample(gy: int, sup: int) -> None:
    if sup < 1 or 8 % sup != 0 or (sup * gy) % 8 != 0:
        raise ValueError(f"supersample {sup} must divide 8 and give "
                         f"8-aligned coarse rows (gy={gy})")


def coarse_metaball_fields_plain(pos_x, pos_y, speed, occ_row,
                                 settings: SimSettings, supersample: int = 2):
    """Plain PyTorch version of :func:`coarse_metaball_fields`: the same
    sums in the same order, vectorised over all coarse blocks. Reads the
    occupancy to the host once, to skip sub-blocks no block needs."""
    gy, k, gxp = pos_x.shape
    sup = int(supersample)
    _check_supersample(gy, sup)
    neg_inv_tau, h_s, off_x, off_y, n_rows = _consts(settings, sup)
    dev = pos_x.device
    f32 = torch.float32
    wc, n_blk = sup * gxp, sup * gy // 8
    wx = (torch.arange(wc, dtype=f32, device=dev) + 0.5) * h_s - off_x
    blk = torch.arange(n_blk, device=dev)
    sub = torch.arange(8, dtype=f32, device=dev)
    wy = ((8.0 * blk.to(f32))[:, None] + sub + 0.5) * h_s - off_y  # [P, 8]
    dens = torch.zeros((n_blk, 8, wc), dtype=f32, device=dev)
    velf = torch.zeros_like(dens)
    occ_h = occ_row.cpu().numpy()
    r_first = (8 * np.arange(n_blk)) // sup - DX_REACH
    for j in range(n_rows):
        rj = r_first + j
        rj_c = np.clip(rj, 0, gy - 1)
        ok_row = (rj >= 0) & (rj < gy) & (occ_h[rj_c] > 0)
        rows = torch.from_numpy(rj_c).to(dev)
        for lo in range(0, k, 8):
            hi = min(lo + 8, k)
            guard = ok_row & (occ_h[rj_c] > lo)
            if not guard.any():
                continue
            guard_t = torch.from_numpy(guard).to(dev)[:, None, None]
            # cell-expanded rows: lane l reads cell l // sup
            ex = [a[rows, lo:hi].repeat_interleave(sup, dim=2)
                  for a in (pos_x, pos_y, speed)]
            for dx in range(-DX_REACH, DX_REACH + 1):
                nx, ny, ns = (torch.roll(a, -dx * sup, dims=2) for a in ex)
                d = torch.zeros_like(dens)
                v = torch.zeros_like(dens)
                for kp in range(hi - lo):
                    ddx = nx[:, kp, None, :] - wx
                    ddy = ny[:, kp, None, :] - wy[:, :, None]
                    r2 = ddx * ddx + ddy * ddy
                    # empty slots: r2 ~ 1e18, so exp == 0 exactly
                    c = torch.exp(r2 * neg_inv_tau)
                    d = d + c
                    v = v + c * ns[:, kp, None, :]
                dens = torch.where(guard_t, dens + d, dens)
                velf = torch.where(guard_t, velf + v, velf)
    return dens.reshape(sup * gy, wc), velf.reshape(sup * gy, wc)


def coarse_metaball_fields(pos_x, pos_y, speed, occ_row,
                           settings: SimSettings, supersample: int = 2):
    """(density, velocity_factor) f32[sup*Gy, sup*Gxp] on the coarse world
    lattice. pos_x / pos_y / speed: slot grids f32[Gy, K, Gxp] (empty
    slots at pos = SENTINEL, speed 0); occ_row: i32[Gy]."""
    if not on_cuda(pos_x, pos_y, speed, occ_row):
        return coarse_metaball_fields_plain(pos_x, pos_y, speed, occ_row,
                                            settings, supersample)
    gy, k, gxp = pos_x.shape
    sup = int(supersample)
    _check_supersample(gy, sup)
    _check_fields((gy, k, gxp), pos_x, pos_y, speed)
    _check_occ(occ_row, gy)
    neg_inv_tau, h_s, off_x, off_y, n_rows = _consts(settings, sup)
    dev = pos_x.device
    dens = torch.empty((sup * gy, sup * gxp), dtype=torch.float32, device=dev)
    velf = torch.empty_like(dens)
    err = _build.load().tf_metaball_coarse(
        ptr(pos_x), ptr(pos_y), ptr(speed), ptr(occ_row), ptr(dens),
        ptr(velf), gy, k, gxp, sup, n_rows, neg_inv_tau, h_s, off_x, off_y,
        stream(dev))
    launched("metaball_coarse", err)
    return dens, velf
