"""The round-1 re-binning kernel with a valid mask (port of
``tpufluid.ops.pallas.rebin.rebin``).

Before the sentinel-encoded slot grid, the resident engine kept a 0/1
``valid_f`` field beside the four particle fields and re-packed the grid
with this kernel; ``ops.fused.rebin`` superseded it and nothing calls it on
a step path. It is ported for completeness, with its own semantics:

* inputs ``[Gy, K, Gxp]`` f32, ``valid_f`` as 0/1 float (a slot with
  ``valid_f == 0`` may hold stale data: it is ignored);
* a valid slot's cell is that of its clamped prediction,
  ``clip(p + v dt, +-half)``, then ``floor((pr + size/2) (1/h)) + 1``
  clipped to ``[1, grid_w - 2]`` and ``[1, grid_h - 2]``;
* target cell (y, x) takes, in (source row y-1..y+1, dx -1..+1, slot)
  order, the valid slots of source row ``y + r`` (a row outside the grid
  is skipped) and column ``(x + dx) mod Gxp`` (the TPU lane roll wraps)
  whose cell is (y, x), packed by a running count into slots 0..K-1;
  arrivals beyond K are dropped;
* outputs: the four moved fields and ``valid'`` (empty slots 0 in all
  five), and ``lost'``: the valid far movers of source cell (y, x) (cell
  more than one row or column away) plus ``max(count - K, 0)``, broadcast
  over the K slots and multiplied by the f32 ``1/K``.

On the CPU :func:`rebin_valid` runs :func:`rebin_valid_plain`; on a CUDA
device it launches ``csrc/rebin_valid.cu`` (on the tile of target cells it
picks from K: :func:`rebin_valid_tile`) and counts the launch in
``_build.LAUNCHES``, or raises; it never falls back.
"""

from __future__ import annotations

import torch

from .. import _build
from ..params import SimSettings
from .._build import launched, on_cuda, ptr, stream
from .fused import _as_f32, _cells, _check_grids, _f32, _rebin_consts, _tile


def rebin_valid_tile(k: int):
    """(rows, columns) of the rebin_valid kernel's tile of target cells at
    capacity ``k``, as ``csrc/rebin_valid.cu`` picks it (builds the
    kernels if needed)."""
    return _tile(_build.load().tf_rebin_valid_tile, k, "rebin_valid")


def rebin_valid_plain(pos_x, pos_y, vel_x, vel_y, valid_f, dt,
                      settings: SimSettings):
    """Plain PyTorch version of :func:`rebin_valid`: the same walk,
    vectorised over all targets (y, x) at once."""
    gy, k, gx = pos_x.shape
    dev = pos_x.device
    dt = _as_f32(dt, dev)
    valid = valid_f > 0.0
    ncx, ncy = _cells(pos_x, pos_y, vel_x, vel_y, dt, settings)
    ty = torch.arange(gy, device=dev)[:, None]
    tx = torch.arange(gx, device=dev)[None, :]

    # far movers of each source cell, counted before the walk
    far = valid & (((ncy - ty[:, None]).abs() > 1)
                   | ((ncx - tx[:, None]).abs() > 1))
    lost = far.sum(dim=1).to(torch.float32)

    src = (pos_x, pos_y, vel_x, vel_y)
    # one spare slot (index k) takes every non-arrival and every overflow
    out = [torch.zeros((gy, k + 1, gx), dtype=torch.float32, device=dev)
           for _ in range(5)]
    count = torch.zeros((gy, gx), dtype=torch.int64, device=dev)
    for r in (-1, 0, 1):
        # source row y + r of target row y; rows outside the grid skipped
        row_ok = ((ty + r >= 0) & (ty + r < gy))[:, None]
        rows = lambda a: torch.roll(a, -r, dims=0)
        for dx in (-1, 0, 1):
            # source column (x + dx) mod gx
            blk = lambda a: torch.roll(rows(a), -dx, dims=2)
            lv, cx, cy = blk(valid) & row_ok, blk(ncx), blk(ncy)
            vals = [blk(a) for a in src]
            for s in range(k):
                hit = lv[:, s] & (cy[:, s] == ty) & (cx[:, s] == tx)
                dest = torch.where(hit & (count < k), count, k)[:, None]
                for f in range(4):
                    out[f].scatter_(1, dest, vals[f][:, s][:, None])
                out[4].scatter_(1, dest, hit[:, None].to(torch.float32))
                count = count + hit
    lost = lost + torch.clamp(count - k, min=0).to(torch.float32)
    lost_f = (lost * _f32(1.0 / k))[:, None, :].expand(gy, k, gx)
    # the TPU kernel accumulates each slot as 0 + value: -0.0 reads +0.0
    return (*(o[:, :k] + 0.0 for o in out), lost_f.contiguous())


def rebin_valid(pos_x, pos_y, vel_x, vel_y, valid_f, dt,
                settings: SimSettings):
    """Re-pack valid grid slots by next-step predicted cell.

    All arrays f32[Gy, K, Gxp] (``valid_f`` 0/1). Returns (pos_x', pos_y',
    vel_x', vel_y', valid_f', lost') as the JAX kernel does: far movers and
    arrivals beyond K are left out of the output and counted in ``lost'``
    (per source cell, divided over its K slots)."""
    if not on_cuda(pos_x, pos_y, vel_x, vel_y, valid_f):
        return rebin_valid_plain(pos_x, pos_y, vel_x, vel_y, valid_f, dt,
                                 settings)
    gy, k, gx = pos_x.shape
    _check_grids((gy, k, gx), pos_x, pos_y, vel_x, vel_y, valid_f)
    dev = pos_x.device
    dt = _as_f32(dt, dev).reshape(1)
    outs = [torch.empty((gy, k, gx), dtype=torch.float32, device=dev)
            for _ in range(6)]
    h_inv, half_x, half_y, cx_max, cy_max = _rebin_consts(settings)
    err = _build.load().tf_rebin_valid(
        ptr(pos_x), ptr(pos_y), ptr(vel_x), ptr(vel_y), ptr(valid_f),
        ptr(dt), *(ptr(o) for o in outs), gy, k, gx, h_inv, half_x,
        half_y, cx_max, cy_max, _f32(1.0 / k), stream(dev))
    launched("rebin_valid", err)
    return tuple(outs)
