"""Far-mover pass of the row-band sharded resident step (the JAX sharded
step's ``do_far`` under ``lax.cond``, ``tpufluid.parallel.shard``).

Band d holds global rows ``[row_off, row_off + rloc)`` of the slot grid.
The pass has two halves with an ``all_gather`` of their packets between
them:

* ``far_collect``: the band's far movers (pre-rebin: a live slot whose
  predicted cell lies beyond the 3 x 3 cells around its own) packed in
  flat slot order into ``far_capacity`` rows of (pos_x, pos_y, vel_x,
  vel_y, valid), rows past the count zero, and the count that did not fit;
* ``far_insert``: of the gathered rows, the valid ones whose target row
  the band owns, stably ordered by band-local target cell, appended to
  their cells after the post-merge band's slots; the band's ``occ_row``
  after it, and ``lost`` plus the movers that found no room and the
  band's packet drops.

On a CUDA device both launch ``csrc/far_sharded.cu`` every step; each
reads ``total`` (the psum of every band's far-mover count) on the device
and writes nothing when it is 0, so the step reads no count on the host.
With the gate closed the packet and drop count are left unwritten. On the
CPU the plain versions run, whatever the count.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import launched, on_cuda, ptr, stream
from ..params import SimSettings
from . import fused
from . import resident as residentops
from .dense import ranks
from .fused import SENTINEL_HALF

PACKET_W = 5


def far_mask(px, py, vx, vy, dt, settings: SimSettings, row_off: int):
    """Which slots of a band (global rows from ``row_off``) hold a far
    mover, the predicate of the JAX step's ``do_far`` (and, with its row
    shift, of the band's rebin count)."""
    rloc, _, gxp = px.shape
    dev = px.device
    ncx, ncy = fused._cells(px, py, vx, vy, dt, settings)
    scx = torch.arange(gxp, device=dev)[None, None, :]
    scy = torch.arange(rloc, device=dev)[:, None, None] + row_off
    return (px < SENTINEL_HALF) & (
        ((ncy - scy).abs() > 1) | ((ncx - scx).abs() > 1))


def far_packet_plain(px, py, vx, vy, dt, settings: SimSettings,
                     row_off: int, far_capacity: int):
    """Plain version of :func:`far_collect`: (packet f32[far_capacity, 5],
    pk_drop i32 0-d), whatever the count."""
    far = far_mask(px, py, vx, vy, dt, settings, row_off).reshape(-1)
    order = torch.sort(torch.where(far, 0, 1).to(torch.int32),
                       stable=True)[1][:far_capacity]
    if order.shape[0] < far_capacity:  # a band smaller than the packet
        order = torch.nn.functional.pad(order,
                                        (0, far_capacity - order.shape[0]))
    count = far.sum().to(torch.int32)
    valid = torch.arange(far_capacity, device=px.device) < count
    fields = torch.stack([px.reshape(-1), py.reshape(-1), vx.reshape(-1),
                          vy.reshape(-1)], dim=1)[order]
    packet = torch.cat([fields, valid[:, None].to(torch.float32)], dim=1)
    packet = torch.where(valid[:, None], packet, 0.0)
    return packet, torch.clamp(count - far_capacity, min=0)


def insert_far_plain(g4, allp, dt, settings: SimSettings, row_off: int):
    """Plain version of :func:`far_insert` without its ``lost`` update:
    (grids, occ_row_of the result, dropped), whatever the count."""
    rloc, k, gxp = g4[0].shape
    grid_w = settings.grid_w
    flag = allp[:, 4] > 0.5
    gcx, gcy = fused._cells(allp[:, 0], allp[:, 1], allp[:, 2], allp[:, 3],
                            dt, settings)
    mine = flag & (gcy >= row_off) & (gcy < row_off + rloc)
    lcell = torch.where(mine, (gcy - row_off) * grid_w + gcx, 2**30)
    lcell_s, perm = torch.sort(lcell, stable=True)
    rows = allp[perm]
    mine_s = mine[perm]
    rank = ranks(lcell_s)
    occ_cell = (g4[0] < SENTINEL_HALF).sum(dim=1)  # [rloc, Gxp]
    cy = torch.clamp(lcell_s // grid_w, 0, rloc - 1)
    cx = torch.clamp(lcell_s % grid_w, 0, gxp - 1)
    slot = occ_cell.reshape(-1)[cy * gxp + cx] + rank
    fits = mine_s & (slot < k)
    flat = torch.where(fits, (cy * k + slot) * gxp + cx, g4[0].numel())
    g4 = tuple(residentops.put_flat(g, flat, rows[:, f])
               for f, g in enumerate(g4))
    dropped = (mine_s.sum() - fits.sum()).to(torch.int32)
    return g4, residentops.occ_row_of(g4[0]), dropped


def _check_band(g4, occ_row, rloc_k_gx):
    fused._check_grids(rloc_k_gx, *g4)
    fused._check_occ(occ_row, rloc_k_gx[0])


def _check_i32(t, n, name):
    if t.dtype != torch.int32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous i32 of {n} element(s), "
                         f"got {t.dtype}{list(t.shape)}")


def far_collect(px, py, vx, vy, occ_row, far_n, total, dt,
                settings: SimSettings, row_off: int, far_capacity: int):
    """Band ``(px, py, vx, vy, occ_row)``'s far movers as a packet:
    (packet f32[far_capacity, 5], pk_drop i32 0-d). ``far_n``: the band's
    rows of its rebin's per-row count (i32[rloc]); ``total``: i32 0-d or
    [1], every band's count summed. On a CUDA device
    ``csrc/far_sharded.cu``, gated on ``total`` on the device (with it 0
    neither output is written); on the CPU :func:`far_packet_plain`."""
    grids = (px, py, vx, vy)
    if not on_cuda(*grids, occ_row, far_n, total):
        return far_packet_plain(*grids, dt, settings, row_off, far_capacity)
    rloc, k, gx = px.shape
    _check_band(grids, occ_row, (rloc, k, gx))
    fused._check_occ(far_n, rloc, "far_n")
    _check_i32(total, 1, "total")
    dev = px.device
    packet = torch.empty((far_capacity, PACKET_W), dtype=torch.float32,
                         device=dev)
    pk_drop = torch.empty((), dtype=torch.int32, device=dev)
    h_inv, half_x, half_y, cx_max, cy_max = fused._rebin_consts(settings)
    err = _build.load().tf_far_band_collect(
        *(ptr(t) for t in (*grids, occ_row, far_n, total)),
        ptr(fused._as_f32(dt, dev).reshape(1)), ptr(packet),
        ptr(pk_drop), rloc, k, gx, row_off, far_capacity, h_inv,
        half_x, half_y, cx_max, cy_max, stream(dev))
    launched("far_collect", err)
    return packet, pk_drop


def far_insert(g4, occ_row, lost, allp, total, pk_drop, dt,
               settings: SimSettings, row_off: int):
    """The gathered far movers ``allp`` (f32[M, 5]) that band ``g4`` (the
    post-merge grids, global rows from ``row_off``) owns, inserted.
    Returns (grids, occ_row, lost + dropped + pk_drop). On a CUDA device
    ``csrc/far_sharded.cu`` updates ``g4``, ``occ_row`` and ``lost`` (i32
    0-d) in place, gated on ``total`` on the device; on the CPU
    :func:`insert_far_plain`."""
    if not on_cuda(*g4, occ_row, lost, allp, total, pk_drop):
        g4, occ, dropped = insert_far_plain(g4, allp, dt, settings, row_off)
        return g4, occ, lost + dropped + pk_drop
    rloc, k, gx = g4[0].shape
    _check_band(g4, occ_row, (rloc, k, gx))
    _check_i32(lost, 1, "lost")
    _check_i32(total, 1, "total")
    _check_i32(pk_drop, 1, "pk_drop")
    m = allp.shape[0]
    if (allp.shape != (m, PACKET_W) or allp.dtype != torch.float32
            or not allp.is_contiguous()):
        raise ValueError(f"allp must be contiguous f32[M, {PACKET_W}], got "
                         f"{allp.dtype}{list(allp.shape)}")
    dev = allp.device
    lib = _build.load()
    n_pad = residentops._pow2(m)
    # the key list of a sort too large for shared memory
    big = n_pad > lib.tf_far_smem_entries()
    keys = torch.empty(n_pad if big else 1, dtype=torch.int64, device=dev)
    gslot = torch.empty(n_pad if big else 1, dtype=torch.int32, device=dev)
    h_inv, half_x, half_y, cx_max, cy_max = fused._rebin_consts(settings)
    err = lib.tf_far_band_insert(
        ptr(allp), m, ptr(total), ptr(pk_drop),
        ptr(fused._as_f32(dt, dev).reshape(1)), ptr(keys),
        ptr(gslot), *(ptr(t) for t in (*g4, occ_row, lost)),
        rloc, k, gx, row_off, settings.grid_w, h_inv, half_x, half_y,
        cx_max, cy_max, stream(dev))
    launched("far_insert", err)
    return tuple(g4), occ_row, lost
