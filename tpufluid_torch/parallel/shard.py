"""Multi-device sharding over a single-controller mesh (port of
``tpufluid.parallel.shard``): the slab sharding of the per-step [N]
engines and the row-band sharding of the resident engine.

Slabs (``make_sharded_step``): the world is cut into vertical slabs of
cell columns (``ShardSpec.col_bounds``), one per shard, each holding a
fixed ``capacity`` of particle slots with a valid mask. Each step:

  1. predict, and pack the particles of the two boundary columns on each
     side (``halo_capacity`` slots) for the neighbours;
  2. the neighbour's halo arrives, and the step's physics runs on local +
     halo: the windowed pair math of the grid engine, or the slab-local
     dense slot grid ``[grid_h, K, Gxp]`` of the dense and pallas engines
     (a slab's columns plus two halo columns each side, ``Gxp`` the width
     padded to 128; its columns wrap through the padding, which joins the
     slab's left and right halo columns, >= 3 cells apart: the cut-off
     rejects those pairs);
  3. particles whose new cell lies in another slab migrate to the
     neighbour (``migration_capacity`` slots each way) and are merged
     behind the slab's kept particles.

Overflow of any buffer drops deterministically and is counted in the
step's stats, never raised. A step reads nothing on the host.

Row bands (``make_sharded_resident_step``): the slot grid ``[Gy, K, Gxp]``
is cut into D bands of ``rows_per_dev`` rows (the rows padded to a
multiple of D with empty sentinel rows), one per shard. Each step runs the single-device step's kernels on every band
and exchanges only what crosses a band edge:

  1. rebin over the band plus one pad row each side (``fused.rebin`` with
     ``row_shift`` = the band's first global row less one);
  2. the pad rows' arrivals go to the neighbours and are appended behind
     the slots of their edge rows, per cell; arrivals past K are counted;
  3. far movers (more than one cell in a step): a packet of
     ``far_capacity`` rows from each shard, gathered by all; each shard
     inserts the rows whose target cell it owns, stable by target cell,
     after its slots, and counts the drops (``ops.far_sharded``). The
     gate is the sum of the shards' far counts, read by the kernels on
     the device (the JAX step's ``lax.cond``), so a step reads nothing on
     the host; the plain step reads it on the host;
  4. a two-row halo from each neighbour, then ``density`` and
     ``forces_integrate`` on band plus halo (the obstacle field sampled on
     the same rows, ``resident.forcefield_cells``' row window).

``lost`` adds the rebin overflow, the merge overflow and the far drops of
every shard. Per-step traffic is O(rows x K x Gxp) each way, whatever the
band height (``comm_audit.resident_comm_formula``).

The mesh is one controller over a list of torch devices, as JAX's
``shard_map`` is one program over a mesh: ``ppermute`` is a copy to the
neighbour's device, ``all_gather`` a concatenation of the copied packets,
``psum`` a sum. The devices may repeat: D shards on one card run the same
exchanges as D cards of one host, whose copies go peer to peer. The mesh
records each transfer of a step for ``comm_audit.audit_step``.

One program a call: on a mesh of one CUDA device, each call of either
sharded step replays one CUDA graph of the whole step
(``graphs.Runners``), the counterpart of the JAX package's
``jax.jit(shard_map(step))``, bitwise the eager step
(``make_eager_sharded_resident_step``, ``make_eager_sharded_step``). A
mesh over several cards runs eagerly, decided from ``mesh.devices`` when
the step is built (``step.graphed``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import graphs
from ..ops import dense as denseops
from ..ops import far_sharded as farops
from ..ops import fused
from ..ops import pairs, prng, sph
from ..ops import resident as residentops
from ..ops.fused import SENTINEL, SENTINEL_HALF
from ..ops.grid import cell_id, cell_xy, point_windows
from ..params import EPSILON, SimSettings
from ..state import ParticleState, init_state
from ..step import _integrate, predict_positions
from .comm_audit import CollectiveOp


def _round8(x: int) -> int:
    return ((x + 7) // 8) * 8


def _pack(mask: torch.Tensor, arrays, cap: int):
    """Pack the masked rows (in order) into ``cap`` slots.

    Returns (packed_arrays, valid[cap], n_dropped): the first ``cap``
    selected rows (by index) survive; the slots past the count hold
    copies of other rows, marked invalid."""
    n = mask.shape[0]
    key = torch.where(mask, 0, 1).to(torch.int32)
    _, perm = torch.sort(key, stable=True)
    sel = perm[:cap]
    if cap > n:  # a buffer larger than the source: pad with row 0
        sel = torch.nn.functional.pad(sel, (0, cap - n))
    count = mask.sum().to(torch.int32)
    valid = torch.arange(cap, device=mask.device) < count
    dropped = torch.clamp(count - cap, min=0)
    return tuple(a[sel] for a in arrays), valid, dropped


# ------------------------------------------------------------------ spec

@dataclasses.dataclass(frozen=True)
class ResidentShardSpec:
    settings: SimSettings
    n_devices: int
    rows_per_dev: int
    gy_pad: int
    far_capacity: int


def build_resident_spec(settings: SimSettings, n_devices: int,
                        far_capacity: Optional[int] = None
                        ) -> ResidentShardSpec:
    """Rows per shard for ``n_devices`` bands (at least 4: the halo is two
    rows); ``far_capacity`` far movers a shard may send in one step."""
    settings = residentops.pad_capacity(settings)
    gy = residentops._rows(settings)
    rows = -(-gy // n_devices)
    if rows < 4:
        raise ValueError(
            f"grid too flat: {gy} rows over {n_devices} devices gives "
            f"{rows} rows/device (need >= 4 for the 2-row halo)")
    if far_capacity is None:
        far_capacity = _round8(
            max(1024, settings.particle_count // (64 * n_devices)))
    return ResidentShardSpec(
        settings=settings, n_devices=n_devices, rows_per_dev=rows,
        gy_pad=rows * n_devices, far_capacity=_round8(far_capacity))


# ------------------------------------------------------------------ mesh

def _resolved(dev: torch.device) -> torch.device:
    """``cuda`` as the index its tensors carry (``cuda:<current>``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _Recording:
    def __init__(self):
        self.ops: List[CollectiveOp] = []
        self.steps = 0


class Mesh:
    """D shards, shard d on ``devices[d]`` (devices may repeat), and the
    collectives between them. While ``recording()`` is open, each
    collective is noted once per call with its per-shard operand, as a
    jaxpr holds it."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_resolved(torch.device(d)) for d in devices)
        self._rec: Optional[_Recording] = None

    def __len__(self) -> int:
        return len(self.devices)

    @contextlib.contextmanager
    def recording(self):
        """Note the collectives made while open (a recording open around
        this one resumes after it)."""
        prev, self._rec = self._rec, _Recording()
        rec = self._rec
        try:
            yield rec
        finally:
            self._rec = prev

    def begin_step(self) -> None:
        if self._rec is not None:
            self._rec.steps += 1

    def replayed(self, rec: _Recording) -> None:
        """A graph replay of the steps recorded in ``rec`` (its capture):
        their steps and collectives noted again."""
        if self._rec is not None:
            self._rec.steps += rec.steps
            self._rec.ops.extend(rec.ops)

    def note(self, primitive: str, shape, dtype: torch.dtype,
             conditional: bool = False) -> None:
        """Record one collective of ``shape`` per shard."""
        if self._rec is None:
            return
        nbytes = dtype.itemsize
        for s in shape:
            nbytes *= int(s)
        self._rec.ops.append(CollectiveOp(
            primitive=primitive, shape=tuple(int(s) for s in shape),
            dtype=str(dtype).replace("torch.", ""), nbytes=nbytes,
            conditional=conditional))

    def shift(self, parts, offset: int) -> list:
        """``ppermute``: shard d's tuple ``parts[d]`` goes to shard
        d + offset; a shard that no shard sends to gets None. One
        ppermute per tensor of the tuple (none with a single shard)."""
        n = len(self.devices)
        if n > 1:
            for t in parts[0]:
                self.note("ppermute", t.shape, t.dtype)
        out = [None] * n
        for d in range(n):
            src = d - offset
            if 0 <= src < n:
                out[d] = tuple(t.to(self.devices[d], non_blocking=True)
                               for t in parts[src])
        return out

    def all_gather(self, parts, conditional: bool = False) -> list:
        """Every shard gets the concatenation of all shards' ``parts``."""
        self.note("all_gather", parts[0].shape, parts[0].dtype, conditional)
        joined = {}
        for dev in self.devices:
            if dev not in joined:
                joined[dev] = torch.cat([p.to(dev, non_blocking=True)
                                         for p in parts])
        return [joined[dev] for dev in self.devices]

    def psum(self, vals) -> list:
        """Every shard gets the sum of all shards' ``vals``."""
        self.note("psum", vals[0].shape, vals[0].dtype)
        total = vals[0]
        for v in vals[1:]:
            total = total + v.to(total.device, non_blocking=True)
        return [total.to(dev, non_blocking=True) for dev in self.devices]


def _mesh_devices(n: int, devices=None) -> list:
    """``devices`` (n of them, repeats allowed), or one CUDA device a
    shard, ``[cuda:0] * n`` when there are fewer than n; raises without a
    card unless the caller passes devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[torch.device('cpu')] * D "
                "to shard on the CPU")
        if torch.cuda.device_count() >= n:
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [torch.device("cuda", 0)] * n
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a spec of {n} shards")
    return list(devices)


def make_resident_mesh(spec: ResidentShardSpec, devices=None) -> Mesh:
    """The shards' devices: ``devices`` (D of them, repeats allowed), or
    one CUDA device a shard, ``[cuda:0] * D`` when there are fewer than
    D. Pass ``[torch.device("cpu")] * D`` to run on the CPU."""
    return Mesh(_mesh_devices(spec.n_devices, devices))


# ----------------------------------------------------------------- state

@dataclasses.dataclass
class ShardedGridState:
    """The resident grid as D row bands: band d is a GridState of global
    rows [d * rows_per_dev, (d + 1) * rows_per_dev) on mesh device d; each
    band carries the global ``tick`` and ``lost``."""

    bands: Tuple[residentops.GridState, ...]

    @property
    def tick(self) -> torch.Tensor:
        return self.bands[0].tick

    @property
    def lost(self) -> torch.Tensor:
        return self.bands[0].lost


def shard_grid_state(gs: residentops.GridState, spec: ResidentShardSpec,
                     mesh: Mesh) -> ShardedGridState:
    """Cut a single-device grid into the spec's row bands (rows padded to
    ``gy_pad`` with empty sentinel rows), band d onto mesh device d."""
    pad = spec.gy_pad - gs.pos_x.shape[0]
    if pad < 0:
        raise ValueError(f"{gs.pos_x.shape[0]} rows exceed the spec's "
                         f"{spec.gy_pad}")

    def padrow(a, fill):
        if pad == 0:
            return a
        p = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                       device=a.device)
        return torch.cat([a, p])

    grids = dict(pos_x=padrow(gs.pos_x, SENTINEL),
                 pos_y=padrow(gs.pos_y, SENTINEL),
                 vel_x=padrow(gs.vel_x, 0.0), vel_y=padrow(gs.vel_y, 0.0),
                 occ_row=padrow(gs.occ_row, 0))
    r = spec.rows_per_dev
    bands = []
    for d, dev in enumerate(mesh.devices):
        band = {n: a[d * r:(d + 1) * r].to(dev).contiguous()
                for n, a in grids.items()}
        bands.append(residentops.GridState(
            **band, tick=gs.tick.to(dev), lost=gs.lost.to(dev)))
    return ShardedGridState(tuple(bands))


def init_sharded_resident(spec: ResidentShardSpec,
                          mesh: Optional[Mesh] = None) -> ShardedGridState:
    """The reference spawn lattice, binned on the first shard's device and
    cut into row bands."""
    mesh = mesh or make_resident_mesh(spec)
    gs = residentops.init_grid_state(spec.settings, mesh.devices[0])
    return shard_grid_state(gs, spec, mesh)


def unshard_grid_state(sgs: ShardedGridState) -> residentops.GridState:
    """The bands joined into one GridState of ``gy_pad`` rows on the first
    band's device."""
    dev = sgs.bands[0].pos_x.device
    join = lambda n: torch.cat([getattr(b, n).to(dev) for b in sgs.bands])
    return residentops.GridState(
        pos_x=join("pos_x"), pos_y=join("pos_y"), vel_x=join("vel_x"),
        vel_y=join("vel_y"), occ_row=join("occ_row"),
        tick=sgs.tick, lost=sgs.lost)


def gather_resident(sgs: ShardedGridState, spec: ResidentShardSpec):
    """(ParticleState, live_count) of a sharded grid (the pad rows are
    empty, so the single-device conversion applies)."""
    return residentops.to_particles(unshard_grid_state(sgs), spec.settings)


# ------------------------------------------------------------------ step

def _merge_row(a4, b4, bcnt: torch.Tensor, k: int):
    """Append the packed boundary row B behind row A, per cell.

    a4/b4: 4 x [K, Gxp] (pos_x, pos_y, vel_x, vel_y), slot-packed with
    sentinel empties; bcnt: i32[Gxp] entries per cell of B. Returns
    (merged4, occ, n_overflow)."""
    acnt = (a4[0] < SENTINEL_HALF).sum(dim=0).to(torch.int32)
    kiota = torch.arange(k, dtype=torch.int32, device=acnt.device)[:, None]
    bidx = torch.clamp(kiota - acnt[None, :], 0, k - 1).to(torch.int64)
    sel = (kiota >= acnt[None, :]) & (kiota - acnt[None, :] < bcnt[None, :])
    out = tuple(torch.where(sel, torch.gather(b, 0, bidx), a)
                for a, b in zip(a4, b4))
    occ = torch.clamp(acnt + bcnt, max=k).max()
    over = torch.clamp(acnt + bcnt - k, min=0).sum().to(torch.int32)
    return out, occ, over


_RESIDENT_KERNELS = (fused.rebin, fused.density, fused.forces_integrate)
_RESIDENT_PLAIN = (fused.rebin_plain, fused.density_plain,
                   fused.forces_integrate_plain)


def make_sharded_resident_step(spec: ResidentShardSpec,
                               mesh: Optional[Mesh] = None,
                               x_boundary: str = "bounce",
                               has_force_field: bool = False,
                               surface_tension: bool = False,
                               adaptive_subsampling: bool = False):
    """Row-band sharded resident step:
    ``step(sgs, params[, forcefield]) -> (sgs, stats)``, with
    ``stats["n_valid"]`` i32[D] the live particles of each shard, on the
    first shard's device. Carries every variant of the single-device
    step (x wrap, obstacle force fields, surface tension, adaptive
    subsampling): the reference's one engine does everything at once
    (compute.wgsl + shaders/compute.wgsl), so the sharded path must too.
    Each band runs the CUDA kernels on a CUDA device and their plain
    versions on the CPU; the far-mover pass runs every step
    (``ops.far_sharded``: gated on the device on a CUDA device, its plain
    version whatever the count on the CPU). On a mesh of one CUDA device
    (``[cuda:0] * D``) each call replays one CUDA graph of the step (the
    JAX package's ``jax.jit(shard_map(step))``; bitwise the eager step of
    ``make_eager_sharded_resident_step``; a failed capture raises); any
    other mesh runs eagerly. ``step.mesh`` is the mesh, ``step.graphed``
    whether calls replay a graph."""
    return _make_sharded_step(
        spec, mesh or make_resident_mesh(spec), x_boundary, has_force_field,
        surface_tension, adaptive_subsampling, _RESIDENT_KERNELS,
        far_kernel=True, graph=True)


def make_eager_sharded_resident_step(spec: ResidentShardSpec,
                                     mesh: Optional[Mesh] = None,
                                     x_boundary: str = "bounce",
                                     has_force_field: bool = False,
                                     surface_tension: bool = False,
                                     adaptive_subsampling: bool = False):
    """``make_sharded_resident_step``'s step run eagerly on any mesh: what
    the graphed step is held to on the card."""
    return _make_sharded_step(
        spec, mesh or make_resident_mesh(spec), x_boundary, has_force_field,
        surface_tension, adaptive_subsampling, _RESIDENT_KERNELS,
        far_kernel=True, graph=False)


def make_plain_sharded_resident_step(spec: ResidentShardSpec,
                                     mesh: Optional[Mesh] = None,
                                     x_boundary: str = "bounce",
                                     has_force_field: bool = False,
                                     surface_tension: bool = False,
                                     adaptive_subsampling: bool = False):
    """The sharded step on the kernels' plain PyTorch versions, on any
    device, eager, its far-mover pass run when the bands' count read on
    the host is not 0: the reference that the CUDA step is held to on the
    card."""
    return _make_sharded_step(
        spec, mesh or make_resident_mesh(spec), x_boundary, has_force_field,
        surface_tension, adaptive_subsampling, _RESIDENT_PLAIN,
        far_kernel=False, graph=False)


def _params_on(params, device):
    if params.device == device:
        return params
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(device)
        for f in dataclasses.fields(params)})


def band_shifts(spec: ResidentShardSpec, mesh: Mesh) -> list:
    """Each band's rebin row shift: band d's padded rows are global rows
    d * rloc - 1 + arange(rloc + 2)."""
    r = spec.rows_per_dev
    return [torch.full((r + 2,), d * r - 1, dtype=torch.int32, device=dev)
            for d, dev in enumerate(mesh.devices)]


def _empty_rows(n, k, gxp, dev):
    pos = torch.full((n, k, gxp), SENTINEL, dtype=torch.float32, device=dev)
    vel = torch.zeros((n, k, gxp), dtype=torch.float32, device=dev)
    return (pos, pos, vel, vel, torch.zeros((n,), dtype=torch.int32,
                                            device=dev))


def rebin_and_merge(mesh: Mesh, bands, dts, shifts, settings: SimSettings,
                    rebin=fused.rebin):
    """Stages 1-2 of the row-band step: each band rebinned over itself plus
    one pad row each side (``rebin`` with the band's row shift), and the
    pad rows' arrivals sent to the neighbours and appended behind their
    edge rows, per cell. Returns (the rebins' outputs, the post-merge
    grids, their occ_row and each band's count lost so far) by band."""
    rloc, k, gxp = bands[0].pos_x.shape
    reb = []
    for d, b in enumerate(bands):
        pad = _empty_rows(1, k, gxp, mesh.devices[d])
        cat = lambda i, a: torch.cat([pad[i], a, pad[i]])
        reb.append(rebin(
            cat(0, b.pos_x), cat(1, b.pos_y), cat(2, b.vel_x),
            cat(3, b.vel_y), cat(4, b.occ_row), dts[d], settings,
            row_shift=shifts[d]))

    def edge(r, row):
        g4 = tuple(a[row] for a in r[:4])
        return g4 + ((g4[0] < SENTINEL_HALF).sum(dim=0).to(torch.int32),)

    from_below = mesh.shift([edge(r, rloc + 1) for r in reb], +1)
    from_above = mesh.shift([edge(r, 0) for r in reb], -1)
    band4, occ_band, n_lost = [], [], []
    for d, r in enumerate(reb):
        g4 = [a[1:rloc + 1] for a in r[:4]]
        occ = r[4][1:rloc + 1]
        over = r[6].sum().to(torch.int32)
        for row, got in ((0, from_below[d]), (rloc - 1, from_above[d])):
            if got is None:
                continue
            m4, occ_m, over_m = _merge_row(
                tuple(a[row] for a in g4), got[:4], got[4], k)
            g4 = [torch.cat([a[:row], m[None], a[row + 1:]])
                  for a, m in zip(g4, m4)]
            occ = torch.cat([occ[:row], occ_m.reshape(1), occ[row + 1:]])
            over = over + over_m
        band4.append(tuple(g4))
        occ_band.append(occ)
        n_lost.append(over)
    return reb, band4, occ_band, n_lost


def _make_sharded_step(spec: ResidentShardSpec, mesh: Mesh, x_boundary: str,
                       has_force_field: bool, surface_tension: bool,
                       adaptive_subsampling: bool, kernels, far_kernel: bool,
                       graph: bool):
    if x_boundary not in ("bounce", "wrap"):
        raise ValueError(f"unknown x_boundary {x_boundary!r}")
    if len(mesh) != spec.n_devices:
        raise ValueError(f"a mesh of {len(mesh)} devices for a spec of "
                         f"{spec.n_devices} shards")
    rebin, density, forces_integrate = kernels
    settings = spec.settings
    n_dev = spec.n_devices
    rloc = spec.rows_per_dev
    k = settings.cell_capacity
    gxp = residentops._gxp(settings)
    fcap = spec.far_capacity
    devices = mesh.devices
    variant = dict(x_boundary=x_boundary, surface_tension=surface_tension,
                   adaptive_subsampling=adaptive_subsampling)
    shifts = band_shifts(spec, mesh)
    packet_shape = (fcap, farops.PACKET_W)
    # each band's field samples, kept while the same field tensor comes
    # back (a field is replaced, never written in place)
    ff_memo = [[None, None] for _ in devices]

    def cells_of(d, forcefield):
        if forcefield is None:
            raise ValueError("step built with has_force_field=True needs a "
                             "forcefield argument")
        memo = ff_memo[d]
        if memo[0] is not forcefield:
            ff = forcefield.to(devices[d])
            memo[:] = [forcefield, residentops.forcefield_cells(
                ff, settings, gxp, row_start=d * rloc - 2,
                n_rows=rloc + 4)]
        return memo[1]

    def far_pass(bands, reb, band4, occ_band, n_lost, prm):
        """Stage 3: far movers, a packet from each band gathered by all,
        gated by the sum of the bands' counts: on the device (the
        kernels' step), or on the host (the plain step)."""
        total = mesh.psum([r[5].sum().to(torch.int32) for r in reb])
        if far_kernel:
            packed = [farops.far_collect(
                b.pos_x, b.pos_y, b.vel_x, b.vel_y, b.occ_row,
                reb[d][5][1:rloc + 1], total[d], prm[d].delta, settings,
                d * rloc, fcap) for d, b in enumerate(bands)]
            allp = mesh.all_gather([p for p, _ in packed], conditional=True)
            for d in range(n_dev):
                band4[d], occ_band[d], n_lost[d] = farops.far_insert(
                    band4[d], occ_band[d], n_lost[d], allp[d], total[d],
                    packed[d][1], prm[d].delta, settings, d * rloc)
        elif int(total[0]) > 0:  # a host read: the plain step
            packed = [farops.far_packet_plain(
                b.pos_x, b.pos_y, b.vel_x, b.vel_y, prm[d].delta, settings,
                d * rloc, fcap) for d, b in enumerate(bands)]
            allp = mesh.all_gather([p for p, _ in packed], conditional=True)
            for d in range(n_dev):
                band4[d], occ_band[d], dropped = farops.insert_far_plain(
                    band4[d], allp[d], prm[d].delta, settings, d * rloc)
                n_lost[d] = n_lost[d] + dropped + packed[d][1]
        else:  # the gated packet still counts in the audit
            mesh.note("all_gather", packet_shape, torch.float32,
                      conditional=True)

    def advance(bands, params, cells):
        mesh.begin_step()
        prm = [_params_on(params, dev) for dev in devices]
        reb, band4, occ_band, n_lost = rebin_and_merge(
            mesh, bands, [p.delta for p in prm], shifts, settings, rebin)
        far_pass(bands, reb, band4, occ_band, n_lost, prm)

        # ---- 4. two-row halo, then physics on band + halo
        below = mesh.shift([tuple(a[rloc - 2:] for a in g4)
                            + (occ[rloc - 2:],)
                            for g4, occ in zip(band4, occ_band)], +1)
        above = mesh.shift([tuple(a[:2] for a in g4) + (occ[:2],)
                            for g4, occ in zip(band4, occ_band)], -1)
        lost = mesh.psum(n_lost)
        out = []
        for d, dev in enumerate(devices):
            lo = below[d] or _empty_rows(2, k, gxp, dev)
            hi = above[d] or _empty_rows(2, k, gxp, dev)
            L = [torch.cat([lo[i], band4[d][i], hi[i]]) for i in range(4)]
            occ_l = torch.cat([lo[4], occ_band[d], hi[4]])
            p = prm[d]
            frame = bands[d].tick + 1
            pres, invr = density(L[0], L[1], L[2], L[3], occ_l, p.mass,
                                 p.delta, p.pressure_constant,
                                 p.rest_density, settings)
            ff_cells = None if cells is None else cells[d]
            npx, npy, nvx, nvy = forces_integrate(
                L[0], L[1], L[2], L[3], pres, invr, occ_l, p, settings,
                frame, ff_cells=ff_cells, **variant)
            out.append(residentops.GridState(
                pos_x=npx[2:rloc + 2], pos_y=npy[2:rloc + 2],
                vel_x=nvx[2:rloc + 2], vel_y=nvy[2:rloc + 2],
                occ_row=occ_band[d], tick=frame,
                lost=bands[d].lost + lost[d]))
        dev0 = devices[0]
        n_valid = torch.stack([(b.pos_x < SENTINEL_HALF).sum()
                               .to(torch.int32).to(dev0) for b in out])
        return tuple(out), n_valid

    graphed = graph and graphs.graphable(*devices)
    runners = graphs.Runners()
    what = f"the row-band sharded step, D={n_dev} [{rloc}, {k}, {gxp}]"

    def run(bands, params, cells):
        if not graphed:
            return advance(bands, params, cells)
        return runners.burst(graphs.signature(params), devices[0], 1,
                             advance, advance, what, bands, params, cells,
                             mesh=mesh)

    def step(sgs: ShardedGridState, params, forcefield=None):
        if len(sgs.bands) != n_dev:
            raise ValueError(f"{len(sgs.bands)} bands for {n_dev} shards")
        for b in sgs.bands:
            if b.pos_x.shape != (rloc, k, gxp):
                raise ValueError(f"band shape {tuple(b.pos_x.shape)} does "
                                 f"not match the spec {(rloc, k, gxp)}")
        cells = (tuple(cells_of(d, forcefield) for d in range(n_dev))
                 if has_force_field else None)
        if graphed:
            params = _params_on(params, devices[0])
        out, n_valid = run(tuple(sgs.bands), params, cells)
        return ShardedGridState(tuple(out)), dict(n_valid=n_valid)

    step.mesh = mesh
    step.graphed = graphed
    return step


# =====================================================================
# Slab sharding of the per-step [N] engines (grid, dense, pallas)
# =====================================================================

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    settings: SimSettings
    n_devices: int
    capacity: int                # per-shard particle slots
    halo_capacity: int           # per-side halo slots
    migration_capacity: int      # per-side migration slots per step
    col_bounds: Tuple[int, ...]  # D+1 cell-x ownership boundaries


def _owners(cx: np.ndarray, col_bounds, n_devices: int) -> np.ndarray:
    """The slab that owns each cell column ``cx``."""
    inner = np.asarray(col_bounds)[1:-1]
    return np.clip(np.searchsorted(inner, cx, side="right"), 0,
                   n_devices - 1)


def _lattice(settings: SimSettings):
    """The reference spawn lattice as numpy: (position, velocity, cell
    column of each particle)."""
    base = init_state(settings, "cpu")
    cx = cell_xy(base.position, settings)[:, 0].numpy()
    return base.position.numpy(), base.velocity.numpy(), cx


def build_shard_spec(settings: SimSettings, n_devices: int,
                     capacity_factor: float = 1.35,
                     halo_capacity: Optional[int] = None,
                     migration_capacity: Optional[int] = None) -> ShardSpec:
    """D slabs of at least 3 interior cell columns each. The capacity is
    sized from the spawn lattice's per-slab counts (a centred block, so
    the slabs start imbalanced), times ``capacity_factor``; the halo holds
    two columns at ~4x rest compression, and the migration buffer as
    much unless given."""
    interior = settings.grid_w - 2
    if interior < 3 * n_devices:
        raise ValueError(
            f"grid too narrow: {interior} interior columns for "
            f"{n_devices} devices (need >= 3 per slab)")
    col_bounds = tuple(1 + (d * interior) // n_devices
                       for d in range(n_devices + 1))
    _, _, cx0 = _lattice(settings)
    counts0 = np.bincount(_owners(cx0, col_bounds, n_devices),
                          minlength=n_devices)
    per_dev = max(int(counts0.max()),
                  -(-settings.particle_count // n_devices))
    cap = _round8(int(np.ceil(per_dev * capacity_factor)))
    if halo_capacity is None:
        per_col = settings.particle_count / interior
        halo_capacity = _round8(max(128, int(per_col * 2 * 4)))
    if migration_capacity is None:
        migration_capacity = halo_capacity
    return ShardSpec(
        settings=settings, n_devices=n_devices, capacity=cap,
        halo_capacity=_round8(halo_capacity),
        migration_capacity=_round8(migration_capacity),
        col_bounds=col_bounds)


def make_mesh(spec: ShardSpec, devices=None) -> Mesh:
    """The slabs' devices, as ``make_resident_mesh`` picks them."""
    return Mesh(_mesh_devices(spec.n_devices, devices))


@dataclasses.dataclass
class Slab:
    """One shard's particles on its device: position and velocity
    f32[C, 2], valid bool[C], and the global tick (i64 0-d)."""

    position: torch.Tensor
    velocity: torch.Tensor
    valid: torch.Tensor
    tick: torch.Tensor


@dataclasses.dataclass
class ShardedState:
    """The particles as D slabs, slab d on mesh device d."""

    slabs: Tuple[Slab, ...]

    @property
    def tick(self) -> torch.Tensor:
        return self.slabs[0].tick


def init_sharded(spec: ShardSpec, mesh: Optional[Mesh] = None
                 ) -> ShardedState:
    """The reference spawn lattice distributed into slabs by cell column
    (in lattice order), each padded to the spec's capacity."""
    pos, vel, cx = _lattice(spec.settings)
    owner = _owners(cx, spec.col_bounds, spec.n_devices)
    c = spec.capacity
    parts, dropped = [], 0
    for d in range(spec.n_devices):
        sel = np.nonzero(owner == d)[0]
        if len(sel) > c:
            dropped += len(sel) - c
            sel = sel[:c]
        p = np.zeros((c, 2), np.float32)
        v = np.zeros((c, 2), np.float32)
        ok = np.zeros((c,), bool)
        p[:len(sel)], v[:len(sel)], ok[:len(sel)] = pos[sel], vel[sel], True
        parts.append((p, v, ok))
    if dropped:
        raise ValueError(f"init overflow: {dropped} particles exceed "
                         f"capacity {c}; raise capacity_factor")
    mesh = mesh or make_mesh(spec)
    return ShardedState(tuple(
        Slab(position=torch.from_numpy(p).to(dev),
             velocity=torch.from_numpy(v).to(dev),
             valid=torch.from_numpy(ok).to(dev),
             tick=torch.zeros((), dtype=torch.int64, device=dev))
        for (p, v, ok), dev in zip(parts, mesh.devices)))


def gather_state(state: ShardedState) -> ParticleState:
    """The valid particles, in shard order, as a ParticleState on the
    first shard's device (predicted = position; density and cell zeroed:
    the next step refreshes them)."""
    dev = state.slabs[0].position.device
    pos = torch.cat([s.position[s.valid].to(dev) for s in state.slabs])
    vel = torch.cat([s.velocity[s.valid].to(dev) for s in state.slabs])
    n = pos.shape[0]
    return ParticleState(
        position=pos, predicted=pos.clone(), velocity=vel,
        density=torch.zeros((n,), dtype=torch.float32, device=dev),
        cell=torch.zeros((n,), dtype=torch.int32, device=dev),
        tick=state.tick.to(dev))


def make_sharded_step(spec: ShardSpec, mesh: Optional[Mesh] = None,
                      has_force_field: bool = False, debug: bool = False,
                      neighbor_mode: str = "grid"):
    """The slab-sharded step:
    ``step(state, params[, forcefield]) -> (state, stats)``, stats a dict
    of i32[D] per-shard counters on the first shard's device
    (``n_valid``, ``halo_dropped``, ``migration_dropped``; with ``debug``
    also the sorted combined set's ``dbg_pred``, ``dbg_dens``,
    ``dbg_local``, ``dbg_cells``, ``dbg_fp``, ``dbg_fv``, [D, T, ...]).
    ``neighbor_mode``: "grid" (windowed pair math), "dense" (the
    slab-local slot grid through ``ops.dense``' roll passes: their CUDA
    kernels on a CUDA device) or "pallas" (the same grid through
    ``ops.sph``: the CUDA kernels on a CUDA device, their plain versions
    on the CPU). On a mesh of one CUDA device each call replays
    one CUDA graph of the step, bitwise the eager step of
    ``make_eager_sharded_step``; any other mesh runs eagerly.
    ``step.mesh`` is the mesh, ``step.graphed`` whether calls replay a
    graph."""
    return _make_slab_step(spec, mesh or make_mesh(spec), has_force_field,
                           debug, neighbor_mode, None, graph=True)


def make_eager_sharded_step(spec: ShardSpec, mesh: Optional[Mesh] = None,
                            has_force_field: bool = False,
                            debug: bool = False, neighbor_mode: str = "grid"):
    """``make_sharded_step``'s step run eagerly on any mesh: what the
    graphed step is held to on the card."""
    return _make_slab_step(spec, mesh or make_mesh(spec), has_force_field,
                           debug, neighbor_mode, None, graph=False)


def make_plain_sharded_step(spec: ShardSpec, mesh: Optional[Mesh] = None,
                            has_force_field: bool = False,
                            debug: bool = False):
    """The pallas-mode sharded step on the plain PyTorch versions of its
    two kernels (``sph.density_plain``, ``sph.forces_plain``), on any
    device, eager: the reference that the CUDA step is held to on the
    card."""
    return _make_slab_step(spec, mesh or make_mesh(spec), has_force_field,
                           debug, "pallas",
                           (sph.density_plain, sph.forces_plain),
                           graph=False)


def _make_slab_step(spec: ShardSpec, mesh: Mesh, has_force_field: bool,
                    debug: bool, neighbor_mode: str, passes, graph: bool):
    if neighbor_mode not in ("grid", "dense", "pallas"):
        raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}")
    if len(mesh) != spec.n_devices:
        raise ValueError(f"a mesh of {len(mesh)} devices for a spec of "
                         f"{spec.n_devices} shards")
    settings = spec.settings
    n_dev = spec.n_devices
    bounds = spec.col_bounds
    # the slab-local grid: the widest slab + 2 halo columns each side
    w_loc = max(b - a for a, b in zip(bounds[:-1], bounds[1:])) + 4
    c, hcap, mcap = spec.capacity, spec.halo_capacity, spec.migration_capacity
    g = settings.num_cells
    grid_w = settings.grid_w
    norms = settings.kernel_norms()
    h = float(settings.smoothing_radius)
    devices = mesh.devices
    # per-device constants, made once: a host-to-device copy waits
    inner = [torch.tensor(bounds[1:-1], dtype=torch.int32, device=dev)
             for dev in devices]
    all_cells = [torch.arange(g + 1, dtype=torch.int32, device=dev)
                 for dev in devices]
    slots = [torch.arange(mcap, dtype=torch.int32, device=dev)
             for dev in devices]
    # each slab's copy of the field, kept while the same field comes back
    ff_memo = [[None, None] for _ in devices]

    def field_on(d, forcefield):
        if forcefield is None:
            return None
        memo = ff_memo[d]
        if memo[0] is not forcefield:
            memo[:] = [forcefield, forcefield.to(devices[d])]
        return memo[1]

    def received(got, sent):
        """What arrived, or zeros (valid False) where no shard sends, as
        JAX's ppermute gives."""
        return got if got is not None else tuple(torch.zeros_like(t)
                                                 for t in sent)

    def physics(d, slab, p, pred, rl, rr, frame, ff):
        """The step's physics on the combined set (local + both halos),
        sorted by cell. Returns (new_pos, new_vel, local, debug dict)."""
        dev = pred.device
        pred_c = torch.cat([pred, rl[0], rr[0]])
        vel_c = torch.cat([slab.velocity, rl[1], rr[1]])
        pos_c = torch.cat([slab.position, torch.zeros_like(rl[0]),
                           torch.zeros_like(rr[0])])
        halo_valid = torch.cat([slab.valid, rl[2], rr[2]])
        is_local = torch.cat([slab.valid, torch.zeros(
            (2 * hcap,), dtype=torch.bool, device=dev)])
        cells_c = torch.where(halo_valid, cell_id(pred_c, settings), g)
        t = pred_c.shape[0]
        if neighbor_mode != "grid":
            # slab-local columns [0, w_loc): every shard's grid has the
            # same shape, and the local ids keep the global row-major order
            lcx = cells_c % grid_w - (bounds[d] - 2)
            ok = halo_valid & (lcx >= 0) & (lcx < w_loc) & (cells_c < g)
            local_cells = torch.where(ok, cells_c // grid_w * w_loc + lcx,
                                      settings.grid_h * w_loc)
            sorted_cells, perm = torch.sort(local_cells, stable=True)
            pred_s, vel_s, pos_s = pred_c[perm], vel_c[perm], pos_c[perm]
            dens, f_p, f_v, _ = denseops.dense_neighbor_forces(
                pred_s, vel_s, sorted_cells, settings, p, norms, frame,
                pallas=neighbor_mode == "pallas",
                dims=(settings.grid_h, w_loc), passes=passes)
        else:
            sorted_cells, perm = torch.sort(cells_c, stable=True)
            cell_start = torch.searchsorted(sorted_cells, all_cells[d],
                                            side="left").to(torch.int32)
            pred_s, vel_s, pos_s = pred_c[perm], vel_c[perm], pos_c[perm]
            win = point_windows(torch.clamp(sorted_cells, max=g - 1),
                                cell_start, settings)
            nb_idx = win.idx.reshape(t, -1)
            nb_valid = win.valid.reshape(t, -1)
            nb_pred = pred_s[nb_idx]
            dens = pairs.density(pred_s, nb_pred, nb_valid, p.mass, h)
            dens = torch.clamp(torch.clamp(dens, min=EPSILON), min=0.1)
            nb_dens = dens[nb_idx]
            sorted_idx = torch.arange(t, device=dev)
            rand_seed = (prng.position_seed(pred_s) + frame * 69) & prng.U32
            f_p = pairs.pressure_force(
                sorted_idx, pred_s, dens, nb_idx, nb_pred, nb_dens, nb_valid,
                p.pressure_constant, p.rest_density, h, settings.sqr_radius,
                norms.spiky_derivative, rand_seed)
            f_v = pairs.viscosity_force(
                sorted_idx, pred_s, vel_s, nb_idx, nb_pred, vel_s[nb_idx],
                nb_dens, nb_valid, p.viscosity_coefficient, h,
                settings.sqr_radius, norms.viscosity)
        local_s = is_local[perm]
        new_pos, new_vel = _integrate(pos_s, vel_s, pred_s, dens, f_p + f_v,
                                      p, settings, ff)
        dbg = dict(dbg_pred=pred_s, dbg_dens=dens, dbg_local=local_s,
                   dbg_cells=sorted_cells, dbg_fp=f_p, dbg_fv=f_v)
        return new_pos, new_vel, local_s, dbg

    def placed(base, la_tgt, la_vals, ra_tgt, ra_vals):
        """``base`` with the arrivals written at their targets; a target
        of ``c`` (no room, or no arrival) lands in a spare slot that is
        cut off."""
        buf = torch.cat([base, base[:1]])
        buf.index_put_((la_tgt,), la_vals)
        buf.index_put_((ra_tgt,), ra_vals)
        return buf[:c]

    def advance(slabs, params, forcefield):
        mesh.begin_step()
        prm = [_params_on(params, dev) for dev in devices]

        # ---- predict, cells (g for invalid slots), the two-column halos
        pre = []
        for d, s in enumerate(slabs):
            pred = predict_positions(s.position, s.velocity, prm[d].delta,
                                     settings)
            cx = torch.where(s.valid, cell_id(pred, settings), g) % grid_w
            hr, hr_valid, hr_drop = _pack(s.valid & (cx >= bounds[d + 1] - 2),
                                          (pred, s.velocity), hcap)
            hl, hl_valid, hl_drop = _pack(s.valid & (cx < bounds[d] + 2),
                                          (pred, s.velocity), hcap)
            pre.append((pred, hr + (hr_valid,), hl + (hl_valid,),
                        hr_drop + hl_drop))
        # my right halo arrives at d + 1 as its left one, and vice versa
        from_left = mesh.shift([x[1] for x in pre], +1)
        from_right = mesh.shift([x[2] for x in pre], -1)

        # ---- physics on local + halo, then the migration packs
        mid = []
        for d, s in enumerate(slabs):
            pred, hr, hl, halo_drop = pre[d]
            frame = s.tick + 1
            new_pos, new_vel, local_s, dbg = physics(
                d, s, prm[d], pred, received(from_left[d], hr),
                received(from_right[d], hl), frame, field_on(d, forcefield))
            ncx = cell_xy(new_pos, settings)[..., 0].contiguous()
            dest = torch.clamp(torch.searchsorted(inner[d], ncx, right=True),
                               0, n_dev - 1)
            route = torch.clamp(dest - d, -1, 1)
            ml, ml_valid, ml_drop = _pack(local_s & (route == -1),
                                          (new_pos, new_vel), mcap)
            mr, mr_valid, mr_drop = _pack(local_s & (route == 1),
                                          (new_pos, new_vel), mcap)
            keep = local_s & (route == 0)
            mid.append((new_pos, new_vel, keep, ml + (ml_valid,),
                        mr + (mr_valid,), ml_drop + mr_drop, halo_drop,
                        frame, dbg))
        arrive_left = mesh.shift([x[4] for x in mid], +1)
        arrive_right = mesh.shift([x[3] for x in mid], -1)

        # ---- merge: the kept particles first, then the arrivals from the
        # left, then those from the right
        slabs, stats = [], []
        for d, (new_pos, new_vel, keep, ml, mr, m_drop, halo_drop, frame,
                dbg) in enumerate(mid):
            al_pos, al_vel, al_valid = received(arrive_left[d], mr)
            ar_pos, ar_vel, ar_valid = received(arrive_right[d], ml)
            (k_pos, k_vel), k_valid, _ = _pack(keep, (new_pos, new_vel), c)
            n_keep = keep.sum(dtype=torch.int32)
            n_al = al_valid.sum(dtype=torch.int32)
            n_ar = ar_valid.sum(dtype=torch.int32)
            la_idx = n_keep + slots[d]
            ra_idx = n_keep + n_al + slots[d]
            la_ok = al_valid & (la_idx < c)
            ra_ok = ar_valid & (ra_idx < c)
            la_tgt = torch.where(la_ok, la_idx, c).to(torch.int64)
            ra_tgt = torch.where(ra_ok, ra_idx, c).to(torch.int64)
            arrival_drop = (n_al - la_ok.sum(dtype=torch.int32)
                            + n_ar - ra_ok.sum(dtype=torch.int32))
            out_valid = placed(k_valid, la_tgt, torch.ones_like(al_valid),
                               ra_tgt, torch.ones_like(ar_valid))
            out_pos = torch.where(out_valid[:, None], placed(
                k_pos, la_tgt, al_pos, ra_tgt, ar_pos), 0.0)
            out_vel = torch.where(out_valid[:, None], placed(
                k_vel, la_tgt, al_vel, ra_tgt, ar_vel), 0.0)
            slabs.append(Slab(position=out_pos, velocity=out_vel,
                              valid=out_valid, tick=frame))
            st = dict(n_valid=out_valid.sum(dtype=torch.int32),
                      halo_dropped=halo_drop.to(torch.int32),
                      migration_dropped=(m_drop + arrival_drop)
                      .to(torch.int32))
            if debug:
                st.update(dbg)
            stats.append(st)
        dev0 = devices[0]
        out = {k: torch.stack([st[k].to(dev0, non_blocking=True)
                               for st in stats]) for k in stats[0]}
        return tuple(slabs), out

    graphed = graph and graphs.graphable(*devices)
    runners = graphs.Runners()
    what = (f"the slab-sharded step, D={n_dev}, {neighbor_mode}"
            f"{'' if passes is None else ' (plain passes)'}")

    def run(slabs, params, forcefield):
        if not graphed:
            return advance(slabs, params, forcefield)
        key = (graphs.signature(params),
               None if forcefield is None
               else (tuple(forcefield.shape), forcefield.dtype))
        return runners.burst(key, devices[0], 1, advance, advance, what,
                             slabs, params, forcefield, mesh=mesh)

    def step(state: ShardedState, params, forcefield=None):
        if len(state.slabs) != n_dev:
            raise ValueError(f"{len(state.slabs)} slabs for {n_dev} shards")
        for s in state.slabs:
            if s.position.shape != (c, 2):
                raise ValueError(f"slab shape {tuple(s.position.shape)} "
                                 f"does not match the spec's {(c, 2)}")
        if not has_force_field:
            forcefield = None  # ignored, as the eager step ignores it
        elif forcefield is None:
            raise ValueError("step built with has_force_field=True needs a "
                             "forcefield argument")
        elif graphed:
            forcefield = forcefield.to(devices[0])
        if graphed:
            params = _params_on(params, devices[0])
        slabs, out = run(tuple(state.slabs), params, forcefield)
        return ShardedState(tuple(slabs)), out

    step.mesh = mesh
    step.graphed = graphed
    return step
