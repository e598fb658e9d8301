"""Row-band sharding of the resident engine (port of the resident half of
``tpufluid.parallel.shard``).

The slot grid ``[Gy, K, Gxp]`` is cut into D bands of ``rows_per_dev``
rows (the rows padded to a multiple of D with empty sentinel rows), one
per shard. Each step runs the single-device step's kernels on every band
and exchanges only what crosses a band edge:

  1. rebin over the band plus one pad row each side (``fused.rebin`` with
     ``row_shift`` = the band's first global row less one);
  2. the pad rows' arrivals go to the neighbours and are appended behind
     the slots of their edge rows, per cell; arrivals past K are counted;
  3. far movers (more than one cell in a step): a packet of
     ``far_capacity`` rows from each shard, gathered by all; each shard
     inserts the rows whose target cell it owns, stable by target cell,
     after its slots, and counts the drops. The gate is the sum of the
     shards' far counts, read on the host once a step, as the
     single-device step reads its own;
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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import fused
from ..ops import resident as residentops
from ..ops.dense import ranks
from ..ops.fused import SENTINEL, SENTINEL_HALF
from ..params import SimSettings
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
        self._rec = rec = _Recording()
        try:
            yield rec
        finally:
            self._rec = None

    def begin_step(self) -> None:
        if self._rec is not None:
            self._rec.steps += 1

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


def make_resident_mesh(spec: ResidentShardSpec, devices=None) -> Mesh:
    """The shards' devices: ``devices`` (D of them, repeats allowed), or
    one CUDA device a shard, ``[cuda:0] * D`` when there are fewer than
    D. Pass ``[torch.device("cpu")] * D`` to run on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[torch.device('cpu')] * D "
                "to shard on the CPU")
        d = spec.n_devices
        if torch.cuda.device_count() >= d:
            devices = [torch.device("cuda", i) for i in range(d)]
        else:
            devices = [torch.device("cuda", 0)] * d
    if len(devices) != spec.n_devices:
        raise ValueError(f"{len(devices)} devices for a spec of "
                         f"{spec.n_devices} shards")
    return Mesh(devices)


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
    versions on the CPU. ``step.mesh`` is the mesh."""
    return _make_sharded_step(
        spec, mesh or make_resident_mesh(spec), x_boundary, has_force_field,
        surface_tension, adaptive_subsampling, fused.rebin, fused.density,
        fused.forces_integrate)


def make_plain_sharded_resident_step(spec: ResidentShardSpec,
                                     mesh: Optional[Mesh] = None,
                                     x_boundary: str = "bounce",
                                     has_force_field: bool = False,
                                     surface_tension: bool = False,
                                     adaptive_subsampling: bool = False):
    """The sharded step on the kernels' plain PyTorch versions, on any
    device: the reference that the CUDA step is held to on the card."""
    return _make_sharded_step(
        spec, mesh or make_resident_mesh(spec), x_boundary, has_force_field,
        surface_tension, adaptive_subsampling, fused.rebin_plain,
        fused.density_plain, fused.forces_integrate_plain)


def _params_on(params, device):
    if params.device == device:
        return params
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(device)
        for f in dataclasses.fields(params)})


def _make_sharded_step(spec: ResidentShardSpec, mesh: Mesh, x_boundary: str,
                       has_force_field: bool, surface_tension: bool,
                       adaptive_subsampling: bool, rebin, density,
                       forces_integrate):
    if x_boundary not in ("bounce", "wrap"):
        raise ValueError(f"unknown x_boundary {x_boundary!r}")
    if len(mesh) != spec.n_devices:
        raise ValueError(f"a mesh of {len(mesh)} devices for a spec of "
                         f"{spec.n_devices} shards")
    settings = spec.settings
    n_dev = spec.n_devices
    rloc = spec.rows_per_dev
    k = settings.cell_capacity
    gxp = residentops._gxp(settings)
    grid_w = settings.grid_w
    fcap = spec.far_capacity
    devices = mesh.devices
    variant = dict(x_boundary=x_boundary, surface_tension=surface_tension,
                   adaptive_subsampling=adaptive_subsampling)
    # band d's padded rows are global rows d * rloc - 1 + arange(rloc + 2)
    shifts = [torch.full((rloc + 2,), d * rloc - 1, dtype=torch.int32,
                         device=dev) for d, dev in enumerate(devices)]
    packet_shape = (fcap, 5)
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

    def empty_rows(n, dev):
        pos = torch.full((n, k, gxp), SENTINEL, dtype=torch.float32,
                         device=dev)
        vel = torch.zeros((n, k, gxp), dtype=torch.float32, device=dev)
        return (pos, pos, vel, vel, torch.zeros((n,), dtype=torch.int32,
                                                device=dev))

    def far_packet(b, dt, d):
        """Band b's far movers (pre-rebin) packed into ``fcap`` rows of
        (pos_x, pos_y, vel_x, vel_y, valid), and the count left out."""
        dev = b.pos_x.device
        ncx, ncy = fused._cells(b.pos_x, b.pos_y, b.vel_x, b.vel_y, dt,
                                settings)
        scx = torch.arange(gxp, device=dev)[None, None, :]
        scy = torch.arange(rloc, device=dev)[:, None, None] + d * rloc
        far = (b.pos_x < SENTINEL_HALF) & (
            ((ncy - scy).abs() > 1) | ((ncx - scx).abs() > 1))
        fields = torch.stack([b.pos_x.reshape(-1), b.pos_y.reshape(-1),
                              b.vel_x.reshape(-1), b.vel_y.reshape(-1)],
                             dim=1)
        (pk,), valid, dropped = _pack(far.reshape(-1), (fields,), fcap)
        packet = torch.cat([pk, valid[:, None].to(torch.float32)], dim=1)
        return packet, dropped

    def insert_far(g4, allp, dt, d):
        """Insert the gathered rows whose target cell band d owns, stable
        by target cell, after each cell's slots. Returns the grids,
        occ_row and the count that found no room."""
        row_off = d * rloc
        flag = allp[:, 4] > 0.5
        gcx, gcy = fused._cells(allp[:, 0], allp[:, 1], allp[:, 2],
                                allp[:, 3], dt, settings)
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

    def step(sgs: ShardedGridState, params, forcefield=None):
        if len(sgs.bands) != n_dev:
            raise ValueError(f"{len(sgs.bands)} bands for {n_dev} shards")
        for b in sgs.bands:
            if b.pos_x.shape != (rloc, k, gxp):
                raise ValueError(f"band shape {tuple(b.pos_x.shape)} does "
                                 f"not match the spec {(rloc, k, gxp)}")
        mesh.begin_step()
        bands = sgs.bands
        prm = [_params_on(params, dev) for dev in devices]

        # ---- 1. rebin over the band + 1 pad row per side
        reb = []
        for d, b in enumerate(bands):
            pad = empty_rows(1, devices[d])
            cat = lambda i, a: torch.cat([pad[i], a, pad[i]])
            reb.append(rebin(
                cat(0, b.pos_x), cat(1, b.pos_y), cat(2, b.vel_x),
                cat(3, b.vel_y), cat(4, b.occ_row), prm[d].delta, settings,
                row_shift=shifts[d]))

        # ---- 2. boundary-row arrivals to the neighbours, merged behind
        # the edge rows
        def edge(r, row):
            g4 = tuple(a[row] for a in r[:4])
            return g4 + ((g4[0] < SENTINEL_HALF).sum(dim=0)
                         .to(torch.int32),)

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

        # ---- 3. far movers: packets gathered by all, gated by their sum
        total_far = mesh.psum([r[5].sum().to(torch.int32) for r in reb])
        if int(total_far[0]) > 0:  # the step's one host sync
            packed = [far_packet(b, prm[d].delta, d)
                      for d, b in enumerate(bands)]
            allp = mesh.all_gather([p for p, _ in packed], conditional=True)
            for d in range(n_dev):
                band4[d], occ_band[d], dropped = insert_far(
                    band4[d], allp[d], prm[d].delta, d)
                n_lost[d] = n_lost[d] + dropped + packed[d][1]
        else:  # the gated packet still counts in the audit
            mesh.note("all_gather", packet_shape, torch.float32,
                      conditional=True)

        # ---- 4. two-row halo, then physics on band + halo
        below = mesh.shift([tuple(a[rloc - 2:] for a in g4)
                            + (occ[rloc - 2:],)
                            for g4, occ in zip(band4, occ_band)], +1)
        above = mesh.shift([tuple(a[:2] for a in g4) + (occ[:2],)
                            for g4, occ in zip(band4, occ_band)], -1)
        lost = mesh.psum(n_lost)
        out = []
        for d, dev in enumerate(devices):
            lo = below[d] or empty_rows(2, dev)
            hi = above[d] or empty_rows(2, dev)
            L = [torch.cat([lo[i], band4[d][i], hi[i]]) for i in range(4)]
            occ_l = torch.cat([lo[4], occ_band[d], hi[4]])
            p = prm[d]
            frame = bands[d].tick + 1
            pres, invr = density(L[0], L[1], L[2], L[3], occ_l, p.mass,
                                 p.delta, p.pressure_constant,
                                 p.rest_density, settings)
            ff_cells = cells_of(d, forcefield) if has_force_field else None
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
        return ShardedGridState(tuple(out)), dict(n_valid=n_valid)

    step.mesh = mesh
    return step
