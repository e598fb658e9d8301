"""Grid-resident engine: particles live in the cell grid between steps
(port of ``tpufluid.ops.resident``: every variant flag, obstacles and
batched world stacks).

The state IS the slot grid ``[Gy, K, Gxp]`` (rows padded to a multiple of
4, columns to a multiple of 128, K above 8 to a multiple of 8: the JAX
shapes, so the two engines' states compare one to one). One step:

  1. rebin: slots move to their next predicted cell (``fused.rebin``);
  2. far movers (> 1 cell in one step, or across the x wall under
     ``x_boundary="wrap"``) re-insert (``far_reinsert``): on a CUDA device
     ``csrc/far_reinsert.cu``, launched every step and gated on the
     device by the rebin's count, as the JAX step's ``lax.cond``; on the
     CPU its plain version, run when the count read on the host is not 0;
  3. physics: density -> (pressure, 1/rho) (``fused.density``), then the
     forces fused with the integration (``fused.forces_integrate``), with
     the per-cell obstacle push-out when the step is built with
     ``has_force_field=True``; or both in one kernel (``fused.physics``,
     bitwise the same) under ``TPUFLUID_FUSED_PHYSICS=1``.

Batched worlds (``n_worlds=B``): B worlds of the same settings stack along
the row axis, each world's rows ending in its empty sentinel ring, so one
set of kernel launches steps them all; ``row_shift`` and ``wid`` map each
row to its world, and the per-tick tunables carry a leading [B] dim
(``delta`` is shared). BASELINE config 4 runs eight 128k worlds so.

Arrivals beyond ``cell_capacity`` and far movers beyond ``far_capacity``
are dropped and counted in ``GridState.lost``, never silently.

Host syncs: none on a CUDA device, so a burst of steps is captured as one
CUDA graph and replayed (``make_grid_multi_step``, the JAX package's
``jax.jit(lax.scan(step))``); on the CPU one per step, the far-mover
count's, and a burst is a Python loop.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from .. import _build, graphs
from .._build import launched, on_cuda, ptr, stream
from ..params import SimSettings
from ..state import ParticleState, init_state
from . import grid as gridops
from .dense import build_grid_cols, ranks
from . import fused
from .fused import SENTINEL, SENTINEL_HALF

# grid rows are padded to a multiple of this (the JAX engine's
# ROWS_PER_PROGRAM); pad rows stay empty
ROW_PAD = 4


@dataclasses.dataclass
class GridState:
    """pos/vel slot grids f32[Gy, K, Gxp] (empty slots at pos=SENTINEL),
    per-row packed occupancy i32[Gy], tick (i64 0-d) and the cumulative
    lost counter (i32 0-d)."""

    pos_x: torch.Tensor
    pos_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor
    occ_row: torch.Tensor
    tick: torch.Tensor
    lost: torch.Tensor


def _gxp(settings: SimSettings) -> int:
    return -(-settings.grid_w // 128) * 128


def _rows(settings: SimSettings) -> int:
    return -(-settings.grid_h // ROW_PAD) * ROW_PAD


def pad_capacity(settings: SimSettings) -> SimSettings:
    """Round cell_capacity > 8 up to a multiple of 8 (as the JAX engine
    does; extra capacity never loses mass)."""
    k = settings.cell_capacity
    if k <= 8 or k % 8 == 0:
        return settings
    return dataclasses.replace(settings, cell_capacity=-(-k // 8) * 8)


def valid_mask(gs: GridState) -> torch.Tensor:
    """bool[Gy, K, Gxp]: which slots hold a live particle."""
    return gs.pos_x < SENTINEL_HALF


def occ_row_of(pos_x: torch.Tensor) -> torch.Tensor:
    """Per-row max packed occupancy, recomputed from a sentinel grid."""
    occ_cell = (pos_x < SENTINEL_HALF).sum(dim=1)
    return occ_cell.amax(dim=1).to(torch.int32)


def from_particles(state: ParticleState, settings: SimSettings) -> GridState:
    """Bin a ParticleState into the resident grid on the state's device."""
    settings = pad_capacity(settings)
    cells = gridops.cell_id(state.predicted, settings)
    binning = gridops.bin_particles(cells, settings)
    g4 = torch.cat([state.position, state.velocity], dim=1)[binning.perm]
    grid = build_grid_cols(
        g4[:, 0], g4[:, 1], g4[:, 2], g4[:, 3], binning.sorted_cells,
        settings, dims=(_rows(settings), settings.grid_w))
    px = torch.where(grid.valid, grid.px, SENTINEL)
    py = torch.where(grid.valid, grid.py, SENTINEL)
    return GridState(
        pos_x=px, pos_y=py, vel_x=grid.vx, vel_y=grid.vy,
        occ_row=occ_row_of(px),
        tick=state.tick.to(torch.int64), lost=grid.n_dropped,
    )


def init_grid_state(settings: SimSettings, device) -> GridState:
    return from_particles(init_state(settings, device), settings)


def grow_capacity(gs: GridState, new_k: int) -> GridState:
    """Widen the slot axis to ``new_k`` by appending empty slots; packing
    and the trajectory are unchanged."""
    gy, k, gxp = gs.pos_x.shape
    if new_k % 8 != 0:
        raise ValueError(f"new_k {new_k} must be a multiple of 8")
    if new_k <= k:
        return gs
    pad = (0, 0, 0, new_k - k)
    F = torch.nn.functional
    return dataclasses.replace(
        gs, pos_x=F.pad(gs.pos_x, pad, value=SENTINEL),
        pos_y=F.pad(gs.pos_y, pad, value=SENTINEL),
        vel_x=F.pad(gs.vel_x, pad), vel_y=F.pad(gs.vel_y, pad))


def shrink_capacity(gs: GridState, new_k: int) -> GridState:
    """Narrow the slot axis to ``new_k``; exact only when every row's
    occupancy is <= ``new_k`` (the caller checks)."""
    gy, k, gxp = gs.pos_x.shape
    if new_k % 8 != 0:
        raise ValueError(f"new_k {new_k} must be a multiple of 8")
    if new_k >= k:
        return gs
    sl = lambda a: a[:, :new_k, :].contiguous()
    return dataclasses.replace(
        gs, pos_x=sl(gs.pos_x), pos_y=sl(gs.pos_y),
        vel_x=sl(gs.vel_x), vel_y=sl(gs.vel_y))


def to_particles(gs: GridState,
                 settings: SimSettings) -> Tuple[ParticleState, torch.Tensor]:
    """(ParticleState, live_count): live slots in cell order, then zeros;
    arrays sized to settings.particle_count."""
    n = settings.particle_count
    gy, k, gxp = gs.pos_x.shape
    size = gy * k * gxp
    dev = gs.pos_x.device
    slot = torch.arange(size, dtype=torch.int64, device=dev)
    cell = (slot // (k * gxp)) * settings.grid_w + slot % gxp
    valid = valid_mask(gs).reshape(-1)
    key = torch.where(valid, cell, settings.num_cells + 1)
    _, perm = torch.sort(key, stable=True)
    sel = perm[:n]
    live = valid.sum().to(torch.int32)
    ok = torch.arange(n, device=dev) < live
    fields = torch.stack(
        [gs.pos_x.reshape(-1), gs.pos_y.reshape(-1),
         gs.vel_x.reshape(-1), gs.vel_y.reshape(-1)], dim=1)[sel]
    fields = torch.where(ok[:, None], fields, 0.0)
    cells_out = torch.where(ok, key[sel], 0).to(torch.int32)
    pos = fields[:, 0:2]
    return ParticleState(
        position=pos, predicted=pos.clone(), velocity=fields[:, 2:4],
        density=torch.zeros((n,), dtype=torch.float32, device=dev),
        cell=cells_out, tick=gs.tick.clone(),
    ), live


def far_movers(gs: GridState, dt, settings: SimSettings):
    """(far, ncx, ncy): which slots of ``gs`` hold a far mover (a live
    slot whose predicted cell lies beyond the 3 x 3 cells around its own),
    and each slot's predicted cell, its row in the stacked frame of a
    batched stack."""
    gy, k, gxp = gs.pos_x.shape
    dev = gs.pos_x.device
    ncx, ncy = fused._cells(gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, dt,
                            settings)
    scx = torch.arange(gxp, device=dev)[None, None, :]
    scy = torch.arange(gy, device=dev)[:, None, None]
    rows_w = _rows(settings)
    if gy > rows_w:  # world-local cell row -> absolute stacked row
        ncy = ncy + (scy // rows_w) * rows_w
    far = (gs.pos_x < SENTINEL_HALF) & (
        ((ncy - scy).abs() > 1) | ((ncx - scx).abs() > 1))
    return far, ncx, ncy


def _reinsert_far(gs: GridState, px, py, vx, vy, n_far, dt,
                  settings: SimSettings, far_capacity: int):
    """Far-mover fallback (``tpufluid.ops.resident`` ``do_far``), the plain
    version of :func:`far_reinsert`: take the far movers of the pre-rebin
    grid in slot order (at most ``far_capacity``), order them by target
    cell, and append each to its target cell after the slots the rebin
    filled. Returns the new grids, occ_row and the count dropped for want
    of room; with ``n_far == 0`` the rebin's grids and occ_row, unchanged.
    In a batched stack a world's cell rows map to its own stacked rows."""
    gy, k, gxp = px.shape
    size = px.numel()
    dev = px.device
    grid_w = settings.grid_w
    far, ncx, ncy = far_movers(gs, dt, settings)
    sort_key = torch.where(far.reshape(-1), 0, 1)
    _, perm = torch.sort(sort_key, stable=True)
    sel = perm[:far_capacity]
    ok = torch.arange(sel.shape[0], device=dev) < n_far
    rows = torch.stack(
        [gs.pos_x.reshape(-1), gs.pos_y.reshape(-1),
         gs.vel_x.reshape(-1), gs.vel_y.reshape(-1)], dim=1)[sel]
    tcx = ncx.reshape(-1)[sel]
    tcy = ncy.reshape(-1)[sel]
    tcell = torch.where(ok, tcy * grid_w + tcx, 2**30)
    tcell_s, perm2 = torch.sort(tcell, stable=True)
    rows = rows[perm2]
    ok = ok[perm2]
    rank = ranks(tcell_s)
    occ_cell = (px < SENTINEL_HALF).sum(dim=1)  # [Gy, Gxp]
    cy2 = torch.clamp(tcell_s // grid_w, 0, gy - 1)
    cx2 = torch.clamp(tcell_s % grid_w, 0, gxp - 1)
    slot = occ_cell.reshape(-1)[cy2 * gxp + cx2] + rank
    fits = ok & (slot < k)
    flat = torch.where(fits, (cy2 * k + slot) * gxp + cx2, size)
    px, py, vx, vy = (put_flat(g, flat, rows[:, f])
                      for f, g in enumerate((px, py, vx, vy)))
    dropped = (n_far - fits.sum()).to(torch.int32)
    return px, py, vx, vy, occ_row_of(px), dropped


def put_flat(grid: torch.Tensor, flat: torch.Tensor, vals: torch.Tensor):
    """``grid`` with ``vals`` written at the flat slot indices ``flat``;
    an index equal to ``grid.numel()`` drops its value (the indices below
    it are distinct)."""
    size = grid.numel()
    buf = torch.cat([grid.reshape(-1), grid.new_zeros(1)])
    buf.index_put_((flat,), vals)
    return buf[:size].reshape(grid.shape)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def far_reinsert(gs: GridState, px, py, vx, vy, occ_row, far_n, lost, dt,
                 settings: SimSettings, far_capacity: int, far_steps=None):
    """The far movers of ``gs`` put back into the rebin's outputs.

    ``px .. occ_row``, ``far_n``: the rebin's outputs on ``gs``; ``lost``:
    i32 0-d, the step's count so far. Returns (px, py, vx, vy, occ_row,
    lost) as :func:`_reinsert_far` gives them, with its dropped count added
    to ``lost``. On a CUDA device ``csrc/far_reinsert.cu`` updates the
    given tensors in place: it reads ``n_far = far_n.sum()`` on the device
    and writes nothing when it is 0 (the JAX step's ``lax.cond``), and adds
    1 to ``far_steps`` (i64[1]) when it is not; no host read. On the CPU the
    plain version runs whatever the count (the step gates it there)."""
    grids = (px, py, vx, vy)
    if not on_cuda(*grids, occ_row, far_n, lost, *_grid_tensors(gs)):
        *out, dropped = _reinsert_far(gs, *grids, far_n.sum(), dt, settings,
                                      far_capacity)
        return (*out, lost + dropped)
    gy, k, gx = px.shape
    fused._check_grids((gy, k, gx), *grids, *_grid_tensors(gs)[:4])
    for t, name in ((occ_row, "occ_row"), (gs.occ_row, "gs.occ_row"),
                    (far_n, "far_n")):
        fused._check_occ(t, gy, name)
    if lost.shape != () or lost.dtype != torch.int32:
        raise ValueError(f"lost must be i32 0-d, got {lost.dtype}"
                         f"{list(lost.shape)}")
    dev = px.device
    if far_steps is None:
        far_steps = torch.zeros(1, dtype=torch.int64, device=dev)
    if far_steps.shape != (1,) or far_steps.dtype != torch.int64:
        raise ValueError("far_steps must be i64[1]")
    lib = _build.load()
    n_pad = _pow2(far_capacity)
    keys = torch.empty(n_pad, dtype=torch.int64, device=dev)
    movers = torch.empty((far_capacity, 4), dtype=torch.float32, device=dev)
    # slots of a sort too large for shared memory
    gslot = torch.empty(n_pad if n_pad > lib.tf_far_smem_entries() else 1,
                        dtype=torch.int32, device=dev)
    h_inv, half_x, half_y, cx_max, cy_max = fused._rebin_consts(settings)
    err = lib.tf_far_reinsert(
        *(ptr(t) for t in _grid_tensors(gs)[:5]), ptr(far_n),
        ptr(fused._as_f32(dt, dev).reshape(1)), ptr(keys),
        ptr(movers), ptr(gslot),
        *(ptr(t) for t in (*grids, occ_row, lost, far_steps)),
        gy, k, gx, _rows(settings), settings.grid_w, far_capacity, h_inv,
        half_x, half_y, cx_max, cy_max, stream(dev))
    launched("far_reinsert", err)
    return (*grids, occ_row, lost)


def _grid_tensors(gs: GridState):
    return (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row)


def forcefield_cells(forcefield: torch.Tensor, settings: SimSettings,
                     gxp: int | None = None, row_start: int = 0,
                     n_rows: int | None = None):
    """Sample the [H, W, 2] pixel push-out field at the grid-cell centres.

    Returns (ffx, ffy) f32[n_rows, gxp] of pixel-space vectors: the forces
    kernel normalises in pixel space and scales the position push to
    world units. The sentinel ring and the pad rows and columns are zero.
    By default the rows are the state's (``_rows``) and the columns its
    padded width; ``row_start``/``n_rows`` take the window of global rows
    ``row_start + arange(n_rows)`` (a row band of the sharded step, whose
    halo may reach past either end of the grid: such rows are zero)."""
    gy, gw = settings.grid_h, settings.grid_w
    n_rows = _rows(settings) if n_rows is None else n_rows
    gxp = _gxp(settings) if gxp is None else gxp
    dev = forcefield.device
    f32 = torch.float32
    h = settings.smoothing_radius
    half = torch.tensor(settings.size, dtype=f32, device=dev) * 0.5
    tex_w, tex_h = settings.texture_size
    # cell c covers [(c-1)h - half, c h - half) (grid.cell_xy's inverse)
    rows = row_start + torch.arange(n_rows, dtype=torch.int32, device=dev)
    wx = (torch.arange(gxp, dtype=f32, device=dev) - 0.5) * h - half[0]
    wy = (rows.to(f32) - 0.5) * h - half[1]
    # the texel as step.sample_force_field picks it: uv = p / size + 0.5;
    # .to(int32) truncates toward zero, as JAX's astype does
    tx = ((wx / (2.0 * half[0]) + 0.5) * tex_w).to(torch.int32)
    ty = ((wy / (2.0 * half[1]) + 0.5) * tex_h).to(torch.int32)
    tx = tx.clamp(0, tex_w - 1).long()
    ty = ty.clamp(0, tex_h - 1).long()
    f = forcefield[ty[:, None], tx[None, :]]  # [n_rows, Gxp, 2]
    cols = torch.arange(gxp, device=dev)
    in_x = (cols >= 1) & (cols <= gw - 2)
    in_y = (rows >= 1) & (rows <= gy - 2)
    mask = (in_y[:, None] & in_x[None, :]).to(f32)
    return ((f[..., 0] * mask).contiguous(), (f[..., 1] * mask).contiguous())


def _split_physics() -> bool:
    """Physics layout, the JAX package's switch: the split density +
    forces_integrate pair (the default), or the single fused physics
    kernel under ``TPUFLUID_FUSED_PHYSICS=1`` (bitwise the same outputs);
    ``TPUFLUID_SPLIT_PHYSICS=1`` forces the pair."""
    if os.environ.get("TPUFLUID_SPLIT_PHYSICS", ""):
        return True
    if os.environ.get("TPUFLUID_FUSED_PHYSICS", ""):
        return False
    return True


def make_grid_step(settings: SimSettings, far_capacity: int | None = None,
                   x_boundary: str = "bounce",
                   has_force_field: bool = False,
                   surface_tension: bool = False,
                   adaptive_subsampling: bool = False,
                   n_worlds: int = 1) -> "GridStep":
    """Resident step, memoised on its arguments: ``step(gs, params)``, or
    ``step(gs, params, forcefield)`` with ``has_force_field`` (forcefield:
    the f32[H, W, 2] push-out field of ``forcefield.obstacle_force_field``;
    with ``n_worlds > 1`` one field for every world or f32[B, H, W, 2]).
    The step runs where ``gs`` lies: the CUDA kernels on a CUDA device,
    their plain versions on the CPU. The physics layout
    (``_split_physics``) is read when the step is built."""
    split = _split_physics()
    key = (settings, far_capacity, x_boundary, has_force_field,
           surface_tension, adaptive_subsampling, n_worlds, split)
    hit = _STEP_CACHE.get(key)
    if hit is None:
        hit = _STEP_CACHE[key] = GridStep(
            settings, far_capacity, x_boundary, has_force_field,
            surface_tension, adaptive_subsampling, n_worlds,
            (fused.rebin, fused.density, fused.forces_integrate,
             None if split else fused.physics), far_kernel=True)
    return hit


def make_plain_grid_step(settings: SimSettings,
                         far_capacity: int | None = None,
                         x_boundary: str = "bounce",
                         has_force_field: bool = False,
                         surface_tension: bool = False,
                         adaptive_subsampling: bool = False,
                         n_worlds: int = 1) -> "GridStep":
    """The resident step built on the kernels' plain PyTorch versions, on
    any device, its far-mover pass gated on the host: the reference that
    the CUDA step is held to on the card."""
    return GridStep(settings, far_capacity, x_boundary, has_force_field,
                    surface_tension, adaptive_subsampling, n_worlds,
                    (fused.rebin_plain, fused.density_plain,
                     fused.forces_integrate_plain, None), far_kernel=False)


class GridStep:
    """One resident step: ``step(gs, params[, forcefield]) -> GridState``.

    ``far_steps``: the steps that ran the far-mover pass with movers. The
    CUDA step counts them on the device (reading the count waits for it);
    the CPU step and the plain step read the rebin's count on the host and
    skip the pass when it is 0."""

    def __init__(self, settings: SimSettings, far_capacity, x_boundary: str,
                 has_force_field: bool, surface_tension: bool,
                 adaptive_subsampling: bool, n_worlds: int, kernels,
                 far_kernel: bool):
        if x_boundary not in ("bounce", "wrap"):
            raise ValueError(f"unknown x_boundary {x_boundary!r}")
        if n_worlds < 1:
            raise ValueError(f"n_worlds {n_worlds} < 1")
        # its burst graphs' key (``graphs.Runners``): the step's arguments,
        # one step to a key through ``make_grid_step``'s cache
        self.key = (settings, far_capacity, x_boundary, has_force_field,
                    surface_tension, adaptive_subsampling, n_worlds, kernels)
        self.settings = settings = pad_capacity(settings)
        k = settings.cell_capacity
        self.rows_w = _rows(settings)
        self.shape = (self.rows_w * n_worlds, k, _gxp(settings))
        if far_capacity is None:
            # impact phases can fling thousands of >1-cell movers in one step
            far_capacity = max(4096, (self.shape[0] * k * self.shape[2])
                               // 128)
        self.far_capacity = far_capacity
        self.has_force_field = has_force_field
        self.n_worlds = n_worlds
        self.variant = dict(x_boundary=x_boundary,
                            surface_tension=surface_tension,
                            adaptive_subsampling=adaptive_subsampling)
        self.rebin, self.density, self.forces_integrate, self.physics = \
            kernels
        self.far_kernel = far_kernel
        self._tables = {}
        self._far_host = 0
        self._far_dev = {}  # device -> i64[1]
        # the field's cell samples, kept while the same field tensor comes
        # back: sampling once per field instead of once per step gives the
        # same numbers (a field is replaced, never written in place)
        self._ff_memo = (None, None)

    @property
    def far_steps(self) -> int:
        return self._far_host + sum(int(c) for c in self._far_dev.values())

    def _world_tables(self, device):
        """A batched stack's (wid, row_shift) on ``device``: each row's
        world, and its cell-row frame offset."""
        if self.n_worlds == 1:
            return None, None
        if device not in self._tables:
            w = torch.arange(self.n_worlds, dtype=torch.int32, device=device)
            w = w.repeat_interleave(self.rows_w)
            self._tables[device] = (w, -(w * self.rows_w))
        return self._tables[device]

    def _far_counter(self, device):
        if device not in self._far_dev:
            self._far_dev[device] = torch.zeros(1, dtype=torch.int64,
                                                device=device)
        return self._far_dev[device]

    def cells(self, forcefield):
        """The obstacle field's per-cell samples (``_world_cells``), or
        None for a step built without ``has_force_field``."""
        if not self.has_force_field:
            return None
        if forcefield is None:
            raise ValueError("step built with has_force_field=True needs a "
                             "forcefield argument")
        if self._ff_memo[0] is not forcefield:
            self._ff_memo = (forcefield, _world_cells(
                forcefield, self.settings, self.n_worlds))
        return self._ff_memo[1]

    def __call__(self, gs: GridState, params, forcefield=None) -> GridState:
        return self.advance(gs, params, self.cells(forcefield))

    def advance(self, gs: GridState, params, ff_cells,
                out: GridState | None = None) -> GridState:
        """One step from ``gs`` with the field's cell samples ``ff_cells``.
        ``out`` (a CUDA step only; may be ``gs`` itself): the state that
        takes the result, written after every read of ``gs``."""
        if gs.pos_x.shape != self.shape:
            raise ValueError(f"state shape {tuple(gs.pos_x.shape)} does not "
                             f"match settings {self.shape}")
        settings = self.settings
        dt = params.delta
        if self.n_worlds > 1 and dt.numel() != 1:
            raise ValueError(
                "batched resident mode shares one delta across worlds "
                "(pass a scalar); gravity/viscosity/etc. may be [B]")
        dev = gs.pos_x.device
        wid, row_shift = self._world_tables(dev)
        frame = gs.tick + 1
        px, py, vx, vy, occ_row, far_n, over_n = self.rebin(
            gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row, dt, settings,
            row_shift=row_shift)
        lost = gs.lost + over_n.sum().to(torch.int32)
        if self.far_kernel and dev.type == "cuda":
            px, py, vx, vy, occ_row, lost = far_reinsert(
                gs, px, py, vx, vy, occ_row, far_n, lost, dt, settings,
                self.far_capacity, self._far_counter(dev))
        elif int(far_n.sum()) > 0:  # a host read: the CPU, the plain step
            px, py, vx, vy, occ_row, dropped = _reinsert_far(
                gs, px, py, vx, vy, far_n.sum(), dt, settings,
                self.far_capacity)
            lost = lost + dropped
            self._far_host += 1
        dst = None if out is None else (out.pos_x, out.pos_y, out.vel_x,
                                        out.vel_y)
        if self.physics is not None:
            new = self.physics(px, py, vx, vy, occ_row, params, settings,
                               frame, ff_cells=ff_cells, wid=wid, out=dst,
                               **self.variant)
        else:
            pres, invr = self.density(
                px, py, vx, vy, occ_row, params.mass, dt,
                params.pressure_constant, params.rest_density, settings,
                wid=wid)
            kw = {} if dst is None else dict(out=dst)
            new = self.forces_integrate(
                px, py, vx, vy, pres, invr, occ_row, params, settings, frame,
                ff_cells=ff_cells, wid=wid, **kw, **self.variant)
        if out is None:
            return GridState(*new, occ_row=occ_row, tick=frame, lost=lost)
        out.occ_row.copy_(occ_row)
        out.tick.copy_(frame)
        out.lost.copy_(lost)
        return out

    def burst(self, gs: GridState, params, n_steps: int,
              forcefield=None) -> GridState:
        """``n_steps`` steps as replays of this step's CUDA graph
        (``graphs.burst``), which overwrites its static state with each
        step's result (``advance(out=)``); fresh tensors out."""
        dev = gs.pos_x.device
        return graphs.burst(
            self.key + (dev, graphs.signature(params)), dev, n_steps,
            self.advance, lambda g, p, ff: self.advance(g, p, ff, out=g),
            f"the resident step {list(self.shape)}", gs, params,
            self.cells(forcefield))


def _world_cells(forcefield: torch.Tensor, settings: SimSettings,
                 n_worlds: int):
    """Per-cell push-out samples of the step's state rows: one world's
    (``forcefield_cells``), or a batched stack's, each world's samples
    stacked along the rows like its state (a [H, W, 2] field is shared by
    every world, a [B, H, W, 2] one gives each its own)."""
    if n_worlds == 1:
        return forcefield_cells(forcefield, settings)
    ff = forcefield
    if ff.dim() == 3:
        ff = ff.expand((n_worlds,) + tuple(ff.shape))
    parts = [forcefield_cells(ff[w], settings) for w in range(n_worlds)]
    return (torch.cat([p[0] for p in parts]).contiguous(),
            torch.cat([p[1] for p in parts]).contiguous())


_STEP_CACHE: dict = {}


def make_grid_multi_step(settings: SimSettings, n_steps: int, **kw):
    """``run(gs, params[, forcefield])``: ``n_steps`` resident steps
    (``kw``: those of ``make_grid_step``). On a CUDA device the burst
    replays the step's CUDA graph once a step (``GridStep.burst``: the JAX
    package's ``jax.jit(lax.scan(step))``, no host work between steps),
    bitwise the eager burst of ``make_eager_grid_multi_step``; a failed
    capture raises. On the CPU the eager burst, a Python loop."""
    eager = make_eager_grid_multi_step(settings, n_steps, **kw)
    step = eager.step

    def run(gs: GridState, params, *forcefield) -> GridState:
        if graphs.graphable(gs.pos_x.device):
            return step.burst(gs, params, n_steps, *forcefield)
        return eager(gs, params, *forcefield)

    run.step = step
    return run


def make_eager_grid_multi_step(settings: SimSettings, n_steps: int, **kw):
    """``make_grid_multi_step``'s burst as a Python loop of eager steps on
    any device: what the graphed burst is held to on the card."""
    step = make_grid_step(settings, **kw)

    def run(gs: GridState, params, *forcefield) -> GridState:
        for _ in range(n_steps):
            gs = step(gs, params, *forcefield)
        return gs

    run.step = step
    return run


# ------------------------------------------------------------- batching
# BASELINE config 4: B independent worlds with differing per-tick params,
# stepped by one set of kernel launches (make_grid_step(n_worlds=B)).

def init_batched_grid_state(settings: SimSettings, n_worlds: int,
                            device) -> GridState:
    """The reference spawn lattice replicated into a B-world row stack."""
    gs = init_grid_state(settings, device)
    tile = lambda a: a.repeat(n_worlds, 1, 1)
    return GridState(
        pos_x=tile(gs.pos_x), pos_y=tile(gs.pos_y),
        vel_x=tile(gs.vel_x), vel_y=tile(gs.vel_y),
        occ_row=gs.occ_row.repeat(n_worlds), tick=gs.tick, lost=gs.lost)


def batched_params(param_list):
    """Stack B TickParams into one with a leading [B] dim on every field
    except ``delta``, which the worlds must share."""
    d0 = param_list[0].delta
    for p in param_list[1:]:
        if not torch.equal(p.delta.to(d0.device), d0):
            raise ValueError("batched worlds must share delta")
    fields = {f.name: torch.stack([getattr(p, f.name) for p in param_list])
              for f in dataclasses.fields(param_list[0])}
    fields["delta"] = d0
    return type(param_list[0])(**fields)


def batched_world_stats(gs: GridState, settings: SimSettings,
                        n_worlds: int) -> dict:
    """Per-world occupancy of a batched row stack: particle count,
    occupied rows, per-row max occupancy (mean over occupied rows and
    max), and the mean occ3 over occupied rows, the candidate-scan bound
    the kernels pay. Plain Python lists, one entry per world."""
    gy = _rows(settings)
    occ_cell = (gs.pos_x < SENTINEL_HALF).sum(dim=1).to(torch.int32)
    occ_cell = occ_cell.reshape(n_worlds, gy, -1)
    n_parts = occ_cell.sum(dim=(1, 2))
    rowmax = occ_cell.amax(dim=2)  # [W, Gy]
    occupied = rowmax > 0
    n_rows = occupied.sum(dim=1)
    zero = torch.zeros_like(rowmax[:, :1])
    lo = torch.cat([zero, rowmax[:, :-1]], dim=1)
    hi = torch.cat([rowmax[:, 1:], zero], dim=1)
    occ3 = torch.maximum(torch.maximum(lo, rowmax), hi)
    denom = torch.clamp(n_rows, min=1).to(torch.float32)
    mean_rowmax = torch.where(occupied, rowmax, 0).sum(dim=1) / denom
    mean_occ3 = torch.where(occupied, occ3, 0).sum(dim=1) / denom
    return dict(
        particles=[int(x) for x in n_parts],
        occupied_rows=[int(x) for x in n_rows],
        rowmax_mean=[float(x) for x in mean_rowmax],
        rowmax_max=[int(x) for x in rowmax.amax(dim=1)],
        occ3_mean=[float(x) for x in mean_occ3],
    )


def world_state(gs: GridState, settings: SimSettings, w: int) -> GridState:
    """World ``w`` of a batched row stack."""
    gy = _rows(settings)
    sl = slice(w * gy, (w + 1) * gy)
    return GridState(
        pos_x=gs.pos_x[sl], pos_y=gs.pos_y[sl],
        vel_x=gs.vel_x[sl], vel_y=gs.vel_y[sl],
        occ_row=gs.occ_row[sl], tick=gs.tick, lost=gs.lost)
