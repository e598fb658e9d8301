"""Cell keys and sort-based binning (port of ``tpufluid.ops.grid``).

Cell math matches ``funcs.wgsl:206-218``: cell = floor((p + bounds/2)/h) + 1,
clamped to the interior [1, grid_dim - 2] so the one-cell sentinel ring
stays empty even when size/h divides exactly in f32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..params import SimSettings


@functools.lru_cache(maxsize=None)
def _cell_consts(settings: SimSettings, device: torch.device):
    """(half-bounds, h, lowest and highest interior cell) on ``device``,
    made once: a host-to-device copy waits for the device's queue."""
    half = torch.tensor(np.asarray(settings.size, np.float32) * np.float32(0.5),
                        device=device)
    h = torch.tensor(np.float32(settings.smoothing_radius), device=device)
    lo = torch.ones(2, dtype=torch.int32, device=device)
    hi = torch.tensor([settings.grid_w - 2, settings.grid_h - 2],
                      dtype=torch.int32, device=device)
    return half, h, lo, hi


def cell_xy(point: torch.Tensor, settings: SimSettings) -> torch.Tensor:
    """Integer (x, y) cell coords of world points f32[..., 2] -> i32[..., 2]."""
    half, h, lo, hi = _cell_consts(settings, point.device)
    xy = torch.floor((point + half) / h).to(torch.int32) + 1
    return torch.minimum(torch.maximum(xy, lo), hi)


def cell_id(point: torch.Tensor, settings: SimSettings) -> torch.Tensor:
    """Row-major cell id of world points f32[..., 2] -> i32[...]."""
    xy = cell_xy(point, settings)
    return xy[..., 1] * settings.grid_w + xy[..., 0]


class Binning(NamedTuple):
    """A permutation into cell-sorted order plus the segment table."""

    perm: torch.Tensor          # i64[N]: sorted[i] = orig[perm[i]]
    sorted_cells: torch.Tensor  # i32[N] cell id per sorted slot
    cell_start: torch.Tensor    # i32[G+1]: run of cell c is [start[c], start[c+1])


def bin_particles(cells: torch.Tensor, settings: SimSettings) -> Binning:
    """Stable sort of particle indices by cell id, plus segment starts."""
    sorted_cells, perm = torch.sort(cells.to(torch.int32), stable=True)
    all_cells = torch.arange(settings.num_cells + 1, dtype=torch.int32,
                             device=cells.device)
    cell_start = torch.searchsorted(sorted_cells, all_cells,
                                    side="left").to(torch.int32)
    return Binning(perm=perm, sorted_cells=sorted_cells, cell_start=cell_start)


class NeighborWindows(NamedTuple):
    """Fixed-shape neighbour candidates, in sorted-array order.

    idx: i64[..., R, W] candidate slots into the sorted arrays, clamped;
    valid: bool[..., R, W] the slot is a real particle of the stencil row.
    R = 2r+1 stencil rows, W = (2r+1) * capacity.
    """

    idx: torch.Tensor
    valid: torch.Tensor


def neighbor_windows(sorted_cells, cell_start, settings: SimSettings,
                     radius_cells: int = 1,
                     capacity: int | None = None) -> NeighborWindows:
    """Candidate windows for a (2r+1)x(2r+1) cell stencil around each
    sorted particle."""
    return point_windows(sorted_cells, cell_start, settings, radius_cells,
                         capacity)


def point_windows(point_cells, cell_start, settings: SimSettings,
                  radius_cells: int = 1,
                  capacity: int | None = None) -> NeighborWindows:
    """Neighbour windows for arbitrary query cell ids (particles or render
    pixels). Cells are row-major, so each of the 2r+1 stencil rows is one
    contiguous run of 2r+1 cells in the sorted array."""
    r = radius_cells
    cap = settings.cell_capacity if capacity is None else capacity
    width = (2 * r + 1) * cap
    dev = point_cells.device
    dys = torch.arange(-r, r + 1, dtype=torch.int64, device=dev)
    base = point_cells.to(torch.int64)[..., None] + dys * settings.grid_w - r
    base = base.clamp(0, settings.num_cells - (2 * r + 1))
    cs = cell_start.to(torch.int64)
    start = cs[base]
    end = cs[base + (2 * r + 1)]
    idx = start[..., None] + torch.arange(width, dtype=torch.int64, device=dev)
    valid = idx < end[..., None]
    idx = torch.minimum(idx, cs[-1] - 1).clamp(min=0)
    return NeighborWindows(idx=idx, valid=valid)


def max_cell_occupancy(cell_start: torch.Tensor) -> torch.Tensor:
    """The largest per-cell particle count (a diagnostic against
    cell_capacity)."""
    return (cell_start[1:] - cell_start[:-1]).max()
