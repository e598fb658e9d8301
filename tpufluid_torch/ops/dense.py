"""Dense slot-grid construction (the part of ``tpufluid.ops.dense`` that
the resident engine's boundary conversion needs).

Particles sorted by cell are scattered into a ``[Gy, K, Gxp]`` slot grid
(K = cell_capacity, Gxp = grid width padded to a multiple of 128), slot =
the particle's rank within its cell. Scatters go into a buffer one element
longer than the grid: particles beyond capacity all land on that spare
slot, which is sliced off, so every kept index is unique and the result is
deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..params import SimSettings


class DenseGrid(NamedTuple):
    flat: torch.Tensor       # i64[N] slot of each sorted particle (=size -> dropped)
    px: torch.Tensor         # f32[Gy, K, Gxp]
    py: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    valid: torch.Tensor      # bool[Gy, K, Gxp]
    n_dropped: torch.Tensor  # i32 particles beyond cell capacity


def ranks(sorted_cells: torch.Tensor) -> torch.Tensor:
    """Rank of each sorted particle within its cell run (a running max
    over run-start positions)."""
    n = sorted_cells.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=sorted_cells.device)
    first = torch.ones(n, dtype=torch.bool, device=sorted_cells.device)
    first[1:] = sorted_cells[1:] != sorted_cells[:-1]
    run_start = torch.cummax(torch.where(first, iota, 0), dim=0).values
    return iota - run_start


def build_grid_cols(pxs, pys, vxs, vys, sorted_cells: torch.Tensor,
                    settings: SimSettings, dims=None) -> DenseGrid:
    """Scatter cell-sorted columns into the slot grid. ``dims``: optional
    (rows, grid_w) override of (grid_h, grid_w)."""
    k = settings.cell_capacity
    gy, gx = dims if dims is not None else (settings.grid_h, settings.grid_w)
    gx_pad = -(-gx // 128) * 128
    rank = ranks(sorted_cells)
    keep = rank < k
    cells = sorted_cells.to(torch.int64)
    cy = cells // gx
    cx = cells % gx
    size = gy * k * gx_pad
    flat = torch.where(keep, (cy * k + rank) * gx_pad + cx, size)
    shape = (gy, k, gx_pad)
    dev = sorted_cells.device

    def scat(vals, dtype=torch.float32):
        buf = torch.zeros(size + 1, dtype=dtype, device=dev)
        buf.index_put_((flat,), vals.to(dtype))
        return buf[:size].reshape(shape)

    return DenseGrid(
        flat=flat,
        px=scat(pxs), py=scat(pys), vx=scat(vxs), vy=scat(vys),
        valid=scat(torch.ones_like(keep), torch.bool),
        n_dropped=(~keep).sum().to(torch.int32),
    )
