"""The least time the card could take for a resident kernel's work.

Work is counted from the algorithm and the state, never from a kernel:

* operations: f32 operations per unit of work, counted from the kernel
  sources once (``OPS``), times the units this state holds: per live
  particle for rebin (predict 2 x 4, cell 2 x 3), per live (target,
  candidate) pair of the 3 x 3 cell stencil for density (predict 8,
  distance 5, kernel 5) and forces (predict 8, distance 7, pressure 11,
  viscosity 17), per live (sample, candidate) pair for the metaball
  coarse fields (distance 5, scale 1, exp 1, sums 3);
* bytes: each input field [Gy, K, Gxp] read once below its row's
  occupancy (slots above it are empty by the grid's invariant), each
  output field written whole (``IO``: input and output fields).

The least time is the larger of the bytes over the memory rate and the
operations over the f32 rate (``PEAKS``: the H100 SXM's published peaks
at 700 W; a card set to a lower power limit reads lower shares).
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, f32 (non-tensor) operations/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations per unit of work (see the module docstring)
OPS = {"rebin": 14, "density": 18, "forces_integrate": 43,
       "metaball_coarse": 10}
# (input fields read below occupancy, output fields written whole)
IO = {"rebin": (4, 4), "density": (4, 2), "forces_integrate": (6, 4)}
# empty slots hold a position of 1e9; anything past this is no particle
SENTINEL_HALF = 5.0e8


def live_per_cell(pos_x: torch.Tensor) -> torch.Tensor:
    """f64[Gy, Gxp]: live particles in each cell of a slot grid."""
    return (pos_x < SENTINEL_HALF).sum(dim=1).double()


def stencil_pairs(pos_x: torch.Tensor) -> float:
    """Live (target, candidate) pairs over the 3 x 3 cell stencil."""
    c = live_per_cell(pos_x)
    box = torch.nn.functional.conv2d(
        c[None, None], torch.ones(1, 1, 3, 3, dtype=c.dtype,
                                  device=c.device), padding=1)[0, 0]
    return float((c * box).sum())


def grid_bytes(pos_x: torch.Tensor, occ_row: torch.Tensor, n_in: int,
               n_out: int) -> int:
    """Bytes a kernel must move on this grid: ``n_in`` f32 fields read
    below each row's occupancy and ``n_out`` written whole."""
    gy, k, gx = pos_x.shape
    live = int(torch.clamp(occ_row.long(), max=k).sum()) * gx * 4
    return n_in * live + n_out * gy * k * gx * 4


def work(kernel: str, pos_x: torch.Tensor, occ_row: torch.Tensor):
    """(bytes, operations) of one launch of ``kernel`` on this grid."""
    n_in, n_out = IO[kernel]
    units = (float((pos_x < SENTINEL_HALF).sum()) if kernel == "rebin"
             else stencil_pairs(pos_x))
    return grid_bytes(pos_x, occ_row, n_in, n_out), OPS[kernel] * units


def least_ms(n_bytes: float, n_ops: float):
    """(ms, "bytes" | "operations"): the bound and what sets it."""
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = n_ops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
