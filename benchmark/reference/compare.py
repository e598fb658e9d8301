"""The comparisons that decide ``correct``.

A step of the program reorders its particles (the slot grid packs them by
cell; the per-step engines return them sorted by cell), so particles are
matched by position: each particle of one side is paired with the nearest
particle of the other side within ``radius``, and the gaps are read over
those pairs in both directions. A particle with no partner within
``radius`` reads a gap of ``radius``. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from .sph import pairs_within


def _nearest(a_pos, b_pos, radius, size):
    """(gap[Na], partner[Na]): each point of ``a``'s nearest point of ``b``
    within ``radius`` (gap ``radius``, partner -1 where there is none)."""
    na = a_pos.shape[0]
    pts = torch.cat([a_pos, b_pos]).to(torch.float64)
    i, j = pairs_within(pts, radius, size, with_self=False)
    keep = (i < na) & (j >= na)
    i, j = i[keep], j[keep] - na
    d = torch.sqrt(((pts[na:][j] - pts[:na][i]) ** 2).sum(1))
    gap = torch.full((na,), float(radius), dtype=torch.float64,
                     device=pts.device)
    gap.scatter_reduce_(0, i, d, "amin")
    partner = torch.full((na,), -1, dtype=torch.int64, device=pts.device)
    best = d == gap[i]
    partner[i[best]] = j[best]
    return gap, partner


def state_gaps(prog_pos, prog_vel, ref_pos, ref_vel, radius: float, size):
    """Gaps between the program's particles and the reference's: the
    largest distance from a particle of either side to its nearest partner
    on the other (``pos_gap``, world units), and the largest speed of the
    difference of matched velocities (``vel_gap``, units/s), with the
    counts of each side."""
    gap_p, part_p = _nearest(prog_pos, ref_pos, radius, size)
    gap_r, _ = _nearest(ref_pos, prog_pos, radius, size)
    ok = part_p >= 0
    dv = (prog_vel[ok].to(torch.float64)
          - ref_vel[part_p[ok]].to(torch.float64))
    vel_gap = float(torch.sqrt((dv * dv).sum(1)).max()) if ok.any() else \
        float("inf")
    pos_gap = max(float(gap_p.max()) if gap_p.numel() else 0.0,
                  float(gap_r.max()) if gap_r.numel() else 0.0)
    return dict(pos_gap=pos_gap, vel_gap=vel_gap,
                n_program=int(prog_pos.shape[0]), n_reference=int(
                    ref_pos.shape[0]))


def frame_gap(prog_rgba8: torch.Tensor, ref_rgba8: torch.Tensor) -> int:
    """Largest difference of one channel of one pixel, in levels of 255."""
    if prog_rgba8.shape != ref_rgba8.shape:
        return 255
    return int((prog_rgba8.to(torch.int16)
                - ref_rgba8.to(torch.int16)).abs().max())
