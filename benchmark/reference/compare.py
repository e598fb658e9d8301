"""The comparisons that decide ``correct``.

A step of the program reorders its particles (the slot grid packs them by
cell; the per-step engines return them sorted by cell), so particles are
matched by position: each particle of one side is paired with the nearest
particle of the other side within ``radius``, and the gaps are read over
those pairs in both directions. A particle with no partner within
``radius`` reads a gap of ``radius``. Where a particle has several nearest
partners at one distance, it reads the one whose velocity is closest.

Particles that sit at one point are paired one to one by velocity instead
(``TIE``, ``_tie_groups``): the walls clamp a particle to the float32 wall
on both sides, so particles driven into a corner land on exactly the same
point, each with its own velocity, and nearness alone cannot tell them
apart. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from .sph import pairs_within

# Program and reference particles closer than this are one point to the
# pairing. A corner holds its particles at exactly (+-half_x, +-half_y) on
# both sides; a particle clamped on one side may sit a rounding or two
# inside the wall on the other. 2**-16 is four float32 ulps of a coordinate
# in [32, 64), where the 1M box's half extents (50.98, 52.05) lie, and far
# under the ~0.1 that separates two particles of the fluid.
TIE = 2.0 ** -16


def _pairs(a_pos, b_pos, radius, size):
    """(i, j, d): every pair of a point ``i`` of ``a`` and a point ``j`` of
    ``b`` closer than ``radius``, with its distance (float64)."""
    na = a_pos.shape[0]
    pts = torch.cat([a_pos, b_pos]).to(torch.float64)
    i, j = pairs_within(pts, radius, size, with_self=False)
    keep = (i < na) & (j >= na)
    i, j = i[keep], j[keep] - na
    d = torch.sqrt(((pts[na:][j] - pts[:na][i]) ** 2).sum(1))
    return i, j, d


def _least(n, idx, val, fill):
    """[n]: the least of ``val`` at each index of ``idx`` (``fill`` where
    none)."""
    out = torch.full((n,), float(fill), dtype=val.dtype, device=val.device)
    return out.scatter_reduce_(0, idx, val, "amin")


def _speed(dv):
    return torch.sqrt((dv * dv).sum(-1))


def _tie_groups(i, j, d, n_a, n_b):
    """The groups of ``a`` and ``b`` points linked by pairs closer than
    ``TIE`` where some point has more than one such partner: a list of
    (a indices, b indices), as lists. Grown on the device from the
    points with two or more partners, so only the few points in a group
    reach the host."""
    tie = d < TIE
    ti, tj = i[tie], j[tie]
    in_a = torch.bincount(ti, minlength=n_a) > 1
    in_b = torch.bincount(tj, minlength=n_b) > 1
    if not (bool(in_a.any()) or bool(in_b.any())):
        return []
    while True:  # to whole groups: as many rounds as a group is wide
        e = in_a[ti] | in_b[tj]
        grow_a, grow_b = in_a.clone(), in_b.clone()
        grow_a[ti[e]] = True
        grow_b[tj[e]] = True
        if torch.equal(grow_a, in_a) and torch.equal(grow_b, in_b):
            break
        in_a, in_b = grow_a, grow_b
    # union-find over the groups' own edges (b offset by n_a)
    e = in_a[ti] | in_b[tj]
    edges = torch.stack([ti[e], tj[e] + n_a], 1).cpu().tolist()
    root = {}

    def find(x):
        root.setdefault(x, x)
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    for x, y in edges:
        rx, ry = find(x), find(y)
        if rx != ry:
            root[max(rx, ry)] = min(rx, ry)
    members = {}
    for x in list(root):
        members.setdefault(find(x), []).append(x)
    return [([x for x in m if x < n_a], [x - n_a for x in m if x >= n_a])
            for m in members.values()]


def _canonical(idx, pos, vel):
    """The indices ``idx`` (a list) as a tensor, in the order of their
    points' (x, y, vx, vy): an order that the values alone decide."""
    idx = torch.tensor(idx, dtype=torch.int64, device=pos.device)
    keys = torch.cat([pos[idx].double(), vel[idx].double()], 1).tolist()
    return idx[sorted(range(len(keys)), key=keys.__getitem__)]


def _matching(allowed):
    """A matching of every row of the bool matrix ``allowed`` [m, n]
    (m <= n) to a column of its own, by augmenting paths, or None."""
    m, n = allowed.shape
    cols = [[c for c, ok in enumerate(row) if ok] for row in allowed.tolist()]
    row_of = [-1] * n

    def augment(r, seen):
        for c in cols[r]:
            if not seen[c]:
                seen[c] = True
                if row_of[c] < 0 or augment(row_of[c], seen):
                    row_of[c] = r
                    return True
        return False

    for r in range(m):
        if not augment(r, [False] * n):
            return None
    col_of = [0] * m
    for c, r in enumerate(row_of):
        if r >= 0:
            col_of[r] = c
    return col_of


def _bottleneck(cost):
    """For the cost matrix [m, n] (m <= n), the column of each row, one to
    one, that makes the largest cost of a row the least it can be."""
    levels = torch.unique(cost)  # sorted; the answer is one of them
    lo, hi = 0, levels.numel() - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if _matching(cost <= levels[mid]) is None:
            lo = mid + 1
        else:
            hi = mid
    return _matching(cost <= levels[lo])


def state_gaps(prog_pos, prog_vel, ref_pos, ref_vel, radius: float, size):
    """Gaps between the program's particles and the reference's: the
    largest distance from a particle of either side to its nearest partner
    on the other (``pos_gap``, world units), and the largest speed of the
    difference of paired velocities (``vel_gap``, units/s), with the
    counts of each side and the sizes (program, reference) of the groups
    paired one to one."""
    n_p, n_r = prog_pos.shape[0], ref_pos.shape[0]
    i, j, d = _pairs(prog_pos, ref_pos, radius, size)
    gap_p = _least(n_p, i, d, radius)
    gap_r = _least(n_r, j, d, radius)
    vp, vr = prog_vel.to(torch.float64), ref_vel.to(torch.float64)
    near = d == gap_p[i]
    speed = _least(n_p, i[near], _speed(vp[i[near]] - vr[j[near]]),
                   float("inf"))
    paired = torch.zeros(n_p, dtype=torch.bool, device=speed.device)
    paired[i] = True

    sizes = []
    for a, b in _tie_groups(i, j, d, n_p, n_r):
        sizes.append((len(a), len(b)))
        a, b = _canonical(a, prog_pos, vp), _canonical(b, ref_pos, vr)
        cost = _speed(vp[a][:, None] - vr[b][None]).cpu()
        if len(a) <= len(b):
            rows, cols = list(range(len(a))), _bottleneck(cost)
        else:  # each reference particle gets one; the rest stay nearest
            rows, cols = _bottleneck(cost.T), list(range(len(b)))
        speed[a[rows]] = cost[rows, cols].to(speed.device)

    vel_gap = float(speed[paired].max()) if paired.any() else float("inf")
    pos_gap = max(float(gap_p.max()) if gap_p.numel() else 0.0,
                  float(gap_r.max()) if gap_r.numel() else 0.0)
    return dict(pos_gap=pos_gap, vel_gap=vel_gap, n_program=n_p,
                n_reference=n_r, tie_groups=sorted(sizes))


def frame_gap(prog_rgba8: torch.Tensor, ref_rgba8: torch.Tensor) -> int:
    """Largest difference of one channel of one pixel, in levels of 255."""
    if prog_rgba8.shape != ref_rgba8.shape:
        return 255
    return int((prog_rgba8.to(torch.int16)
                - ref_rgba8.to(torch.int16)).abs().max())
