"""The chamfer push-out field of a video frame (port of
``tpufluid.native.distfield``).

Byte-exact to the reference's CPU algorithm (src/main.rs:403-515): a
raster propagation whose every step reads the one before it, with ties
kept by the earlier candidate. It stays a host computation, as in the JAX
package, and its result is uploaded once per frame when a video field is
set. For a CUDA device it runs the port's compiled copy
(``csrc/distfield.cpp``, built with the kernels; a failed build raises);
for the CPU, the NumPy copy ``_chamfer_numpy`` below, its plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

# calls of the compiled copy (fields bound for a CUDA device)
CALLS = {"chamfer": 0}


def chamfer_push_field(mask_u8, device="cuda") -> torch.Tensor:
    """u8[H, W] grayscale mask -> f32[H, W, 2] push vectors (pixels) on
    ``device``. Sources are pixels > 128 ("outside"); the image border
    seeds when there is none."""
    mask = np.ascontiguousarray(mask_u8, dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"expected a u8[H, W] mask, got {mask.shape}")
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(_chamfer_numpy(mask))
    if device.type != "cuda":
        raise NotImplementedError(f"no chamfer field for device {device}")
    h, w = mask.shape
    out = np.empty((h, w, 2), np.float32)
    err = _build.load().tf_chamfer_push_field(
        mask.ctypes.data_as(ctypes.c_void_p), w, h,
        out.ctypes.data_as(ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"tf_chamfer_push_field returned {err}")
    CALLS["chamfer"] += 1
    return torch.from_numpy(out).to(device)


def _chamfer_numpy(mask_u8: np.ndarray) -> np.ndarray:
    """Plain NumPy version, byte-exact to the compiled copy.

    Each pass relaxes a pixel by its four earlier neighbours in order
    (forward: left, top-left, top, top-right; backward: right,
    bottom-right, bottom, bottom-left), keeping a candidate only when it
    is strictly nearer. That keeps the first candidate, in that order,
    that reaches the least distance. So the three candidates from the row
    already done are reduced for the whole row at once, and only the
    chain along the row runs pixel by pixel. Distances are exact integer
    squares in float64."""
    h, w = mask_u8.shape
    src = mask_u8 > 128
    if not src.any():
        src = np.zeros((h, w), bool)
        src[0, :] = src[-1, :] = True
        src[:, 0] = src[:, -1] = True
    dist = np.where(src, 0.0, float(np.finfo(np.float32).max))
    xs = np.arange(w)
    near_x = np.where(src, xs[None, :], 0)
    near_y = np.where(src, np.arange(h)[:, None], 0)

    def best_of(y, ry, offsets):
        """The first nearest of row ``ry``'s candidates (x + dx, ry) for
        every x of row y, in the order of ``offsets``."""
        bd = np.full(w, np.inf)
        bx = np.zeros(w, np.int64)
        by = np.zeros(w, np.int64)
        for dx in offsets:
            nx = xs + dx
            ok = (nx >= 0) & (nx < w)
            nx = np.clip(nx, 0, w - 1)
            cx, cy = near_x[ry, nx], near_y[ry, nx]
            d = np.where(ok, ((xs - cx) ** 2 + (y - cy) ** 2)
                         .astype(np.float64), np.inf)
            take = d < bd
            bd = np.where(take, d, bd)
            bx = np.where(take, cx, bx)
            by = np.where(take, cy, by)
        return bd.tolist(), bx.tolist(), by.tolist()

    def sweep(y, order, step, ry, offsets):
        """Relax row y along ``order`` by its neighbour ``x - step`` in
        the row, then by the reduced candidates of row ``ry``."""
        d_row = dist[y].tolist()
        x_row = near_x[y].tolist()
        y_row = near_y[y].tolist()
        if 0 <= ry < h:
            td, tx, ty = best_of(y, ry, offsets)
        else:
            td = None
        for x in order:
            d = d_row[x]
            bx, by = x_row[x], y_row[x]
            p = x - step
            if 0 <= p < w:
                cx, cy = x_row[p], y_row[p]
                dl = float((x - cx) * (x - cx) + (y - cy) * (y - cy))
                if dl < d:
                    d, bx, by = dl, cx, cy
            if td is not None and td[x] < d:
                d, bx, by = td[x], tx[x], ty[x]
            d_row[x], x_row[x], y_row[x] = d, bx, by
        dist[y] = d_row
        near_x[y] = x_row
        near_y[y] = y_row

    fwd = range(w)
    for y in range(h):
        sweep(y, fwd, 1, y - 1, (-1, 0, 1))
    bwd = range(w - 1, -1, -1)
    for y in range(h - 1, -1, -1):
        sweep(y, bwd, -1, y + 1, (1, 0, -1))

    nearest = np.stack([near_x, near_y], axis=-1)
    px = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"),
                  axis=-1)
    d = (px - nearest).astype(np.float32)
    length = np.linalg.norm(d, axis=-1, keepdims=True)
    return np.where(length > 1e-6, -d, 0.0).astype(np.float32)
