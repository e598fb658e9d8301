"""Checkpoints, PNG frames and mp4 export (port of ``tpufluid.utils.io``).

* Checkpoints use the JAX package's ``.npz`` layout (position, predicted,
  velocity, density, cell, tick). The JAX package stores ``cell`` and
  ``tick`` as u32; the port widens them on load (i32 cell, i64 tick) and
  narrows them on save, so one file moves between the two packages.
* PNGs (RGBA8) are written and read with Python's ``zlib`` and ``struct``:
  no native library, no PIL.
* mp4 export pipes raw frames into an ``ffmpeg`` binary and raises when
  there is none.
* Video force fields read grayscale frame stacks from ``.npy``/``.npz``,
  or decode any container through an ``ffmpeg`` binary.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import zlib
from typing import Optional

import numpy as np
import torch

from ..state import ParticleState

_CKPT_FIELDS = ("position", "predicted", "velocity", "density", "cell", "tick")


# ---------------------------------------------------------------- checkpoint

def save_checkpoint(path: str, state: ParticleState) -> None:
    arrays = {n: getattr(state, n).detach().cpu().numpy()
              for n in _CKPT_FIELDS}
    arrays["cell"] = arrays["cell"].astype(np.uint32)
    arrays["tick"] = arrays["tick"].astype(np.uint32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device) -> ParticleState:
    with np.load(path) as z:
        v = {n: np.array(z[n]) for n in _CKPT_FIELDS}
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return ParticleState(
        position=f32(v["position"]), predicted=f32(v["predicted"]),
        velocity=f32(v["velocity"]), density=f32(v["density"]),
        cell=torch.from_numpy(v["cell"].astype(np.int32)).to(device),
        tick=torch.tensor(int(v["tick"]), dtype=torch.int64, device=device),
    )


# ----------------------------------------------------------------------- PNG

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgba8) -> str:
    """Write u8[H, W, 4] as an RGBA8 PNG (filter 0 on every row). Returns
    the path."""
    a = np.ascontiguousarray(np.asarray(rgba8, dtype=np.uint8))
    if a.ndim != 3 or a.shape[2] != 4:
        raise ValueError(f"expected u8[H, W, 4], got {a.shape}")
    h, w = a.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * 4)],
                         axis=1)
    png = (_PNG_SIG
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)
    return path


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) into u8[h, stride]."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.astype(np.int32)
            up = prior.astype(np.int32)
            for x in range(bpp, stride + bpp, bpp):
                px = slice(x - bpp, x)
                left = (cur[x - 2 * bpp:x - bpp] if x >= 2 * bpp
                        else np.zeros(bpp, np.int32))
                if kind == 3:
                    cur[px] = (cur[px] + (left + up[px]) // 2) & 0xFF
                else:
                    ul = (up[x - 2 * bpp:x - bpp] if x >= 2 * bpp
                          else np.zeros(bpp, np.int32))
                    p = left + up[px] - ul
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up[px]),
                                  np.abs(p - ul))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up[px], ul))
                    cur[px] = (cur[px] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """u8[H, W, 4] from an 8-bit, non-interlaced grey, grey-alpha, RGB or
    RGBA PNG (alpha 255 where the file has none)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(data, h, w * ch, ch).reshape(h, w, ch)
    if ch == 4:
        return px
    rgb = px[..., :1].repeat(3, axis=2) if ch in (1, 2) else px
    alpha = (px[..., 1:2] if ch == 2
             else np.full((h, w, 1), 255, np.uint8))
    return np.concatenate([rgb, alpha], axis=2)


# ----------------------------------------------------------------------- mp4

def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def save_mp4(path: str, frames, fps: int = 30) -> str:
    """Encode RGBA frames (an iterable of u8[H, W, 4]) to mp4 through an
    ``ffmpeg`` subprocess. Raises RuntimeError when no ffmpeg binary
    exists."""
    if not ffmpeg_available():
        raise RuntimeError(
            "mp4 export needs an ffmpeg binary on PATH; use PNG frames "
            "(utils.io.write_png / `render --out DIR`) instead")
    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    proc = subprocess.Popen(
        ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo",
         "-pix_fmt", "rgba", "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
         "-pix_fmt", "yuv420p", "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
         path],
        stdin=subprocess.PIPE)
    for f in frames:
        proc.stdin.write(f.tobytes())
    proc.stdin.close()
    if proc.wait() != 0:
        raise RuntimeError("ffmpeg encode failed")
    return path


# ------------------------------------------------------------ video frames

def load_gray_frames(path: str,
                     max_frames: Optional[int] = None) -> np.ndarray:
    """Grayscale frame stack u8[T, H, W] from ``.npy``/``.npz`` (the first
    array of the archive), or any container an ``ffmpeg`` binary decodes."""
    if path.endswith(".npy"):
        frames = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            frames = z[list(z.files)[0]]
    else:
        frames = _ffmpeg_decode_gray(path, max_frames)
    if frames.ndim != 3:
        raise ValueError(f"expected [T, H, W] gray frames, got {frames.shape}")
    if max_frames is not None:
        frames = frames[:max_frames]
    return frames.astype(np.uint8)


def _ffmpeg_decode_gray(path: str, max_frames: Optional[int]) -> np.ndarray:
    if not ffmpeg_available():
        raise RuntimeError(
            "no ffmpeg binary on PATH; provide frames as .npy/.npz instead")
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True)
    w, h = (int(v) for v in probe.stdout.strip().split(","))
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-f", "rawvideo",
           "-pix_fmt", "gray"]
    if max_frames is not None:
        cmd += ["-frames:v", str(max_frames)]
    cmd += ["-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    t = len(raw) // (w * h)
    return np.frombuffer(raw[: t * w * h], np.uint8).reshape(t, h, w)


def gray_frame_to_outside_mask(frame) -> np.ndarray:
    """u8[H, W] -> bool "outside" mask with the reference's > 128
    threshold (src/main.rs:416): bright pixels are outside, dark ones
    obstacles."""
    return np.asarray(frame) > 128
