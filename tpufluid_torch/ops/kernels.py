"""2D SPH smoothing kernels and the equation of state (port of
``tpufluid.ops.kernels``).

Elementwise over any shape; the math of the reference's WGSL library
(``funcs.wgsl:71-154``) with the 2D normalisations of
``src/simulation.rs:486-490``. ``h`` is a Python float: every constant
derived from it is computed once in double precision from ``h`` rounded to
f32, and rounded to f32 (``_f32``), so that h^2 is the f32 square of h, as
in the JAX functions, and a candidate at exactly r = h sits exactly on the
cutoff. Masked lanes are written with
``torch.where`` on division-safe operands, so they contribute exactly +0.0.

Divisions keep a tensor on both sides (``div``): torch turns
``scalar / tensor`` into a reciprocal times the scalar, and on a CUDA
device ``tensor / scalar`` into a product with the scalar's reciprocal,
each of which rounds twice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi


def _f32(x: float) -> float:
    """A Python float rounded to f32."""
    return float(np.float32(x))


def div(a, b) -> torch.Tensor:
    """a / b rounded once, for tensors and Python floats alike (at least
    one of them a tensor)."""
    like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full((), _f32(a), dtype=torch.float32, device=like.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), _f32(b), dtype=torch.float32, device=like.device)
    return torch.div(a, b)


def _h2(h: float) -> float:
    """h^2 as the JAX functions compute it: the f32 square of f32 h."""
    hf = _f32(h)
    return _f32(hf * hf)


def poly6(h: float, r2: torch.Tensor) -> torch.Tensor:
    """4/(pi h^8) (h^2 - r^2)^3 for r2 <= h^2, else 0 (funcs.wgsl:72-78)."""
    h2 = _h2(h)
    norm = _f32(4.0 / (PI * _f32(h)**8))
    diff = h2 - r2
    return torch.where(r2 > h2, 0.0, norm * diff * diff * diff)


def poly6_gradient(h: float, rx: torch.Tensor, ry: torch.Tensor):
    """(gx, gy): the vector gradient of poly6 at r = (rx, ry); zero at
    r = 0 and r >= h (funcs.wgsl:81-88)."""
    r_len = torch.sqrt(rx * rx + ry * ry)
    const = _f32(-24.0 / (PI * _f32(h)**8))
    diff2 = _h2(h) - r_len * r_len
    scale = const * diff2 * diff2
    bad = (r_len >= _f32(h)) | (r_len == 0.0)
    return (torch.where(bad, 0.0, scale * rx),
            torch.where(bad, 0.0, scale * ry))


def poly6_laplacian(h: float, r: torch.Tensor) -> torch.Tensor:
    """8/(pi h^8) (h^2 - r^2)(3h^2 - 4r^2) for r <= h (funcs.wgsl:91-98)."""
    h2 = _h2(h)
    const = _f32(8.0 / (PI * _f32(h)**8))
    r2 = r * r
    return torch.where(r > _f32(h), 0.0,
                       const * (h2 - r2) * (_f32(3.0 * h2) - 4.0 * r2))


def spiky_derivative(h: float, r: torch.Tensor, norm: float) -> torch.Tensor:
    """-(h - r) * norm for r <= h, norm = 12/(pi h^4) (funcs.wgsl:101-109)."""
    hf = _f32(h)
    return torch.where(r <= hf, -(hf - r) * _f32(norm), 0.0)


def viscosity(h: float, r: torch.Tensor, norm: float) -> torch.Tensor:
    """Viscosity kernel, norm = 15/(2 pi h^3) (funcs.wgsl:112-123); exactly
    ``norm`` at r = 0, the reference's special case."""
    hf = _f32(h)
    safe_r = torch.where(r == 0.0, 1.0, r)
    r2 = safe_r * safe_r
    val = _f32(norm) * (div(-(r2 * safe_r), 2.0 * hf**3) + div(r2, _h2(h))
                        + div(hf, 2.0 * safe_r) - 1.0)
    val = torch.where(r == 0.0, _f32(norm), val)
    return torch.where(r <= hf, val, 0.0)


def pressure_eos(density, pressure_constant, rest_density):
    """Linear EOS p = k (rho - rho0) (funcs.wgsl:152-154)."""
    return pressure_constant * (density - rest_density)
