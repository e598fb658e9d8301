"""Xorshift32 PRNG on tensors (port of ``tpufluid.ops.prng`` and the
tie-break helpers of ``tpufluid.ops.pallas.sph``).

torch has no uint32 shifts or adds on the CPU, so a uint32 value is held
in an int64 tensor in [0, 2^32) and every step is masked back to 32 bits.
An int64 product of two such values may wrap, but its low 32 bits are
still the uint32 product, which is all the mask keeps.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> its uint32 value held in int64."""
    return x.to(torch.int64) & U32


def bitcast_u32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the uint32 of its bits (held in int64)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & U32


def xorshift32(x: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (funcs.wgsl:129-137)."""
    x = u32(x)
    x = x ^ ((x << 13) & U32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & U32)
    return x


def u32_to_uniform01(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 in [0, 1) by dividing by 2^32 (funcs.wgsl:139-142)."""
    return x.to(torch.float32) / 4294967296.0


def position_seed(points: torch.Tensor) -> torch.Tensor:
    """Seed from position bits: f32[..., 2] -> uint32[...] (in int64)."""
    bits = bitcast_u32(points)
    return (((bits[..., 0] * 0x9E3779B1) & U32)
            ^ ((bits[..., 1] * 0x85EBCA6B) & U32))


def rand_unit_vector(seed: torch.Tensor) -> torch.Tensor:
    """First two draws of the chain -> normalized 2D direction [..., 2]."""
    s1 = xorshift32(seed)
    s2 = xorshift32(s1)
    v = torch.stack([u32_to_uniform01(s1), u32_to_uniform01(s2)], dim=-1)
    norm = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
    safe = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    return v / safe
