"""Counter-style vectorized xoroshiro64** RNG, bit-compatible with the
reference's GLSL sampler and with ``vulkanraytracing_tpu.core.rng``.

State is a pair of int64 tensors holding uint32 values (one stream per
ray).  torch has no uint32 shift or add on the CPU, so every operation
runs on int64 and is masked back to 32 bits; products are split so no
intermediate leaves the int64 range.
"""

from __future__ import annotations

import torch
from torch import Tensor

M32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2^32 for x < 2^32: c is split into 16-bit halves so each
    partial product stays below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl(x: Tensor, k: int) -> Tensor:
    return ((x << k) & M32) | (x >> (32 - k))


def wang_hash(x: Tensor) -> Tensor:
    """Thomas Wang 32-bit integer hash."""
    x = x.to(torch.int64) & M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 4)
    x = _mul32(x, 0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def rand_uint(s0: Tensor, s1: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """One xoroshiro64** draw. Returns (bits, s0', s1')."""
    result = _mul32(_rotl(_mul32(s0, 0x9E3779BB), 5), 5)
    s1 = s1 ^ s0
    s0 = _rotl(s0, 26) ^ s1 ^ ((s1 << 9) & M32)
    s1 = _rotl(s1, 13)
    return result, s0, s1


def next_float(s0: Tensor, s1: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Uniform float32 in [0, 1) via the 0x3F800000 mantissa trick."""
    bits, s0, s1 = rand_uint(s0, s1)
    u = (0x3F800000 | (bits >> 9)).to(torch.int32)
    return u.view(torch.float32) - 1.0, s0, s1


def next_vec2(s0: Tensor, s1: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    a, s0, s1 = next_float(s0, s1)
    b, s0, s1 = next_float(s0, s1)
    return torch.stack([a, b], dim=-1), s0, s1


def next_vec3(s0: Tensor, s1: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    a, s0, s1 = next_float(s0, s1)
    b, s0, s1 = next_float(s0, s1)
    c, s0, s1 = next_float(s0, s1)
    return torch.stack([a, b, c], dim=-1), s0, s1


def pixel_seed(x: Tensor, y: Tensor, frame_index: int) -> tuple[Tensor, Tensor]:
    """Per-pixel per-frame seeding: s0 = wang((x << 16) | y),
    s1 = wang(frame), then one discarded draw."""
    x = x.to(torch.int64) & M32
    y = y.to(torch.int64) & M32
    s0 = wang_hash(((x << 16) & M32) | y)
    s1 = wang_hash(torch.full_like(s0, int(frame_index) & M32))
    _, s0, s1 = rand_uint(s0, s1)
    return s0, s1
