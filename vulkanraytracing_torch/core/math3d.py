"""Vectorized shading math shared by the path tracer.

Counterpart of ``vulkanraytracing_tpu/core/math3d.py`` with the same
constants and formulas.  Vectors are ``(..., 3)`` tensors.  Dot products,
cross products and small matrix-vector products are written as explicit
component sums, left to right, so that the CPU and the card evaluate them
in one operation order (``torch.sum`` and ``einsum`` reduce in an order
that differs between devices).
"""

from __future__ import annotations

import torch
from torch import Tensor

EPSILON = 1e-6
BIAS = 5e-3
PI = 3.141592654
INVERSE_PI = 0.31830988618

RAY_MIN_T = 1e-3
RAY_MAX_T = 1e3


def dot(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v: Tensor) -> Tensor:
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), 1e-30))[..., None]


def cross(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def reflect(i: Tensor, n: Tensor) -> Tensor:
    """GLSL reflect: i - 2*dot(n, i)*n."""
    return i - 2.0 * dot(n, i)[..., None] * n


def mix(a: Tensor, b: Tensor, t) -> Tensor:
    return a + (b - a) * t


def rcp(x: Tensor) -> Tensor:
    """Reciprocal with 1e10 at zero."""
    zero = x == 0.0
    return torch.where(zero, 1e10, 1.0 / torch.where(zero, 1.0, x))


def max_component(v: Tensor) -> Tensor:
    return torch.amax(v, dim=-1)


def bary_lerp(a: Tensor, b: Tensor, c: Tensor, bary: Tensor) -> Tensor:
    """bary = (1-u-v, u, v)."""
    return a * bary[..., 0:1] + b * bary[..., 1:2] + c * bary[..., 2:3]


# TBN is (..., 3, 3) with COLUMNS (T, B, N): TBN[..., :, 0] = T.


def get_tbn_from_nt(n: Tensor, t: Tensor) -> Tensor:
    """Gram-Schmidt frame from shading normal + tangent."""
    t = normalize(t - dot(t, n)[..., None] * n)
    b = cross(n, t)
    return torch.stack([t, b, n], dim=-1)


def get_tbn_from_n(n: Tensor) -> Tensor:
    """Frame from normal only: T = N x Y, falling back to N x X when
    degenerate."""
    unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    unit_y = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    t = cross(n, unit_y.expand_as(n))
    fallback = cross(n, unit_x.expand_as(n))
    degenerate = dot(t, t) < EPSILON
    t = normalize(torch.where(degenerate[..., None], fallback, t))
    b = normalize(cross(n, t))
    return torch.stack([t, b, n], dim=-1)


def tangent_to_world(v: Tensor, tbn: Tensor) -> Tensor:
    """TBN @ v."""
    return (
        tbn[..., :, 0] * v[..., 0:1]
        + tbn[..., :, 1] * v[..., 1:2]
        + tbn[..., :, 2] * v[..., 2:3]
    )


def world_to_tangent(v: Tensor, tbn: Tensor) -> Tensor:
    """v @ TBN = TBN^T v."""
    return (
        tbn[..., 0, :] * v[..., 0:1]
        + tbn[..., 1, :] * v[..., 1:2]
        + tbn[..., 2, :] * v[..., 2:3]
    )


def cos_theta_tangent(v: Tensor) -> Tensor:
    """max(v.z, 0)."""
    return torch.clamp_min(v[..., 2], 0.0)


def luminance(color: Tensor) -> Tensor:
    """Rec.709 luma."""
    return color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722


def to_srgb(linear: Tensor) -> Tensor:
    higher = 1.055 * torch.pow(torch.clamp_min(linear, 1e-10), 1.0 / 2.4) - 0.055
    lower = linear * 12.92
    return torch.where(linear < 0.0031308, lower, higher)


def to_linear(srgb: Tensor) -> Tensor:
    higher = torch.pow((srgb + 0.055) / 1.055, 2.4)
    lower = srgb / 12.92
    return torch.where(srgb < 0.04045, lower, higher)


def tone_mapping(linear: Tensor) -> Tensor:
    """Hejl/Burgess-Dawson filmic curve with built-in sRGB."""
    x = torch.clamp_min(linear - 0.004, 0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def uncharted_tone_mapping(linear: Tensor) -> Tensor:
    """The Uncharted 2 filmic curve, white point 11.2 (in the reference
    renderer's shader library, unused by its renderer)."""
    a, b, c, d, e, f, wp = 0.22, 0.30, 0.10, 0.20, 0.01, 0.30, 11.2

    def curve(x):
        return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f

    return curve(linear) / curve(torch.tensor(wp, dtype=linear.dtype, device=linear.device))


def pow5(x: Tensor) -> Tensor:
    """x**5 as x * ((x*x)*(x*x)) — the multiplication order of
    ``jax.lax.integer_pow``."""
    x2 = x * x
    return x * (x2 * x2)


_M32 = 0xFFFFFFFF


def reverse_bits32(bits: Tensor) -> Tensor:
    """Bit reversal of 32-bit words.  uint32 values live in int64 masked to
    32 bits, as in ``core.rng``: torch has no uint32 shifts on the CPU."""
    bits = bits.to(torch.int64) & _M32
    bits = ((bits << 16) | (bits >> 16)) & _M32
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return bits


def hammersley(i: Tensor, n: int) -> Tensor:
    """The i-th of n Hammersley points, (..., 2)."""
    e1 = torch.remainder(i.to(torch.float32) / n, 1.0)
    e2 = reverse_bits32(i).to(torch.float32) * 2.3283064365386963e-10
    return torch.stack([e1, e2], dim=-1)


def cosine_sample_hemisphere(e: Tensor) -> Tensor:
    """e is (..., 2); returns (..., 3) in tangent space (+Z up)."""
    phi = 2.0 * PI * e[..., 0]
    cos_theta = torch.sqrt(e[..., 1])
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def cosine_pdf_hemisphere(cos_theta: Tensor) -> Tensor:
    return cos_theta * INVERSE_PI


def power_heuristic(pdf_a: Tensor, pdf_b: Tensor) -> Tensor:
    """Veach's power heuristic, exponent 2 (in the reference renderer's
    shader library, unused by its renderer)."""
    f = pdf_a * pdf_a
    g = pdf_b * pdf_b
    return f / (f + g)
