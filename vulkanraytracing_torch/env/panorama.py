"""Equirectangular environment sampling.

Counterpart of ``vulkanraytracing_tpu/env/panorama.py``: the same
direction -> uv mapping (with its Y negation) and the same bilinear
filter, wrap in u and clamp in v.  Cube sampling (IBL) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.scene.types import Environment


def panorama_uv(direction: Tensor) -> Tensor:
    """Direction -> equirect uv."""
    x = direction[..., 0]
    y = -direction[..., 1]
    z = direction[..., 2]
    u = torch.atan2(z, x) * 0.1591 + 0.5
    v = torch.asin(torch.clamp(y, -1.0, 1.0)) * 0.3183 + 0.5
    return torch.stack([u, v], dim=-1)


def sample_bilinear_wrap(image: Tensor, uv: Tensor) -> Tensor:
    """Bilinear sample of an (H, W, C) image; wrap in u, clamp in v; v = 0
    is the top row."""
    h, w = image.shape[0], image.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00 = image[y0i, x0i]
    c10 = image[y0i, x1i]
    c01 = image[y1i, x0i]
    c11 = image[y1i, x1i]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_environment(env: Environment, direction: Tensor) -> Tensor:
    """Radiance arriving from ``direction`` (the miss lookup)."""
    return sample_bilinear_wrap(env.panorama, panorama_uv(direction))
