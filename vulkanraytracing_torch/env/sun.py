"""The analytic sun, extracted from the HDR panorama.

Counterpart of ``vulkanraytracing_tpu/env/sun.py``: 8x8 block luminance
sums in 24-bit fixed point (value / 10000 * 0xFFFFFF, truncated), the
brightest block (the first one on a tie), its centre as a direction and
its mean as the colour, then the colour scaled down to luminance 25 at
most.  The sums are int64 here (at most 64 * 0xFFFFFF); the JAX package
sums in uint32, the same values.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.core import math3d
from vulkanraytracing_torch.core.math3d import PI
from vulkanraytracing_torch.scene.types import DirectLight

BLOCK = 8
MAX_FLOAT = 10000.0
MAX_UINT = float(0x00FFFFFF)
K_MAX_LUMINANCE = 25.0


def extract_direct_light(panorama: Tensor) -> DirectLight:
    """(H, W, 3) linear panorama -> DirectLight{direction, color} on the
    panorama's device, read back nowhere."""
    h, w = panorama.shape[0], panorama.shape[1]
    bh, bw = h // BLOCK, w // BLOCK
    crop = panorama[: bh * BLOCK, : bw * BLOCK]
    blocks = crop.reshape(bh, BLOCK, bw, BLOCK, 3).permute(0, 2, 1, 3, 4)

    lum = math3d.luminance(blocks)  # (bh, bw, 8, 8)
    q = (torch.clamp(lum / MAX_FLOAT, 0.0, 1.0) * MAX_UINT).to(torch.int64)
    block_sum = q.sum(dim=(2, 3))

    flat_idx = torch.argmax(block_sum.reshape(-1))
    by = flat_idx // bw
    bx = flat_idx % bw

    # block centre -> uv -> spherical direction
    px = bx.to(torch.float32) * BLOCK + BLOCK / 2.0
    py = by.to(torch.float32) * BLOCK + BLOCK / 2.0
    u = px / w
    v = py / h
    x = u * 2.0 - 1.0
    y = (1.0 - v) * 2.0 - 1.0
    theta = x * PI
    phi = y * PI * 0.5
    direction = torch.stack([
        torch.cos(phi) * torch.cos(theta),
        torch.sin(phi),
        torch.cos(phi) * torch.sin(theta),
    ])
    direction = -direction / torch.sqrt(math3d.dot(direction, direction))

    color = blocks[by, bx].mean(dim=(0, 1))  # the 8x8 box: a level-3 sample
    color = color / torch.clamp_min(math3d.luminance(color) / K_MAX_LUMINANCE, 1.0)

    zero = torch.zeros((1,), dtype=torch.float32, device=panorama.device)
    return DirectLight(direction=torch.cat([direction, zero]),
                       color=torch.cat([color, zero + 1.0]))

