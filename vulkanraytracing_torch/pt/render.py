"""Progressive frame rendering and accumulation state.

Counterpart of ``vulkanraytracing_tpu/pt/render.py``: pixels are traced in
16x16-tile order, each frame's tone-mapped sample is averaged into the
accumulator, ``(value + n * last) / (n + 1)``, and with
``cfg.parity_quantization`` the result makes the RGBA8 round trip that
feeds the next frame.  The JAX package maps over ray chunks inside one
jit; here a Python loop runs the chunks (a 1080p frame is one chunk at the
default ``ray_chunk_size``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from vulkanraytracing_torch.config import Config
from vulkanraytracing_torch.pt.integrator import TraceStats, pathtrace
from vulkanraytracing_torch.scene.camera import CameraPT
from vulkanraytracing_torch.scene.types import Scene

TILE = 16  # pixels per tile side
_M32 = 0xFFFFFFFF


def tile_pixel_coords(width: int, rows: int, device="cuda"):
    """Pixel coordinates in 16x16-tile order, covering rows [0, rows)
    padded up to whole tiles.  Returns (px, py, valid, tiles_y, tiles_x);
    px and py are int64."""
    tx = -(-width // TILE)
    ty = -(-rows // TILE)
    t = torch.arange(tx * ty * TILE * TILE, dtype=torch.int64, device=device)
    tile = t >> 8
    lane = t & 255
    px = (tile % tx) * TILE + (lane & 15)
    py = (tile // tx) * TILE + (lane >> 4)
    valid = (px < width) & (py < rows)
    return px, py, valid, ty, tx


def untile_image(colors: Tensor, width: int, rows: int, ty: int, tx: int) -> Tensor:
    """(N, 3) tile-ordered colors -> (rows, width, 3) image crop."""
    img = colors.reshape(ty, tx, TILE, TILE, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(ty * TILE, tx * TILE, 3)
    return img[:rows, :width]


class RenderState(NamedTuple):
    """Progressive accumulation state."""

    accumulation: Tensor  # (H, W, 3) f32 tone-mapped running average
    accum_index: int      # frames accumulated so far (uint32, wraps)


def create_render_state(cfg: Config, device="cuda") -> RenderState:
    return RenderState(
        accumulation=torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                                 device=device),
        accum_index=0,
    )


def reset_accumulation(state: RenderState) -> RenderState:
    """Start accumulating anew (camera move, resize, reload, moved
    instances)."""
    return RenderState(accumulation=torch.zeros_like(state.accumulation),
                       accum_index=0)


def _quantize_rgb8(x: Tensor) -> Tensor:
    """RGBA8 storage round trip (UNORM: round(clamp(x) * 255) / 255)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0


def render_frame(
    scene: Scene, cfg: Config, camera: CameraPT, state: RenderState
) -> tuple[RenderState, TraceStats]:
    """Trace one progressive sample per pixel and fold it into the
    accumulator.  The new state's ``accumulation`` is the display image."""
    h, w = cfg.height, cfg.width
    device = state.accumulation.device
    px, py, valid, ty, tx = tile_pixel_coords(w, h, device=device)
    total = px.shape[0]
    chunk = min(max(cfg.ray_chunk_size, TILE * TILE), total)
    chunk -= chunk % (TILE * TILE)

    colors, rays = [], torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, total, chunk):
        sl = slice(start, start + chunk)
        color, stats = pathtrace(scene, cfg, camera, px[sl], py[sl], w, h,
                                 state.accum_index, valid=valid[sl])
        colors.append(color)
        rays = rays + stats.rays
    value = untile_image(torch.cat(colors), w, h, ty, tx)

    n = float(state.accum_index)
    result = (value + n * state.accumulation) / (n + 1.0)
    if cfg.parity_quantization:
        result = _quantize_rgb8(result)
    new_state = RenderState(accumulation=result,
                            accum_index=(state.accum_index + 1) & _M32)
    return new_state, TraceStats(rays=rays)


def render_progressive(
    scene: Scene, cfg: Config, camera: CameraPT, spp: int,
    state: RenderState | None = None,
) -> tuple[RenderState, float]:
    """Accumulate ``spp`` progressive frames; returns (state, total rays).
    The ray count is summed on the device and read once at the end."""
    if state is None:
        state = create_render_state(cfg, camera.inverse_view.device)
    total_rays = torch.zeros((), dtype=torch.int64,
                             device=state.accumulation.device)
    for _ in range(spp):
        state, stats = render_frame(scene, cfg, camera, state)
        total_rays = total_rays + stats.rays
    return state, float(total_rays)


def to_display(state: RenderState, cfg: Config | None = None) -> np.ndarray:
    """Accumulated image -> uint8 HxWx3 (the curve is applied here only in
    linear-HDR mode)."""
    img = state.accumulation
    if cfg is not None and not cfg.tone_map_before_accumulation:
        from vulkanraytracing_torch.core.math3d import tone_mapping

        img = tone_mapping(img)
    img = img.detach().cpu().numpy()
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
