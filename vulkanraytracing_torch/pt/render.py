"""Progressive frame rendering and accumulation state.

Counterpart of ``vulkanraytracing_tpu/pt/render.py``: pixels are traced in
16x16-tile order, each frame's tone-mapped sample is averaged into the
accumulator, ``(value + n * last) / (n + 1)``, and with
``cfg.parity_quantization`` the result makes the RGBA8 round trip that
feeds the next frame.  The JAX package maps over ray chunks inside one
jit; here a Python loop runs the chunks (a 1080p frame is one chunk at the
default ``ray_chunk_size``).

``render_span`` is ``n`` frames whose ray count is summed on the device,
and ``render_progressive`` is one span of ``spp`` frames.  In the JAX
package a span is one jit dispatch and ``VRT_SPAN`` sets its length; here
a span is a loop of frames, so its length would change nothing and there
is no such option.  Pixel
rows ``[row0, row0 + rows)`` of a frame (``trace_rows``) are what one
device of ``parallel.shard_render_frame`` traces: each pixel's random
numbers come from its absolute coordinates, so a frame split into row
blocks equals the whole frame bit for bit.
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


def tile_pixel_coords(width: int, rows: int, row0: int = 0, device="cuda"):
    """Pixel coordinates in 16x16-tile order, covering rows [row0, row0 +
    rows) padded up to whole tiles.  Returns (px, py, valid, tiles_y,
    tiles_x); px and py are int64."""
    tx = -(-width // TILE)
    ty = -(-rows // TILE)
    t = torch.arange(tx * ty * TILE * TILE, dtype=torch.int64, device=device)
    tile = t >> 8
    lane = t & 255
    px = (tile % tx) * TILE + (lane & 15)
    py = row0 + (tile // tx) * TILE + (lane >> 4)
    valid = (px < width) & (py < row0 + rows)
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


def trace_rows(scene: Scene, cfg: Config, camera: CameraPT, sample_index: int,
               device, row0: int = 0, rows: int | None = None) -> tuple[Tensor, Tensor]:
    """One tone-mapped sample of each pixel of rows [row0, row0 + rows)
    (all rows by default) at ``sample_index``, on ``device``: the (rows,
    width, 3) image and the ray count (int64, on the device)."""
    h, w = cfg.height, cfg.width
    rows = h - row0 if rows is None else rows
    px, py, valid, ty, tx = tile_pixel_coords(w, rows, row0, device=device)
    total = px.shape[0]
    chunk = min(max(cfg.ray_chunk_size, TILE * TILE), total)
    chunk -= chunk % (TILE * TILE)

    colors, rays = [], torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, total, chunk):
        sl = slice(start, start + chunk)
        color, stats = pathtrace(scene, cfg, camera, px[sl], py[sl], w, h,
                                 sample_index, valid=valid[sl])
        colors.append(color)
        rays = rays + stats.rays
    return untile_image(torch.cat(colors), w, rows, ty, tx), rays


def accumulate(value: Tensor, accumulation: Tensor, count: float, weight: float,
               cfg: Config) -> Tensor:
    """Fold ``weight`` samples whose sum is ``value`` into an accumulator
    of ``count`` samples: ``(value + count * last) / (count + weight)``,
    then the RGBA8 round trip under ``cfg.parity_quantization``."""
    result = (value + count * accumulation) / (count + weight)
    if cfg.parity_quantization:
        result = _quantize_rgb8(result)
    return result


def render_frame(
    scene: Scene, cfg: Config, camera: CameraPT, state: RenderState
) -> tuple[RenderState, TraceStats]:
    """Trace one progressive sample per pixel and fold it into the
    accumulator.  The new state's ``accumulation`` is the display image."""
    value, rays = trace_rows(scene, cfg, camera, state.accum_index,
                             state.accumulation.device)
    result = accumulate(value, state.accumulation, float(state.accum_index), 1.0, cfg)
    new_state = RenderState(accumulation=result,
                            accum_index=(state.accum_index + 1) & _M32)
    return new_state, TraceStats(rays=rays)


def render_span(
    scene: Scene, cfg: Config, camera: CameraPT, state: RenderState, n: int
) -> tuple[RenderState, TraceStats]:
    """``n`` progressive frames; their ray count is summed on the device
    (nothing is read back).  The same frames as ``n`` calls of
    ``render_frame``, bit for bit."""
    rays = torch.zeros((), dtype=torch.int64, device=state.accumulation.device)
    for _ in range(n):
        state, stats = render_frame(scene, cfg, camera, state)
        rays = rays + stats.rays
    return state, TraceStats(rays=rays)


def render_progressive(
    scene: Scene, cfg: Config, camera: CameraPT, spp: int,
    state: RenderState | None = None,
) -> tuple[RenderState, float]:
    """Accumulate ``spp`` progressive frames (one ``render_span``); returns
    (state, total rays), the ray count read once at the end."""
    if state is None:
        state = create_render_state(cfg, camera.inverse_view.device)
    state, stats = render_span(scene, cfg, camera, state, spp)
    return state, float(stats.rays)


def to_display(state: RenderState, cfg: Config | None = None) -> np.ndarray:
    """Accumulated image -> uint8 HxWx3 (the curve is applied here only in
    linear-HDR mode)."""
    img = state.accumulation
    if cfg is not None and not cfg.tone_map_before_accumulation:
        from vulkanraytracing_torch.core.math3d import tone_mapping

        img = tone_mapping(img)
    img = img.detach().cpu().numpy()
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
