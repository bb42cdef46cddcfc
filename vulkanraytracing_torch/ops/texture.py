"""Texture pool and sampling: the bindless samplers of the reference.

Counterpart of ``vulkanraytracing_tpu/ops/texture.py``.  Every texture of
a scene, at its native size (capped at ``max_size``) with a full mip chain
down to 1x1, lives in one flat (N, 4) uint8 texel tensor, addressed by
small per-(texture, level) offset and size tables.  A bilinear tap is four
texel gathers and a lerp over all rays; trilinear adds a second level;
``AnisoFootprint`` spreads trilinear taps along the footprint's major
axis.  Filtering happens in storage (sRGB) space and the shader applies
``to_linear`` afterwards, as the reference does.

The mip levels (and a texture past ``max_size``) are made by ``_resize``:
Pillow's bilinear resize of an RGBA image written out in numpy, equal to
Pillow's byte for byte.  The JAX package resizes with Pillow where it is
installed, so the port builds the JAX package's mip chains on a machine
without Pillow too.

The path tracer samples the base level (``footprint=None``).  The JAX
package also keeps a 2x2 footprint table per texel (``TexturePool.quad``)
so that a tap is one TPU row-gather: it holds the same texel values, and
the four gathers here compute with the same arithmetic, so it is not
ported.  The level tables are read with a gather, not the JAX package's
one-hot sum over the level axis: the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from vulkanraytracing_torch.utils.profiling import span

# address modes (a subset of vk::SamplerAddressMode)
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2


class TexturePool(NamedTuple):
    """All scene textures and their mip chains in one flat texel array."""

    texels: Tensor  # (N, 4) uint8, storage (sRGB for color) space
    offset: Tensor  # (K, L) i32 — first texel of (texture, level); levels
    #                 past a texture's chain repeat its last level
    width: Tensor   # (K, L) i32 — per-level widths (>= 1)
    height: Tensor  # (K, L) i32
    wrap_s: Tensor  # (K,) i32 address mode
    wrap_t: Tensor  # (K,) i32

    @property
    def count(self) -> int:
        return self.offset.shape[0]

    @property
    def max_levels(self) -> int:
        return self.offset.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)

    def to(self, device) -> "TexturePool":
        return TexturePool(*[t.to(device) for t in self])


_PRECISION_BITS = 22  # Pillow's fixed point for 8-bit resampling (32 - 8 - 2)


def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for its
    triangle filter: each output's first input and its weights (out, k) in
    22-bit fixed point, computed in float64 in Pillow's operation order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support of 1, widened when reducing
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    first = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - first
    weights = np.zeros((out_size, ksize))
    total = np.zeros(out_size)
    for x in range(ksize):  # one tap at a time: Pillow's order of the sum
        w = np.abs(((x + first) - center + 0.5) * (1.0 / filterscale))
        w = np.where((w < 1.0) & (x < count), 1.0 - w, 0.0)
        weights[:, x] = w
        total += w
    weights = np.where(total[:, None] != 0.0,
                       weights / np.where(total == 0.0, 1.0, total)[:, None], weights)
    return first, np.trunc(0.5 + weights * (1 << _PRECISION_BITS)).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis``: the weighted
    sum in fixed point with half added, shifted down and clipped."""
    in_size = img.shape[axis]
    first, kk = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    lanes = (-1,) + (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        acc += src[np.minimum(first + x, in_size - 1)] * kk[:, x].reshape(lanes)
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """RGBA u8 resize, byte for byte Pillow's ``Image.resize((w, h),
    Image.BILINEAR)`` of an RGBA image, in numpy: colour premultiplied by
    alpha (``MULDIV255``), a horizontal then a vertical pass where a side
    changes, then divided by alpha again (alpha 0 and 255 pass through)."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    alpha = img[..., 3:].astype(np.uint32)
    t = img[..., :3].astype(np.uint32) * alpha + 128
    out = np.concatenate([((t >> 8) + t) >> 8, alpha], axis=-1).astype(np.uint8)
    if out.shape[1] != w:
        out = _resample_axis(out, w, 1)
    if out.shape[0] != h:
        out = _resample_axis(out, h, 0)
    alpha = out[..., 3:].astype(np.uint32)
    color = out[..., :3].astype(np.uint32)
    straight = np.minimum(255 * color // np.maximum(alpha, 1), 255)
    color = np.where((alpha == 0) | (alpha == 255), color, straight).astype(np.uint8)
    return np.concatenate([color, out[..., 3:]], axis=-1)


def _to_rgba8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return img


def build_texture_pool(
    images: Sequence[np.ndarray],
    wrap_modes: Sequence[tuple[int, int]] | None = None,
    max_size: int = 2048,
    device="cuda",
) -> Optional[TexturePool]:
    """The flat mipped pool of (H, W, C) images at their native sizes (on
    the host with numpy, then moved to ``device`` once).  Each texture is
    downsampled only where a side exceeds ``max_size`` and gets a full mip
    chain down to 1x1."""
    if not images:
        return None
    k = len(images)
    chains: list[list[np.ndarray]] = []
    for img in images:
        img = _to_rgba8(img)
        h, w = img.shape[:2]
        if max(h, w) > max_size:
            s = max_size / max(h, w)
            w, h = max(1, int(round(w * s))), max(1, int(round(h * s)))
            img = _resize(img, w, h)
        chain = [img]
        while w > 1 or h > 1:
            w, h = max(1, w // 2), max(1, h // 2)
            chain.append(_resize(chain[-1], w, h))
        chains.append(chain)

    lmax = max(len(c) for c in chains)
    offset = np.zeros((k, lmax), np.int32)
    width = np.ones((k, lmax), np.int32)
    height = np.ones((k, lmax), np.int32)
    flat_parts = []
    base = 0
    for i, chain in enumerate(chains):
        for lv in range(lmax):
            mip = chain[min(lv, len(chain) - 1)]
            if lv < len(chain):
                flat_parts.append(mip.reshape(-1, 4))
                off = base
                base += mip.shape[0] * mip.shape[1]
            else:  # past the chain: repeat the last level's storage
                off = offset[i, lv - 1]
            offset[i, lv] = off
            height[i, lv], width[i, lv] = mip.shape[0], mip.shape[1]

    flat = np.concatenate(flat_parts, axis=0)
    if wrap_modes is None:
        wrap = np.zeros((k, 2), np.int32)
    else:
        wrap = np.asarray(wrap_modes, np.int32).reshape(k, 2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TexturePool(texels=t(flat), offset=t(offset), width=t(width), height=t(height),
                       wrap_s=t(wrap[:, 0]), wrap_t=t(wrap[:, 1]))


def _apply_wrap(x: Tensor, n: Tensor, mode: Tensor) -> Tensor:
    """Texel-index wrapping per address mode; x, n, mode broadcastable
    integer tensors."""
    rep = torch.remainder(x, n)
    clamp = torch.minimum(torch.clamp_min(x, 0), n - 1)
    period = torch.remainder(x, 2 * n)
    mirror = torch.where(period < n, period, 2 * n - 1 - period)
    return torch.where(mode == WRAP_REPEAT, rep,
                       torch.where(mode == WRAP_CLAMP, clamp, mirror))


def _bilinear(pool: TexturePool, base: Tensor, w: Tensor, h: Tensor,
              ws: Tensor, wt: Tensor, uv: Tensor) -> Tensor:
    """One bilinear tap at a given level (first texel, width, height per
    ray), (R, 4) in [0, 1]."""
    x = uv[..., 0] * w.to(torch.float32) - 0.5
    y = uv[..., 1] * h.to(torch.float32) - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    xi = x0f.to(torch.int64)
    yi = y0f.to(torch.int64)
    w, h, base = w.long(), h.long(), base.long()
    x0 = _apply_wrap(xi, w, ws)
    x1 = _apply_wrap(xi + 1, w, ws)
    y0 = _apply_wrap(yi, h, wt)
    y1 = _apply_wrap(yi + 1, h, wt)

    def fetch(yy, xx):
        return pool.texels[base + yy * w + xx].to(torch.float32) * (1.0 / 255.0)

    c00 = fetch(y0, x0)
    c10 = fetch(y0, x1)
    c01 = fetch(y1, x0)
    c11 = fetch(y1, x1)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def _level_meta(pool: TexturePool, tid: Tensor, level: Tensor):
    """(first texel, width, height) of each ray's (texture, level)."""
    return pool.offset[tid, level], pool.width[tid, level], pool.height[tid, level]


class AnisoFootprint(NamedTuple):
    """Per-ray uv-space pixel footprint as its two screen-axis derivative
    vectors, for N-tap anisotropic filtering."""

    duvdx: Tensor  # (R, 2) uv change per pixel step in x
    duvdy: Tensor  # (R, 2) uv change per pixel step in y
    taps: int      # tap count (1 = plain trilinear)


def _trilinear(pool, tid, ws, wt, uv, lod):
    """Two-level bilinear lerp at a per-ray float lod."""
    lmax = pool.max_levels - 1
    lod = torch.clamp(lod, 0.0, float(lmax))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp_max(l0 + 1, lmax)
    frac = (lod - l0.to(torch.float32))[..., None]
    c0 = _bilinear(pool, *_level_meta(pool, tid, l0), ws, wt, uv)
    c1 = _bilinear(pool, *_level_meta(pool, tid, l1), ws, wt, uv)
    return c0 * (1.0 - frac) + c1 * frac


@span("vrt.texture")
def sample_pool(pool: TexturePool, tex_id: Tensor, uv: Tensor,
                footprint: "Tensor | AnisoFootprint | None" = None) -> Tensor:
    """Filtered fetch: (R,) texture ids and (R, 2) uv -> (R, 4) in [0, 1].

    ``footprint=None`` samples the base level bilinearly (the ray tracer's
    implicit lod).  An (R,) float footprint, the uv extent of one pixel,
    gives trilinear filtering at lod = log2(footprint * texture size).  An
    ``AnisoFootprint`` gives ``taps`` trilinear taps along the major axis
    at the lod of the minor one (the ratio clamped to ``taps``).  A
    texture id < 0 samples texture 0; callers mask the result."""
    tid = torch.clamp_min(tex_id, 0).long()
    ws = pool.wrap_s[tid]
    wt = pool.wrap_t[tid]

    if footprint is None:
        return _bilinear(pool, pool.offset[tid, 0], pool.width[tid, 0],
                         pool.height[tid, 0], ws, wt, uv)

    w0 = pool.width[tid, 0].to(torch.float32)
    h0 = pool.height[tid, 0].to(torch.float32)

    if isinstance(footprint, AnisoFootprint):
        ex = footprint.duvdx * torch.stack([w0, h0], dim=1)  # texel-space axes
        ey = footprint.duvdy * torch.stack([w0, h0], dim=1)
        lx = torch.sqrt(torch.clamp_min(ex[:, 0] * ex[:, 0] + ex[:, 1] * ex[:, 1], 1e-16))
        ly = torch.sqrt(torch.clamp_min(ey[:, 0] * ey[:, 0] + ey[:, 1] * ey[:, 1], 1e-16))
        maj_len = torch.maximum(lx, ly)
        min_len = torch.minimum(lx, ly)
        taps = max(int(footprint.taps), 1)
        min_eff = torch.maximum(min_len, maj_len / float(taps))
        lod = torch.log2(torch.clamp_min(min_eff, 1e-8))
        major_uv = torch.where((lx >= ly)[:, None], footprint.duvdx, footprint.duvdy)
        acc = None
        for i in range(taps):
            off = (i + 0.5) / taps - 0.5
            c = _trilinear(pool, tid, ws, wt, uv + major_uv * off, lod)
            acc = c if acc is None else acc + c
        return acc * (1.0 / taps)

    texels = footprint * torch.maximum(w0, h0)
    lod = torch.log2(torch.clamp_min(texels, 1e-8))
    return _trilinear(pool, tid, ws, wt, uv, lod)
