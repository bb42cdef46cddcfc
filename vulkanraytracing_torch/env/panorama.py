"""Equirectangular environment sampling and the cube maps of the IBL.

Counterpart of ``vulkanraytracing_tpu/env/panorama.py``: the same
direction -> uv mapping (with its Y negation) and the same bilinear
filter, wrap in u and clamp in v; the cube faces' frames, the direction
-> (face, uv) inversion, bilinear cube sampling clamped at each face's
edges, trilinear sampling across a prefiltered mip chain, and the
panorama resampled into a cube.  Every fetch is a gather.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.core import math3d
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


# the cube faces' frames: normal, tangent (u) and bitangent (v)
_FACES_N = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
_FACES_T = ((0, 0, -1), (0, 0, 1), (1, 0, 0), (1, 0, 0), (1, 0, 0), (-1, 0, 0))
_FACES_B = ((0, -1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1), (0, -1, 0), (0, -1, 0))


def _faces(rows, device) -> Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=device)


def cube_direction(face: int, uv: Tensor) -> Tensor:
    """uv in [0, 1]^2 on a cube face -> unit direction N + (2u-1) T +
    (2v-1) B, normalized."""
    st = uv * 2.0 - 1.0
    n, t, b = (_faces(rows[face], uv.device) for rows in (_FACES_N, _FACES_T, _FACES_B))
    d = n + st[..., 0:1] * t + st[..., 1:2] * b
    return d / torch.sqrt(math3d.dot(d, d))[..., None]


def cube_face_uv(direction: Tensor) -> tuple[Tensor, Tensor]:
    """Direction -> (face, uv) for cube sampling, the inverse of
    ``cube_direction``'s face frames (the major axis picks the face)."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    x_major = (ax >= ay) & (ax >= az)
    y_major = ay >= az
    face = torch.where(
        x_major, torch.where(x >= 0, 0, 1),
        torch.where(y_major, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)))
    major = torch.where(x_major, ax, torch.where(y_major, ay, az))
    inv = 1.0 / torch.clamp_min(major, 1e-20)
    dn = direction * inv[..., None]
    s = math3d.dot(dn, _faces(_FACES_T, direction.device)[face])
    t = math3d.dot(dn, _faces(_FACES_B, direction.device)[face])
    uv = torch.stack([(s + 1.0) * 0.5, (t + 1.0) * 0.5], dim=-1)
    return face, uv


def sample_cube(cube: Tensor, direction: Tensor) -> Tensor:
    """Bilinear sample of a (6, S, S, C) cube, clamped at each face's
    edges (no filtering across seams)."""
    face, uv = cube_face_uv(direction)
    s = cube.shape[1]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.long(), 0, s - 1)
    x1i = torch.clamp(x0i + 1, 0, s - 1)
    y0i = torch.clamp(y0.long(), 0, s - 1)
    y1i = torch.clamp(y0i + 1, 0, s - 1)
    flat = cube.reshape(-1, cube.shape[-1])
    base = face * (s * s)
    c00 = flat[base + y0i * s + x0i]
    c10 = flat[base + y0i * s + x1i]
    c01 = flat[base + y1i * s + x0i]
    c11 = flat[base + y1i * s + x1i]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_cube_mips(mips: tuple, direction: Tensor, lod: Tensor) -> Tensor:
    """Trilinear sample across a prefiltered mip chain of (6, s, s, C)
    cubes at a per-ray ``lod`` (the hybrid IBL reflection lookup)."""
    n = len(mips)
    lod = torch.clamp(lod, 0.0, float(n - 1))
    lo = torch.floor(lod).long()
    frac = (lod - lo.to(torch.float32))[..., None]
    samples = torch.stack([sample_cube(m, direction) for m in mips], dim=0)  # (n, ..., C)

    def take(idx):
        return samples.gather(0, idx[None, ..., None].expand(1, *samples.shape[1:]))[0]

    return take(lo) * (1.0 - frac) + take(torch.clamp_max(lo + 1, n - 1)) * frac


def cube_face_uvs(size: int, device) -> Tensor:
    """Texel-centre uvs of a size x size face, (size, size, 2), u along
    the rows."""
    ji = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    v, u = torch.meshgrid(ji, ji, indexing="ij")
    return torch.stack([u, v], dim=-1)


def panorama_to_cube(env: Environment, size: int) -> Tensor:
    """The panorama resampled into a (6, size, size, 3) cube."""
    uv = cube_face_uvs(size, env.panorama.device)
    return torch.stack([sample_bilinear_wrap(env.panorama, panorama_uv(cube_direction(f, uv)))
                        for f in range(6)], dim=0)
