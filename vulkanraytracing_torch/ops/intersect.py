"""Ray-triangle intersection (Moller-Trumbore, and the plane test of the
BVH8 traversal's plane records) and the brute-force oracle.

Counterpart of ``vulkanraytracing_tpu/ops/intersect.py``.  Two query
kinds: ``intersect_closest_brute`` (material rays; back faces culled
unless the triangle is double-sided) and ``intersect_any_brute``
(visibility; no culling).  Front faces are counter-clockwise from the ray
origin: det = e1 . (d x e2) > 0; a hit with det < 0 is a back-face hit.

``moller_trumbore`` writes every dot and cross product as explicit
component sums, in the operation order of the BVH8 traversal kernel
(``csrc/bvh8_traverse.cuh``), so the oracle, the kernel and its plain
version round identically and equal-t ties cannot flip between them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch.core import math3d
from vulkanraytracing_torch.scene.types import TraceGeometry

BIG_T = 3.0e38
DET_EPS = 1e-20


class Hit(NamedTuple):
    """Closest-hit record."""

    t: Tensor         # (R,) f32 — hit distance; >= BIG_T => miss
    u: Tensor         # (R,) f32 — barycentric u
    v: Tensor         # (R,) f32 — barycentric v
    tri: Tensor       # (R,) i32 — BVH-order triangle id (0 on a miss)
    backface: Tensor  # (R,) bool — hit the back side (det < 0)

    @property
    def is_hit(self) -> Tensor:
        return self.t < BIG_T

    @property
    def is_miss(self) -> Tensor:
        return self.t >= BIG_T


def moller_trumbore(o: Tensor, d: Tensor, v0: Tensor, e1: Tensor, e2: Tensor,
                    det_eps: float = DET_EPS):
    """Raw Moller-Trumbore over broadcastable (..., 3) inputs.  Returns
    (t, u, v, det); the caller applies windows, culling and validity.
    ``det_eps`` guards the reciprocal of det (the packet kernels use
    1e-30)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det.abs() < det_eps, 1.0, det)
    tvx = ox - v0[..., 0]
    tvy = oy - v0[..., 1]
    tvz = oz - v0[..., 2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return t, u, v, det


def plane_test(o: Tensor, d: Tensor, n: Tensor, dn: Tensor, up: Tensor, uc: Tensor,
               vp: Tensor, vc: Tensor, det_eps: float = DET_EPS):
    """The plane ("Woop") leaf test over plane records
    (``ops.traverse_wide8.woop_records``): the geometric plane n.x + dn
    and the barycentric planes up.x + uc, vp.x + vc, with (..., 3) normals
    and (...,) offsets.  In the operation order of the JAX package's woop
    branch (``vulkanraytracing_tpu/ops/traverse_wide8.py:530-552``) and of
    ``csrc/bvh8_traverse.cuh::test_triangle_plane``: den = n.d,
    t = -(n.o + dn) / den, p = o + t d, u = up.p + uc, v = vp.p + vc.
    Returns (t, u, v, det) with det = -den, Moller-Trumbore's det for the
    same triangle, so that the caller's verdicts are MT's: |det| > eps,
    front face det > eps, back face det < 0."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    den = nx * dx + ny * dy + nz * dz
    num = -(nx * ox + ny * oy + nz * oz + dn)
    inv = 1.0 / torch.where(den.abs() < det_eps, 1.0, den)
    t = num * inv
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = up[..., 0] * px + up[..., 1] * py + up[..., 2] * pz + uc
    v = vp[..., 0] * px + vp[..., 1] * py + vp[..., 2] * pz + vc
    return t, u, v, -den


def intersect_closest_brute(
    geom: TraceGeometry,
    o: Tensor,
    d: Tensor,
    t_min: Tensor,
    t_max: Tensor,
    cull_backface: bool = True,
    tile: int = 512,
) -> Hit:
    """Closest hit over all triangles, in tiles of ``tile`` triangles.
    Equal-t ties go to the lowest triangle id (first minimum in a tile,
    strict ``<`` across tiles)."""
    r = o.shape[0]
    dev = o.device
    bt = torch.full((r,), BIG_T, dtype=torch.float32, device=dev)
    bu = torch.zeros((r,), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    btri = torch.zeros((r,), dtype=torch.int32, device=dev)
    bdet = torch.ones_like(bu)
    rows = torch.arange(r, device=dev)
    for start in range(0, geom.num_triangles, tile):
        sl = slice(start, start + tile)
        t, u, v, det = moller_trumbore(
            o[:, None, :], d[:, None, :],
            geom.v0[None, sl], geom.e1[None, sl], geom.e2[None, sl],
        )
        valid = det.abs() > DET_EPS
        if cull_backface:
            valid &= (det > DET_EPS) | geom.cull_disable[None, sl]
        valid &= (geom.opaque[sl] | geom.alpha_test[sl])[None, :]
        valid &= (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        valid &= (t >= t_min[:, None]) & (t <= t_max[:, None])
        t = torch.where(valid, t, BIG_T)
        best = torch.argmin(t, dim=1)
        tt = t[rows, best]
        closer = tt < bt
        bt = torch.where(closer, tt, bt)
        bu = torch.where(closer, u[rows, best], bu)
        bv = torch.where(closer, v[rows, best], bv)
        btri = torch.where(closer, (best + start).to(torch.int32), btri)
        bdet = torch.where(closer, det[rows, best], bdet)
    return Hit(t=bt, u=bu, v=bv, tri=btri, backface=bdet < 0.0)


def intersect_any_brute(
    geom: TraceGeometry, o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor,
    tile: int = 512,
) -> Tensor:
    """Visibility: does any candidate triangle block [t_min, t_max]?"""
    hit = intersect_closest_brute(geom, o, d, t_min, t_max,
                                  cull_backface=False, tile=tile)
    return hit.is_hit


class SurfaceAttributes(NamedTuple):
    """Interpolated hit attributes."""

    normal: Tensor       # (R, 3) world-space shading normal (backface-flipped)
    tangent: Tensor      # (R, 3) world-space tangent
    uv: Tensor           # (R, 2)
    material_id: Tensor  # (R,) i32


def fetch_surface_attributes(geom: TraceGeometry, hit: Hit) -> SurfaceAttributes:
    """Barycentric attribute interpolation with (1-u-v, u, v), normalized,
    with the shading normal flipped on back-face hits."""
    tri = hit.tri.long()
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    n = math3d.bary_lerp(geom.n0[tri], geom.n1[tri], geom.n2[tri], bary)
    t = math3d.bary_lerp(geom.t0[tri], geom.t1[tri], geom.t2[tri], bary)
    uv = math3d.bary_lerp(geom.uv0[tri], geom.uv1[tri], geom.uv2[tri], bary)
    n = math3d.normalize(n)
    n = torch.where(hit.backface[..., None], -n, n)
    return SurfaceAttributes(
        normal=n, tangent=math3d.normalize(t), uv=uv,
        material_id=geom.material_id[tri],
    )
