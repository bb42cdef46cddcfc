"""Scene representation: NamedTuples and dataclasses of torch tensors.

Counterpart of ``vulkanraytracing_tpu/scene/types.py``: flat world-space
triangle soup indexed by a global triangle id, SOA materials, point
lights with colour pre-multiplied by intensity, and the BVH arrays.  Every
container has ``to(device)``; nothing here holds global device state.
The constructors put their tensors on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor


def _to(obj, device):
    return type(obj)(*[
        None if f is None else f.to(device) if hasattr(f, "to") else f
        for f in obj
    ])


class TraceGeometry(NamedTuple):
    v0: Tensor  # (T, 3) f32 — first vertex
    e1: Tensor  # (T, 3) f32 — v1 - v0
    e2: Tensor  # (T, 3) f32 — v2 - v0
    n0: Tensor  # (T, 3) f32 — per-corner shading normals
    n1: Tensor
    n2: Tensor
    t0: Tensor  # (T, 3) f32 — per-corner tangents
    t1: Tensor
    t2: Tensor
    uv0: Tensor  # (T, 2) f32
    uv1: Tensor
    uv2: Tensor
    material_id: Tensor   # (T,) i32
    cull_disable: Tensor  # (T,) bool — double-sided: no back-face cull
    opaque: Tensor        # (T,) bool — a hit commits without an alpha test
    alpha_test: Tensor    # (T,) bool — needs a texture alpha test

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def to(self, device) -> "TraceGeometry":
        return _to(self, device)

    def take(self, index: Tensor) -> "TraceGeometry":
        return TraceGeometry(*[f[index] for f in self])


class Materials(NamedTuple):
    base_color_factor: Tensor           # (M, 4) f32
    emission_factor: Tensor             # (M, 4) f32
    roughness_factor: Tensor            # (M,) f32
    metallic_factor: Tensor             # (M,) f32
    normal_scale: Tensor                # (M,) f32
    alpha_cutoff: Tensor                # (M,) f32
    base_color_texture: Tensor          # (M,) i32, -1 = none
    roughness_metallic_texture: Tensor  # (M,) i32
    normal_texture: Tensor              # (M,) i32
    emission_texture: Tensor            # (M,) i32
    occlusion_texture: Tensor           # (M,) i32

    @property
    def count(self) -> int:
        return self.base_color_factor.shape[0]

    def to(self, device) -> "Materials":
        return _to(self, device)


class PointLights(NamedTuple):
    position: Tensor  # (L, 4) f32
    color: Tensor     # (L, 4) f32, rgb pre-multiplied by intensity

    @property
    def count(self) -> int:
        return self.position.shape[0]

    def to(self, device) -> "PointLights":
        return _to(self, device)


class DirectLight(NamedTuple):
    direction: Tensor  # (4,) f32 — the direction the light travels
    color: Tensor      # (4,) f32

    def to(self, device) -> "DirectLight":
        return _to(self, device)


class Environment(NamedTuple):
    """The HDR panorama and, once ``env.ibl.bake_ibl`` has run, the hybrid
    mode's image-based lighting: irradiance cube, GGX-prefiltered
    reflection mips (mip m at roughness m / (mips - 1)) and the split-sum
    BRDF table."""

    panorama: Tensor  # (H, W, 3) f32 linear radiance, equirectangular
    irradiance: Optional[Tensor] = None  # (6, S, S, 3)
    reflection: Optional[tuple] = None   # (6, s, s, 3) mips, largest first
    brdf_lut: Optional[Tensor] = None    # (S, S, 2) scale, offset

    def to(self, device) -> "Environment":
        reflection = self.reflection
        if reflection is not None:
            reflection = tuple(m.to(device) for m in reflection)
        return Environment(self.panorama.to(device),
                           None if self.irradiance is None else self.irradiance.to(device),
                           reflection,
                           None if self.brdf_lut is None else self.brdf_lut.to(device))


class Topology(NamedTuple):
    """What a refit needs of a tree's fixed topology, found once when the
    tree is built (``accel.lbvh.build_bvh``) and kept by every refit."""

    levels: tuple[Tensor, ...]  # node rows per refit pass, children's first
    slot_left: Tensor           # (k,) i64 box-table row of each node's children:
    slot_right: Tensor          # Karras nodes, then one row per triangle
    stack_need: int             # worst-case BVH2 traversal stack entries

    def to(self, device) -> "Topology":
        return self._replace(levels=tuple(x.to(device) for x in self.levels),
                             slot_left=self.slot_left.to(device),
                             slot_right=self.slot_right.to(device))


@dataclasses.dataclass
class BVH:
    """Flattened 2-wide BVH with multi-triangle leaves, optionally with its
    8-wide collapse (see ``accel``).

    Child encoding: id >= 0 is a node; id < 0 is a leaf ``~((start << 4) |
    count)``.  ``nodes8``/``child8`` are the BVH8 collapse (empty slots:
    child 0 and a far box lo = hi = +3e38); ``tri_perm8[i]`` is the
    BVH-order triangle stored in aligned slot ``i`` (-1 = padding).
    ``table8``, ``table8_woop`` and ``table2`` cache the traversal
    kernels' tables (``ops.traverse_wide8.Table8`` with Moller-Trumbore
    and with plane triangle records, ``ops.traverse_wide.Table2``), built
    on first use; a refit returns a new BVH with all empty, so a kernel
    never traces a stale table."""

    nodes: Tensor        # (N, 12) f32: c0.lo c0.hi c1.lo c1.hi
    child_index: Tensor  # (N, 2) i32
    tris: Tensor         # (T, 12) f32: v0 e1 e2 pad
    tri_flags: Tensor    # (T,) i32: bit0 cull_disable, bit1 opaque, bit2 alpha
    tri_order: Tensor    # (T,) i32 — BVH order -> original triangle id
    nodes8: Optional[Tensor] = None     # (M, 48) f32 — 8 x (lo3, hi3)
    child8: Optional[Tensor] = None     # (M, 8) i32
    tri_perm8: Optional[Tensor] = None  # (T8,) i32
    table8: Optional[Any] = None
    table8_woop: Optional[Any] = None
    table2: Optional[Any] = None
    topology: Optional[Topology] = None  # LBVH builds only

    def to(self, device) -> "BVH":
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        out = {k: (None if v is None else v.to(device)) for k, v in fields.items()}
        return BVH(**out)

    def opaque_view(self) -> "BVH":
        """The same tree with its alpha-tested triangles no candidates (bit
        2 of the flags cleared), with tables of its own."""
        return dataclasses.replace(self, tri_flags=self.tri_flags & ~4, table8=None,
                                   table8_woop=None, table2=None)


class AlphaScene(NamedTuple):
    """The alpha-tested (cutout) triangles in a tree of their own, attached
    by ``accel.lbvh.build_scene_bvh`` when a scene has such triangles.  A
    trace then runs as an opaque phase over the main tree, where cutouts
    are no candidates, and a closest-passing-cutout phase over this small
    tree with the bounded alpha re-trace (``ops.trace``).

    ``opaque_bvh`` is the main tree with bit 2 of its triangle flags
    cleared: built once per scene, with its own lazily packed kernel
    tables, because the tables are cached on the BVH object and packing
    them reads the tree back to the host."""

    geometry: TraceGeometry  # the cutout subset, in its own BVH order
    bvh: BVH                 # the tree over the subset
    tri_map: Tensor          # (Ta,) i32 — subset triangle id -> scene triangle id
    opaque_bvh: BVH          # the main tree's opaque view

    def to(self, device) -> "AlphaScene":
        return _to(self, device)


class Scene(NamedTuple):
    geometry: TraceGeometry
    materials: Materials
    environment: Environment
    direct_light: DirectLight
    point_lights: Optional[PointLights]
    bvh: Optional[BVH]
    # the texture pool (ops.texture.TexturePool); None = untextured
    textures: Optional[Any] = None
    # the cutout subset with its own tree; None without alpha-tested
    # triangles (or before a BVH is built)
    alpha: Optional[AlphaScene] = None

    @property
    def has_point_lights(self) -> bool:
        return self.point_lights is not None and self.point_lights.count > 0

    def to(self, device) -> "Scene":
        return _to(self, device)


def make_trace_geometry(
    positions: np.ndarray,      # (V, 3)
    indices: np.ndarray,        # (T, 3) int
    normals: np.ndarray | None = None,
    tangents: np.ndarray | None = None,
    uvs: np.ndarray | None = None,
    material_id: np.ndarray | int = 0,
    cull_disable: np.ndarray | bool = False,
    opaque: np.ndarray | bool = True,
    alpha_test: np.ndarray | bool = False,
    device: torch.device | str = "cuda",
) -> TraceGeometry:
    """Assemble SOA trace geometry from indexed vertex data (numpy on the
    host, then tensors on ``device``).  Generates flat normals, arbitrary
    tangents and zero uvs when attributes are missing."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    t = indices.shape[0]

    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0

    if normals is None:
        gn = np.cross(e1, e2)
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        n0 = n1 = n2 = gn
    else:
        normals = np.asarray(normals, np.float32)
        n0, n1, n2 = (normals[indices[:, k]] for k in range(3))

    if tangents is None:
        ref_axis = np.where(
            np.abs(n0[:, 1:2]) < 0.99,
            np.array([[0.0, 1.0, 0.0]], np.float32),
            np.array([[1.0, 0.0, 0.0]], np.float32),
        )
        t0_ = np.cross(n0, ref_axis)
        t0_ /= np.maximum(np.linalg.norm(t0_, axis=-1, keepdims=True), 1e-20)
        t0 = t1 = t2 = t0_
    else:
        tangents = np.asarray(tangents, np.float32)[..., :3]
        t0, t1, t2 = (tangents[indices[:, k]] for k in range(3))

    if uvs is None:
        uv0 = uv1 = uv2 = np.zeros((t, 2), np.float32)
    else:
        uvs = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = (uvs[indices[:, k]] for k in range(3))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def flag(a, dtype):
        return torch.from_numpy(np.array(np.broadcast_to(np.asarray(a, dtype), (t,)))).to(device)

    return TraceGeometry(
        v0=f32(p0), e1=f32(e1), e2=f32(e2),
        n0=f32(n0), n1=f32(n1), n2=f32(n2),
        t0=f32(t0), t1=f32(t1), t2=f32(t2),
        uv0=f32(uv0), uv1=f32(uv1), uv2=f32(uv2),
        material_id=flag(material_id, np.int32),
        cull_disable=flag(cull_disable, bool),
        opaque=flag(opaque, bool),
        alpha_test=flag(alpha_test, bool),
    )


def concat_geometry(parts: list[TraceGeometry]) -> TraceGeometry:
    """Concatenate triangle soups (instance flattening)."""
    return TraceGeometry(*[torch.cat(fs, dim=0) for fs in zip(*parts)])


def default_materials(base_color=(1.0, 1.0, 1.0, 1.0), emission=(0.0, 0.0, 0.0, 1.0),
                      roughness=1.0, metallic=0.0, device="cuda") -> Materials:
    """Single-material helper with glTF defaults."""
    return make_materials(
        base_color_factors=[base_color],
        emission_factors=[emission],
        roughness_factors=[roughness],
        metallic_factors=[metallic],
        device=device,
    )


def make_materials(
    base_color_factors,
    emission_factors=None,
    roughness_factors=None,
    metallic_factors=None,
    normal_scales=None,
    alpha_cutoffs=None,
    base_color_textures=None,
    roughness_metallic_textures=None,
    normal_textures=None,
    emission_textures=None,
    occlusion_textures=None,
    device: torch.device | str = "cuda",
) -> Materials:
    base = np.asarray(base_color_factors, np.float32).reshape(-1, 4)
    m = base.shape[0]

    def _f(x, default):
        if x is None:
            return np.full((m,), default, np.float32)
        return np.asarray(x, np.float32).reshape(m)

    def _i(x):
        if x is None:
            return np.full((m,), -1, np.int32)
        return np.asarray(x, np.int32).reshape(m)

    emission = (
        np.zeros((m, 4), np.float32)
        if emission_factors is None
        else np.asarray(emission_factors, np.float32).reshape(-1, 4)
    )

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Materials(
        base_color_factor=t(base),
        emission_factor=t(emission),
        roughness_factor=t(_f(roughness_factors, 1.0)),
        metallic_factor=t(_f(metallic_factors, 1.0)),
        normal_scale=t(_f(normal_scales, 1.0)),
        alpha_cutoff=t(_f(alpha_cutoffs, 0.5)),
        base_color_texture=t(_i(base_color_textures)),
        roughness_metallic_texture=t(_i(roughness_metallic_textures)),
        normal_texture=t(_i(normal_textures)),
        emission_texture=t(_i(emission_textures)),
        occlusion_texture=t(_i(occlusion_textures)),
    )


def make_environment(panorama: Tensor) -> Environment:
    """Environment over an (H, W, 3) float32 panorama.  The JAX package
    adds a 2x2 bilinear footprint table here, a TPU row-gather device; the
    port samples the panorama with the same arithmetic."""
    return Environment(panorama=panorama)


def constant_environment(color, size: int = 8, device="cuda") -> Environment:
    pano = np.broadcast_to(np.asarray(color, np.float32), (size, size * 2, 3))
    return Environment(panorama=torch.from_numpy(pano.copy()).to(device))


def black_environment(size: int = 8, device="cuda") -> Environment:
    return constant_environment((0.0, 0.0, 0.0), size, device)


def no_direct_light(device="cuda") -> DirectLight:
    return DirectLight(
        direction=torch.tensor([0.0, -1.0, 0.0, 0.0], device=device),
        color=torch.zeros((4,), device=device),
    )
