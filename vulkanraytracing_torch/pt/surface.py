"""Material unpacking at hit points.

Counterpart of ``vulkanraytracing_tpu/pt/surface.py``: factor times
texture for base color (sRGB to linear after filtering), roughness and
metallic from the texture's green and blue, emission (sRGB to linear),
and tangent-space normal mapping scaled by ``normal_scale`` with a rebuilt
frame.  The JAX package selects material rows with a one-hot matmul to
dodge TPU gathers; here a plain index does it, with the same values.  The
occlusion slot is read only for the hybrid G-buffer (``with_occlusion``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch.core import math3d
from vulkanraytracing_torch.ops.intersect import SurfaceAttributes
from vulkanraytracing_torch.ops.texture import sample_pool
from vulkanraytracing_torch.pt import bsdf as bsdf_mod
from vulkanraytracing_torch.scene.types import Materials, Scene
from vulkanraytracing_torch.utils.profiling import host_sync

# the texture slots of a material, in the order of ``texture_slots_used``
SLOTS = ("base_color_texture", "roughness_metallic_texture", "emission_texture",
         "normal_texture", "occlusion_texture")


class UnpackedSurface(NamedTuple):
    surface: bsdf_mod.Surface
    tbn: Tensor        # (R, 3, 3), columns T, B, N
    occlusion: Tensor  # (R,) — hybrid mode only (1.0 without a texture)


def texture_slots_used(materials: Materials) -> dict[str, bool]:
    """Which texture slots any material uses, read back to the host once.
    A slot no material uses samples nothing that survives its mask, so
    ``unpack_material`` may skip it: the result is the same."""
    ids = torch.stack([getattr(materials, name) for name in SLOTS])
    with host_sync("texture_slots"):
        used = (ids >= 0).any(dim=1).tolist()
    return dict(zip(SLOTS, used))


def unpack_material(scene: Scene, attrs: SurfaceAttributes, with_occlusion: bool = False,
                    footprint=None, slots: dict[str, bool] | None = None) -> UnpackedSurface:
    """The surface at each hit.  ``footprint`` selects the texture filter
    (``ops.texture.sample_pool``; None is the ray tracer's base level);
    ``slots`` (``texture_slots_used``) lets unused texture slots be
    skipped, None samples every slot."""
    mats = scene.materials
    mid = attrs.material_id.long()
    base_color = mats.base_color_factor[mid, :3]
    emission = mats.emission_factor[mid, :3]
    roughness = mats.roughness_factor[mid]
    metallic = mats.metallic_factor[mid]
    tbn = math3d.get_tbn_from_nt(attrs.normal, attrs.tangent)
    occlusion = torch.ones_like(roughness)

    if scene.textures is not None:
        pool, uv = scene.textures, attrs.uv

        def sample(name):
            """(texture ids, their samples), or None for a slot skipped."""
            if slots is not None and not slots[name]:
                return None
            tex = getattr(mats, name)[mid]
            return tex, sample_pool(pool, tex, uv, footprint)

        # base color *= ToLinear(tex.rgb)
        if (bc := sample("base_color_texture")) is not None:
            tex, c = bc
            base_color = base_color * torch.where(
                (tex >= 0)[:, None], math3d.to_linear(c[:, :3]), 1.0)
        # roughness *= tex.g, metallic *= tex.b
        if (rm := sample("roughness_metallic_texture")) is not None:
            tex, c = rm
            roughness = roughness * torch.where(tex >= 0, c[:, 1], 1.0)
            metallic = metallic * torch.where(tex >= 0, c[:, 2], 1.0)
        # emission *= ToLinear(tex.rgb)
        if (em := sample("emission_texture")) is not None:
            tex, c = em
            emission = emission * torch.where(
                (tex >= 0)[:, None], math3d.to_linear(c[:, :3]), 1.0)
        if with_occlusion and (oc := sample("occlusion_texture")) is not None:
            tex, c = oc
            occlusion = torch.where(tex >= 0, c[:, 0], 1.0)
        # normal mapping
        if (nm := sample("normal_texture")) is not None:
            tex, c = nm
            scale = mats.normal_scale[mid]
            ns = c[:, :3] * 2.0 - 1.0
            ns = math3d.normalize(ns * torch.stack([scale, scale, torch.ones_like(scale)], dim=-1))
            tbn_mapped = math3d.get_tbn_from_n(math3d.tangent_to_world(ns, tbn))
            tbn = torch.where((tex >= 0)[:, None, None], tbn_mapped, tbn)

    surface = bsdf_mod.make_surface(base_color, roughness, metallic, emission)
    return UnpackedSurface(surface=surface, tbn=tbn, occlusion=occlusion)
