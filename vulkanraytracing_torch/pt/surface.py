"""Material unpacking at hit points (factor-only materials).

Counterpart of ``vulkanraytracing_tpu/pt/surface.py``.  The JAX package
selects material rows with a one-hot matmul to dodge TPU gathers; here a
plain index does it, with the same values.  Texture taps are not ported
yet: the integrator refuses textured scenes.
"""

from __future__ import annotations

from typing import NamedTuple

from torch import Tensor

from vulkanraytracing_torch.core import math3d
from vulkanraytracing_torch.ops.intersect import SurfaceAttributes
from vulkanraytracing_torch.pt import bsdf as bsdf_mod
from vulkanraytracing_torch.scene.types import Scene


class UnpackedSurface(NamedTuple):
    surface: bsdf_mod.Surface
    tbn: Tensor  # (R, 3, 3), columns T, B, N


def unpack_material(scene: Scene, attrs: SurfaceAttributes) -> UnpackedSurface:
    mats = scene.materials
    mid = attrs.material_id.long()
    surface = bsdf_mod.make_surface(
        mats.base_color_factor[mid, :3],
        mats.roughness_factor[mid],
        mats.metallic_factor[mid],
        mats.emission_factor[mid, :3],
    )
    tbn = math3d.get_tbn_from_nt(attrs.normal, attrs.tangent)
    return UnpackedSurface(surface=surface, tbn=tbn)
