"""Carry a scene, instance soup or camera from the JAX package across, by
field name.

``scene_from_numpy``, ``soup_from_numpy`` and ``camera_from_numpy`` read
objects whose leaves
are numpy arrays (for example the JAX package's ``Scene`` after
``jax.tree.map(np.asarray, scene)``) and return the port's objects on
``device``.  Nothing here imports JAX: any object with the same field
names works, so both packages can trace the very same BVH.  ``device``
defaults to the card.
"""

from __future__ import annotations

import numpy as np
import torch

from vulkanraytracing_torch.ops.texture import TexturePool
from vulkanraytracing_torch.scene.camera import CameraPT
from vulkanraytracing_torch.scene.types import (
    BVH,
    AlphaScene,
    DirectLight,
    Environment,
    Materials,
    PointLights,
    Scene,
    TraceGeometry,
    make_environment,
)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _fields(cls, obj, device):
    return cls(**{name: _tensor(getattr(obj, name), device) for name in cls._fields})


_BVH_FIELDS = ("nodes", "child_index", "tris", "tri_flags", "tri_order",
               "nodes8", "child8", "tri_perm8")


def _bvh(b, device) -> BVH:
    """Port ``BVH`` from the JAX one's arrays (its probe cut, a TPU wave
    device, is not carried)."""
    return BVH(**{n: None if getattr(b, n) is None else _tensor(getattr(b, n), device)
                  for n in _BVH_FIELDS})


def _environment(env, device) -> Environment:
    """The panorama and whichever IBL fields are set (the JAX package's
    2x2 footprint table is not carried)."""
    def opt(name):
        a = getattr(env, name, None)
        return None if a is None else _tensor(a, device)

    reflection = getattr(env, "reflection", None)
    if reflection is not None:
        reflection = tuple(_tensor(m, device) for m in reflection)
    return make_environment(_tensor(env.panorama, device))._replace(
        irradiance=opt("irradiance"), reflection=reflection, brdf_lut=opt("brdf_lut"))


def scene_from_numpy(obj, device="cuda") -> Scene:
    """Port ``Scene`` from a numpy-leaved scene with the JAX field names:
    geometry, materials with their texture slots, the panorama, lights,
    the BVH, the texture pool (less its footprint table, a TPU gather
    device), the cutout subset, to which the main tree's opaque view is
    added as ``accel.lbvh.build_scene_bvh`` adds it, and the IBL fields of
    the environment (irradiance cube, reflection mips, BRDF table) where
    they were baked."""
    point_lights = None
    if obj.point_lights is not None:
        point_lights = _fields(PointLights, obj.point_lights, device)
    bvh = None if obj.bvh is None else _bvh(obj.bvh, device)
    textures = None
    if getattr(obj, "textures", None) is not None:
        textures = _fields(TexturePool, obj.textures, device)
    alpha = None
    if getattr(obj, "alpha", None) is not None:
        a = obj.alpha
        alpha = AlphaScene(geometry=_fields(TraceGeometry, a.geometry, device),
                           bvh=_bvh(a.bvh, device), tri_map=_tensor(a.tri_map, device),
                           opaque_bvh=bvh.opaque_view())
    return Scene(
        geometry=_fields(TraceGeometry, obj.geometry, device),
        materials=_fields(Materials, obj.materials, device),
        environment=_environment(obj.environment, device),
        direct_light=_fields(DirectLight, obj.direct_light, device),
        point_lights=point_lights,
        bvh=bvh,
        textures=textures,
        alpha=alpha,
    )


def soup_from_numpy(obj, device="cuda"):
    """Port ``accel.tlas.InstanceSoup`` from a numpy-leaved soup with the
    JAX field names."""
    from vulkanraytracing_torch.accel.tlas import InstanceSoup

    return InstanceSoup(
        object_geometry=_fields(TraceGeometry, obj.object_geometry, device),
        instance_id=_tensor(obj.instance_id, device),
    )


def camera_from_numpy(obj, device="cuda") -> CameraPT:
    """Port ``CameraPT`` from a numpy-leaved camera with the JAX field names."""
    return CameraPT(
        inverse_view=_tensor(obj.inverse_view, device),
        inverse_proj=_tensor(obj.inverse_proj, device),
        z_near=float(obj.z_near),
        z_far=float(obj.z_far),
    )
