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

from vulkanraytracing_torch.scene.camera import CameraPT
from vulkanraytracing_torch.scene.types import (
    BVH,
    DirectLight,
    Environment,
    Materials,
    PointLights,
    Scene,
    TraceGeometry,
)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _fields(cls, obj, device):
    return cls(**{name: _tensor(getattr(obj, name), device) for name in cls._fields})


def scene_from_numpy(obj, device="cuda") -> Scene:
    """Port ``Scene`` from a numpy-leaved scene with the JAX field names."""
    if getattr(obj, "textures", None) is not None or getattr(obj, "alpha", None) is not None:
        raise NotImplementedError("textured or alpha-tested scenes are not ported yet")
    if np.any(obj.geometry.alpha_test):
        raise NotImplementedError("alpha-tested geometry is not ported yet")
    point_lights = None
    if obj.point_lights is not None:
        point_lights = _fields(PointLights, obj.point_lights, device)
    bvh = None
    if obj.bvh is not None:
        b = obj.bvh
        names = ("nodes", "child_index", "tris", "tri_flags", "tri_order",
                 "nodes8", "child8", "tri_perm8")
        bvh = BVH(**{
            n: None if getattr(b, n) is None else _tensor(getattr(b, n), device)
            for n in names
        })
    return Scene(
        geometry=_fields(TraceGeometry, obj.geometry, device),
        materials=_fields(Materials, obj.materials, device),
        environment=Environment(panorama=_tensor(obj.environment.panorama, device)),
        direct_light=_fields(DirectLight, obj.direct_light, device),
        point_lights=point_lights,
        bvh=bvh,
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
