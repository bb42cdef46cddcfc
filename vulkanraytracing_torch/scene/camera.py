"""Camera with exact matrix parity to the reference renderer.

Counterpart of ``vulkanraytracing_tpu/scene/camera.py``: glm lookAt and
perspective (depth 0..1) with the reference's three quirks — vertical fov
``x_fov / aspect``, reverse depth, and a negated ``P[1][1]`` for Vulkan's
Y-down clip space.  The path tracer only consumes the inverses, which are
computed on the host in float64 and stored as float32 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from vulkanraytracing_torch.config import CameraConfig


class CameraPT(NamedTuple):
    inverse_view: Tensor  # (4, 4) f32
    inverse_proj: Tensor  # (4, 4) f32
    z_near: float
    z_far: float

    def to(self, device) -> "CameraPT":
        return self._replace(
            inverse_view=self.inverse_view.to(device),
            inverse_proj=self.inverse_proj.to(device),
        )


def look_at(position, target, up) -> np.ndarray:
    """glm::lookAtRH with column vectors: v' = V @ v."""
    position = np.asarray(position, np.float64)
    f = _normalize(np.asarray(target, np.float64) - position)
    s = _normalize(np.cross(f, np.asarray(up, np.float64)))
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3] = s
    view[1, :3] = u
    view[2, :3] = -f
    view[0, 3] = -s @ position
    view[1, 3] = -u @ position
    view[2, 3] = f @ position
    return view


def perspective(y_fov: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """glm::perspectiveRH_ZO (depth in [0, 1])."""
    tan_half = np.tan(y_fov / 2.0)
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / (aspect * tan_half)
    p[1, 1] = 1.0 / tan_half
    p[2, 2] = z_far / (z_near - z_far)
    p[2, 3] = -(z_far * z_near) / (z_far - z_near)
    p[3, 2] = -1.0
    return p


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


@dataclasses.dataclass
class Camera:
    """Host-side camera state."""

    description: CameraConfig

    def view_matrix(self) -> np.ndarray:
        d = self.description
        return look_at(d.position, d.target, d.up)

    def projection_matrix(self, reverse_depth: bool = True) -> np.ndarray:
        d = self.description
        y_fov = d.x_fov / d.aspect_ratio
        z_near = d.z_far if reverse_depth else d.z_near
        z_far = d.z_near if reverse_depth else d.z_far
        p = perspective(y_fov, d.aspect_ratio, z_near, z_far)
        p[1, 1] = -p[1, 1]
        return p

    def to_device(self, device="cuda", reverse_depth: bool = True) -> CameraPT:
        d = self.description

        def f32(m):
            return torch.from_numpy(np.asarray(m, np.float32)).to(device)

        return CameraPT(
            inverse_view=f32(np.linalg.inv(self.view_matrix())),
            inverse_proj=f32(np.linalg.inv(self.projection_matrix(reverse_depth))),
            z_near=float(np.float32(d.z_near)),
            z_far=float(np.float32(d.z_far)),
        )

    # --- mutators (the Engine's camera system moves the camera) ---

    def set_position(self, position) -> None:
        self.description = dataclasses.replace(self.description, position=tuple(position))

    def set_direction(self, direction) -> None:
        p = np.asarray(self.description.position)
        self.description = dataclasses.replace(
            self.description, target=tuple(p + np.asarray(direction))
        )

    def set_target(self, target) -> None:
        self.description = dataclasses.replace(self.description, target=tuple(target))
