"""The moving objects of a configuration, as its ``scene.instances`` block
states them: the user's input, as the camera is.

    "instances": {"mesh": {"radius": 0.6, "lat": 16, "lon": 32},
                  "count": 64, "materials": [3, 4],
                  "orbit": {"radius": 3.0, "height": 1.2, "bob": 0.4,
                            "period_frames": 96, "phase_spacing_turns": 0.015625}}

Instance 0 is the hall under the identity.  Instances 1 to ``count`` are
the mesh, a UV sphere (``scenegen.generate_sphere(radius, lat, lon)``),
instance i with the configuration's material ``materials[(i - 1) %
len(materials)]``, translated along its orbit: at frame k its phase is 2 pi
(k / period_frames + (i - 1) phase_spacing_turns), and its centre lies at
(radius cos phase, height + bob sin 2 phase, radius sin phase).

The animation is a pure function of the frame index.  The program gets it
as ``Engine``'s ``animation``, and the reference forms each checked frame's
triangles from it; this module imports nothing of either.
"""

from __future__ import annotations

import math

import numpy as np

KEYS = {"mesh", "count", "materials", "orbit"}
MESH_KEYS = {"radius", "lat", "lon"}
ORBIT_KEYS = {"radius", "height", "bob", "period_frames", "phase_spacing_turns"}


def unread_keys(instances: dict) -> list[str]:
    """The keys of an ``instances`` block that nothing here reads."""
    return sorted((set(instances) - KEYS)
                  | {f"mesh.{k}" for k in set(instances.get("mesh", {})) - MESH_KEYS}
                  | {f"orbit.{k}" for k in set(instances.get("orbit", {})) - ORBIT_KEYS})


def materials(instances: dict) -> list[int]:
    """The configuration's material of instances 1 to ``count``."""
    pattern = instances["materials"]
    return [pattern[i % len(pattern)] for i in range(instances["count"])]


def animation(instances: dict):
    """frame index -> (1 + count, 4, 4) float32 world transforms."""
    orbit = instances["orbit"]
    offsets = np.arange(instances["count"]) * (2.0 * math.pi * orbit["phase_spacing_turns"])

    def transforms(frame: int) -> np.ndarray:
        phase = frame * (2.0 * math.pi / orbit["period_frames"]) + offsets
        out = np.tile(np.eye(4, dtype=np.float32), (1 + instances["count"], 1, 1))
        out[1:, 0, 3] = orbit["radius"] * np.cos(phase)
        out[1:, 1, 3] = orbit["height"] + orbit["bob"] * np.sin(2.0 * phase)
        out[1:, 2, 3] = orbit["radius"] * np.sin(phase)
        return out

    return transforms
