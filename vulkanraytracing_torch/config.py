"""Typed runtime configuration — the fields the path-tracing slice reads.

Counterpart of ``vulkanraytracing_tpu/config.py``.  Only path-tracing mode
exists here; hybrid mode, IBL sizes and anisotropic taps come with later
slices.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class TraversalMode(enum.Enum):
    """Which trace backend to use.  Both implement the same ``Hit``
    contract (``ops.intersect.Hit``)."""

    BRUTE_FORCE = "brute_force"  # O(R*T) Moller-Trumbore oracle, plain torch
    BVH8 = "bvh8"                # BVH8 traversal: CUDA kernel on the card,
    #                              its plain torch version for CPU tensors


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Default camera: 5 units on +Z looking at the origin, +Y up, 90 degree
    x-fov, 16:9.  ``x_fov / aspect_ratio`` is used as the vertical fov (the
    reference renderer's convention)."""

    position: tuple[float, float, float] = (0.0, 0.0, 5.0)
    target: tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    x_fov: float = math.radians(90.0)
    aspect_ratio: float = 16.0 / 9.0
    z_near: float = 0.01
    z_far: float = 1000.0


@dataclasses.dataclass(frozen=True)
class Config:
    width: int = 1280
    height: int = 720
    traversal: TraversalMode = TraversalMode.BVH8

    # Russian roulette starts after min_bounce_count bounces
    min_bounce_count: int = 2
    max_bounce_count: int = 4
    rr_min_threshold: float = 0.05

    # Accumulate tone-mapped samples in an RGBA8 round trip (the reference
    # renderer's storage image); False keeps a float accumulator.
    parity_quantization: bool = True
    # Tone-map each sample before accumulation (reference behaviour);
    # False accumulates linear radiance and tone-maps at display.
    tone_map_before_accumulation: bool = True

    point_light_radius: float = 0.05

    camera:CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # Rays per integrator call; a 1080p frame is one chunk at the default.
    ray_chunk_size: int = 1 << 22

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
