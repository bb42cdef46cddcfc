"""Typed runtime configuration — the fields the ported slices read.

Counterpart of ``vulkanraytracing_tpu/config.py``, with the same names
and defaults.  Both render modes draw, and the Engine's T key toggles
between them.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class RenderMode(enum.Enum):
    """The reference's RenderMode::{eHybrid, ePathTracing}."""

    PATH_TRACING = "path_tracing"
    HYBRID = "hybrid"


class TraversalMode(enum.Enum):
    """Which trace backend to use: interchangeable implementations of the
    ``Hit`` contract (``ops.intersect.Hit``), as the JAX package's switch.
    The kernels run CUDA on the card and their plain torch versions for
    CPU tensors.  The packet kernels and ``BVH_PER_RAY`` keep their JAX
    counterparts' window (a hit exactly at t_max is not committed; equal-t
    ties follow visit order), the others commit it and break ties to the
    lowest id."""

    BRUTE_FORCE = "brute_force"  # O(R*T) Moller-Trumbore oracle, plain torch
    BVH = "bvh"                  # the JAX package's BVH: packet traversal
    #                              in plain torch (ops.traverse_packet)
    BVH_PER_RAY = "bvh_per_ray"  # BVH + per-ray lockstep traversal (oracle),
    #                              plain torch (ops.traverse), with the JAX
    #                              module's window and first-tested ties
    BVH_KERNEL = "bvh_kernel"    # the JAX package's BVH_PALLAS: the BVH8
    #                              kernel when the BVH has its 8-wide
    #                              collapse, the BVH2 kernel otherwise
    BVH_SUBPACKET = "bvh_subpacket"  # the JAX package's BVH_PALLAS_SUBPACKET:
    #                              one cursor per 128-ray packet, persistent
    #                              blocks with work refill
    #                              (ops.traverse_subpacket)
    BVH_SHARED = "bvh_shared"    # the JAX package's BVH_PALLAS_SHARED: one
    #                              shared cursor per 1024-ray packet
    #                              (ops.traverse_pallas)


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

    # toggled by the Engine's T key
    render_mode: RenderMode = RenderMode.PATH_TRACING
    traversal: TraversalMode = TraversalMode.BVH_KERNEL

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

    # Alpha-tested (cutout) triangles: resolve the texture alpha test on
    # material and visibility rays; False treats every cutout hit as opaque.
    alpha_visibility: bool = True

    # the Engine's camera projection swaps z_near and z_far
    reverse_depth: bool = True
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # environment preprocessing, declared as in the JAX package: the IBL
    # sizes (``env.ibl.bake_ibl``'s defaults, which the CLI bakes with) and
    # the sun's luminance clamp (``env.sun.K_MAX_LUMINANCE``)
    env_cube_size: int = 1024
    irradiance_size: int = 128
    reflection_size: int = 512
    brdf_lut_size: int = 256
    direct_light_max_luminance: float = 25.0

    # Rays per integrator call; a 1080p frame is one chunk at the default.
    ray_chunk_size: int = 1 << 22

    # Anisotropic texture taps of the hybrid G-buffer fetch (the reference
    # sampler's maxAnisotropy 16); 1 is plain trilinear.  16 is the parity
    # default: fewer taps are a speed option that changes the image.
    hybrid_aniso_taps: int = 16

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
