"""Trace dispatch: brute force or a BVH traversal kernel.

Counterpart of ``vulkanraytracing_tpu/ops/trace.py`` for opaque scenes.
``TraversalMode.BVH_KERNEL`` picks the kernel by the BVH's shape, as the
JAX package's ``BVH_PALLAS`` does: the 8-wide kernel
(``ops.traverse_wide8``) when the BVH carries its 8-wide collapse, the
2-wide kernel (``ops.traverse_wide``) otherwise, which is every LBVH build
and TLAS refit.  Alpha-tested geometry, wavefront reordering and the other
traversal backends are not ported yet; scenes that need them are refused
where they are built (``scene.types.check_supported``).
"""

from __future__ import annotations

from torch import Tensor

from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.ops import intersect, traverse_wide, traverse_wide8
from vulkanraytracing_torch.ops.intersect import Hit
from vulkanraytracing_torch.scene.types import Scene


def _traversal(scene: Scene):
    """(bvh, traversal module) for the scene's BVH."""
    if scene.bvh is None:
        raise ValueError(
            "TraversalMode.BVH_KERNEL needs a BVH: build one with "
            "accel.lbvh.build_scene_bvh, or use TraversalMode.BRUTE_FORCE"
        )
    return scene.bvh, traverse_wide8 if scene.bvh.nodes8 is not None else traverse_wide


def trace_closest(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor, cull_backface: bool = True,
) -> Hit:
    """Closest hit of each ray against the scene."""
    if cfg.traversal == TraversalMode.BRUTE_FORCE:
        return intersect.intersect_closest_brute(
            scene.geometry, o, d, t_min, t_max, cull_backface=cull_backface
        )
    bvh, kernel = _traversal(scene)
    return kernel.intersect_closest(bvh, o, d, t_min, t_max, cull_backface=cull_backface)


def trace_any(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor,
) -> Tensor:
    """Visibility query: is [t_min, t_max] of each ray blocked?"""
    if cfg.traversal == TraversalMode.BRUTE_FORCE:
        return intersect.intersect_any_brute(scene.geometry, o, d, t_min, t_max)
    bvh, kernel = _traversal(scene)
    return kernel.intersect_any(bvh, o, d, t_min, t_max)
