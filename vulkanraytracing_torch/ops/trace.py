"""Trace dispatch: brute force or the BVH8 traversal.

Counterpart of ``vulkanraytracing_tpu/ops/trace.py`` for opaque scenes.
Alpha-tested geometry, wavefront reordering and the other traversal
backends are not ported yet; scenes that need them are refused where they
are built (``scene.types.check_supported``).
"""

from __future__ import annotations

from torch import Tensor

from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.ops import intersect, traverse_wide8
from vulkanraytracing_torch.ops.intersect import Hit
from vulkanraytracing_torch.scene.types import Scene


def _bvh(scene: Scene):
    if scene.bvh is None:
        raise ValueError(
            "TraversalMode.BVH8 needs a BVH: build one with "
            "accel.lbvh.build_scene_bvh, or use TraversalMode.BRUTE_FORCE"
        )
    return scene.bvh


def trace_closest(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor, cull_backface: bool = True,
) -> Hit:
    """Closest hit of each ray against the scene."""
    if cfg.traversal == TraversalMode.BRUTE_FORCE:
        return intersect.intersect_closest_brute(
            scene.geometry, o, d, t_min, t_max, cull_backface=cull_backface
        )
    return traverse_wide8.intersect_closest(
        _bvh(scene), o, d, t_min, t_max, cull_backface=cull_backface
    )


def trace_any(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor,
) -> Tensor:
    """Visibility query: is [t_min, t_max] of each ray blocked?"""
    if cfg.traversal == TraversalMode.BRUTE_FORCE:
        return intersect.intersect_any_brute(scene.geometry, o, d, t_min, t_max)
    return traverse_wide8.intersect_any(_bvh(scene), o, d, t_min, t_max)
