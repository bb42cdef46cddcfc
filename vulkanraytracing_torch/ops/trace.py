"""Trace dispatch: the traversal-backend switch.

Counterpart of ``vulkanraytracing_tpu/ops/trace.py`` for opaque scenes:
interchangeable implementations of one trace, the analogue of the
reference's compile-time ``PathTracingMode`` backend switch.

- ``BRUTE_FORCE``: the O(R*T) oracle (``ops.intersect``); a scene with no
  BVH is traced this way in every mode, as in the JAX package;
- ``BVH``: packet traversal in plain torch (``ops.traverse_packet``);
- ``BVH_KERNEL``: the 8-wide kernel (``ops.traverse_wide8``) when the BVH
  carries its 8-wide collapse, the 2-wide kernel (``ops.traverse_wide``)
  otherwise, which is every LBVH build and TLAS refit, as the JAX
  package's ``BVH_PALLAS`` does;
- ``BVH_SUBPACKET``: the subpacket kernel (``ops.traverse_subpacket``);
- ``BVH_SHARED``: the shared-cursor kernel (``ops.traverse_pallas``).

The packet backends read the BVH's 2-wide arrays, which an 8-wide collapse
keeps, so they run on SAH and LBVH trees alike.  Alpha-tested geometry
and wavefront reordering are not ported yet; scenes that need them are
refused where they are built (``scene.types.check_supported``).
"""

from __future__ import annotations

from torch import Tensor

from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.ops import (
    intersect,
    traverse_packet,
    traverse_pallas,
    traverse_subpacket,
    traverse_wide,
    traverse_wide8,
)
from vulkanraytracing_torch.ops.intersect import Hit
from vulkanraytracing_torch.scene.types import BVH, Scene


def _backend(mode: TraversalMode, bvh: BVH):
    """(intersect_closest, intersect_any) of the mode's backend."""
    if mode == TraversalMode.BVH:
        return traverse_packet.intersect_closest_packet, traverse_packet.intersect_any_packet
    if mode == TraversalMode.BVH_KERNEL:
        module = traverse_wide8 if bvh.nodes8 is not None else traverse_wide
    elif mode == TraversalMode.BVH_SUBPACKET:
        module = traverse_subpacket
    elif mode == TraversalMode.BVH_SHARED:
        module = traverse_pallas
    else:
        raise ValueError(f"unknown traversal mode {mode}")
    return module.intersect_closest, module.intersect_any


def trace_closest(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor, cull_backface: bool = True,
) -> Hit:
    """Closest hit of each ray against the scene."""
    if cfg.traversal == TraversalMode.BRUTE_FORCE or scene.bvh is None:
        return intersect.intersect_closest_brute(
            scene.geometry, o, d, t_min, t_max, cull_backface=cull_backface
        )
    closest, _ = _backend(cfg.traversal, scene.bvh)
    return closest(scene.bvh, o, d, t_min, t_max, cull_backface=cull_backface)


def trace_any(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor,
) -> Tensor:
    """Visibility query: is [t_min, t_max] of each ray blocked?"""
    if cfg.traversal == TraversalMode.BRUTE_FORCE or scene.bvh is None:
        return intersect.intersect_any_brute(scene.geometry, o, d, t_min, t_max)
    _, blocked = _backend(cfg.traversal, scene.bvh)
    return blocked(scene.bvh, o, d, t_min, t_max)
