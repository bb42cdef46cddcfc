"""Trace dispatch: the traversal-backend switch, the wavefront reorder of a
single trace and the alpha split for cutout geometry.

Counterpart of ``vulkanraytracing_tpu/ops/trace.py``: interchangeable
implementations of one trace, the analogue of the reference's
compile-time ``PathTracingMode`` backend switch.

- ``BRUTE_FORCE``: the O(R*T) oracle (``ops.intersect``); a scene with no
  BVH is traced this way in every mode, as in the JAX package;
- ``BVH``: packet traversal in plain torch (``ops.traverse_packet``);
- ``BVH_PER_RAY``: per-ray lockstep traversal in plain torch
  (``ops.traverse``), the JAX package's reference backend;
- ``BVH_KERNEL``: the 8-wide kernel (``ops.traverse_wide8``) when the BVH
  carries its 8-wide collapse, the 2-wide kernel (``ops.traverse_wide``)
  otherwise, which is every LBVH build and TLAS refit, as the JAX
  package's ``BVH_PALLAS`` does;
- ``BVH_SUBPACKET``: the subpacket kernel (``ops.traverse_subpacket``);
- ``BVH_SHARED``: the shared-cursor kernel (``ops.traverse_pallas``).

The packet backends read the BVH's 2-wide arrays, which an 8-wide collapse
keeps, so they run on SAH and LBVH trees alike.  Every traversal of a tree
goes through ``traverse_closest`` / ``traverse_any``.

Alpha-tested (cutout) triangles of a textured scene pass a hit only where
the texture's alpha reaches the material's cutoff.  With the cutout subset
attached (``Scene.alpha``, by ``accel.lbvh.build_scene_bvh``) a trace runs
as an opaque phase over the main tree's opaque view (cutouts are no
candidates) and a closest-passing-cutout phase over the subset's own
tree, with the bounded re-trace loop (``MAX_ALPHA_ITERS`` rounds, each
from just past the rejected hit) confined to the subset.  Without the
subset the loop runs over the whole scene.  The opaque view carries no
textures, so its any-hit phase reaches the any-hit kernel; the JAX
package reaches the same verdicts through its closest-hit loop.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.core import math3d
from vulkanraytracing_torch.ops import (
    intersect,
    reorder as reorder_mod,
    traverse,
    traverse_packet,
    traverse_pallas,
    traverse_subpacket,
    traverse_wide,
    traverse_wide8,
)
from vulkanraytracing_torch.ops.intersect import BIG_T, Hit
from vulkanraytracing_torch.ops.texture import sample_pool
from vulkanraytracing_torch.scene.types import BVH, Scene

# Transparency layers resolved per ray before a hit is given up (the
# reference's any-hit loop is unbounded; 4 covers cutout stacks).
MAX_ALPHA_ITERS = 4


def root_bounds(bvh: BVH) -> tuple[Tensor, Tensor]:
    """The root's box (lo, hi), the union of its two children's."""
    lo = torch.minimum(bvh.nodes[0, 0:3], bvh.nodes[0, 6:9])
    hi = torch.maximum(bvh.nodes[0, 3:6], bvh.nodes[0, 9:12])
    return lo, hi


def _backend(mode: TraversalMode, bvh: BVH):
    """(intersect_closest, intersect_any) of the mode's backend."""
    if mode == TraversalMode.BVH:
        return traverse_packet.intersect_closest_packet, traverse_packet.intersect_any_packet
    if mode == TraversalMode.BVH_PER_RAY:
        return traverse.intersect_closest_bvh, traverse.intersect_any_bvh
    if mode == TraversalMode.BVH_KERNEL:
        module = traverse_wide8 if bvh.nodes8 is not None else traverse_wide
    elif mode == TraversalMode.BVH_SUBPACKET:
        module = traverse_subpacket
    elif mode == TraversalMode.BVH_SHARED:
        module = traverse_pallas
    else:
        raise ValueError(f"unknown traversal mode {mode}")
    return module.intersect_closest, module.intersect_any


def traverse_closest(cfg: Config, bvh: BVH, o: Tensor, d: Tensor, t_min: Tensor,
                     t_max: Tensor, cull_backface: bool) -> Hit:
    """One closest-hit traversal of ``bvh`` by the mode's backend."""
    closest, _ = _backend(cfg.traversal, bvh)
    return closest(bvh, o, d, t_min, t_max, cull_backface=cull_backface)


def traverse_any(cfg: Config, bvh: BVH, o: Tensor, d: Tensor, t_min: Tensor,
                 t_max: Tensor) -> Tensor:
    """One any-hit traversal of ``bvh`` by the mode's backend."""
    _, blocked = _backend(cfg.traversal, bvh)
    return blocked(bvh, o, d, t_min, t_max)


def _hit_alpha(scene: Scene, hit: Hit) -> tuple[Tensor, Tensor]:
    """(alpha, cutoff) at each hit: base color factor alpha times the base
    color texture's alpha, and the material's cutoff."""
    geom, mats = scene.geometry, scene.materials
    tri = hit.tri.long()
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    uv = math3d.bary_lerp(geom.uv0[tri], geom.uv1[tri], geom.uv2[tri], bary)
    mid = geom.material_id[tri].long()
    alpha = mats.base_color_factor[mid, 3]
    cutoff = mats.alpha_cutoff[mid]
    if scene.textures is not None:
        tex = mats.base_color_texture[mid]
        sampled = sample_pool(scene.textures, tex, uv)
        alpha = alpha * torch.where(tex >= 0, sampled[:, 3], 1.0)
    return alpha, cutoff


def _failing(scene: Scene, hit: Hit) -> Tensor:
    """Hits on alpha-tested triangles whose alpha is below the cutoff."""
    alpha, cutoff = _hit_alpha(scene, hit)
    return hit.is_hit & scene.geometry.alpha_test[hit.tri.long()] & (alpha < cutoff)


def _resolve_alpha(scene: Scene, trace_fn, hit: Hit, t_max: Tensor) -> Hit:
    """Re-trace past hits that fail the alpha test: each round traces the
    failed rays again from just beyond the rejected surface
    (``trace_fn(t_min, t_max)``).  Every round runs: the rays that passed
    get the empty window [t * 1.0001 + 1e-4, 0] and leave the traversal at
    once, so nothing is read back to the host.  Hits still failing after
    ``MAX_ALPHA_ITERS`` rounds become misses."""
    for _ in range(MAX_ALPHA_ITERS):
        fail = _failing(scene, hit)
        new_tmin = hit.t * 1.0001 + 1e-4
        new_tmax = torch.where(fail, t_max, 0.0)
        nxt = trace_fn(new_tmin, new_tmax)
        hit = Hit(*[torch.where(fail, n, h) for n, h in zip(nxt, hit)])
    fail = _failing(scene, hit)
    return hit._replace(t=torch.where(fail, BIG_T, hit.t))


def _opaque_view(scene: Scene) -> Scene:
    """The scene with its cutouts as no candidates: the main tree's opaque
    view (bit 2 of its triangle flags cleared, built once per scene) and
    ``alpha_test`` cleared for brute force; no textures, no subset."""
    geom = scene.geometry._replace(alpha_test=torch.zeros_like(scene.geometry.alpha_test))
    return scene._replace(geometry=geom, bvh=scene.alpha.opaque_bvh, textures=None,
                          alpha=None)


def _closest_alpha_subset(scene: Scene, cfg: Config, o, d, t_min, t_max,
                          cull_backface: bool) -> Hit:
    """The closest passing cutout hit over the subset's tree, with the
    re-trace loop confined to the subset; ``tri`` is the scene's id."""
    alpha = scene.alpha
    sub = scene._replace(geometry=alpha.geometry, bvh=alpha.bvh, alpha=None)
    if cfg.traversal == TraversalMode.BRUTE_FORCE:
        def trace_fn(lo_t, hi_t):
            return intersect.intersect_closest_brute(sub.geometry, o, d, lo_t, hi_t,
                                                     cull_backface=cull_backface)
    else:
        def trace_fn(lo_t, hi_t):
            return traverse_closest(cfg, sub.bvh, o, d, lo_t, hi_t, cull_backface)

    hit = _resolve_alpha(sub, trace_fn, trace_fn(t_min, t_max), t_max)
    tri_global = alpha.tri_map[hit.tri.long().clamp(0, alpha.tri_map.shape[0] - 1)]
    return hit._replace(tri=torch.where(hit.is_hit, tri_global, hit.tri))


def _merge_closest(hit_a: Hit, hit_b: Hit) -> Hit:
    """Merge two closest-hit records by (t, triangle id), the per-ray
    kernels' order-independent rule: an exact-t tie goes to the lower id."""
    better = (hit_a.t < hit_b.t) | ((hit_a.t == hit_b.t) & (hit_a.tri < hit_b.tri))
    better &= hit_a.is_hit
    return Hit(*[torch.where(better, a, b) for a, b in zip(hit_a, hit_b)])


def trace_closest(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor, cull_backface: bool = True, reorder: bool = False,
) -> Hit:
    """Closest hit of each ray against the scene.  ``reorder=True`` sorts
    the rays into coherence order (``ops.reorder``) for the traversal and
    restores their order after it."""
    use_alpha = scene.textures is not None and cfg.alpha_visibility
    if use_alpha and scene.alpha is not None:
        hit_o = trace_closest(_opaque_view(scene), cfg, o, d, t_min, t_max,
                              cull_backface=cull_backface, reorder=reorder)
        hit_a = _closest_alpha_subset(scene, cfg, o, d, t_min,
                                      torch.minimum(t_max, hit_o.t), cull_backface)
        return _merge_closest(hit_a, hit_o)

    brute = cfg.traversal == TraversalMode.BRUTE_FORCE or scene.bvh is None
    if brute:
        def trace_fn(lo_t, hi_t):
            return intersect.intersect_closest_brute(scene.geometry, o, d, lo_t, hi_t,
                                                     cull_backface=cull_backface)
    else:
        def trace_fn(lo_t, hi_t):
            return traverse_closest(cfg, scene.bvh, o, d, lo_t, hi_t, cull_backface)

    if reorder and not brute:
        order = reorder_mod.make_order(o, d, t_min, t_max, *root_bounds(scene.bvh))
        hit = traverse_closest(cfg, scene.bvh,
                               *reorder_mod.apply_order(order, o, d, t_min, t_max),
                               cull_backface)
        hit = Hit(*reorder_mod.unapply_order(order, *hit))
    else:
        hit = trace_fn(t_min, t_max)
    if use_alpha:
        # the re-trace rounds run in the rays' own order
        hit = _resolve_alpha(scene, trace_fn, hit, t_max)
    return hit


def trace_any(
    scene: Scene, cfg: Config, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor, reorder: bool = False,
) -> Tensor:
    """Visibility query: is [t_min, t_max] of each ray blocked?"""
    if scene.textures is not None and cfg.alpha_visibility:
        if scene.alpha is not None:
            # opaque occluders keep the any-hit kernel; only the cutout
            # subset pays the alpha loop, on its own small tree
            blocked = trace_any(_opaque_view(scene), cfg, o, d, t_min, t_max,
                                reorder=reorder)
            hit_a = _closest_alpha_subset(scene, cfg, o, d, t_min, t_max,
                                          cull_backface=False)
            return blocked | hit_a.is_hit
        # no cutout subset: an occluder exists where a committed hit
        # survives the closest-hit alpha loop over the whole scene
        return trace_closest(scene, cfg, o, d, t_min, t_max, cull_backface=False,
                             reorder=reorder).is_hit
    if cfg.traversal == TraversalMode.BRUTE_FORCE or scene.bvh is None:
        return intersect.intersect_any_brute(scene.geometry, o, d, t_min, t_max)
    if reorder:
        order = reorder_mod.make_order(o, d, t_min, t_max, *root_bounds(scene.bvh))
        blocked = traverse_any(cfg, scene.bvh,
                               *reorder_mod.apply_order(order, o, d, t_min, t_max))
        return reorder_mod.unapply_order(order, blocked)[0]
    return traverse_any(cfg, scene.bvh, o, d, t_min, t_max)
