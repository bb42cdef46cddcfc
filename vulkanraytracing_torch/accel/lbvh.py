"""BVH layout shared by the builders, and the scene-level build entry.

Counterpart of ``vulkanraytracing_tpu/accel/lbvh.py``.  The port builds
static scenes with the native binned-SAH builder (``accel.sah``) followed
by the BVH8 collapse (``accel.bvh8``); the on-device LBVH (Morton codes,
Karras hierarchy, refit) is not ported yet, so ``builder="lbvh"`` raises.

Layout: each internal node packs both children's AABBs into one (12,)
record (c0.lo c0.hi c1.lo c1.hi) with child ids in a separate (N, 2)
int32 array; id >= 0 is a node, id < 0 a leaf ``~((start << 4) | count)``
over the BVH-ordered triangles.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.scene.types import Scene, TraceGeometry, check_supported

# Max triangles per leaf (4 bits of the leaf code hold the count; the BVH8
# leaf alignment needs <= 8).
LEAF_SIZE = 8

_DONE_PAD = -1  # leaf code decoding to (start 0, count 0): never matches


def encode_leaf(start: Tensor, count: Tensor) -> Tensor:
    """Leaf child id: negative int packing (start, count)."""
    return ~((start << 4) | count)


def decode_leaf(idx: Tensor) -> tuple[Tensor, Tensor]:
    packed = ~idx
    return packed >> 4, packed & 15


def _pack_tris(geometry: TraceGeometry) -> tuple[Tensor, Tensor]:
    """(T, 12) float triangle records (v0, e1, e2, 3 pads) and (T,) int32
    flags: bit0 cull_disable, bit1 opaque (commits), bit2 alpha_test."""
    flags = (
        geometry.cull_disable.to(torch.int32)
        | (geometry.opaque.to(torch.int32) << 1)
        | (geometry.alpha_test.to(torch.int32) << 2)
    )
    pad = torch.zeros_like(geometry.v0)
    tris = torch.cat([geometry.v0, geometry.e1, geometry.e2, pad], dim=1)
    return tris, flags


def pad_nodes(nodes: Tensor, child_index: Tensor, num_tris: int):
    """Pad node arrays to exactly ``num_tris`` rows, as the JAX builders do
    (padding rows are unreachable: zero boxes, leaf code -1)."""
    pad = num_tris - nodes.shape[0]
    if pad <= 0:
        return nodes, child_index
    nodes = torch.cat([nodes, nodes.new_zeros((pad, nodes.shape[1]))], dim=0)
    child_index = torch.cat(
        [child_index, child_index.new_full((pad, 2), _DONE_PAD)], dim=0
    )
    return nodes, child_index


def build_scene_bvh(
    scene: Scene, leaf_size: int = LEAF_SIZE, builder: str = "sah"
) -> Scene:
    """Permute the scene geometry into BVH order and attach its BVH,
    including the BVH8 collapse the traversal kernel reads."""
    check_supported(scene)
    if builder != "sah":
        raise NotImplementedError(
            f"builder={builder!r}: only the native SAH builder is ported"
        )
    from vulkanraytracing_torch.accel.bvh8 import collapse_bvh8
    from vulkanraytracing_torch.accel.sah import build_bvh_sah

    geometry, bvh = build_bvh_sah(scene.geometry, leaf_size)
    return scene._replace(geometry=geometry, bvh=collapse_bvh8(bvh))
