"""The on-device LBVH builder, the BVH layout shared by the builders, and
the scene-level build entry.

Counterpart of ``vulkanraytracing_tpu/accel/lbvh.py``.  ``build_bvh`` is
the Karras (2012) pipeline on tensors, on the geometry's device: triangle
boxes and centroids, 30-bit Morton codes, a stable sort, the binary radix
hierarchy, a bottom-up box refit, and the leaf collapse of subtrees of at
most ``LEAF_SIZE`` Morton-contiguous triangles.  Every step is integer
arithmetic or exact float min/max, plus one divide and adds in the JAX
package's order, so codes, order, child ids and boxes are bit-equal to
the JAX build on the same triangles.

Two departures from the JAX code, both in how, not what:
- PyTorch has no uint32 and no ``clz``.  Codes are held in int64 (they
  use 30 bits, so ``^`` is exact) and the leading-zero count of a 32-bit
  value comes from ``torch.frexp`` of it as float64 (exact below 2^53).
- The JAX refit loops until every node is ready, one readback per tree
  level here.  The topology is fixed, so the levels are found once, on
  the host, when the tree is built (``refit_levels``) and kept in
  ``BVH.topology`` with the Karras tree's box-table slots; the build and
  every refit (``node_records``) then run one pass per level with no
  readback.  Mins and maxes are exact in any order, so the boxes stay
  bit-equal.

Layout: each internal node packs both children's AABBs into one (12,)
record (c0.lo c0.hi c1.lo c1.hi) with child ids in a separate (N, 2)
int32 array; id >= 0 is a node, id < 0 a leaf ``~((start << 4) | count)``
over the BVH-ordered triangles.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from vulkanraytracing_torch.scene.types import (
    BVH,
    AlphaScene,
    Scene,
    Topology,
    TraceGeometry,
)

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


def _expand_bits_10(v: Tensor) -> Tensor:
    """Spread 10 bits to every third bit position (Morton interleave)."""
    v = v.to(torch.int64)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(centroids: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """30-bit Morton codes (int64) of points quantized into [lo, hi]
    (a 1024^3 grid)."""
    extent = torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((centroids - lo) / extent, 0.0, 0.99999994)
    cells = torch.clamp_max((q * 1024.0).to(torch.int64), 1023)
    return (
        (_expand_bits_10(cells[:, 0]) << 2)
        | (_expand_bits_10(cells[:, 1]) << 1)
        | _expand_bits_10(cells[:, 2])
    )


def _clz32(x: Tensor) -> Tensor:
    """Leading zeros of non-negative int64 values below 2^32, as 32-bit
    words (32 for 0): frexp's exponent is the bit length."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def _delta_codes(codes: Tensor, i: Tensor, j: Tensor, n: int) -> Tensor:
    """Common-prefix length delta(i, j) over the conceptual 64-bit key
    (code << 32 | index), the duplicate-code tie-break.  Out-of-range j
    yields -1."""
    j_in = (j >= 0) & (j < n)
    j_safe = j.clamp(0, n - 1)
    x = codes[i] ^ codes[j_safe]
    delta = torch.where(x != 0, _clz32(x), 32 + _clz32(i ^ j_safe))
    return torch.where(j_in, delta, -1)


def karras_hierarchy(codes: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The binary radix tree over sorted Morton codes.

    Returns int32 (child_left, child_right, range_lo, range_hi) for the
    n-1 internal nodes; child >= 0 is an internal node id, child < 0 a
    single-triangle leaf ``~tri``.  range_lo/hi is the sorted-triangle
    span each node covers.  Node 0 is the root."""
    n = codes.shape[0]
    i = torch.arange(n - 1, dtype=torch.int64, device=codes.device)

    def delta(a, b):
        return _delta_codes(codes, a, b, n)

    # static iteration bound: ranges are at most n long
    k_iters = max(int(n - 1).bit_length() + 1, 2)

    # direction of the range containing i
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)

    # upper bound of the range length by exponential search (fixed trip
    # count: the search is monotone, so extra iterations change nothing)
    delta_min = delta(i, i - d)
    lmax = torch.full_like(i, 2)
    for _ in range(k_iters):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)

    # binary search of the exact range end
    length = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(k_iters):
        cond = (t > 0) & (delta(i, i + (length + t) * d) > delta_min)
        length = torch.where(cond, length + t, length)
        t = t // 2
    j = i + length * d  # the other end of the range

    # binary search of the split (the highest differing bit in the range)
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = -(-length // 2)  # ceil(length / 2)
    for _ in range(k_iters):
        cond = (t > 0) & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(cond, s + t, s)
        t = torch.where(t > 1, -(-t // 2), 0)
    gamma = i + s * d + torch.clamp_max(d, 0)

    range_lo = torch.minimum(i, j)
    range_hi = torch.maximum(i, j)
    child_left = torch.where(range_lo == gamma, ~gamma, gamma)
    child_right = torch.where(range_hi == gamma + 1, ~(gamma + 1), gamma + 1)
    return tuple(x.to(torch.int32) for x in (child_left, child_right,
                                              range_lo, range_hi))


def refit_levels(child: np.ndarray) -> list[np.ndarray]:
    """Bottom-up passes over an (N, 2) child array (host numpy): pass k
    holds the rows whose node children were all finished by passes < k.
    These are exactly the rows the JAX refit's readiness loop finishes in
    its k-th iteration, unreachable and padding rows included."""
    internal = child >= 0
    kid = np.where(internal, child, 0)
    ready = np.zeros(child.shape[0], bool)
    levels = []
    while not ready.all():
        now = ~ready & (~internal | ready[kid]).all(axis=1)
        if not now.any():
            raise ValueError("the child array is not a forest")
        levels.append(np.nonzero(now)[0])
        ready |= now
    return levels


def worst_case_stack(child: np.ndarray) -> int:
    """Worst-case stack need of the BVH2 traversal (kernel, CPU twin and
    plain version alike) over an (N, 2) child array (host numpy).  A node
    visit pushes one entry when both children are hit, a leaf visit
    pushes nothing, so the need is the largest number of internal nodes
    on a root-to-node path.  A refit keeps the topology, and this bound."""
    depth = 0
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        depth += 1
        kids = child[frontier].ravel()
        frontier = kids[kids >= 0]
    return depth


def _levels_on(levels: list[np.ndarray], device) -> tuple[Tensor, ...]:
    return tuple(torch.from_numpy(x.astype(np.int64)).to(device) for x in levels)


def refit_passes(lo: Tensor, hi: Tensor, slot_left: Tensor, slot_right: Tensor,
                 levels: tuple[Tensor, ...]) -> None:
    """Bottom-up passes over a box table, in place.  Rows [0, N) of
    ``lo``/``hi`` are the N nodes, later rows hold leaf boxes;
    ``slot_left``/``slot_right`` (N,) give the table row of each node's
    children, and ``levels`` the node rows of each pass."""
    for rows in levels:
        left, right = slot_left[rows], slot_right[rows]
        lo[rows] = torch.minimum(lo[left], lo[right])
        hi[rows] = torch.maximum(hi[left], hi[right])


def _karras_slots(child_left: Tensor, child_right: Tensor) -> tuple[Tensor, Tensor]:
    """Box-table rows of each Karras node's children: rows [0, n-1) are
    the nodes, then one row per triangle."""
    n_int = child_left.shape[0]

    def slot(child):
        child = child.long()
        return torch.where(child >= 0, child, n_int + ~child)

    return slot(child_left), slot(child_right)


def _karras_box_table(leaf_lo, leaf_hi, slot_left, slot_right, levels):
    """Node and single-triangle leaf boxes of a Karras tree in one table:
    rows [0, n-1) the nodes (refitted), then the n triangles."""
    inf = torch.full((leaf_lo.shape[0] - 1, 3), torch.inf, dtype=torch.float32,
                     device=leaf_lo.device)
    lo, hi = torch.cat([inf, leaf_lo]), torch.cat([-inf, leaf_hi])
    refit_passes(lo, hi, slot_left, slot_right, levels)
    return lo, hi


def node_records(tri_lo: Tensor, tri_hi: Tensor, topology: Topology) -> Tensor:
    """The (k, 12) node records (c0.lo c0.hi c1.lo c1.hi) of an LBVH's k
    unpadded nodes over BVH-ordered triangle boxes.  The leaf collapse only
    re-encodes child ids, so each child's box is its Karras node's box:
    the build and every refit compute the records by this one route."""
    lo, hi = _karras_box_table(tri_lo, tri_hi, topology.slot_left,
                               topology.slot_right, topology.levels)
    sl, sr = topology.slot_left, topology.slot_right
    return torch.cat([lo[sl], hi[sl], lo[sr], hi[sr]], dim=1)


def refit_aabbs(
    child_left: Tensor, child_right: Tensor, leaf_lo: Tensor, leaf_hi: Tensor
) -> tuple[Tensor, Tensor]:
    """Bottom-up AABB propagation over a Karras tree: per-internal-node
    boxes (N-1, 3) lo/hi.  Reads the children back once to find the
    passes (``refit_levels``)."""
    child = torch.stack([child_left, child_right], dim=1).cpu().numpy()
    levels = _levels_on(refit_levels(child), child_left.device)
    lo, hi = _karras_box_table(leaf_lo, leaf_hi, *_karras_slots(child_left, child_right),
                               levels)
    n_int = child_left.shape[0]
    return lo[:n_int], hi[:n_int]


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


def triangle_boxes(geometry: TraceGeometry) -> tuple[Tensor, Tensor]:
    """Per-triangle (lo, hi) boxes of v0, v0 + e1, v0 + e2."""
    v0 = geometry.v0
    p1 = v0 + geometry.e1
    p2 = v0 + geometry.e2
    return (torch.minimum(torch.minimum(v0, p1), p2),
            torch.maximum(torch.maximum(v0, p1), p2))


def build_bvh(
    geometry: TraceGeometry, leaf_size: int = LEAF_SIZE
) -> tuple[TraceGeometry, BVH]:
    """Build the LBVH on the geometry's device; returns (geometry in
    Morton order, BVH with its ``topology``).  The tree's child array is
    read to the host once, to find the refit passes and the stack bound."""
    if not 1 <= leaf_size <= LEAF_SIZE:
        raise ValueError(f"leaf_size must be in [1, {LEAF_SIZE}], got {leaf_size}")
    n = geometry.num_triangles
    if n == 0:
        raise ValueError("cannot build a BVH over no triangles")
    dev = geometry.v0.device
    tri_lo, tri_hi = triangle_boxes(geometry)
    centroid = (tri_lo + tri_hi) * 0.5
    codes = morton_codes(centroid, tri_lo.amin(dim=0), tri_hi.amax(dim=0))
    codes, order = torch.sort(codes, stable=True)

    geometry = geometry.take(order)
    tri_lo = tri_lo[order]
    tri_hi = tri_hi[order]

    if n == 1:
        leaf = encode_leaf(torch.zeros((1,), dtype=torch.int32, device=dev),
                           torch.ones((1,), dtype=torch.int32, device=dev))
        child_index = torch.stack([leaf, leaf], dim=1)
        # both children are the triangle's row of a table with no node rows
        slot_left = slot_right = torch.zeros((1,), dtype=torch.int64, device=dev)
        levels = []
    else:
        child_left, child_right, range_lo, range_hi = karras_hierarchy(codes)
        levels = refit_levels(
            torch.stack([child_left, child_right], dim=1).cpu().numpy())
        slot_left, slot_right = _karras_slots(child_left, child_right)

        def collapse(child):
            """Re-encode children whose subtree fits in one leaf."""
            is_leaf = child < 0
            node = torch.where(is_leaf, 0, child).long()
            start = range_lo[node]
            count = range_hi[node] - start + 1
            small = ~is_leaf & (count <= leaf_size)
            single = encode_leaf(torch.where(is_leaf, ~child, 0), torch.ones_like(child))
            ranged = encode_leaf(start, count)
            return torch.where(is_leaf, single, torch.where(small, ranged, child))

        child_index = torch.stack([collapse(child_left), collapse(child_right)], dim=1)

    topology = Topology(levels=_levels_on(levels, dev), slot_left=slot_left,
                        slot_right=slot_right,
                        stack_need=worst_case_stack(child_index.cpu().numpy()))
    nodes, child_index = pad_nodes(node_records(tri_lo, tri_hi, topology), child_index, n)
    tris, tri_flags = _pack_tris(geometry)
    bvh = BVH(
        nodes=nodes,
        child_index=child_index,
        tris=tris,
        tri_flags=tri_flags,
        tri_order=order.to(torch.int32),
        topology=topology,
    )
    return geometry, bvh


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


def _build(geometry: TraceGeometry, leaf_size: int, builder: str):
    """(geometry in BVH order, BVH with its 8-wide collapse)."""
    from vulkanraytracing_torch.accel.bvh8 import collapse_bvh8

    if builder == "sah":
        from vulkanraytracing_torch.accel.sah import build_bvh_sah

        geometry, bvh = build_bvh_sah(geometry, leaf_size)
    elif builder == "lbvh":
        geometry, bvh = build_bvh(geometry, leaf_size)
    else:
        raise ValueError(f"builder must be 'lbvh' or 'sah', got {builder!r}")
    return geometry, collapse_bvh8(bvh)


def build_scene_bvh(
    scene: Scene, leaf_size: int = LEAF_SIZE, builder: str = "lbvh"
) -> Scene:
    """Permute the scene geometry into BVH order and attach its BVH with
    the BVH8 collapse the 8-wide traversal kernel reads, and the cutout
    subset (``_attach_alpha_set``) where the scene has alpha-tested
    triangles.

    builder: "lbvh" (on-device, fast build) or "sah" (the native binned
    SAH builder, higher-quality trees for static scenes)."""
    geometry, bvh = _build(scene.geometry, leaf_size, builder)
    return _attach_alpha_set(scene._replace(geometry=geometry, bvh=bvh), leaf_size, builder)


def _attach_alpha_set(scene: Scene, leaf_size: int, builder: str) -> Scene:
    """Build the tree of the alpha-tested triangles alone
    (``scene.types.AlphaScene``) and the main tree's opaque view, when the
    scene has such triangles; ``ops.trace`` then splits every trace into an
    opaque phase and a cheap cutout phase.  Reads the flags back once."""
    at = scene.geometry.alpha_test
    if not bool(at.any()):
        return scene
    alpha_idx = torch.nonzero(at).squeeze(1)
    sub_geom, sub_bvh = _build(scene.geometry.take(alpha_idx), leaf_size, builder)
    tri_map = alpha_idx[sub_bvh.tri_order.long()].to(torch.int32)
    return scene._replace(alpha=AlphaScene(geometry=sub_geom, bvh=sub_bvh, tri_map=tri_map,
                                           opaque_bvh=scene.bvh.opaque_view()))
