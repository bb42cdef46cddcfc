"""Two-level acceleration: instanced geometry and a per-frame BVH refit.

Counterpart of ``vulkanraytracing_tpu/accel/tlas.py``.  Object-space
triangle soups are concatenated once with a per-triangle instance id;
every frame the world-space geometry is recomputed by one batched
transform and the BVH is refitted: the topology (Morton order, Karras
tree, leaf ranges) is kept from the build frame and only the boxes and
triangle records are recomputed on the device, by the build's own route:
one pass per tree level (``BVH.topology``, found at the build), with no
readback.  Mirrored
instances (negative-determinant transforms) swap their winding so back
faces stay culled as on the unmirrored instance.

The transform is written out as elementwise products and sums, so each
triangle's world coordinates depend on its own values only: a refit and a
rebuild at the same transforms give bit-equal geometry.  Against the JAX
package (whose ``einsum`` sums in another order) they agree within 1e-6
relative.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch.accel.lbvh import (
    _pack_tris,
    build_bvh,
    node_records,
    triangle_boxes,
)
from vulkanraytracing_torch.scene.types import BVH, TraceGeometry, concat_geometry


class InstanceSoup(NamedTuple):
    """Concatenated object-space geometry with per-triangle instance ids."""

    object_geometry: TraceGeometry  # (T, ...) object space
    instance_id: Tensor             # (T,) i32 — the instance custom index

    def to(self, device) -> "InstanceSoup":
        return InstanceSoup(self.object_geometry.to(device), self.instance_id.to(device))


def make_instances(
    blases: list[TraceGeometry],
    blas_ids: list[int],
    material_offsets: list[int] | None = None,
) -> InstanceSoup:
    """Duplicate each referenced BLAS per instance (object space).

    ``blas_ids[i]`` selects the BLAS of instance i; ``material_offsets[i]``
    (optional) is added to that copy's material ids."""
    parts, inst_ids = [], []
    for i, bid in enumerate(blas_ids):
        g = blases[bid]
        if material_offsets is not None and material_offsets[i]:
            g = g._replace(material_id=g.material_id + material_offsets[i])
        parts.append(g)
        inst_ids.append(torch.full((g.num_triangles,), i, dtype=torch.int32,
                                   device=g.v0.device))
    return InstanceSoup(object_geometry=concat_geometry(parts),
                        instance_id=torch.cat(inst_ids))


def _mat_vec(rot: Tensor, v: Tensor) -> Tensor:
    """rot (T, 3, 3) times v (T, K, 3), row by row in one fixed order."""
    return torch.stack([
        rot[:, None, i, 0] * v[..., 0] + rot[:, None, i, 1] * v[..., 1]
        + rot[:, None, i, 2] * v[..., 2]
        for i in range(3)
    ], dim=-1)


def _normalize(v: Tensor) -> Tensor:
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])
    return v / torch.clamp_min(n, 1e-20)[..., None]


def _det3(m: Tensor) -> Tensor:
    """Determinants of (I, 3, 3) matrices by cofactors (only the sign is
    read)."""
    return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
            - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
            + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))


def world_geometry(soup: InstanceSoup, transforms: Tensor) -> TraceGeometry:
    """Transform the soup to world space; transforms is (I, 4, 4) (or
    (I, 3, 4)) on the soup's device.

    Positions and shading normals/tangents are transformed by M (not its
    inverse transpose, as the reference's closest-hit shader does), the
    vectors renormalized; winding is flipped for mirrored instances."""
    g = soup.object_geometry
    inst = soup.instance_id.long()
    m = transforms.to(torch.float32)
    rot = m[inst, :3, :3]
    trans = m[inst, :3, 3]
    vecs = torch.stack([g.v0, g.v0 + g.e1, g.v0 + g.e2,
                        g.n0, g.n1, g.n2, g.t0, g.t1, g.t2], dim=1)
    out = _mat_vec(rot, vecs)
    v0, p1, p2 = (out[:, :3] + trans[:, None]).unbind(dim=1)
    n0, n1, n2, t0, t1, t2 = _normalize(out[:, 3:]).unbind(dim=1)
    e1 = p1 - v0
    e2 = p2 - v0

    mirrored = (_det3(m[:, :3, :3]) < 0.0)[inst]

    # winding flip for mirrored instances: swap corners 1 and 2
    def pick(a, b):
        return torch.where(mirrored[:, None], b, a)

    return TraceGeometry(
        v0=v0,
        e1=pick(e1, e2),
        e2=pick(e2, e1),
        n0=n0,
        n1=pick(n1, n2),
        n2=pick(n2, n1),
        t0=t0,
        t1=pick(t1, t2),
        t2=pick(t2, t1),
        uv0=g.uv0,
        uv1=pick(g.uv1, g.uv2),
        uv2=pick(g.uv2, g.uv1),
        material_id=g.material_id,
        cull_disable=g.cull_disable,
        opaque=g.opaque,
        alpha_test=g.alpha_test,
    )


def build_tlas(
    soup: InstanceSoup, transforms: Tensor
) -> tuple[TraceGeometry, BVH, Tensor]:
    """Initial build: world transform and a full LBVH.  Returns (geometry
    in Morton order, bvh, order); keep ``order`` to refit: the soup is
    permuted once (``permute_soup``) so refits skip re-sorting."""
    geom_sorted, bvh = build_bvh(world_geometry(soup, transforms))
    return geom_sorted, bvh, bvh.tri_order


def permute_soup(soup: InstanceSoup, order: Tensor) -> InstanceSoup:
    """Apply the build-time Morton order to the soup so refits keep ids
    aligned with the tree's leaf ranges."""
    order = order.long()
    return InstanceSoup(object_geometry=soup.object_geometry.take(order),
                        instance_id=soup.instance_id[order])


def refit_tlas(
    bvh: BVH, soup_sorted: InstanceSoup, transforms: Tensor
) -> tuple[TraceGeometry, BVH]:
    """Per-frame refit: recompute the world geometry (already in Morton
    order) and propagate boxes bottom-up through the fixed topology, by
    the build's own route (``accel.lbvh.node_records``).  The padding
    row's empty boxes become (+inf, -inf), as in the JAX package.  The
    returned BVH carries the topology and no cached traversal table, so
    the next trace builds its table over the new boxes."""
    if bvh.topology is None or bvh.nodes8 is not None:
        raise ValueError(
            "refit_tlas refits the 2-wide LBVH of build_tlas (it needs the "
            "build's topology; an 8-wide collapse would keep last frame's boxes)"
        )
    geom = world_geometry(soup_sorted, transforms)
    tri_lo, tri_hi = triangle_boxes(geom)
    nodes = node_records(tri_lo, tri_hi, bvh.topology)
    empty = torch.tensor([torch.inf] * 3 + [-torch.inf] * 3, device=nodes.device).repeat(2)
    nodes = torch.cat([nodes, empty.expand(bvh.nodes.shape[0] - nodes.shape[0], 12)])

    tris, tri_flags = _pack_tris(geom)
    new_bvh = BVH(
        nodes=nodes,
        child_index=bvh.child_index,
        tris=tris,
        tri_flags=tri_flags,
        tri_order=bvh.tri_order,
        topology=bvh.topology,
    )
    return geom, new_bvh
