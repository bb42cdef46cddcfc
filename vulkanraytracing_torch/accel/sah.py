"""ctypes bridge to the native binned-SAH BVH builder.

Counterpart of ``vulkanraytracing_tpu/accel/sah.py``.  The builder is
``csrc/sah_builder.cpp``, a byte-equal copy of the JAX package's
``native/sah_builder.cpp`` (a test holds the two equal), compiled with the
same g++ flags into the port's own build directory, so both packages
build bit-identical trees from the same triangles.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vulkanraytracing_torch import native
from vulkanraytracing_torch.accel.lbvh import LEAF_SIZE, _pack_tris, build_scene_bvh, pad_nodes
from vulkanraytracing_torch.scene.types import BVH, Scene, TraceGeometry

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _library() -> ctypes.CDLL:
    src = native.CSRC_DIR / "sah_builder.cpp"
    path = native.build_library("sah_builder", native.GXX, [src])
    return native.load_library(path, {
        "build_sah_bvh": (ctypes.c_int, [
            _FP, _FP, _FP,          # tri_lo, tri_hi, centroids (T, 3)
            ctypes.c_int,           # num_tris
            ctypes.c_int,           # leaf_size
            _IP,                    # child_index out (T, 2)
            _FP,                    # child_box out (T, 12)
            _IP,                    # tri_order out (T,)
        ]),
    })


def build_bvh_sah(
    geometry: TraceGeometry, leaf_size: int = LEAF_SIZE
) -> tuple[TraceGeometry, BVH]:
    """Build a binned-SAH BVH; returns (geometry in BVH order, BVH)."""
    if not 1 <= leaf_size <= LEAF_SIZE:
        raise ValueError(f"leaf_size must be in [1, {LEAF_SIZE}], got {leaf_size}")
    lib = _library()
    v0 = geometry.v0.detach().cpu().numpy().astype(np.float32)
    p1 = v0 + geometry.e1.detach().cpu().numpy().astype(np.float32)
    p2 = v0 + geometry.e2.detach().cpu().numpy().astype(np.float32)
    tri_lo = np.ascontiguousarray(np.minimum(np.minimum(v0, p1), p2))
    tri_hi = np.ascontiguousarray(np.maximum(np.maximum(v0, p1), p2))
    centroids = np.ascontiguousarray(((tri_lo + tri_hi) * 0.5).astype(np.float32))

    t = v0.shape[0]
    max_nodes = max(t, 1)
    child_index = np.zeros((max_nodes, 2), np.int32)
    child_box = np.zeros((max_nodes, 12), np.float32)
    tri_order = np.zeros((t,), np.int32)
    n_nodes = lib.build_sah_bvh(
        tri_lo.ctypes.data_as(_FP), tri_hi.ctypes.data_as(_FP),
        centroids.ctypes.data_as(_FP), t, leaf_size,
        child_index.ctypes.data_as(_IP), child_box.ctypes.data_as(_FP),
        tri_order.ctypes.data_as(_IP),
    )
    if n_nodes <= 0:
        raise RuntimeError(f"SAH build failed ({n_nodes}) for {t} tris")

    device = geometry.v0.device
    order = torch.from_numpy(tri_order).to(device)
    geometry = geometry.take(order.long())
    nodes, child = pad_nodes(
        torch.from_numpy(child_box[:n_nodes]).to(device),
        torch.from_numpy(child_index[:n_nodes]).to(device),
        t,
    )
    tris, tri_flags = _pack_tris(geometry)
    bvh = BVH(nodes=nodes, child_index=child, tris=tris, tri_flags=tri_flags,
              tri_order=order)
    return geometry, bvh


def build_scene_bvh_sah(scene: Scene, leaf_size: int = LEAF_SIZE) -> Scene:
    """The scene in SAH-tree order with its BVH: ``build_scene_bvh(scene,
    leaf_size, builder="sah")``, so the tree also carries the BVH8 collapse
    and, for a scene with cutouts, the cutout subset, as every build of the
    port does.  Its 2-wide arrays are the JAX ``build_scene_bvh_sah``'s."""
    return build_scene_bvh(scene, leaf_size, builder="sah")
