"""Host-side BVH2 -> BVH8 collapse.

Counterpart of ``vulkanraytracing_tpu/accel/bvh8.py``.  The collapse is
``csrc/bvh8_collapse.cpp``, a byte-equal copy of the JAX package's
``native/bvh8_collapse.cpp`` (SAH-greedy: expand the
largest-area interior slot until 8 slots are filled, emit slots largest
first; empty slots get child 0 and a degenerate far box lo = hi = +3e38,
which the slab test rejects for every ray).  A failed native build raises:
there is no Python fallback.

Leaves are then row-aligned (``_align_leaves``): every leaf starts at a
multiple of ``TRIS_PER_ROW`` aligned slots, so ``tri_perm8`` matches the
JAX package's layout slot for slot.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vulkanraytracing_torch import native
from vulkanraytracing_torch.scene.types import BVH

TRIS_PER_ROW = 8

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _library() -> ctypes.CDLL:
    src = native.CSRC_DIR / "bvh8_collapse.cpp"
    path = native.build_library("bvh8_collapse", native.GXX, [src])
    return native.load_library(path, {
        "collapse_bvh8": (ctypes.c_int, [
            _FP,           # nodes (n, 12)
            _IP,           # child (n, 2)
            ctypes.c_int,  # n
            _FP,           # nodes8 out (n, 48)
            _IP,           # child8 out (n, 8)
        ]),
    })


def _collapse_native(nodes: np.ndarray, child: np.ndarray):
    lib = _library()
    n = nodes.shape[0]
    nodes = np.ascontiguousarray(nodes, np.float32)
    child = np.ascontiguousarray(child, np.int32)
    nodes8 = np.empty((n, 48), np.float32)
    child8 = np.empty((n, 8), np.int32)
    m = lib.collapse_bvh8(
        nodes.ctypes.data_as(_FP), child.ctypes.data_as(_IP), n,
        nodes8.ctypes.data_as(_FP), child8.ctypes.data_as(_IP),
    )
    if m <= 0:
        raise RuntimeError(f"BVH8 collapse failed ({m}) for {n} nodes")
    return nodes8[:m].copy(), child8[:m].copy()


def _worst_case_stack(child8: np.ndarray) -> int:
    """Worst-case stack need of the port's traversal (kernel, CPU twin and
    plain version alike).  A node visit pushes every hit child but the one
    it descends into, and a leaf visit pushes nothing, so the need is the
    largest sum, over a root-to-node path, of (non-empty children - 1).
    Nodes are in BFS order (parent id < child id); entries == 0 are empty
    slots, entries < 0 leaf codes.  (The TPU kernel's bound,
    7*(max_depth+1) + 1, also counts a leaf continuation it keeps.)"""
    m = child8.shape[0]
    if m == 0:
        return 0
    need = np.maximum((child8 != 0).sum(axis=1) - 1, 0).astype(np.int64)
    parent = np.full(m, -1, np.int64)
    rows, cols = np.nonzero(child8 > 0)
    parent[child8[rows, cols]] = rows
    for i in range(1, m):
        if parent[i] >= 0:
            need[i] += need[parent[i]]
    return int(need.max())


def _align_leaves(child8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row-aligned leaf triangle layout.  Returns (child8 with rewritten
    leaf codes, tri_perm8) where tri_perm8[i] is the BVH-order triangle in
    aligned slot i (-1 = padding)."""
    leaf_m = child8 < 0
    if not leaf_m.any():
        return child8, np.zeros((0,), np.int32)
    enc = ~child8[leaf_m]
    starts = enc >> 4
    counts = enc & 15
    if counts.max() > TRIS_PER_ROW:
        raise ValueError(
            f"leaf alignment requires leaf_size <= {TRIS_PER_ROW} "
            f"(got a {counts.max()}-tri leaf)"
        )
    uniq, inv = np.unique(starts, return_inverse=True)
    npairs = np.unique(np.stack([starts, counts], axis=1), axis=0).shape[0]
    if npairs != uniq.shape[0]:
        raise ValueError("leaf ranges share a start with differing counts")
    ucounts = np.zeros_like(uniq)
    ucounts[inv] = counts
    n = uniq.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), TRIS_PER_ROW)
    slots = np.tile(np.arange(TRIS_PER_ROW, dtype=np.int64), n)
    valid = slots < ucounts[rows]
    perm = np.full(n * TRIS_PER_ROW, -1, np.int32)
    perm[valid] = (uniq[rows] + slots)[valid].astype(np.int32)

    new_start = (np.arange(n, dtype=np.int64) * TRIS_PER_ROW)[inv]
    new_enc = ~((new_start << 4) | counts).astype(np.int64)
    out = child8.copy()
    out[leaf_m] = new_enc.astype(np.int32)
    return out, perm


def collapse_bvh8(bvh: BVH) -> BVH:
    """Attach (nodes8, child8, tri_perm8) to a host-built BVH.  Whether the
    traversal kernel's stack fits this tree is checked when its table is
    built (``ops.traverse_wide8.build_table8``)."""
    nodes8, child8 = _collapse_native(
        bvh.nodes.detach().cpu().numpy(), bvh.child_index.detach().cpu().numpy()
    )
    child8, perm8 = _align_leaves(child8)
    device = bvh.nodes.device
    return BVH(
        nodes=bvh.nodes, child_index=bvh.child_index, tris=bvh.tris,
        tri_flags=bvh.tri_flags, tri_order=bvh.tri_order,
        nodes8=torch.from_numpy(nodes8).to(device),
        child8=torch.from_numpy(child8).to(device),
        tri_perm8=torch.from_numpy(perm8).to(device),
    )
