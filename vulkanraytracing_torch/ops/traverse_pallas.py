"""Shared-cursor packet traversal: the hand-written CUDA kernel and its
plain version.

Counterpart of ``vulkanraytracing_tpu/ops/traverse_pallas.py``
(``TraversalMode.BVH_SHARED``, the JAX package's ``BVH_PALLAS_SHARED``):
closest hit or occlusion over the 2-wide BVH with ONE cursor and stack per
packet of 1024 consecutive rays.  At each node the packet descends into a
child when any live lane's slab test hits it, nearer child first by the
packet's minimum entry distance, and tests hit leaf children at once.
Three implementations share the BVH2 kernel's table (``Table2``):

- the CUDA kernel (``csrc/shared_traverse.cu``, one block of 1024 threads
  per packet, built with nvcc for ``sm_90a`` on first use), launched for
  CUDA tensors;
- the plain PyTorch version (``closest_plain`` / ``any_plain``): packet
  lockstep over ``(P, 1024)`` lane tensors, one cursor per packet, with no
  host synchronization inside a step, run for CPU tensors and held against
  the kernel on the card;
- the CPU twin (``closest_twin`` / ``any_twin``): the kernel's header
  compiled by g++, used only by the tests.

All three visit nodes in the same order and round every operation the
same way, so they agree bit for bit.  The contract is the TPU packet
kernels' (``csrc/packet_common.cuh``): det epsilon 1e-30, the window
``t_min <= t < best`` with ``best`` starting at ``t_max`` (a hit exactly
at ``t_max`` is not committed), and on equal t the first triangle tested
wins.  ``intersect_closest`` / ``intersect_any`` take the plain version
only for CPU tensors; for CUDA tensors they launch the kernel, and a
failed build or launch raises.  ``LAUNCHES`` counts kernel launches
("closest", "any").

Not ported, by design: the TPU kernel's 128-lane table packing, its ray
chunking and its packet fallback past ``VMEM_TRI_LIMIT`` (the table lives
in global memory), and its trip cap (traversal ends through the bounded
stack).  The plain version is made of ``ops.packet_lockstep``'s helpers.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
from torch import Tensor

from vulkanraytracing_torch import native
from vulkanraytracing_torch.ops.intersect import BIG_T, Hit
from vulkanraytracing_torch.ops.packet_lockstep import (
    DONE,
    HEADERS,
    RAY_ARGS,
    TABLE_ARGS,
    commit_leaves,
    descend,
    flat_hit,
    max_leaf_count,
    packet_state,
    run_packets,
    slab2,
)
from vulkanraytracing_torch.ops.traverse_wide import Table2, get_table2
from vulkanraytracing_torch.ops.traverse_wide8 import STACK_DEPTH, _canon_rays, _check, _ptrs
from vulkanraytracing_torch.scene.types import BVH

LANE = 1024  # rays per packet: one block of the kernel

# Kernel launches per specialization ("closest", "any"), counted by the
# CUDA wrappers only.
LAUNCHES: collections.Counter = collections.Counter()


# --- the plain PyTorch version -------------------------------------------


def _traverse_plain(table: Table2, o, d, t_min, t_max, any_hit: bool,
                    cull_backface: bool) -> dict:
    kmax = max_leaf_count(table)

    def step(s):
        act = s["cur"] != DONE
        node = torch.where(act, s["cur"], 0)
        kids = table.child[node].long()                             # (P, 2)
        live = s["live0"] & act[:, None]
        if any_hit:
            live = live & ~s["hit"]
        tn, ok = slab2(table.nodes[node], s)
        lane_hit = ok & live[:, None]
        hit = lane_hit.any(dim=2)                                   # (P, 2)
        te = torch.where(lane_hit, tn, BIG_T).amin(dim=2)
        commit_leaves(table, s, torch.where(hit & (kids < 0), kids, -1), live,
                      kmax, cull_backface)
        descend(s, act, kids, hit & (kids >= 0), te, any_hit)

    return run_packets(packet_state(o, d, t_min, t_max, LANE), step, graphs=True)


def closest_plain(table: Table2, o, d, t_min, t_max, cull_backface=True) -> Hit:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    return flat_hit(_traverse_plain(table, o, d, t_min, t_max, False, cull_backface),
                    o.shape[0])


def any_plain(table: Table2, o, d, t_min, t_max) -> Tensor:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    return _traverse_plain(table, o, d, t_min, t_max, True, False)["hit"].reshape(-1)[
        : o.shape[0]]


# --- the CUDA kernel -------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (nvcc, sm_90a) and load the traversal kernel."""
    cmd = [native.nvcc_path(), *native.NVCC_FLAGS,
           f"-DVRT_STACK_DEPTH={STACK_DEPTH}", f"-I{native.CSRC_DIR}"]
    path = native.build_library(
        "shared_traverse", cmd, [native.CSRC_DIR / "shared_traverse.cu"], HEADERS
    )
    return native.load_library(path, {
        "vrt_shared_closest": (_I, TABLE_ARGS + RAY_ARGS + [_I, _P, _P, _P, _P, _P, _P]),
        "vrt_shared_any": (_I, TABLE_ARGS + RAY_ARGS + [_P, _P]),
    })


def closest_cuda(table: Table2, o, d, t_min, t_max, cull_backface=True) -> Hit:
    """Launch the closest-hit kernel on the current stream."""
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cuda")
    lib = cuda_library()
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((r,), dtype=torch.int32, device=o.device)
    bf = torch.empty((r,), dtype=torch.bool, device=o.device)
    if r:
        with torch.cuda.device(o.device):
            err = lib.vrt_shared_closest(
                *_ptrs(*table.arrays, o, d, t_min, t_max), r, int(cull_backface),
                *_ptrs(t, u, v, tri, bf),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"shared-cursor closest-hit launch failed: cudaError {err}")
        LAUNCHES["closest"] += 1
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_cuda(table: Table2, o, d, t_min, t_max) -> Tensor:
    """Launch the any-hit kernel on the current stream."""
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cuda")
    lib = cuda_library()
    r = o.shape[0]
    out = torch.empty((r,), dtype=torch.bool, device=o.device)
    if r:
        with torch.cuda.device(o.device):
            err = lib.vrt_shared_any(
                *_ptrs(*table.arrays, o, d, t_min, t_max), r, out.data_ptr(),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"shared-cursor any-hit launch failed: cudaError {err}")
        LAUNCHES["any"] += 1
    return out


# --- the CPU twin (tests only) --------------------------------------------


@functools.cache
def twin_library() -> ctypes.CDLL:
    """The kernel's header compiled by g++ for the host."""
    cmd = [*native.GXX, "-ffp-contract=off", f"-DVRT_STACK_DEPTH={STACK_DEPTH}",
           f"-I{native.CSRC_DIR}"]
    path = native.build_library(
        "shared_twin", cmd, [native.CSRC_DIR / "shared_twin.cpp"], HEADERS
    )
    return native.load_library(path, {
        "vrt_shared_closest_cpu": (_I, TABLE_ARGS + RAY_ARGS + [_I, _P, _P, _P, _P, _P]),
        "vrt_shared_any_cpu": (_I, TABLE_ARGS + RAY_ARGS + [_P]),
    })


def closest_twin(table: Table2, o, d, t_min, t_max, cull_backface=True) -> Hit:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((r,), dtype=torch.int32)
    bf = torch.empty((r,), dtype=torch.bool)
    twin_library().vrt_shared_closest_cpu(
        *_ptrs(*table.arrays, o, d, t_min, t_max), r, int(cull_backface),
        *_ptrs(t, u, v, tri, bf),
    )
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_twin(table: Table2, o, d, t_min, t_max) -> Tensor:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    out = torch.empty((o.shape[0],), dtype=torch.bool)
    twin_library().vrt_shared_any_cpu(
        *_ptrs(*table.arrays, o, d, t_min, t_max), o.shape[0], out.data_ptr()
    )
    return out


# --- public entries --------------------------------------------------------


def intersect_closest(bvh: BVH, o, d, t_min, t_max, cull_backface=True) -> Hit:
    """Closest hit over the BVH's 2-wide arrays: the kernel for CUDA rays,
    the plain version for CPU rays."""
    table = get_table2(bvh)
    if o.device.type == "cuda":
        return closest_cuda(table, o, d, t_min, t_max, cull_backface)
    if o.device.type == "cpu":
        return closest_plain(table, o, d, t_min, t_max, cull_backface)
    raise ValueError(f"no shared-cursor traversal for rays on {o.device}")


def intersect_any(bvh: BVH, o, d, t_min, t_max) -> Tensor:
    """Occlusion of [t_min, t_max) (no culling): the kernel for CUDA rays,
    the plain version for CPU rays."""
    table = get_table2(bvh)
    if o.device.type == "cuda":
        return any_cuda(table, o, d, t_min, t_max)
    if o.device.type == "cpu":
        return any_plain(table, o, d, t_min, t_max)
    raise ValueError(f"no shared-cursor traversal for rays on {o.device}")
