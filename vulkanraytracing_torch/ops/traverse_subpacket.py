"""Subpacket traversal with work refill: the hand-written CUDA kernel and
its plain version.

Counterpart of ``vulkanraytracing_tpu/ops/traverse_subpacket.py``
(``TraversalMode.BVH_SUBPACKET``, the JAX package's
``BVH_PALLAS_SUBPACKET``): closest hit or occlusion over the 2-wide BVH
with ONE cursor and stack per packet of 128 consecutive rays.  The cursor
may hold a leaf code: an interior step moves it by the packet's minimum
entry distances, a leaf step tests the leaf for every lane and pops.
Three implementations share the BVH2 kernel's table (``Table2``):

- the CUDA kernel (``csrc/subpacket_traverse.cu``): a persistent grid of
  128-thread blocks, each taking its next packet from a global atomic
  counter when it finishes one (the TPU kernel's row refill), built with
  nvcc for ``sm_90a`` on first use, launched for CUDA tensors;
- the plain PyTorch version (``closest_plain`` / ``any_plain``): packet
  lockstep over ``(P, 128)`` lane tensors (``ops.packet_lockstep``),
  run for CPU tensors and held against the kernel on the card;
- the CPU twin (``closest_twin`` / ``any_twin``): the kernel's header
  compiled by g++, used only by the tests.

Packets are independent, so the order in which blocks take them changes
nothing: all three agree bit for bit.  The contract is the TPU packet
kernels' (``csrc/packet_common.cuh``; see ``ops.traverse_pallas``).
Closest-hit goes to the nearer hit child (child 0 on equal distances) and
pushes the other; any-hit goes to child 0 when it is hit, else child 1,
and retires a packet after a leaf step once every lane is occluded or
dead.  ``LAUNCHES`` counts kernel launches ("closest", "any").

Not ported, by design: the 128-lane table packing and what comes of it in
the TPU kernel (the row-mate leaf tests and the synthetic pushes of leaves
that span two rows, which change only which triangle wins an exact tie),
``return_counters``, the packet fallback past ``VMEM_TRI_LIMIT`` and the
trip cap.
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
    advance,
    commit_leaves,
    flat_hit,
    max_leaf_count,
    nearer_first,
    packet_state,
    run_packets,
    slab2,
)
from vulkanraytracing_torch.ops.traverse_wide import Table2, get_table2
from vulkanraytracing_torch.ops.traverse_wide8 import STACK_DEPTH, _canon_rays, _check, _ptrs
from vulkanraytracing_torch.scene.types import BVH

LANE = 128  # rays per packet: one block of the kernel

# Kernel launches per specialization ("closest", "any"), counted by the
# CUDA wrappers only.
LAUNCHES: collections.Counter = collections.Counter()


# --- the plain PyTorch version -------------------------------------------


def _traverse_plain(table: Table2, o, d, t_min, t_max, any_hit: bool,
                    cull_backface: bool) -> dict:
    kmax = max_leaf_count(table)

    def step(s):
        cur = s["cur"]
        act = cur != DONE
        inner = cur >= 0
        leaf = act & ~inner
        node = torch.where(inner, cur, 0)
        kids = table.child[node].long()                             # (P, 2)
        tn, ok = slab2(table.nodes[node], s)
        te = torch.where(ok, tn, BIG_T).amin(dim=2)                 # (P, 2)
        h0 = inner & (te[:, 0] < BIG_T)
        h1 = inner & (te[:, 1] < BIG_T)
        if any_hit:
            nxt = torch.where(h0, kids[:, 0], kids[:, 1])
            far = kids[:, 1]
        else:
            nxt, far = nearer_first(kids, h0, h1, te)
        # a leaf cursor tests its leaf for every lane, then pops
        commit_leaves(table, s, torch.where(leaf, cur, -1)[:, None], leaf[:, None],
                      kmax, cull_backface)
        nxt = advance(s, nxt, far, h0 & h1, h0 | h1)
        if any_hit:
            done = (s["hit"] | (s["t_min"] > s["best"])).all(dim=1)
            nxt = torch.where(leaf & done, DONE, nxt)
        s["cur"] = torch.where(act, nxt, DONE)

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
        "subpacket_traverse", cmd, [native.CSRC_DIR / "subpacket_traverse.cu"], HEADERS
    )
    return native.load_library(path, {
        "vrt_subpacket_closest": (_I, TABLE_ARGS + RAY_ARGS + [_I, _P, _P, _P, _P, _P, _P, _P]),
        "vrt_subpacket_any": (_I, TABLE_ARGS + RAY_ARGS + [_P, _P, _P]),
    })


def _next_packet(device) -> Tensor:
    """The kernel's work counter: one zeroed int32 per launch."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


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
        counter = _next_packet(o.device)
        with torch.cuda.device(o.device):
            err = lib.vrt_subpacket_closest(
                *_ptrs(*table, o, d, t_min, t_max), r, int(cull_backface),
                *_ptrs(counter, t, u, v, tri, bf),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"subpacket closest-hit launch failed: cudaError {err}")
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
        counter = _next_packet(o.device)
        with torch.cuda.device(o.device):
            err = lib.vrt_subpacket_any(
                *_ptrs(*table, o, d, t_min, t_max), r,
                *_ptrs(counter, out),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"subpacket any-hit launch failed: cudaError {err}")
        LAUNCHES["any"] += 1
    return out


# --- the CPU twin (tests only) --------------------------------------------


@functools.cache
def twin_library() -> ctypes.CDLL:
    """The kernel's header compiled by g++ for the host."""
    cmd = [*native.GXX, "-ffp-contract=off", f"-DVRT_STACK_DEPTH={STACK_DEPTH}",
           f"-I{native.CSRC_DIR}"]
    path = native.build_library(
        "subpacket_twin", cmd, [native.CSRC_DIR / "subpacket_twin.cpp"], HEADERS
    )
    return native.load_library(path, {
        "vrt_subpacket_closest_cpu": (_I, TABLE_ARGS + RAY_ARGS + [_I, _P, _P, _P, _P, _P]),
        "vrt_subpacket_any_cpu": (_I, TABLE_ARGS + RAY_ARGS + [_P]),
    })


def closest_twin(table: Table2, o, d, t_min, t_max, cull_backface=True) -> Hit:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((r,), dtype=torch.int32)
    bf = torch.empty((r,), dtype=torch.bool)
    twin_library().vrt_subpacket_closest_cpu(
        *_ptrs(*table, o, d, t_min, t_max), r, int(cull_backface),
        *_ptrs(t, u, v, tri, bf),
    )
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_twin(table: Table2, o, d, t_min, t_max) -> Tensor:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    out = torch.empty((o.shape[0],), dtype=torch.bool)
    twin_library().vrt_subpacket_any_cpu(
        *_ptrs(*table, o, d, t_min, t_max), o.shape[0], out.data_ptr()
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
    raise ValueError(f"no subpacket traversal for rays on {o.device}")


def intersect_any(bvh: BVH, o, d, t_min, t_max) -> Tensor:
    """Occlusion of [t_min, t_max) (no culling): the kernel for CUDA rays,
    the plain version for CPU rays."""
    table = get_table2(bvh)
    if o.device.type == "cuda":
        return any_cuda(table, o, d, t_min, t_max)
    if o.device.type == "cpu":
        return any_plain(table, o, d, t_min, t_max)
    raise ValueError(f"no subpacket traversal for rays on {o.device}")
