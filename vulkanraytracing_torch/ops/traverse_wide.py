"""BVH2 traversal: the hand-written CUDA kernel and its plain version.

Counterpart of ``vulkanraytracing_tpu/ops/traverse_wide.py``: the same
``Hit`` contract over a 2-wide BVH with no 8-wide collapse, which is what
every LBVH build and TLAS refit gives (``accel.lbvh.build_bvh``,
``accel.tlas``).  Three implementations share one table (``Table2``):

- the CUDA kernel (``csrc/bvh2_traverse.cu``: persistent warps that take
  rays from a queue, each lane walking one ray; built with nvcc for
  ``sm_90a`` on first use), launched for CUDA tensors;
- the plain PyTorch version (``closest_plain`` / ``any_plain``): the same
  per-ray algorithm in lockstep over all rays
  (``ops.traverse_wide8.lockstep``), run for CPU tensors and held against
  the kernel on the card;
- the CPU twin (``closest_twin`` / ``any_twin``): the kernel's header
  compiled by g++, used only by the tests.

All three visit nodes in the same order and round every operation the
same way, so they agree bit for bit, whichever lane of the kernel walks
which ray.  Closest-hit descends the nearer hit
child (child 0 on equal entry distances) and pushes the other; any-hit
descends child 0 when it is hit, else child 1, and stops at the first
occluder.  ``intersect_closest`` / ``intersect_any`` take the plain version
only for CPU tensors; for CUDA tensors they launch the kernel, and a
failed build or launch raises.  ``LAUNCHES`` counts kernel launches per
specialization ("closest2", "any2").

Not ported, by design: the TPU kernel's wave/row schedule, its
``return_counters`` and its packet fallback past ``VMEM_TRI_LIMIT`` (the
table lives in global memory, which has no such limit).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch import native
from vulkanraytracing_torch.accel.lbvh import worst_case_stack
from vulkanraytracing_torch.ops.intersect import BIG_T, Hit
from vulkanraytracing_torch.ops.traverse_wide8 import (
    STACK_DEPTH,
    _canon_rays,
    _check,
    _ptrs,
    child_distances,
    lockstep,
    ray_queue,
)
from vulkanraytracing_torch.scene.types import BVH
from vulkanraytracing_torch.utils.profiling import host_sync

# Kernel launches per specialization ("closest2", "any2"), counted by the
# CUDA wrappers only.
LAUNCHES: collections.Counter = collections.Counter()


class Table2(NamedTuple):
    """The traversal table of the three 2-wide kernels (``build_table2``).
    Triangles are stored in BVH order, so a triangle's id is its record
    index.  All three kernels read the packed records ``node`` and ``tri``
    with 16-byte loads (both contiguous and 16-byte aligned; integers are
    stored bit for bit in float32 slots); the packet kernels' plain
    versions read ``tri`` and the BVH's own ``nodes``, ``child`` and
    ``tri_flags``, which the table shares with the BVH and does not copy."""

    # (N, 16) f32, a node's record: c0.lo c0.hi c1.lo c1.hi, the two child
    # ids as int32 bits, 2 pads
    node: Tensor
    # (T, 12) f32: v0 xyz, e1 xyz, e2 xyz, the flags as int32 bits, 2 pads
    tri: Tensor
    nodes: Tensor      # (N, 12) f32: c0.lo c0.hi c1.lo c1.hi
    child: Tensor      # (N, 2) i32: node id (>= 0) or leaf code (< 0)
    tri_flags: Tensor  # (T,) i32: bit0 cull-disable, bits 1-2 candidate

    def to(self, device) -> "Table2":
        return Table2(*[t.to(device) for t in self])

    @property
    def records(self) -> tuple[Tensor, Tensor]:
        """The kernels' arguments."""
        return self.node, self.tri

    @property
    def arrays(self) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        """What the packet kernels' plain versions read."""
        return self.nodes, self.child, self.tri, self.tri_flags


def stack_need(bvh: BVH) -> int:
    """The tree's worst-case stack need in any 2-wide traversal of the
    port (the deepest chain of internal nodes): from the build's topology
    when the BVH has one (kept across refits), else from the child array
    on the host."""
    if bvh.topology is not None:
        return bvh.topology.stack_need
    with host_sync("table2"):
        child = bvh.child_index.cpu().numpy()
    return worst_case_stack(child)


def build_table2(bvh: BVH) -> Table2:
    """The kernel's table over the BVH's own arrays.  Raises when the
    tree's worst-case stack need exceeds ``STACK_DEPTH``: the kernel has no
    overflow path."""
    need = stack_need(bvh)
    if need > STACK_DEPTH:
        raise ValueError(
            f"BVH2 needs a traversal stack of {need} > {STACK_DEPTH} entries"
        )
    nodes = bvh.nodes.to(torch.float32).contiguous()
    child = bvh.child_index.to(torch.int32).contiguous()
    tri_flags = bvh.tri_flags.to(torch.int32).contiguous()
    # a few device copies and no readback: a refitted BVH gets its table on
    # every moving frame; assembled as int32 so that every copy moves bits only
    node = torch.cat([nodes.view(torch.int32), child, torch.zeros_like(child)], dim=1)
    tri = bvh.tris.to(torch.float32).contiguous().view(torch.int32).clone()
    tri[:, 9] = tri_flags
    return Table2(node=node.view(torch.float32), tri=tri.view(torch.float32),
                  nodes=nodes, child=child, tri_flags=tri_flags)


def get_table2(bvh: BVH) -> Table2:
    """The BVH's cached table, built on first use (and again after the BVH
    moved to another device)."""
    if bvh.table2 is None or bvh.table2.nodes.device != bvh.nodes.device:
        bvh.table2 = build_table2(bvh)
    return bvh.table2


# --- the plain PyTorch version -------------------------------------------


def _traverse_plain(table: Table2, o, d, t_min, t_max, any_hit: bool,
                    cull_backface: bool, counts: dict | None = None):
    flags = table.tri.view(torch.int32)[:, 9]

    def node_step(node, oi, qi, tmin_i, best_i):
        rec = table.node[node]
        dist = child_distances(rec[:, :12].view(-1, 2, 6), oi, qi, tmin_i, best_i)
        kids = rec[:, 12:14].view(torch.int32).long()
        h0, h1 = dist[:, 0] < BIG_T, dist[:, 1] < BIG_T
        first0 = h0 if any_hit else torch.where(h0 & h1, dist[:, 0] <= dist[:, 1], h0)
        first = torch.where(first0, kids[:, 0], kids[:, 1])
        far = torch.where(first0, kids[:, 1], kids[:, 0])
        return first, far[:, None], (h0 & h1)[:, None], h0 | h1

    def leaf_fetch(s):
        rec = table.tri[s]
        return rec[:, 0:3], rec[:, 3:6], rec[:, 6:9], flags[s], s.to(torch.int32)

    return lockstep(node_step, leaf_fetch, o, d, t_min, t_max, any_hit, cull_backface,
                    counts, boxes=2)


def closest_plain(table: Table2, o, d, t_min, t_max, cull_backface=True,
                  counts: dict | None = None) -> Hit:
    """The plain version; ``counts`` gathers its work
    (``traverse_wide8.lockstep``)."""
    t, u, v, tri, bf, _ = _traverse_plain(
        table, *_canon_rays(o, d, t_min, t_max), False, cull_backface, counts
    )
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_plain(table: Table2, o, d, t_min, t_max, counts: dict | None = None) -> Tensor:
    return _traverse_plain(table, *_canon_rays(o, d, t_min, t_max), True, False,
                           counts)[5]


# --- the CUDA kernel -------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_TABLE_ARGS = [_P, _P]            # node, tri
_RAY_ARGS = [_P, _P, _P, _P, _I]  # o, d, t_min, t_max, n
_HEADERS = (native.CSRC_DIR / "bvh2_traverse.cuh",
            native.CSRC_DIR / "traverse_common.cuh")


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (nvcc, sm_90a) and load the traversal kernel."""
    cmd = [native.nvcc_path(), *native.NVCC_FLAGS,
           f"-DVRT_STACK_DEPTH={STACK_DEPTH}", f"-I{native.CSRC_DIR}"]
    path = native.build_library(
        "bvh2_traverse", cmd, [native.CSRC_DIR / "bvh2_traverse.cu"], _HEADERS
    )
    return native.load_library(path, {
        "vrt_bvh2_closest": (_I, _TABLE_ARGS + _RAY_ARGS + [_I, _P, _P, _P, _P, _P, _P, _P]),
        "vrt_bvh2_any": (_I, _TABLE_ARGS + _RAY_ARGS + [_P, _P, _P]),
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
        counter = ray_queue(o.device)
        with torch.cuda.device(o.device):
            err = lib.vrt_bvh2_closest(
                *_ptrs(*table.records, o, d, t_min, t_max), r, int(cull_backface),
                *_ptrs(counter, t, u, v, tri, bf),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"bvh2 closest-hit launch failed: cudaError {err}")
        LAUNCHES["closest2"] += 1
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_cuda(table: Table2, o, d, t_min, t_max) -> Tensor:
    """Launch the any-hit kernel on the current stream."""
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cuda")
    lib = cuda_library()
    r = o.shape[0]
    out = torch.empty((r,), dtype=torch.bool, device=o.device)
    if r:
        counter = ray_queue(o.device)
        with torch.cuda.device(o.device):
            err = lib.vrt_bvh2_any(
                *_ptrs(*table.records, o, d, t_min, t_max), r, *_ptrs(counter, out),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"bvh2 any-hit launch failed: cudaError {err}")
        LAUNCHES["any2"] += 1
    return out


# --- the CPU twin (tests only) --------------------------------------------


@functools.cache
def twin_library() -> ctypes.CDLL:
    """The kernel's header compiled by g++ for the host."""
    cmd = [*native.GXX, "-ffp-contract=off", f"-DVRT_STACK_DEPTH={STACK_DEPTH}",
           f"-I{native.CSRC_DIR}"]
    path = native.build_library(
        "bvh2_twin", cmd, [native.CSRC_DIR / "bvh2_twin.cpp"], _HEADERS
    )
    return native.load_library(path, {
        "vrt_bvh2_closest_cpu": (_I, _TABLE_ARGS + _RAY_ARGS + [_I, _P, _P, _P, _P, _P]),
        "vrt_bvh2_any_cpu": (_I, _TABLE_ARGS + _RAY_ARGS + [_P]),
    })


def closest_twin(table: Table2, o, d, t_min, t_max, cull_backface=True) -> Hit:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((r,), dtype=torch.int32)
    bf = torch.empty((r,), dtype=torch.bool)
    twin_library().vrt_bvh2_closest_cpu(
        *_ptrs(*table.records, o, d, t_min, t_max), r, int(cull_backface),
        *_ptrs(t, u, v, tri, bf),
    )
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_twin(table: Table2, o, d, t_min, t_max) -> Tensor:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    out = torch.empty((o.shape[0],), dtype=torch.bool)
    twin_library().vrt_bvh2_any_cpu(
        *_ptrs(*table.records, o, d, t_min, t_max), o.shape[0], out.data_ptr()
    )
    return out


# --- public entries --------------------------------------------------------


def intersect_closest(bvh: BVH, o, d, t_min, t_max, cull_backface=True) -> Hit:
    """Closest hit over the BVH: the kernel for CUDA rays, the plain
    version for CPU rays."""
    table = get_table2(bvh)
    if o.device.type == "cuda":
        return closest_cuda(table, o, d, t_min, t_max, cull_backface)
    if o.device.type == "cpu":
        return closest_plain(table, o, d, t_min, t_max, cull_backface)
    raise ValueError(f"no BVH2 traversal for rays on {o.device}")


def intersect_any(bvh: BVH, o, d, t_min, t_max) -> Tensor:
    """Occlusion of [t_min, t_max] (no culling): the kernel for CUDA rays,
    the plain version for CPU rays."""
    table = get_table2(bvh)
    if o.device.type == "cuda":
        return any_cuda(table, o, d, t_min, t_max)
    if o.device.type == "cpu":
        return any_plain(table, o, d, t_min, t_max)
    raise ValueError(f"no BVH2 traversal for rays on {o.device}")
