"""BVH8 traversal: the hand-written CUDA kernel and its plain version.

Counterpart of ``vulkanraytracing_tpu/ops/traverse_wide8.py``: the same
``Hit`` contract over the same 8-wide BVH (``accel.bvh8``), rebuilt for a
Hopper card.  Three implementations share one table (``Table8``):

- the CUDA kernel (``csrc/bvh8_traverse.cu``: persistent warps that take
  rays from a queue, each lane walking one ray; built with nvcc for
  ``sm_90a`` on first use), launched for CUDA tensors;
- the plain PyTorch version (``closest_plain`` / ``any_plain``): the same
  per-ray algorithm in lockstep over all rays, with an (R, depth) stack
  tensor, run for CPU tensors and held against the kernel on the card;
- the CPU twin (``closest_twin`` / ``any_twin``): the kernel's header
  compiled by g++, used only by the tests.

All three visit nodes in the same order and round every operation the
same way, so they agree bit for bit, whichever lane of the kernel walks
which ray.  ``intersect_closest`` /
``intersect_any`` take the plain version only for CPU tensors; for CUDA
tensors they launch the kernel, and a failed build or launch raises.
``LAUNCHES`` counts kernel launches per specialization.

Two leaf tests, as in the JAX package: Moller-Trumbore over (v0, e1, e2)
records, the default, and the plane ("Woop") test over precomputed
plane records (``woop_records``), taken by every call when ``VRT_WOOP=1``
is set at import (``WOOP_DEFAULT``).  A table holds one or the other
(``Table8.woop``), and each has its own kernel specializations, CPU twin
entries, plain leaf test (``ops.intersect.plane_test``) and ``LAUNCHES``
keys ("woop_closest", "woop_any").
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch import native
from vulkanraytracing_torch.accel.bvh8 import _worst_case_stack
from vulkanraytracing_torch.accel.lbvh import decode_leaf
from vulkanraytracing_torch.ops.intersect import (
    BIG_T, DET_EPS, Hit, moller_trumbore, plane_test,
)
from vulkanraytracing_torch.scene.types import BVH

# Per-ray stack entries.  Every traversal kernel (BVH8 here; BVH2 and the
# packet kernels import it) is compiled with this depth, and build_table8 /
# build_table2 refuse trees whose worst case needs more.  The BVH8 trees of
# the v1 and real scenes at 1-2 million triangles need 64-67 (SAH and
# LBVH), their 2-wide trees at most 29: 96 leaves a margin.  Only the
# entries past the 16 in shared memory grow (local memory on the card).
STACK_DEPTH = 96
TINY = 1e-30
_INT32_MAX = 2**31 - 1

# The leaf test of every BVH8 call: the plane test of ``woop_records``
# where set, else Moller-Trumbore (the JAX package's switch, read once at
# import as there).
WOOP_DEFAULT = os.environ.get("VRT_WOOP", "0") == "1"

# Kernel launches per specialization ("closest", "any"; "woop_closest",
# "woop_any" over plane records), counted by the CUDA wrappers only.
LAUNCHES: collections.Counter = collections.Counter()


class Table8(NamedTuple):
    """The traversal table, built once per BVH (``build_table8``): packed
    records that the kernel reads with 16-byte loads, so both tensors are
    contiguous and 16-byte aligned (a node record 256-byte aligned wherever
    the allocator aligns the tensor so).  Integers are stored bit for bit
    in float32 slots; ``boxes``, ``child`` and ``tri_meta`` decode them."""

    # (M, 64) f32, a node's record: children 0-3 at [0, 24) and 4-7 at
    # [24, 48), each half as lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4] hi.z[4];
    # the 8 child ids at [48, 56) as int32 bits; 8 pads
    node: Tensor
    # Moller-Trumbore records, (T8, 12) f32: v0 xyz, flags; e1 xyz,
    # BVH-order triangle id (-1 = padding); e2 xyz, pad.  Or plane records
    # (``woop_records``), (T8, 16) f32: n xyz, dn; up xyz, uc; vp xyz, vc;
    # flags, id, 2 pads.  Flags and id as int32 bits.
    tri: Tensor

    def to(self, device) -> "Table8":
        return Table8(*[t.to(device) for t in self])

    @property
    def woop(self) -> bool:
        """Whether ``tri`` holds plane records (the plane leaf test)."""
        return self.tri.shape[1] == 16

    @property
    def boxes(self) -> Tensor:
        """(M, 8, 6) f32: child k's box as lo xyz, hi xyz."""
        m = self.node.shape[0]
        return self.node[:, :48].view(m, 2, 6, 4).permute(0, 1, 3, 2).reshape(m, 8, 6)

    @property
    def child(self) -> Tensor:
        """(M, 8) i32: node id (> 0), leaf code (< 0), 0 = empty."""
        return self.node.view(torch.int32)[:, 48:56]

    @property
    def tri_meta(self) -> Tensor:
        """(T8, 2) i32: flags, BVH-order triangle id (-1 = padding)."""
        return self.tri.view(torch.int32)[:, [12, 13] if self.woop else [3, 7]]


def woop_records(tris: Tensor) -> Tensor:
    """Plane records (T, 12) f32 of (T, >= 9) triangles (v0, e1, e2): the
    geometric plane (n, dn) and the barycentric planes (up, uc), (vp, vc),
    so that the leaf test is t = -(n.o + dn) / (n.d), p = o + t d,
    u = up.p + uc, v = vp.p + vc (``ops.intersect.plane_test``).

    The JAX package's ``_woop_records`` formula, every product rounded and
    every sum taken left to right: n = e1 x e2, up = (e2 x n) / |n|^2,
    vp = (n x e1) / |n|^2, dn = -n.v0, uc = -up.v0, vc = -vp.v0.  A
    degenerate triangle (|n|^2 = 0) gets zero planes, so n.d = 0 rejects
    every ray.  XLA contracts some of these products into fused
    multiply-adds, so the records agree with the JAX package's to rounding,
    not bit for bit."""
    t = tris.float()
    v0x, v0y, v0z = t[:, 0], t[:, 1], t[:, 2]
    e1x, e1y, e1z = t[:, 3], t[:, 4], t[:, 5]
    e2x, e2y, e2z = t[:, 6], t[:, 7], t[:, 8]
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    nn = nx * nx + ny * ny + nz * nz
    inv_nn = torch.where(nn > 0.0, 1.0 / nn, 0.0)
    upx = (e2y * nz - e2z * ny) * inv_nn
    upy = (e2z * nx - e2x * nz) * inv_nn
    upz = (e2x * ny - e2y * nx) * inv_nn
    vpx = (ny * e1z - nz * e1y) * inv_nn
    vpy = (nz * e1x - nx * e1z) * inv_nn
    vpz = (nx * e1y - ny * e1x) * inv_nn
    dn = -(nx * v0x + ny * v0y + nz * v0z)
    uc = -(upx * v0x + upy * v0y + upz * v0z)
    vc = -(vpx * v0x + vpy * v0y + vpz * v0z)
    return torch.stack([nx, ny, nz, dn, upx, upy, upz, uc, vpx, vpy, vpz, vc], dim=1)


def build_table8(bvh: BVH, woop: bool = False) -> Table8:
    """Pack the BVH8 collapse into the kernel's table, with Moller-Trumbore
    triangle records, or plane records with ``woop``.  Leaf codes address
    the row-aligned slots of ``tri_perm8``; padding slots get flags 0, so
    they are never candidates.  Raises when the tree's worst-case stack
    need exceeds ``STACK_DEPTH``: the kernel has no overflow path."""
    if bvh.nodes8 is None:
        raise ValueError("the BVH has no 8-wide collapse (accel.bvh8.collapse_bvh8)")
    need = _worst_case_stack(bvh.child8.cpu().numpy())
    if need > STACK_DEPTH:
        raise ValueError(
            f"BVH8 needs a traversal stack of {need} > {STACK_DEPTH} entries"
        )
    # records are assembled as int32 so that every copy moves bits only
    m = bvh.nodes8.shape[0]
    boxes = bvh.nodes8.float().contiguous().view(torch.int32)
    node = torch.zeros((m, 64), dtype=torch.int32, device=boxes.device)
    node[:, :48] = boxes.view(m, 2, 4, 6).permute(0, 1, 3, 2).reshape(m, 48)
    node[:, 48:56] = bvh.child8.to(torch.int32)
    perm = bvh.tri_perm8.long()
    valid = perm >= 0
    idx = perm.clamp_min(0)
    if woop:
        geo = woop_records(bvh.tris[idx]).contiguous().view(torch.int32)
        tri = torch.zeros((perm.shape[0], 16), dtype=torch.int32, device=geo.device)
        tri[:, 0:12] = geo
        meta = (12, 13)
    else:
        src = bvh.tris[idx].float().contiguous().view(torch.int32)
        tri = torch.zeros((perm.shape[0], 12), dtype=torch.int32, device=src.device)
        tri[:, 0:3] = src[:, 0:3]
        tri[:, 4:7] = src[:, 3:6]
        tri[:, 8:11] = src[:, 6:9]
        meta = (3, 7)
    tri[~valid] = 0
    tri[:, meta[0]] = torch.where(valid, bvh.tri_flags[idx], 0)
    tri[:, meta[1]] = torch.where(valid, idx, -1)
    return Table8(node=node.view(torch.float32), tri=tri.view(torch.float32))


def get_table8(bvh: BVH, woop: bool = False) -> Table8:
    """The BVH's cached table with Moller-Trumbore records, or with plane
    records with ``woop`` (each variant cached apart), built on first use
    and again after the BVH moved to another device."""
    field = "table8_woop" if woop else "table8"
    table = getattr(bvh, field)
    if table is None or table.node.device != bvh.nodes8.device:
        table = build_table8(bvh, woop)
        setattr(bvh, field, table)
    return table


def _canon_rays(o, d, t_min, t_max):
    return tuple(x.to(torch.float32).contiguous() for x in (o, d, t_min, t_max))


# --- the plain PyTorch version -------------------------------------------


def _safe_inv(c: Tensor) -> Tensor:
    return 1.0 / torch.where(c.abs() < TINY, torch.where(c < 0, -TINY, TINY), c)


def child_distances(box: Tensor, o: Tensor, inv: Tensor, t_min: Tensor,
                    best: Tensor) -> Tensor:
    """Slab test of (R, W, 6) child boxes (lo xyz, hi xyz): entry
    distances (R, W), BIG_T where missed."""
    ax = (box[:, :, 0] - o[:, 0:1]) * inv[:, 0:1]
    bx = (box[:, :, 3] - o[:, 0:1]) * inv[:, 0:1]
    ay = (box[:, :, 1] - o[:, 1:2]) * inv[:, 1:2]
    by = (box[:, :, 4] - o[:, 1:2]) * inv[:, 1:2]
    az = (box[:, :, 2] - o[:, 2:3]) * inv[:, 2:3]
    bz = (box[:, :, 5] - o[:, 2:3]) * inv[:, 2:3]
    tn = torch.maximum(
        torch.maximum(torch.minimum(ax, bx), torch.minimum(ay, by)),
        torch.maximum(torch.minimum(az, bz), t_min[:, None]),
    )
    tf = torch.minimum(
        torch.minimum(torch.maximum(ax, bx), torch.maximum(ay, by)),
        torch.minimum(torch.maximum(az, bz), best[:, None]),
    )
    return torch.where(tn <= tf, tn, BIG_T)


def lockstep(node_step, leaf_fetch, o, d, t_min, t_max, any_hit: bool,
             cull_backface: bool, counts: dict | None = None, boxes: int = 8,
             leaf_test=moller_trumbore):
    """Lockstep traversal: every live ray makes one node or leaf visit per
    step, exactly as one thread of a traversal kernel does.

    ``node_step(node, o, inv, t_min, best)`` returns (first, push_list,
    push, descend) for a batch of node visits: the child to descend into,
    (R, W) entries pushed in column order where ``push`` is set, and
    whether any child was hit.  ``leaf_fetch(slot)`` returns the triangle
    records' geometry (the arguments of ``leaf_test`` after o and d: v0,
    e1, e2 for ``moller_trumbore``), flags and tid.  ``leaf_test`` returns
    (t, u, v, det) with Moller-Trumbore's sign of det (``plane_test`` gives
    -(n.d)).  Returns (t, u, v, tri, backface, hit) tensors over the rays.

    With ``counts`` (a dict), the work the kernel does for these rays is
    added to it: "box_tests" (``boxes`` slab tests per node visit) and
    "tri_tests" (candidate triangles tested, up to an any-hit query's
    first occluder)."""
    r, dev = o.shape[0], o.device
    inv = _safe_inv(d)
    best = torch.clamp_max(t_max, BIG_T)
    hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    tri = torch.zeros((r,), dtype=torch.int32, device=dev)
    u = torch.zeros((r,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    bf = torch.zeros_like(hit)
    cur = torch.zeros((r,), dtype=torch.int64, device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    stack = torch.zeros((r, STACK_DEPTH), dtype=torch.int64, device=dev)
    active = t_min <= t_max
    n_box = torch.zeros((), dtype=torch.int64, device=dev)
    n_tri = torch.zeros_like(n_box)

    while True:
        ids = torch.nonzero(active).squeeze(1)
        if ids.numel() == 0:
            break
        c = cur[ids]
        inner = c >= 0
        pop = torch.zeros_like(inner)

        ii = ids[inner]
        if ii.numel():
            n_box += ii.numel() * boxes
            first, push_list, push, descend = node_step(
                c[inner], o[ii], inv[ii], t_min[ii], best[ii])
            pos = sp[ii, None] + torch.cumsum(push.long(), dim=1) - 1
            rows = ii[:, None].expand_as(push)
            stack[rows[push], pos[push]] = push_list[push]
            sp[ii] += push.sum(1)
            cur[ii[descend]] = first[descend]
            pop[inner] = ~descend

        leaf = ~inner
        il = ids[leaf]
        if il.numel():
            start, count = decode_leaf(c[leaf])
            ol, dl, tmin_l = o[il], d[il], t_min[il]
            best_l, hit_l = best[il], hit[il]
            tri_l, u_l, v_l, bf_l = tri[il], u[il], v[il], bf[il]
            for j in range(int(count.max())):
                m = j < count
                s = torch.where(m, start + j, 0)
                *geo, flags, tid = leaf_fetch(s)
                tested = m & ((flags & 6) != 0)
                n_tri += (tested & ~hit_l).sum() if any_hit else tested.sum()
                t, tu, tv, det = leaf_test(ol, dl, *geo)
                valid = (
                    m & ((flags & 6) != 0) & (det.abs() > DET_EPS)
                    & (tu >= 0.0) & (tv >= 0.0) & (tu + tv <= 1.0)
                    & (t >= tmin_l) & (t <= best_l)
                )
                if cull_backface:
                    valid &= (det > DET_EPS) | ((flags & 1) != 0)
                if not any_hit:
                    cur_tid = torch.where(hit_l, tri_l, _INT32_MAX)
                    valid &= (t < best_l) | (tid < cur_tid)
                best_l = torch.where(valid, t, best_l)
                hit_l = hit_l | valid
                tri_l = torch.where(valid, tid, tri_l)
                u_l = torch.where(valid, tu, u_l)
                v_l = torch.where(valid, tv, v_l)
                bf_l = torch.where(valid, det < 0.0, bf_l)
            best[il], hit[il] = best_l, hit_l
            tri[il], u[il], v[il], bf[il] = tri_l, u_l, v_l, bf_l
            if any_hit:
                active[il[hit_l]] = False
                pop[leaf] = ~hit_l
            else:
                pop[leaf] = True

        pi = ids[pop]
        can = sp[pi] > 0
        pc = pi[can]
        sp[pc] -= 1
        cur[pc] = stack[pc, sp[pc]]
        active[pi[~can]] = False

    if counts is not None:
        counts["box_tests"] = counts.get("box_tests", 0) + int(n_box)
        counts["tri_tests"] = counts.get("tri_tests", 0) + int(n_tri)
    t = torch.where(hit, best, BIG_T)
    return t, u, v, tri, bf & hit, hit


def _traverse_plain(table: Table8, o, d, t_min, t_max, any_hit: bool,
                    cull_backface: bool, counts: dict | None = None):
    slot = torch.arange(8, device=o.device)
    boxes, child, meta = table.boxes, table.child, table.tri_meta

    def node_step(node, oi, qi, tmin_i, best_i):
        dist = child_distances(boxes[node], oi, qi, tmin_i, best_i)
        kids = child[node].long()
        hitk = dist < BIG_T
        n_hit = hitk.sum(1)
        if any_hit:
            # nearest hit child first, the others pushed in slot order
            near = torch.argmin(dist, dim=1)
            first = kids.gather(1, near[:, None]).squeeze(1)
            return first, kids, hitk & (slot[None, :] != near[:, None]), n_hit > 0
        # stable ascending sort; push sorted entries n-1 .. 1
        order = torch.sort(dist, dim=1, stable=True).indices
        sorted_kids = kids.gather(1, order)
        rank = 7 - slot[None, :]
        push = (rank >= 1) & (rank < n_hit[:, None])
        return sorted_kids[:, 0], sorted_kids.flip(1), push, n_hit > 0

    def leaf_fetch(s):
        rec, m = table.tri[s], meta[s]
        if table.woop:
            geo = (rec[:, 0:3], rec[:, 3], rec[:, 4:7], rec[:, 7], rec[:, 8:11],
                   rec[:, 11])
        else:
            geo = (rec[:, 0:3], rec[:, 4:7], rec[:, 8:11])
        return *geo, m[:, 0], m[:, 1]

    return lockstep(node_step, leaf_fetch, o, d, t_min, t_max, any_hit, cull_backface,
                    counts, boxes=8,
                    leaf_test=plane_test if table.woop else moller_trumbore)


def closest_plain(table: Table8, o, d, t_min, t_max, cull_backface=True,
                  counts: dict | None = None) -> Hit:
    """The plain version; ``counts`` gathers its work (``lockstep``)."""
    t, u, v, tri, bf, _ = _traverse_plain(
        table, *_canon_rays(o, d, t_min, t_max), False, cull_backface, counts
    )
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_plain(table: Table8, o, d, t_min, t_max, counts: dict | None = None) -> Tensor:
    return _traverse_plain(table, *_canon_rays(o, d, t_min, t_max), True, False,
                           counts)[5]


# --- the CUDA kernel -------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_TABLE_ARGS = [_P, _P]            # node, tri
_RAY_ARGS = [_P, _P, _P, _P, _I]  # o, d, t_min, t_max, n


def _sources() -> tuple[list, tuple]:
    return [native.CSRC_DIR / "bvh8_traverse.cu"], (
        native.CSRC_DIR / "bvh8_traverse.cuh",
        native.CSRC_DIR / "traverse_common.cuh",
    )


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (nvcc, sm_90a) and load the traversal kernel."""
    sources, headers = _sources()
    cmd = [native.nvcc_path(), *native.NVCC_FLAGS,
           f"-DVRT_STACK_DEPTH={STACK_DEPTH}", f"-I{native.CSRC_DIR}"]
    path = native.build_library("bvh8_traverse", cmd, sources, headers)
    closest = (_I, _TABLE_ARGS + _RAY_ARGS + [_I, _P, _P, _P, _P, _P, _P, _P])
    blocked = (_I, _TABLE_ARGS + _RAY_ARGS + [_P, _P, _P])
    return native.load_library(path, {
        "vrt_bvh8_closest": closest, "vrt_bvh8_any": blocked,
        "vrt_bvh8_woop_closest": closest, "vrt_bvh8_woop_any": blocked,
    })


def launches_by_kind() -> dict:
    """Kernel launches so far by query ("closest", "any"), over both leaf
    tests."""
    return {kind: LAUNCHES[kind] + LAUNCHES[f"woop_{kind}"] for kind in ("closest", "any")}


def _kind(table: Table8, kind: str) -> str:
    """The specialization of ``kind`` ("closest", "any") for the table's
    leaf test: its ``LAUNCHES`` key, and its C entry after "vrt_bvh8_"."""
    return f"woop_{kind}" if table.woop else kind


def _check(table: Table8, o, d, t_min, t_max, device_type: str) -> None:
    r = o.shape[0]
    shapes = {"o": (o, (r, 3)), "d": (d, (r, 3)), "t_min": (t_min, (r,)),
              "t_max": (t_max, (r,))}
    for name, (x, shape) in shapes.items():
        if x.device.type != device_type or x.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {device_type}, got "
                             f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous {shape}, got {tuple(x.shape)}")
    for x in table:
        if x.device != o.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("the table must be contiguous and 16-byte aligned on "
                             "the rays' device")


def _ptrs(*tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def ray_queue(device) -> Tensor:
    """The kernel's ray-queue counter: one zeroed int32 per launch."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def closest_cuda(table: Table8, o, d, t_min, t_max, cull_backface=True) -> Hit:
    """Launch the closest-hit kernel of the table's leaf test on the
    current stream."""
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cuda")
    lib = cuda_library()
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((r,), dtype=torch.int32, device=o.device)
    bf = torch.empty((r,), dtype=torch.bool, device=o.device)
    if r:
        kind = _kind(table, "closest")
        counter = ray_queue(o.device)
        with torch.cuda.device(o.device):
            err = getattr(lib, f"vrt_bvh8_{kind}")(
                *_ptrs(*table, o, d, t_min, t_max), r, int(cull_backface),
                *_ptrs(counter, t, u, v, tri, bf),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"bvh8 {kind} launch failed: cudaError {err}")
        LAUNCHES[kind] += 1
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_cuda(table: Table8, o, d, t_min, t_max) -> Tensor:
    """Launch the any-hit kernel of the table's leaf test on the current
    stream."""
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cuda")
    lib = cuda_library()
    r = o.shape[0]
    out = torch.empty((r,), dtype=torch.bool, device=o.device)
    if r:
        kind = _kind(table, "any")
        counter = ray_queue(o.device)
        with torch.cuda.device(o.device):
            err = getattr(lib, f"vrt_bvh8_{kind}")(
                *_ptrs(*table, o, d, t_min, t_max), r, *_ptrs(counter, out),
                torch.cuda.current_stream(o.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"bvh8 {kind} launch failed: cudaError {err}")
        LAUNCHES[kind] += 1
    return out


# --- the CPU twin (tests only) --------------------------------------------


@functools.cache
def twin_library() -> ctypes.CDLL:
    """The kernel's header compiled by g++ for the host."""
    _, headers = _sources()
    cmd = [*native.GXX, "-ffp-contract=off", f"-DVRT_STACK_DEPTH={STACK_DEPTH}",
           f"-I{native.CSRC_DIR}"]
    path = native.build_library(
        "bvh8_twin", cmd, [native.CSRC_DIR / "bvh8_twin.cpp"], headers
    )
    closest = (_I, _TABLE_ARGS + _RAY_ARGS + [_I, _P, _P, _P, _P, _P])
    blocked = (_I, _TABLE_ARGS + _RAY_ARGS + [_P])
    return native.load_library(path, {
        "vrt_bvh8_closest_cpu": closest, "vrt_bvh8_any_cpu": blocked,
        "vrt_bvh8_woop_closest_cpu": closest, "vrt_bvh8_woop_any_cpu": blocked,
        "vrt_bvh8_sort8_cpu": (_I, [_P, _P, _I]),
    })


def sort8_twin(dist: Tensor, kid: Tensor) -> tuple[Tensor, Tensor]:
    """The kernel's child sort (``csrc/bvh8_traverse.cuh::sort8``) on (N, 8)
    float32 distances and int32 child ids: both sorted by distance, equal
    distances in slot order."""
    dist = dist.to(torch.float32).contiguous().clone()
    kid = kid.to(torch.int32).contiguous().clone()
    if tuple(dist.shape) != (dist.shape[0], 8) or dist.shape != kid.shape:
        raise ValueError(f"need (N, 8) distances and ids, got {tuple(dist.shape)}, "
                         f"{tuple(kid.shape)}")
    twin_library().vrt_bvh8_sort8_cpu(*_ptrs(dist, kid), dist.shape[0])
    return dist, kid


def closest_twin(table: Table8, o, d, t_min, t_max, cull_backface=True) -> Hit:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((r,), dtype=torch.int32)
    bf = torch.empty((r,), dtype=torch.bool)
    getattr(twin_library(), f"vrt_bvh8_{_kind(table, 'closest')}_cpu")(
        *_ptrs(*table, o, d, t_min, t_max), r, int(cull_backface),
        *_ptrs(t, u, v, tri, bf),
    )
    return Hit(t=t, u=u, v=v, tri=tri, backface=bf)


def any_twin(table: Table8, o, d, t_min, t_max) -> Tensor:
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    out = torch.empty((o.shape[0],), dtype=torch.bool)
    getattr(twin_library(), f"vrt_bvh8_{_kind(table, 'any')}_cpu")(
        *_ptrs(*table, o, d, t_min, t_max), o.shape[0], out.data_ptr()
    )
    return out


# --- public entries --------------------------------------------------------


def intersect_closest(bvh: BVH, o, d, t_min, t_max, cull_backface=True) -> Hit:
    """Closest hit over the BVH: the kernel for CUDA rays, the plain
    version for CPU rays; the plane leaf test where ``WOOP_DEFAULT``."""
    table = get_table8(bvh, WOOP_DEFAULT)
    if o.device.type == "cuda":
        return closest_cuda(table, o, d, t_min, t_max, cull_backface)
    if o.device.type == "cpu":
        return closest_plain(table, o, d, t_min, t_max, cull_backface)
    raise ValueError(f"no BVH8 traversal for rays on {o.device}")


def intersect_any(bvh: BVH, o, d, t_min, t_max) -> Tensor:
    """Occlusion of [t_min, t_max] (no culling): the kernel for CUDA rays,
    the plain version for CPU rays; the plane leaf test where
    ``WOOP_DEFAULT``."""
    table = get_table8(bvh, WOOP_DEFAULT)
    if o.device.type == "cuda":
        return any_cuda(table, o, d, t_min, t_max)
    if o.device.type == "cpu":
        return any_plain(table, o, d, t_min, t_max)
    raise ValueError(f"no BVH8 traversal for rays on {o.device}")
