"""Per-ray BVH traversal in plain PyTorch (``TraversalMode.BVH_PER_RAY``).

Counterpart of ``vulkanraytracing_tpu/ops/traverse.py``, the JAX package's
reference backend: no kernel of its own there either.  Every ray walks the
2-wide BVH (``bvh.nodes``, ``bvh.child_index``) with its own cursor and
stack, all rays in lockstep.  A step loads the ray's node, slab-tests its
two children (the exit capped by the ray's best t so far), tests a hit
leaf child's triangles at once (child 0 before child 1, so child 1's slab
test sees child 0's hits), descends into the nearer hit interior child and
pushes the other.

It keeps the JAX module's rules, not the per-ray kernels':

- det and direction epsilon 1e-20;
- the window ``t_min <= t < best``, ``best`` starting at ``t_max``: a hit
  exactly at ``t_max`` is not committed, and of equal-t hits the first
  tested wins;
- candidates are triangles with ``flags & 6``, cull-disable is ``flags & 1``;
- ``stack_depth`` entries (``STACK_DEPTH``); a push past them is dropped,
  as the JAX module drops it, so a deeper tree loses subtrees alike on both
  sides;
- at most ``MAX_ITERS`` steps.

Rays whose walk has ended leave the working set after each step (their
results are written out then), which changes no ray's walk.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.accel.lbvh import LEAF_SIZE, decode_leaf
from vulkanraytracing_torch.ops.intersect import BIG_T, Hit, moller_trumbore
from vulkanraytracing_torch.scene.types import BVH

TINY = 1e-20
DONE = -(2**31)  # cursor of a walk that has ended
STACK_DEPTH = 64
MAX_ITERS = 16384


def _traverse(bvh: BVH, o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor,
              cull_backface: bool, any_hit: bool, stack_depth: int = STACK_DEPTH) -> Hit:
    o, d, t_min, t_max = (x.to(torch.float32) for x in (o, d, t_min, t_max))
    r, dev = o.shape[0], o.device
    last_tri = bvh.tris.shape[0] - 1
    d_safe = torch.where(d.abs() < TINY, torch.where(d < 0, -TINY, TINY), d)
    inv_d = 1.0 / d_safe

    # the results, written as walks end
    out_t = torch.full((r,), BIG_T, dtype=torch.float32, device=dev)
    out_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    out_v = torch.zeros_like(out_u)
    out_tri = torch.zeros((r,), dtype=torch.int64, device=dev)
    out_det = torch.ones_like(out_u)

    # the working set: the rays still walking
    s = {"id": torch.nonzero(t_min <= t_max).squeeze(1)}
    s.update(o=o[s["id"]], d=d[s["id"]], inv=inv_d[s["id"]], t_min=t_min[s["id"]])
    a = s["id"].shape[0]
    s.update(
        cur=torch.zeros((a,), dtype=torch.int64, device=dev),
        sp=torch.zeros((a,), dtype=torch.int64, device=dev),
        stack=torch.zeros((a, stack_depth), dtype=torch.int64, device=dev),
        best=torch.clamp_max(t_max[s["id"]], BIG_T),
        u=torch.zeros((a,), dtype=torch.float32, device=dev),
        v=torch.zeros((a,), dtype=torch.float32, device=dev),
        tri=torch.zeros((a,), dtype=torch.int64, device=dev),
        det=torch.ones((a,), dtype=torch.float32, device=dev),
        hit=torch.zeros((a,), dtype=torch.bool, device=dev),
    )

    def write_out(rows: Tensor) -> None:
        ids = s["id"][rows]
        found = s["hit"][rows]
        out_t[ids] = torch.where(found, s["best"][rows], BIG_T)
        out_u[ids] = s["u"][rows]
        out_v[ids] = s["v"][rows]
        out_tri[ids] = s["tri"][rows]
        out_det[ids] = s["det"][rows]

    for _ in range(MAX_ITERS):
        if s["id"].shape[0] == 0:
            break
        ro, rd, inv, tmin = s["o"], s["d"], s["inv"], s["t_min"]
        node = bvh.nodes[s["cur"]]                    # (A, 12)
        kids = bvh.child_index[s["cur"]].long()       # (A, 2)
        best, hit = s["best"], s["hit"]
        u, v, tri, det = s["u"], s["v"], s["tri"], s["det"]
        descend, t_enter = [], []
        for c in (0, 1):
            lo, hi = node[:, 6 * c:6 * c + 3], node[:, 6 * c + 3:6 * c + 6]
            t0 = (lo - ro) * inv
            t1 = (hi - ro) * inv
            tn = torch.maximum(torch.minimum(t0, t1).amax(dim=1), tmin)
            tf = torch.minimum(torch.maximum(t0, t1).amin(dim=1), best)
            box_hit = tn <= tf
            idx = kids[:, c]
            is_leaf = idx < 0
            start, count = decode_leaf(idx)
            leaf_hit = is_leaf & box_hit
            base = torch.where(leaf_hit, start, 0)
            for k in range(LEAF_SIZE):
                tid = (base + k).clamp_max(last_tri)
                rec = bvh.tris[tid]
                flags = bvh.tri_flags[tid]
                mt, mu, mv, mdet = moller_trumbore(ro, rd, rec[:, 0:3], rec[:, 3:6],
                                                   rec[:, 6:9], det_eps=TINY)
                valid = (leaf_hit & (k < count) & (mdet.abs() > TINY)
                         & (mu >= 0.0) & (mv >= 0.0) & (mu + mv <= 1.0)
                         & (mt >= tmin) & (mt < best) & ((flags & 6) != 0))
                if cull_backface:
                    valid &= (mdet > TINY) | ((flags & 1) != 0)
                best = torch.where(valid, mt, best)
                u = torch.where(valid, mu, u)
                v = torch.where(valid, mv, v)
                tri = torch.where(valid, base + k, tri)
                det = torch.where(valid, mdet, det)
                hit = hit | valid
            descend.append(box_hit & ~is_leaf)
            t_enter.append(tn)

        d0, d1 = descend
        both = d0 & d1
        near_is_0 = t_enter[0] <= t_enter[1]
        near = torch.where(near_is_0, kids[:, 0], kids[:, 1])
        far = torch.where(near_is_0, kids[:, 1], kids[:, 0])
        nxt = torch.where(both, near, torch.where(d0, kids[:, 0], kids[:, 1]))
        go_down = d0 | d1

        # push the far child where both are hit and the stack has room;
        # a push past the last entry is dropped
        sp, stack = s["sp"], s["stack"]
        push = both & (sp < stack_depth)
        at = sp.clamp_max(stack_depth - 1)[:, None]
        stack = stack.scatter(1, at, torch.where(push, far, stack.gather(1, at)[:, 0])[:, None])
        sp = torch.where(push, sp + 1, sp)
        # otherwise pop, or end the walk on an empty stack
        can_pop = sp > 0
        popped = stack.gather(1, (sp - 1).clamp_min(0)[:, None])[:, 0]
        nxt = torch.where(go_down, nxt, torch.where(can_pop, popped, DONE))
        sp = torch.where(go_down, sp, torch.where(can_pop, sp - 1, sp))
        if any_hit:
            nxt = torch.where(hit, DONE, nxt)

        s.update(cur=nxt, sp=sp, stack=stack, best=best, u=u, v=v, tri=tri, det=det,
                 hit=hit)
        ended = nxt == DONE
        if bool(ended.any()):
            write_out(ended)
            keep = ~ended
            s = {key: x[keep] for key, x in s.items()}
    else:
        # the step cap: the walks still running keep what they found
        write_out(torch.ones_like(s["hit"]))

    return Hit(t=out_t, u=out_u, v=out_v, tri=out_tri.to(torch.int32),
               backface=out_det < 0.0)


def intersect_closest_bvh(bvh: BVH, o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor,
                          cull_backface: bool = True) -> Hit:
    """Closest hit through the 2-wide BVH; ``tri`` is the BVH-order id."""
    return _traverse(bvh, o, d, t_min, t_max, cull_backface, any_hit=False)


def intersect_any_bvh(bvh: BVH, o: Tensor, d: Tensor, t_min: Tensor,
                      t_max: Tensor) -> Tensor:
    """Occlusion of [t_min, t_max) (no culling; a walk ends at its first
    hit)."""
    return _traverse(bvh, o, d, t_min, t_max, False, any_hit=True).is_hit
