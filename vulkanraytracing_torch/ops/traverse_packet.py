"""Packet BVH traversal in plain PyTorch (``TraversalMode.BVH``).

Counterpart of ``vulkanraytracing_tpu/ops/traverse_packet.py``, the JAX
package's XLA packet backend: no kernel of its own there either.  Rays
travel in packets of 256 consecutive lanes, each packet with ONE cursor
and one 48-entry stack over the 2-wide BVH; a packet descends into a child
when any live lane's slab test hits it, nearer child first by the
packet's minimum entry distance.  Each step tests the hit leaf children's
candidates all against the lanes' best t at the start of the step (the
window ``t_min <= t <= best``, inclusive), and commits the nearest, the
lowest triangle id among equal t, by the lexicographic ``(t, id)`` rule;
any-hit commits any hit and ends a packet once every lane is occluded or
dead.  The winner's u, v and back face are recomputed after the loop.
Det and direction epsilons are this backend's 1e-20.

The JAX code drops a push once the 48 entries are full, which would
silently skip subtrees; the port refuses such a tree instead (the stack
need is the deepest chain of internal nodes, ``traverse_wide.stack_need``,
checked on every call).  Its trip cap (``MAX_ITERS``) and its grouping of
packets into independent loops only bound work on the TPU and are left out.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.accel.lbvh import LEAF_SIZE, decode_leaf
from vulkanraytracing_torch.ops.intersect import BIG_T, Hit, moller_trumbore
from vulkanraytracing_torch.ops.packet_lockstep import (
    DONE,
    descend,
    packet_state,
    run_packets,
    slab2,
)
from vulkanraytracing_torch.ops.traverse_wide import stack_need
from vulkanraytracing_torch.ops.traverse_wide8 import _canon_rays
from vulkanraytracing_torch.scene.types import BVH

LANE = 256
STACK_DEPTH = 48
TINY = 1e-20
_INT32_MAX = 2**31 - 1


def traverse_packets(bvh: BVH, o, d, t_min, t_max, cull_backface: bool,
                     any_hit: bool) -> Hit:
    """Trace rays through the BVH in packets of ``LANE`` rays."""
    need = stack_need(bvh)
    if need > STACK_DEPTH:
        raise ValueError(
            f"the packet traversal needs a stack of {need} > {STACK_DEPTH} entries"
        )
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    j = torch.arange(LEAF_SIZE, device=o.device)
    last_tri = bvh.tris.shape[0] - 1

    def step(s):
        act = s["cur"] != DONE
        node = torch.where(act, s["cur"], 0)
        kids = bvh.child_index[node].long()                         # (P, 2)
        live = act[:, None] & ~s["hit"] if any_hit else act[:, None].expand_as(s["hit"])
        tn, ok = slab2(bvh.nodes[node], s)
        lane_hit = ok & live[:, None]                               # (P, 2, L)
        child_hit = lane_hit.any(dim=2)
        te = torch.where(lane_hit, tn, BIG_T).amin(dim=2)
        is_leaf = kids < 0

        # every candidate of the hit leaves against the step's starting
        # best t; the nearest wins, the lowest id among equal t
        start, count = decode_leaf(kids)
        in_leaf = ((is_leaf & child_hit)[..., None] & (j < count[..., None])).flatten(1)
        tid = (torch.where(is_leaf & child_hit, start, 0)[..., None] + j).flatten(1)
        rec = bvh.tris[tid.clamp_max(last_tri)]                     # (P, 2K, 12)
        flags = bvh.tri_flags[tid.clamp_max(last_tri)]
        t, mu, mv, det = moller_trumbore(
            s["o"][:, None], s["d"][:, None], rec[:, :, None, 0:3],
            rec[:, :, None, 3:6], rec[:, :, None, 6:9], det_eps=TINY)
        best = s["best"]
        valid = (
            (in_leaf & ((flags & 6) != 0))[..., None] & live[:, None]
            & (det.abs() > TINY) & (mu >= 0.0) & (mv >= 0.0) & (mu + mv <= 1.0)
            & (t >= s["t_min"][:, None]) & (t <= best[:, None])
        )
        if cull_backface:
            valid &= (det > TINY) | ((flags & 1) != 0)[..., None]
        t = torch.where(valid, t, BIG_T)
        new_t = t.amin(dim=1)
        sel = torch.where(t == new_t[:, None], tid.to(torch.int32)[..., None],
                          _INT32_MAX).amin(dim=1)
        have_new = new_t < BIG_T
        if any_hit:
            take = have_new & (new_t <= best)
        else:
            cur_id = torch.where(s["hit"], s["tri"], _INT32_MAX)
            take = have_new & ((new_t < best) | ((new_t == best) & (sel < cur_id)))
        s["best"] = torch.where(take, new_t, best)
        s["tri"] = torch.where(take, sel, s["tri"])
        s["hit"] = s["hit"] | take

        descend(s, act, kids, child_hit & ~is_leaf, te, any_hit)

    s = run_packets(packet_state(o, d, t_min, t_max, LANE, tiny=TINY,
                                 stack_depth=STACK_DEPTH), step)
    r = o.shape[0]
    hit = s["hit"].reshape(-1)[:r]
    tri = s["tri"].reshape(-1)[:r]
    # one more test against the winning triangle gives its u, v, det
    rec = bvh.tris[torch.where(hit, tri, 0).long()]
    _, u, v, det = moller_trumbore(o, d, rec[:, 0:3], rec[:, 3:6], rec[:, 6:9],
                                   det_eps=TINY)
    return Hit(t=torch.where(hit, s["best"].reshape(-1)[:r], BIG_T),
               u=torch.where(hit, u, 0.0), v=torch.where(hit, v, 0.0), tri=tri,
               backface=hit & (det < 0.0))


def intersect_closest_packet(bvh: BVH, o, d, t_min, t_max,
                             cull_backface: bool = True) -> Hit:
    return traverse_packets(bvh, o, d, t_min, t_max, cull_backface, any_hit=False)


def intersect_any_packet(bvh: BVH, o, d, t_min, t_max) -> Tensor:
    """Occlusion of [t_min, t_max] (no culling)."""
    return traverse_packets(bvh, o, d, t_min, t_max, False, any_hit=True).is_hit
