"""The reference's own tree and its per-ray traversal, in plain torch.

The tree is a binary BVH built top-down with binned SAH (16 bins on each
axis, every node of a level split at once), with at most ``LEAF`` triangles
a leaf and an object-median split where the bins cannot separate the
centroids.  Node boxes are widened by a relative epsilon so that a slab
test never loses a triangle that the exact triangle test would find.

Traversal walks every ray with its own stack, all rays of a call in
lockstep: a step pops one node a ray, tests both children's boxes (pushing
the far one first) or the leaf's triangles.  Closest-hit keeps the
smallest t in [t_min, t_max], an exact tie going to the lower triangle id;
any-hit stops at the first hit.  ``counts`` receives the box and triangle
tests the rays needed: the benchmark's measure of a traversal's work,
whatever tree or kernel the program uses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

LEAF = 4
BINS = 16
STACK = 64
BIG_T = 3.0e38
DET_EPS = 1e-20
_BOX_PAD = 1e-6


class Tree(NamedTuple):
    lo: Tensor      # (N, 3) node boxes
    hi: Tensor
    left: Tensor    # (N,) int64 child ids, -1 at a leaf
    right: Tensor
    start: Tensor   # (N,) int64 first slot in ``order`` (leaves)
    count: Tensor   # (N,) int64 triangles (leaves), 0 inside
    order: Tensor   # (T,) int64 triangle ids in leaf order
    v0: Tensor      # (T, 3) triangle data, by triangle id
    e1: Tensor
    e2: Tensor
    two_sided: Tensor  # (T,) bool: no back-face culling


def _area(ext: Tensor) -> Tensor:
    ext = torch.clamp_min(ext, 0.0)
    return ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2] + ext[..., 2] * ext[..., 0]


def build(v0: Tensor, e1: Tensor, e2: Tensor, two_sided: Tensor) -> Tree:
    """Binned-SAH BVH over the triangles (v0, v0 + e1, v0 + e2)."""
    dev = v0.device
    n_tri = v0.shape[0]
    p1, p2 = v0 + e1, v0 + e2
    tlo = torch.minimum(torch.minimum(v0, p1), p2)
    thi = torch.maximum(torch.maximum(v0, p1), p2)
    cen = (tlo + thi) * 0.5
    order = torch.arange(n_tri, device=dev)
    # nodes are numbered level by level; each open node owns order[s:s+c]
    open_start = torch.zeros(1, dtype=torch.int64, device=dev)
    open_count = torch.full((1,), n_tri, dtype=torch.int64, device=dev)
    open_id = torch.zeros(1, dtype=torch.int64, device=dev)
    n_nodes = 1
    node_tables = []
    while open_id.numel():
        k = open_id.numel()
        seg = torch.repeat_interleave(torch.arange(k, device=dev), open_count)
        seg_first = torch.cumsum(open_count, 0) - open_count
        rank = torch.arange(seg.numel(), device=dev) - seg_first[seg]
        slot = open_start[seg] + rank
        tri = order[slot]
        inf = torch.full((k, 3), float("inf"), device=dev)
        nlo = inf.scatter_reduce(0, seg[:, None].expand(-1, 3), tlo[tri], "amin")
        nhi = (-inf).scatter_reduce(0, seg[:, None].expand(-1, 3), thi[tri], "amax")
        clo = inf.scatter_reduce(0, seg[:, None].expand(-1, 3), cen[tri], "amin")
        chi = (-inf).scatter_reduce(0, seg[:, None].expand(-1, 3), cen[tri], "amax")
        pad = _BOX_PAD * torch.clamp_min(torch.maximum(nlo.abs(), nhi.abs()), 1.0)
        split = open_count > LEAF
        # bins of each triangle on each axis, relative to its node's centroid box
        ext = chi - clo
        scale = torch.where(ext > 0, BINS / torch.where(ext > 0, ext, 1.0), 0.0)
        b = ((cen[tri] - clo[seg]) * scale[seg]).long().clamp(0, BINS - 1)  # (n, 3)
        key = (seg[:, None] * 3 + torch.arange(3, device=dev)) * BINS + b   # (n, 3)
        nb = k * 3 * BINS
        cnt = torch.zeros(nb, device=dev).index_add_(0, key.reshape(-1),
                                                     torch.ones(key.numel(), device=dev))
        blo = torch.full((nb, 3), float("inf"), device=dev)
        bhi = torch.full((nb, 3), float("-inf"), device=dev)
        kk = key.reshape(-1)[:, None].expand(-1, 3)
        blo = blo.scatter_reduce(0, kk, tlo[tri].repeat_interleave(3, 0), "amin")
        bhi = bhi.scatter_reduce(0, kk, thi[tri].repeat_interleave(3, 0), "amax")
        cnt = cnt.reshape(k, 3, BINS)
        blo = blo.reshape(k, 3, BINS, 3)
        bhi = bhi.reshape(k, 3, BINS, 3)
        # left of split j: bins 0..j; right: bins j+1..
        lc = torch.cumsum(cnt, dim=2)[..., :-1]
        llo = torch.cummin(blo, dim=2).values[..., :-1, :]
        lhi = torch.cummax(bhi, dim=2).values[..., :-1, :]
        rc = torch.flip(torch.cumsum(torch.flip(cnt, [2]), dim=2), [2])[..., 1:]
        rlo = torch.flip(torch.cummin(torch.flip(blo, [2]), dim=2).values, [2])[..., 1:, :]
        rhi = torch.flip(torch.cummax(torch.flip(bhi, [2]), dim=2).values, [2])[..., 1:, :]
        cost = _area(lhi - llo) * lc + _area(rhi - rlo) * rc
        cost = torch.where((lc > 0) & (rc > 0), cost, float("inf")).reshape(k, -1)
        best = torch.argmin(cost, dim=1)
        ok = torch.isfinite(cost.gather(1, best[:, None]))[:, 0]
        axis, sbin = best // (BINS - 1), best % (BINS - 1)
        go_left = b.gather(1, axis[seg][:, None])[:, 0] <= sbin[seg]
        # no bin separates the centroids: object median of the node's slots
        go_left = torch.where(ok[seg], go_left, rank < open_count[seg] // 2)
        # stable partition of each splitting node's slots
        gl = go_left.long()
        cl = torch.cumsum(gl, 0)
        n_left = torch.zeros(k, dtype=torch.int64, device=dev).index_add_(0, seg, gl)
        before_l = (cl - gl) - (cl - gl)[seg_first][seg]
        rank_r = rank - before_l
        new_pos = torch.where(go_left, open_start[seg] + before_l,
                              open_start[seg] + n_left[seg] + rank_r)
        moving = split[seg]
        order[torch.where(moving, new_pos, slot)] = tri
        # children of the splitting nodes
        ns = int(split.sum())
        child_l = torch.full((k,), -1, dtype=torch.int64, device=dev)
        child_r = torch.full((k,), -1, dtype=torch.int64, device=dev)
        child_l[split] = n_nodes + 2 * torch.arange(ns, device=dev)
        child_r[split] = child_l[split] + 1
        node_tables.append((open_id, nlo - pad, nhi + pad, child_l, child_r,
                            open_start, torch.where(split, 0, open_count)))
        n_nodes += 2 * ns
        cs = torch.stack([open_start[split], open_start[split] + n_left[split]], 1).reshape(-1)
        cc = torch.stack([n_left[split], open_count[split] - n_left[split]], 1).reshape(-1)
        open_id = torch.stack([child_l[split], child_r[split]], 1).reshape(-1)
        open_start, open_count = cs, cc
    lo = torch.zeros((n_nodes, 3), device=dev)
    hi = torch.zeros((n_nodes, 3), device=dev)
    left = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    right = left.clone()
    start = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    count = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    for ids, a, b_, c, d, s, n in node_tables:
        lo[ids], hi[ids], left[ids], right[ids], start[ids], count[ids] = a, b_, c, d, s, n
    return Tree(lo, hi, left, right, start, count, order, v0, e1, e2, two_sided)


def moller_trumbore(o, d, v0, e1, e2):
    """(t, u, v, det), every dot and cross product summed left to right."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det.abs() < DET_EPS, 1.0, det)
    tvx = ox - v0[..., 0]
    tvy = oy - v0[..., 1]
    tvz = oz - v0[..., 2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return t, u, v, det


class Hit(NamedTuple):
    t: Tensor       # BIG_T on a miss
    u: Tensor
    v: Tensor
    tri: Tensor     # int64 triangle id (0 on a miss)
    back: Tensor    # bool

    @property
    def is_hit(self) -> Tensor:
        return self.t < BIG_T


def _slab(o, inv, lo, hi, t0, t1):
    a = (lo - o) * inv
    b = (hi - o) * inv
    near = torch.amax(torch.minimum(a, b), dim=-1)
    far = torch.amin(torch.maximum(a, b), dim=-1)
    near = torch.maximum(near, t0)
    far = torch.minimum(far, t1)
    return near <= far, near


def traverse(tree: Tree, o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor,
             cull: bool, any_hit: bool, counts: dict | None = None) -> Hit:
    """Closest (or, with ``any_hit``, some) hit of each ray in [t_min,
    t_max] over ``tree``.  Back faces are culled where ``cull`` and the
    triangle is one-sided.  ``counts`` gets "box_tests" and "tri_tests"
    added."""
    r = o.shape[0]
    dev = o.device
    best_t = torch.full((r,), BIG_T, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)
    best_tri = torch.zeros(r, dtype=torch.int64, device=dev)
    best_back = torch.zeros(r, dtype=torch.bool, device=dev)
    box_tests = torch.zeros((), dtype=torch.int64, device=dev)
    tri_tests = torch.zeros((), dtype=torch.int64, device=dev)
    tiny = torch.full_like(d, 1e-30)
    inv = 1.0 / torch.where(d.abs() < 1e-30, torch.copysign(tiny, d), d)
    stack = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    live = t_min <= t_max
    box_tests += live.sum()
    root_hit, _ = _slab(o, inv, tree.lo[0], tree.hi[0], t_min, t_max)
    sp = (live & root_hit).long()
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack[act, sp[act]]
        leaf = tree.left[node] < 0
        # leaves: test up to LEAF triangles
        la = act[leaf]
        if la.numel():
            ln = node[leaf]
            cnt = tree.count[ln]
            tri_tests += cnt.sum()
            j = torch.arange(LEAF, device=dev)
            valid = j[None, :] < cnt[:, None]
            tri = tree.order[(tree.start[ln][:, None] + j).clamp(max=tree.order.numel() - 1)]
            t, u, v, det = moller_trumbore(o[la][:, None], d[la][:, None], tree.v0[tri],
                                           tree.e1[tri], tree.e2[tri])
            ok = valid & (det.abs() > DET_EPS)
            if cull:
                ok &= (det > DET_EPS) | tree.two_sided[tri]
            ok &= (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            ok &= (t >= t_min[la][:, None]) & (t <= t_max[la][:, None])
            bt = best_t[la][:, None]
            btri = best_tri[la][:, None]
            ok &= (t < bt) | ((t == bt) & (tri < btri))
            tt = torch.where(ok, t, float("inf"))
            # the smallest t of the leaf, the lowest id on a tie
            m = tt.amin(dim=1, keepdim=True)
            pick = ok & (tt == m)
            idx = torch.where(pick, tri, torch.iinfo(torch.int64).max).argmin(dim=1)
            got = pick.any(dim=1)
            g = la[got]
            sel = idx[got][:, None]
            best_t[g] = t[got].gather(1, sel)[:, 0]
            best_u[g] = u[got].gather(1, sel)[:, 0]
            best_v[g] = v[got].gather(1, sel)[:, 0]
            best_tri[g] = tri[got].gather(1, sel)[:, 0]
            best_back[g] = det[got].gather(1, sel)[:, 0] < 0.0
            if any_hit:
                sp[g] = 0
        # inner nodes: both children's boxes, the nearer popped first
        ia = act[~leaf]
        if ia.numel():
            inn = node[~leaf]
            box_tests += 2 * ia.numel()
            cl, cr = tree.left[inn], tree.right[inn]
            oo, ii, t0, t1 = o[ia], inv[ia], t_min[ia], torch.minimum(t_max[ia], best_t[ia])
            hl, nl = _slab(oo, ii, tree.lo[cl], tree.hi[cl], t0, t1)
            hr, nr = _slab(oo, ii, tree.lo[cr], tree.hi[cr], t0, t1)
            near_first = nl <= nr
            first = torch.where(near_first, cr, cl)   # pushed first: popped last
            second = torch.where(near_first, cl, cr)
            h_first = torch.where(near_first, hr, hl)
            h_second = torch.where(near_first, hl, hr)
            s = sp[ia]
            stack[ia, s.clamp(max=STACK - 1)] = first
            s = s + h_first.long()
            stack[ia, s.clamp(max=STACK - 1)] = second
            s = s + h_second.long()
            if bool((s > STACK).any()):
                raise RuntimeError("reference traversal: stack overflow")
            sp[ia] = s
    if counts is not None:
        counts["box_tests"] = counts.get("box_tests", 0) + int(box_tests)
        counts["tri_tests"] = counts.get("tri_tests", 0) + int(tri_tests)
    return Hit(best_t, best_u, best_v, best_tri, best_back)
