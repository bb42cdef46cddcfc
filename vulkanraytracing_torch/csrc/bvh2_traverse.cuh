// BVH2 ray traversal: one ray per call, closest-hit or any-hit.
//
// Replaces the Pallas kernel vulkanraytracing_tpu/ops/traverse_wide.py
// (_kernel, driven by _traverse_wide_packed) on an NVIDIA Hopper card.
// That kernel moves one cursor per 128-ray row through a unified
// node+triangle table in VMEM, in static waves of 64 rows, and tests all 8
// records of a fetched leaf row (pushing a continuation when a leaf spans
// two rows).  Here every CUDA thread walks its own ray with its own stack
// over the 2-wide BVH in global memory (ops/traverse_wide.py::Table2) and
// tests exactly the leaf's [start, start + count) triangles; the (t, id)
// rule of traverse_common.cuh makes the winner independent of visit order
// and of the TPU kernel's extra candidates.  The order of visits follows
// the TPU kernel: closest-hit descends the nearer hit child (child 0 on
// equal entry distances) and pushes the other; any-hit descends child 0
// when it is hit, else child 1, pushes child 1 when both are hit, and
// returns at the first occluder.  Triangle ids are record indices (the
// triangles are stored in BVH order), u, v and back face are committed
// here rather than recomputed for the winner afterwards.
//
// What bounds it on the card: the 2-wide tree is about three times as deep
// as the 8-wide one, and every node visit is a dependent chain of global
// loads (48 bytes of boxes, then 8 bytes of child ids) taken by one ray;
// the rays of a warp diverge as soon as their paths split, and the stack
// lives in local memory.  The design is the plain one-ray-per-thread one
// for now; wider nodes (collapse after each build), persistent threads and
// ray reordering are the later options.
#pragma once

#include "traverse_common.cuh"

namespace vrt {

struct Table2 {
  const float* nodes;    // (N, 12): c0.lo c0.hi c1.lo c1.hi
  const int* child;      // (N, 2): node id (>= 0) or leaf code (< 0)
  const float* tri;      // (T, 12): v0 xyz, e1 xyz, e2 xyz, 3 pads
  const int* tri_flags;  // (T,): bit0 cull-disable, bits 1-2 candidate
};

template <bool kAnyHit, bool kCull>
VRT_HD HitRecord traverse2(const Table2& tab, const Ray& r) {
  HitRecord h{kBig, 0.0f, 0.0f, 0, false, false};
  if (!(r.tmin <= r.tmax)) return h;
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  float best = fminf(r.tmax, kBig);
  // build_table2 proves the tree's worst-case pushes fit this stack
  // (accel/lbvh.py::worst_case_stack)
  int stack[kStackDepth];
  int sp = 0;
  int cur = 0;  // the root
  for (;;) {
    if (cur >= 0) {
      const float* b = tab.nodes + 12 * static_cast<long long>(cur);
      const float d0 = box_distance(b, r, ix, iy, iz, best);
      const float d1 = box_distance(b + 6, r, ix, iy, iz, best);
      const int c0 = tab.child[2 * static_cast<long long>(cur)];
      const int c1 = tab.child[2 * static_cast<long long>(cur) + 1];
      const bool h0 = d0 < kBig, h1 = d1 < kBig;
      if (h0 || h1) {
        const bool first0 = kAnyHit ? h0 : (h0 && h1 ? d0 <= d1 : h0);
        if (h0 && h1) stack[sp++] = first0 ? c1 : c0;
        cur = first0 ? c0 : c1;
        continue;
      }
    } else {
      const int packed = ~cur;
      const int start = packed >> 4, count = packed & 15;
      for (int s = start; s < start + count; ++s) {
        const int flags = tab.tri_flags[s];
        if (!(flags & 6)) continue;
        const float* q = tab.tri + 12 * static_cast<long long>(s);
        if (test_triangle<kAnyHit, kCull>(q, q + 3, q + 6, flags, s, r, best, h))
          return h;
      }
    }
    if (sp == 0) break;
    cur = stack[--sp];
  }
  if (h.hit) h.t = best;
  return h;
}

}  // namespace vrt
