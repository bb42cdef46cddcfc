// BVH8 ray traversal: one ray per call, closest-hit or any-hit.
//
// Replaces the Pallas kernel vulkanraytracing_tpu/ops/traverse_wide8.py
// (_kernel, driven by _traverse_wide8_packed) on an NVIDIA Hopper card.
// That kernel marches 128-ray rows through VMEM with a shared cursor per
// row; here every CUDA thread walks its own ray with its own stack, over a
// table in global memory (built by ops/traverse_wide8.py::build_table8).
// The Hit contract it keeps is in traverse_common.cuh; the order of visits:
// closest-hit descends the nearest child first (a stable sort of the
// child entry distances); any-hit descends the nearest hit child and
// returns at the first occluder.
//
// What bounds it on the card (the work of later changes): each node visit
// is a chain of dependent global loads (192 bytes of boxes, then the
// child ids), rays of one warp diverge as soon as their paths split, and
// the per-thread stack and sort buffers live in local memory.  Compressed
// nodes, persistent threads and ray reordering address those.
#pragma once

#include "traverse_common.cuh"

namespace vrt {

struct Table8 {
  const float* boxes;   // (M, 48): child k's box at [6k, 6k+6): lo xyz, hi xyz
  const int* child;     // (M, 8): node id (> 0), leaf code (< 0), 0 = empty
  const float* tri;     // (T8, 12): v0 xyz 0, e1 xyz 0, e2 xyz 0
  const int* tri_meta;  // (T8, 2): flags, BVH-order triangle id
};

template <bool kAnyHit, bool kCull>
VRT_HD HitRecord traverse(const Table8& tab, const Ray& r) {
  HitRecord h{kBig, 0.0f, 0.0f, 0, false, false};
  if (!(r.tmin <= r.tmax)) return h;
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  float best = fminf(r.tmax, kBig);
  // build_table8 proves the tree's worst-case pushes fit this stack
  // (accel/bvh8.py::_worst_case_stack)
  int stack[kStackDepth];
  int sp = 0;
  int cur = 0;  // the root
  for (;;) {
    bool descend = false;
    if (cur >= 0) {
      const float* boxes = tab.boxes + 48 * static_cast<long long>(cur);
      float dist[8];
      for (int k = 0; k < 8; ++k)
        dist[k] = box_distance(boxes + 6 * k, r, ix, iy, iz, best);
      const int* kids = tab.child + 8 * static_cast<long long>(cur);
      if (kAnyHit) {
        int near = -1;
        float dn = kBig;
        for (int k = 0; k < 8; ++k)
          if (dist[k] < dn) { dn = dist[k]; near = k; }
        if (near >= 0) {
          for (int k = 0; k < 8; ++k)
            if (k != near && dist[k] < kBig) stack[sp++] = kids[k];
          cur = kids[near];
          descend = true;
        }
      } else {
        // stable insertion sort of the hit children, nearest first
        int order[8];
        int n = 0;
        for (int k = 0; k < 8; ++k) {
          if (!(dist[k] < kBig)) continue;
          int j = n++;
          while (j > 0 && dist[order[j - 1]] > dist[k]) {
            order[j] = order[j - 1];
            --j;
          }
          order[j] = k;
        }
        if (n > 0) {
          for (int j = n - 1; j >= 1; --j) stack[sp++] = kids[order[j]];
          cur = kids[order[0]];
          descend = true;
        }
      }
    } else {
      const int packed = ~cur;
      const int start = packed >> 4, count = packed & 15;
      for (int s = start; s < start + count; ++s) {
        const int flags = tab.tri_meta[2 * s];
        if (!(flags & 6)) continue;
        const float* q = tab.tri + 12 * static_cast<long long>(s);
        if (test_triangle<kAnyHit, kCull>(q, q + 4, q + 8, flags,
                                          tab.tri_meta[2 * s + 1], r, best, h))
          return h;
      }
    }
    if (descend) continue;
    if (sp == 0) break;
    cur = stack[--sp];
  }
  if (h.hit) h.t = best;
  return h;
}

}  // namespace vrt
