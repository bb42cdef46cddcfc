// BVH8 ray traversal: one ray per call, closest-hit or any-hit.
//
// Replaces the Pallas kernel vulkanraytracing_tpu/ops/traverse_wide8.py
// (_kernel, driven by _traverse_wide8_packed) on an NVIDIA Hopper card.
// That kernel marches 128-ray rows through VMEM with a shared cursor per
// row; here every CUDA thread walks its own ray with its own stack, over a
// table in global memory (built by ops/traverse_wide8.py::build_table8).
// What is kept from the TPU kernel is the Hit contract, rule for rule:
//   - slab test with the tiny = 1e-30 reciprocal guard, inclusive
//     tn <= tf, tf capped by the current best t;
//   - Moller-Trumbore with det epsilon 1e-20 and the window
//     t_min <= t <= best, products and sums written out in one order;
//   - candidates are triangles with flags & 6, cull-disable is flags & 1,
//     back faces are culled (closest mode only) unless det > eps or the
//     triangle is double-sided;
//   - equal-t ties go to the lowest triangle id: (t < best) | (id < cur);
//   - closest-hit descends the nearest child first (a stable sort of the
//     child entry distances); any-hit descends the nearest hit child and
//     returns at the first occluder.
//
// What bounds it on the card (the work of later changes): each node visit
// is a chain of dependent global loads (192 bytes of boxes, then the
// child ids), rays of one warp diverge as soon as their paths split, and
// the per-thread stack and sort buffers live in local memory.  Compressed
// nodes, persistent threads and ray reordering address those.
//
// The same code is compiled by nvcc for the kernel and by g++ for a CPU
// twin used in the tests; both must be built without FMA contraction
// (-fmad=false, -ffp-contract=off) to round as the plain PyTorch version.
#pragma once

#ifdef __CUDACC__
#define VRT_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define VRT_HD inline
#endif

#ifndef VRT_STACK_DEPTH
#error "VRT_STACK_DEPTH must be defined by the build"
#endif

namespace vrt {

constexpr int kStackDepth = VRT_STACK_DEPTH;
constexpr float kBig = 3.0e38f;
constexpr float kTiny = 1e-30f;
constexpr float kDetEps = 1e-20f;
constexpr int kIntMax = 0x7fffffff;

struct Table8 {
  const float* boxes;   // (M, 48): child k's box at [6k, 6k+6): lo xyz, hi xyz
  const int* child;     // (M, 8): node id (> 0), leaf code (< 0), 0 = empty
  const float* tri;     // (T8, 12): v0 xyz 0, e1 xyz 0, e2 xyz 0
  const int* tri_meta;  // (T8, 2): flags, BVH-order triangle id
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

struct HitRecord {
  float t, u, v;
  int tri;
  bool hit, backface;
};

VRT_HD float safe_inv(float c) {
  return 1.0f / (fabsf(c) < kTiny ? (c < 0.0f ? -kTiny : kTiny) : c);
}

// Entry distance of each of the node's 8 children, kBig where missed.
VRT_HD void child_distances(const float* b, const Ray& r, float ix, float iy,
                            float iz, float best, float* dist) {
  for (int k = 0; k < 8; ++k) {
    const float* c = b + 6 * k;
    float ax = (c[0] - r.ox) * ix, bx = (c[3] - r.ox) * ix;
    float ay = (c[1] - r.oy) * iy, by = (c[4] - r.oy) * iy;
    float az = (c[2] - r.oz) * iz, bz = (c[5] - r.oz) * iz;
    float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                     fmaxf(fminf(az, bz), r.tmin));
    float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                     fminf(fmaxf(az, bz), best));
    dist[k] = tn <= tf ? tn : kBig;
  }
}

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
      float dist[8];
      child_distances(tab.boxes + 48 * static_cast<long long>(cur), r, ix, iy,
                      iz, best, dist);
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
        const int tid = tab.tri_meta[2 * s + 1];
        const float* q = tab.tri + 12 * static_cast<long long>(s);
        const float v0x = q[0], v0y = q[1], v0z = q[2];
        const float e1x = q[4], e1y = q[5], e1z = q[6];
        const float e2x = q[8], e2y = q[9], e2z = q[10];
        const float pvx = r.dy * e2z - r.dz * e2y;
        const float pvy = r.dz * e2x - r.dx * e2z;
        const float pvz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float inv_det = 1.0f / (fabsf(det) < kDetEps ? 1.0f : det);
        const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
        const float mu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float mv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
        const float mt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        bool valid = fabsf(det) > kDetEps && mu >= 0.0f && mv >= 0.0f &&
                     mu + mv <= 1.0f && mt >= r.tmin && mt <= best;
        if (kCull) valid = valid && (det > kDetEps || (flags & 1));
        if (kAnyHit) {
          if (valid) {
            h.hit = true;
            return h;
          }
          continue;
        }
        valid = valid && (mt < best || tid < (h.hit ? h.tri : kIntMax));
        if (valid) {
          best = mt;
          h.hit = true;
          h.tri = tid;
          h.u = mu;
          h.v = mv;
          h.backface = det < 0.0f;
        }
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
