// What the BVH8 and BVH2 traversals share: the ray and hit records, the
// slab test of one child box and the Moller-Trumbore test of one triangle.
//
// The Hit contract of the TPU kernels, rule for rule:
//   - slab test with the tiny = 1e-30 reciprocal guard, inclusive
//     tn <= tf, tf capped by the current best t;
//   - Moller-Trumbore with det epsilon 1e-20 and the window
//     t_min <= t <= best, products and sums written out in one order;
//   - candidates are triangles with flags & 6, cull-disable is flags & 1,
//     back faces are culled (closest mode only) unless det > eps or the
//     triangle is double-sided;
//   - equal-t ties go to the lowest triangle id: (t < best) | (id < cur).
//
// The same code is compiled by nvcc for the kernels and by g++ for CPU
// twins used in the tests; both must be built without FMA contraction
// (-fmad=false, -ffp-contract=off) to round as the plain PyTorch versions.
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

// Entry distance of the box c = (lo xyz, hi xyz), kBig where missed.
VRT_HD float box_distance(const float* c, const Ray& r, float ix, float iy,
                          float iz, float best) {
  float ax = (c[0] - r.ox) * ix, bx = (c[3] - r.ox) * ix;
  float ay = (c[1] - r.oy) * iy, by = (c[4] - r.oy) * iy;
  float az = (c[2] - r.oz) * iz, bz = (c[5] - r.oz) * iz;
  float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                   fmaxf(fminf(az, bz), r.tmin));
  float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                   fminf(fmaxf(az, bz), best));
  return tn <= tf ? tn : kBig;
}

// Tests one candidate triangle (v0, e1, e2 at the given pointers) and
// commits a valid closest hit into h and best.  Returns true when an
// any-hit query has found its occluder.
template <bool kAnyHit, bool kCull>
VRT_HD bool test_triangle(const float* v0, const float* e1, const float* e2,
                          int flags, int tid, const Ray& r, float& best,
                          HitRecord& h) {
  const float v0x = v0[0], v0y = v0[1], v0z = v0[2];
  const float e1x = e1[0], e1y = e1[1], e1z = e1[2];
  const float e2x = e2[0], e2y = e2[1], e2z = e2[2];
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
    h.hit = h.hit || valid;
    return valid;
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
  return false;
}

}  // namespace vrt
