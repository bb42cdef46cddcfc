// What the two packet traversals share: the shared-cursor kernel
// (shared_traverse.cu, one cursor per 1024-ray packet) and the subpacket
// kernel (subpacket_traverse.cu, one cursor per 128-ray packet).  Both walk
// the 2-wide BVH's own arrays (Table2, bvh2_traverse.cuh) with ONE cursor
// and ONE stack per packet; every lane (thread) runs its own ray.
//
// The per-lane arithmetic is here: the slab test of one child box and the
// leaf test.  So is the packet's uniform decision (next cursor, push, pop),
// taken from packet-wide flags and minima.  The kernels apply it from one
// thread to the block's shared cursor and stack; the CPU twins apply it in
// host loops over the lanes.
//
// The packet kernels keep the Hit contract of the TPU packet kernels
// (ops/traverse_pallas.py, ops/traverse_subpacket.py), which differs from
// the wide kernels' (traverse_common.cuh):
//   - det epsilon kTiny = 1e-30 for validity (|det| > tiny) and for the
//     cull test (det > tiny, or the triangle is double-sided);
//   - the window t_min <= t < best, best starting at t_max: a hit exactly
//     at t_max is not committed, and on equal t the first triangle tested
//     wins, so ties follow the packet's visit order;
//   - a hit's triangle id is its record index (BVH order); u, v and the
//     back face are committed here, by the formulas the JAX package
//     recomputes for the winner outside its kernels.
// The TPU subpacket kernel also tests a leaf's row-mates in its 8-record
// VMEM row and pushes synthetic leaves for ranges that span two rows; both
// come from that layout alone and are not ported: a leaf tests exactly its
// own [start, start + count) triangles.  They change only which triangle
// wins an exact tie.
//
// Both kernels push at most one entry per visit of an interior node (the
// far child of two hit children) and pop before they push again along
// another path, so the stack never holds more entries than the deepest
// chain of interior nodes: accel/lbvh.py::worst_case_stack, which
// build_table2 holds to kStackDepth.  The TPU kernels' trip caps
// (MAX_ITERS) are left out: traversal ends when the bounded stack empties.
//
// Built by nvcc with -fmad=false and by g++ with -ffp-contract=off, so the
// kernels, the twins and the plain PyTorch versions round every operation
// alike.
#pragma once

#include "bvh2_traverse.cuh"

namespace vrt {
namespace packet {

// The cursor of a packet with nothing left to visit.  Leaf codes stay
// above it: triangle starts fit in 24 bits.
constexpr int kDone = -(1 << 30);

// Slab test of the child box c = (lo xyz, hi xyz): sets the entry
// distance tn and returns tn <= tf, tf capped by the lane's best t.
VRT_HD bool slab(const float* c, const Ray& r, float ix, float iy, float iz,
                 float best, float& tn) {
  const float ax = (c[0] - r.ox) * ix, bx = (c[3] - r.ox) * ix;
  const float ay = (c[1] - r.oy) * iy, by = (c[4] - r.oy) * iy;
  const float az = (c[2] - r.oz) * iz, bz = (c[5] - r.oz) * iz;
  tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fmaxf(fminf(az, bz), r.tmin));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                         fminf(fmaxf(az, bz), best));
  return tn <= tf;
}

// Ray i of n; lanes past the last ray are dead (t_min 1 > t_max 0), as
// the TPU kernels pad them.
VRT_HD Ray load_lane(const float* o, const float* d, const float* tmin,
                     const float* tmax, long long i, int n) {
  if (i >= n) return Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
             d[3 * i + 2], tmin[i], tmax[i]};
}

// The lane's best t before any hit: t_max, or kBig past it.
VRT_HD float initial_best(const Ray& r) { return r.tmax < kBig ? r.tmax : kBig; }

// Tests the leaf `code`'s triangles in order and commits each valid hit
// of a live lane into best and h (the last valid one wins, and each must
// be nearer than the one before).
template <bool kCull>
VRT_HD void test_leaf(const Table2& tab, int code, const Ray& r, bool live,
                      float& best, HitRecord& h) {
  const int packed = ~code;
  const int start = packed >> 4, count = packed & 15;
  for (int s = start; s < start + count; ++s) {
    const int flags = tab.tri_flags[s];
    const float* q = tab.tri + 12 * static_cast<long long>(s);
    const float v0x = q[0], v0y = q[1], v0z = q[2];
    const float e1x = q[3], e1y = q[4], e1z = q[5];
    const float e2x = q[6], e2y = q[7], e2z = q[8];
    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv_det = 1.0f / (fabsf(det) < kTiny ? 1.0f : det);
    const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
    const float mu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float mv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
    const float mt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    bool valid = live && (flags & 6) && fabsf(det) > kTiny && mu >= 0.0f &&
                 mv >= 0.0f && mu + mv <= 1.0f && mt >= r.tmin && mt < best;
    if (kCull) valid = valid && (det > kTiny || (flags & 1));
    if (valid) {
      best = mt;
      h.hit = true;
      h.tri = s;
      h.u = mu;
      h.v = mv;
      h.backface = det < 0.0f;
    }
  }
}

VRT_HD int pop(const int* stack, int& sp) { return sp > 0 ? stack[--sp] : kDone; }

// The shared-cursor kernel's next cursor after a node step whose hit leaf
// children were already tested: the nearer of two hit interior children
// (child 0 on equal entry distances) with the other pushed, the one hit
// interior child, else a pop.
VRT_HD int shared_next(bool hit0, bool hit1, float te0, float te1, int c0,
                       int c1, int* stack, int& sp) {
  const bool d0 = hit0 && c0 >= 0, d1 = hit1 && c1 >= 0;
  if (d0 && d1) {
    const bool near0 = te0 <= te1;
    stack[sp++] = near0 ? c1 : c0;
    return near0 ? c0 : c1;
  }
  if (d0 || d1) return d0 ? c0 : c1;
  return pop(stack, sp);
}

// The subpacket kernel's next cursor after an interior step; a child may
// be a leaf, which becomes the cursor.  Closest-hit goes to the nearer hit
// child (child 0 on equal entry distances) and pushes the other; any-hit
// goes to child 0 when it is hit, else child 1, and pushes child 1 when
// both are hit; with neither hit it pops.
template <bool kAnyHit>
VRT_HD int subpacket_next(bool h0, bool h1, float t0, float t1, int c0,
                          int c1, int* stack, int& sp) {
  if (!(h0 || h1)) return pop(stack, sp);
  const bool near0 = t0 <= t1;
  int next, far;
  if (kAnyHit) {
    next = h0 ? c0 : c1;
    far = c1;
  } else {
    next = h0 && h1 ? (near0 ? c0 : c1) : (h0 ? c0 : c1);
    far = near0 ? c1 : c0;
  }
  if (h0 && h1) stack[sp++] = far;
  return next;
}

#ifdef __CUDACC__
__device__ __forceinline__ float warp_min(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide minima of a and b, returned to every thread.  A minimum is
// exact in any order, so the kernel stays bit-equal to its plain version.
template <int kWarps>
__device__ __forceinline__ void block_min2(float& a, float& b,
                                           float (*scratch)[32], float* out) {
  a = warp_min(a);
  b = warp_min(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[0][warp] = a;
    scratch[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float x = lane < kWarps ? scratch[0][lane] : kBig;
    float y = lane < kWarps ? scratch[1][lane] : kBig;
    x = warp_min(x);
    y = warp_min(y);
    if (lane == 0) {
      out[0] = x;
      out[1] = y;
    }
  }
  __syncthreads();
  a = out[0];
  b = out[1];
}

#endif

}  // namespace packet
}  // namespace vrt
