// What the BVH8 and BVH2 traversals share: the ray and hit records, the
// slab test of one child box, the Moller-Trumbore test of one triangle,
// the 16-byte loads of the packed tables, the per-ray stack and walk state,
// and the persistent-warp kernel that drives either walk on the card.
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
// A walk (Walk) is one ray's traversal as a sequence of steps: a step at an
// interior node (cur >= 0) runs the node's slab tests and moves the cursor
// to a child or pops; a step at a leaf (cur < 0) tests the leaf's triangles
// and pops; the cursor is kDone once nothing is left.  A ray's steps and
// their arithmetic depend on nothing but the ray and the table, so whoever
// drives them (the persistent warps below, the host loop of a CPU twin)
// gets the same result, bit for bit.
//
// The same code is compiled by nvcc for the kernels and by g++ for CPU
// twins used in the tests; both must be built without FMA contraction
// (-fmad=false, -ffp-contract=off) to round as the plain PyTorch versions.
#pragma once

#ifdef __CUDACC__
#define VRT_HD __host__ __device__ __forceinline__
#define VRT_UNROLL _Pragma("unroll")
#else
#include <cmath>
#define VRT_HD inline
#define VRT_UNROLL
#endif
#include <cstring>

#ifndef VRT_STACK_DEPTH
#error "VRT_STACK_DEPTH must be defined by the build"
#endif

namespace vrt {

constexpr int kStackDepth = VRT_STACK_DEPTH;
constexpr float kBig = 3.0e38f;
constexpr float kTiny = 1e-30f;
constexpr float kDetEps = 1e-20f;
constexpr int kIntMax = 0x7fffffff;
// The cursor of a walk with nothing left to visit.  Leaf codes stay above
// it: triangle starts fit in 24 bits.
constexpr int kDone = -(1 << 30);

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

struct HitRecord {
  float t, u, v;
  int tri;
  bool hit, backface;
};

// Four consecutive floats of a packed table record.
struct alignas(16) Vec4 {
  float f[4];
};

// One 16-byte load of a table record at a 16-byte-aligned address: through
// the read-only path on the card, a plain copy on the host.
VRT_HD Vec4 load16(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return Vec4{{q.x, q.y, q.z, q.w}};
#else
  Vec4 q;
  std::memcpy(&q, p, sizeof q);
  return q;
#endif
}

// The int32 stored bit for bit in a float of a packed record.
VRT_HD int as_int(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int i;
  std::memcpy(&i, &x, sizeof i);
  return i;
#endif
}

// Ray i of the (n, 3) origins and directions and the (n,) windows.
VRT_HD Ray load_ray(const float* o, const float* d, const float* tmin,
                    const float* tmax, int i) {
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
             d[3 * i + 2], tmin[i], tmax[i]};
}

VRT_HD float safe_inv(float c) {
  return 1.0f / (fabsf(c) < kTiny ? (c < 0.0f ? -kTiny : kTiny) : c);
}

// Entry distance of the box (lo xyz, hi xyz), kBig where missed.
VRT_HD float box_distance(float lox, float loy, float loz, float hix,
                          float hiy, float hiz, const Ray& r, float ix,
                          float iy, float iz, float best) {
  float ax = (lox - r.ox) * ix, bx = (hix - r.ox) * ix;
  float ay = (loy - r.oy) * iy, by = (hiy - r.oy) * iy;
  float az = (loz - r.oz) * iz, bz = (hiz - r.oz) * iz;
  float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                   fmaxf(fminf(az, bz), r.tmin));
  float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                   fminf(fmaxf(az, bz), best));
  return tn <= tf ? tn : kBig;
}

// Tests one candidate triangle (vertex v0, edges e1 and e2) and commits a
// valid closest hit into h and best.  Returns true when an any-hit query
// has found its occluder.
template <bool kAnyHit, bool kCull>
VRT_HD bool test_triangle(float v0x, float v0y, float v0z, float e1x,
                          float e1y, float e1z, float e2x, float e2y,
                          float e2z, int flags, int tid, const Ray& r,
                          float& best, HitRecord& h) {
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

// A ray's traversal stack of kStackDepth entries (build_table8 and
// build_table2 prove that no tree needs more).  The first kFast entries live in `fast`, kStride
// ints apart: on the card a column of the block's shared memory, one column
// per thread, so the threads of a warp always fall into 32 different banks;
// deeper entries spill into `slow`, an array of kStackDepth - kFast ints of
// the thread's own (local memory on the card).
template <int kFast, int kStride>
struct Stack {
  static_assert(0 < kFast && kFast < kStackDepth, "the fast part of the stack");
  int* fast;
  int* slow;
  int sp;

  VRT_HD void push(int entry) {
    if (sp < kFast)
      fast[sp * kStride] = entry;
    else
      slow[sp - kFast] = entry;
    ++sp;
  }
  // The next cursor: the top entry, or kDone from an empty stack.
  VRT_HD int pop() {
    if (sp == 0) return kDone;
    --sp;
    return sp < kFast ? fast[sp * kStride] : slow[sp - kFast];
  }
};

// One ray in flight.
struct Walk {
  Ray r;
  float ix, iy, iz, best;
  HitRecord h;
  int cur;
};

// Puts a ray at the root, or nowhere when its window is empty.
template <class S>
VRT_HD void start_walk(Walk& w, S& stack, const Ray& r) {
  w.r = r;
  w.ix = safe_inv(r.dx);
  w.iy = safe_inv(r.dy);
  w.iz = safe_inv(r.dz);
  w.best = fminf(r.tmax, kBig);
  w.h = HitRecord{kBig, 0.0f, 0.0f, 0, false, false};
  w.cur = r.tmin <= r.tmax ? 0 : kDone;
  stack.sp = 0;
}

// The whole walk of one ray over the traversal T (Bvh8 or Bvh2: its table,
// node step and leaf step), as the CPU twins run it.
template <class T, bool kAnyHit, bool kCull>
VRT_HD HitRecord walk_ray(const typename T::Table& tab, const Ray& r) {
  int fast[T::kFastStack], slow[kStackDepth - T::kFastStack];
  Stack<T::kFastStack, 1> stack{fast, slow, 0};
  Walk w;
  start_walk(w, stack, r);
  while (w.cur != kDone) {
    if (w.cur >= 0)
      T::template node_step<kAnyHit>(tab, w, stack);
    else
      T::template leaf_step<kAnyHit, kCull>(tab, w, stack);
  }
  if (w.h.hit) w.h.t = w.best;
  return w.h;
}

#ifdef __CUDACC__

constexpr int kBlock = 128;
// Blocks per SM that the register budget must allow: 64 registers a thread.
constexpr int kMinBlocksPerSm = 8;
constexpr unsigned kFullWarp = 0xffffffffu;
// A warp whose walking lanes fall below this count takes new rays from the
// queue into every idle lane.
constexpr int kRefillBelow = 16;
// A lane leaves the node loop or the leaf loop once fewer than this many
// lanes of its warp are still in it with it, so that a few long walks do
// not hold the other lanes off their next phase or their refill.  Every
// lane makes at least one step a round, whatever the count says.
constexpr int kLeaveLoopBelow = 12;

// Persistent warps over a queue of rays.  The grid is sized to the card
// (traverse_launch); every warp takes rays from the global counter
// `next_ray`, 32 at first and later as many as it has idle lanes.  A ray
// with an empty window gets its miss written at once and never holds a
// lane.  A round: the walking lanes run node steps until each stands at a
// leaf or has finished (or too few are left at nodes), then leaf steps
// until each stands at a node again (or too few are left at leaves), so the
// lanes of a warp test triangles together; a finished lane writes its
// result and waits for the next refill.  Which lane walks which ray changes
// from run to run and changes no result.
template <class T, bool kAnyHit, bool kCull>
__global__ void __launch_bounds__(kBlock, kMinBlocksPerSm)
    traverse_kernel(typename T::Table tab, const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n, int* next_ray,
                    float* out_t, float* out_u, float* out_v, int* out_tri,
                    bool* out_flag) {
  __shared__ int fast[T::kFastStack * kBlock];
  int slow[kStackDepth - T::kFastStack];
  Stack<T::kFastStack, kBlock> stack{fast + threadIdx.x, slow, 0};
  const unsigned lane = threadIdx.x & 31;
  Walk w;
  w.cur = kDone;
  int ray = -1;      // the ray this lane walks
  bool more = true;  // the queue may hold rays (the same in every lane)
  for (;;) {
    if (ray >= 0 && w.cur == kDone) {
      if (kAnyHit) {
        out_flag[ray] = w.h.hit;
      } else {
        out_t[ray] = w.h.hit ? w.best : kBig;
        out_u[ray] = w.h.u;
        out_v[ray] = w.h.v;
        out_tri[ray] = w.h.tri;
        out_flag[ray] = w.h.backface;
      }
      ray = -1;
    }
    unsigned idle = __ballot_sync(kFullWarp, ray < 0);
    if (more && 32 - __popc(idle) < kRefillBelow) {
      do {
        const int want = __popc(idle);
        int base = 0;
        if (lane == 0) base = atomicAdd(next_ray, want);
        base = __shfl_sync(kFullWarp, base, 0);
        const int i = base + __popc(idle & ((1u << lane) - 1u));
        if (ray < 0 && i < n) {
          const Ray r = load_ray(o, d, tmin, tmax, i);
          if (r.tmin <= r.tmax) {
            start_walk(w, stack, r);
            ray = i;
          } else if (kAnyHit) {
            out_flag[i] = false;
          } else {
            out_t[i] = kBig;
            out_u[i] = 0.0f;
            out_v[i] = 0.0f;
            out_tri[i] = 0;
            out_flag[i] = false;
          }
        }
        more = base + want < n;
        idle = __ballot_sync(kFullWarp, ray < 0);
      } while (more && idle != 0u);
    }
    if (idle == kFullWarp) break;  // nothing in flight, so the queue is empty
    while (w.cur >= 0) {
      T::template node_step<kAnyHit>(tab, w, stack);
      if (__popc(__activemask()) < kLeaveLoopBelow) break;
    }
    __syncwarp();
    while (w.cur < 0 && w.cur != kDone) {
      T::template leaf_step<kAnyHit, kCull>(tab, w, stack);
      if (__popc(__activemask()) < kLeaveLoopBelow) break;
    }
    __syncwarp();
  }
}

// Launches traverse_kernel<T, kAnyHit, kCull> on stream s over n > 0 rays:
// as many blocks as the card holds at once, or as the rays need if fewer.
// next_ray is one zeroed int32 on the device.  Returns the first CUDA error
// of the set-up, else cudaGetLastError() right after the launch.
template <class T, bool kAnyHit, bool kCull>
int traverse_launch(const typename T::Table& tab, const float* o,
                    const float* d, const float* tmin, const float* tmax,
                    int n, int* next_ray, float* out_t, float* out_u,
                    float* out_v, int* out_tri, bool* out_flag,
                    cudaStream_t s) {
  auto kernel = traverse_kernel<T, kAnyHit, kCull>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = per_sm * sms;
  const int needed = (n + kBlock - 1) / kBlock;
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;  // a launch the card cannot hold fails below
  kernel<<<blocks, kBlock, 0, s>>>(tab, o, d, tmin, tmax, n, next_ray, out_t,
                                   out_u, out_v, out_tri, out_flag);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace vrt
