// What the two packet traversals share: the shared-cursor kernel
// (shared_traverse.cu, one cursor per 1024-ray packet) and the subpacket
// kernel (subpacket_traverse.cu, one cursor per 128-ray packet).  Both walk
// the packed records of the 2-wide BVH (ops/traverse_wide.py::Table2, the
// per-ray BVH2 kernel's table) with ONE cursor and ONE stack per packet.
//
// A packet is served by a group of kWarps warps; a thread carries several
// of the packet's rays (Lane), strided so that a warp's loads coalesce.
// Here are:
//   - the per-ray arithmetic: the slab test of one child box and the leaf
//     test, over records read as 16-byte loads (a node 4, a triangle 3);
//   - the vote: what a thread knows of a step (two entry distances as
//     order-preserving integer keys, a few flag bits) reduced over its warp
//     by redux instructions, and over the group's warps through slots of
//     shared memory with ONE barrier (Group::vote);
//   - the decision (next cursor, push, pop), taken from the packet-wide
//     vote by every thread alike: each warp keeps its own copy of the stack
//     and every copy gets the same writes, so no thread waits for another
//     to decide.
// The CPU twins run the same functions in host loops over threads and
// warps, with one cursor and stack per packet.
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

#include "traverse_common.cuh"

namespace vrt {
namespace packet {

// Rays a thread carries: of a 128-ray packet in the subpacket kernel (1, 2
// or 4: a packet is 4, 2 or 1 warps), of a 1024-ray packet in the
// shared-cursor kernel (1, 2, 4 or 8: 32 to 4 warps).
constexpr int kRaysPerLane = 4;
constexpr int kRaysPerThread = 4;

// The packed records (ops/traverse_wide.py::Table2).
struct Table {
  // (n_nodes, 16): c0.lo c0.hi c1.lo c1.hi, then the two child ids as int32
  // bits: node id (>= 0) or leaf code (< 0); 2 pads.
  const float* node;
  // (n_tris, 12): v0 xyz, e1 xyz, e2 xyz, the flags as int32 bits (bit0
  // cull-disable, bits 1-2 candidate), 2 pads.
  const float* tri;
};

// A node's record.
struct Record {
  Vec4 q[4];
};

VRT_HD Record load_node(const Table& tab, int id) {
  const float* p = tab.node + 16 * static_cast<long long>(id);
  return Record{{load16(p), load16(p + 4), load16(p + 8), load16(p + 12)}};
}

VRT_HD int child0(const Record& node) { return as_int(node.q[3].f[0]); }
VRT_HD int child1(const Record& node) { return as_int(node.q[3].f[1]); }

VRT_HD void load_triangle(const Table& tab, int s, Vec4& a, Vec4& b, Vec4& c) {
  const float* p = tab.tri + 12 * static_cast<long long>(s);
  a = load16(p);
  b = load16(p + 4);
  c = load16(p + 8);
}

// Slab test of a child box: sets the entry distance tn and returns
// tn <= tf, tf capped by the ray's best t.
VRT_HD bool slab(float lox, float loy, float loz, float hix, float hiy,
                 float hiz, const Ray& r, float ix, float iy, float iz,
                 float best, float& tn) {
  const float ax = (lox - r.ox) * ix, bx = (hix - r.ox) * ix;
  const float ay = (loy - r.oy) * iy, by = (hiy - r.oy) * iy;
  const float az = (loz - r.oz) * iz, bz = (hiz - r.oz) * iz;
  tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fmaxf(fminf(az, bz), r.tmin));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                         fminf(fmaxf(az, bz), best));
  return tn <= tf;
}

// One ray of a packet in flight.
struct Lane {
  Ray r;
  float ix, iy, iz, best;
  HitRecord h;
};

// Slab tests of child 0 and child 1 of a node's record for one ray.
VRT_HD bool slab0(const Record& n, const Lane& l, float& tn) {
  return slab(n.q[0].f[0], n.q[0].f[1], n.q[0].f[2], n.q[0].f[3], n.q[1].f[0],
              n.q[1].f[1], l.r, l.ix, l.iy, l.iz, l.best, tn);
}
VRT_HD bool slab1(const Record& n, const Lane& l, float& tn) {
  return slab(n.q[1].f[2], n.q[1].f[3], n.q[2].f[0], n.q[2].f[1], n.q[2].f[2],
              n.q[2].f[3], l.r, l.ix, l.iy, l.iz, l.best, tn);
}

// Ray i of n as a Lane; rays past the last are dead (t_min 1 > t_max 0),
// as the TPU kernels pad them.  best starts at t_max, or kBig past it.
VRT_HD Lane load_lane(const float* o, const float* d, const float* tmin,
                      const float* tmax, long long i, int n) {
  const Ray r = i < n ? Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                            d[3 * i + 1], d[3 * i + 2], tmin[i], tmax[i]}
                      : Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  return Lane{r, safe_inv(r.dx), safe_inv(r.dy), safe_inv(r.dz),
              r.tmax < kBig ? r.tmax : kBig,
              HitRecord{kBig, 0.0f, 0.0f, 0, false, false}};
}

// Writes ray i's result: the verdict of an any-hit query, else the Hit.
template <bool kAnyHit>
VRT_HD void store_lane(const Lane& l, long long i, float* out_t, float* out_u,
                       float* out_v, int* out_tri, bool* out_flag) {
  if (kAnyHit) {
    out_flag[i] = l.h.hit;
    return;
  }
  out_t[i] = l.h.hit ? l.best : kBig;
  out_u[i] = l.h.u;
  out_v[i] = l.h.v;
  out_tri[i] = l.h.tri;
  out_flag[i] = l.h.backface;
}

// Tests triangle s (record a, b, c) for one ray and commits a valid hit of
// a live ray (each must be nearer than the one before).
template <bool kCull>
VRT_HD void test_triangle(const Vec4& a, const Vec4& b, const Vec4& c, int s,
                          bool live, Lane& l) {
  const Ray& r = l.r;
  const int flags = as_int(c.f[1]);
  const float v0x = a.f[0], v0y = a.f[1], v0z = a.f[2];
  const float e1x = a.f[3], e1y = b.f[0], e1z = b.f[1];
  const float e2x = b.f[2], e2y = b.f[3], e2z = c.f[0];
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
               mv >= 0.0f && mu + mv <= 1.0f && mt >= r.tmin && mt < l.best;
  if (kCull) valid = valid && (det > kTiny || (flags & 1));
  if (valid) {
    l.best = mt;
    l.h.hit = true;
    l.h.tri = s;
    l.h.u = mu;
    l.h.v = mv;
    l.h.backface = det < 0.0f;
  }
}

// Tests the leaf `code`'s triangles in order for a thread's kRays rays;
// live[j] gates ray j's commits.  The next triangle's record is loaded
// while this one is tested.
template <bool kCull, int kRays>
VRT_HD void test_leaf(const Table& tab, int code, const bool (&live)[kRays],
                      Lane (&lanes)[kRays]) {
  const int packed = ~code;
  const int start = packed >> 4, count = packed & 15;
  if (count == 0) return;
  Vec4 na, nb, nc;
  load_triangle(tab, start, na, nb, nc);
  for (int s = start; s < start + count; ++s) {
    const Vec4 a = na, b = nb, c = nc;
    if (s + 1 < start + count) load_triangle(tab, s + 1, na, nb, nc);
    VRT_UNROLL
    for (int j = 0; j < kRays; ++j)
      test_triangle<kCull>(a, b, c, s, live[j], lanes[j]);
  }
}

// --- the vote ---------------------------------------------------------

VRT_HD unsigned float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
#endif
}

VRT_HD float bits_float(unsigned u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// An unsigned key that orders as the float does (-0 just below +0), so an
// integer minimum over keys finds the float minimum.  The values reduced
// are entry distances or kBig, never NaN (slab() is false for a NaN), and
// the minima feed only `<= ` and `< kBig`, which take -0 and +0 alike: the
// decisions are those of fminf in any order.
VRT_HD unsigned min_key(float x) {
  const unsigned u = float_bits(x);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

VRT_HD float key_value(unsigned k) {
  return bits_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// What a thread, a warp or the packet knows of one step: the keys of two
// minima and flag bits that are true when true anywhere.
struct alignas(16) Vote {
  unsigned k0, k1, flags, pad;
};
constexpr unsigned kHit0 = 1u;     // some live ray hit child 0's box
constexpr unsigned kHit1 = 2u;     // ... child 1's box
constexpr unsigned kNotDone = 4u;  // some ray of an any-hit query goes on

VRT_HD Vote thread_vote(float t0, float t1, unsigned flags) {
  return Vote{min_key(t0), min_key(t1), flags, 0u};
}

VRT_HD void merge(Vote& into, const Vote& v) {
  into.k0 = v.k0 < into.k0 ? v.k0 : into.k0;
  into.k1 = v.k1 < into.k1 ? v.k1 : into.k1;
  into.flags |= v.flags;
}

// --- the decision -------------------------------------------------------

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

// The decisions from a packet-wide vote, as every thread takes them.
template <bool kAnyHit>
VRT_HD int subpacket_decide(const Vote& v, int c0, int c1, int* stack, int& sp) {
  const float t0 = key_value(v.k0), t1 = key_value(v.k1);
  return subpacket_next<kAnyHit>(t0 < kBig, t1 < kBig, t0, t1, c0, c1, stack, sp);
}

VRT_HD int shared_decide(const Vote& v, int c0, int c1, int* stack, int& sp) {
  return shared_next(v.flags & kHit0, v.flags & kHit1, key_value(v.k0),
                     key_value(v.k1), c0, c1, stack, sp);
}

#ifdef __CUDACC__

// The kWarps warps that serve one packet: a single warp (any number of
// them in a block, none ever waiting for another), or a whole block.
// Every warp of the group makes the same calls in the same order.
template <int kWarps>
struct Group {
  Vote (*slots)[kWarps];  // [2][kWarps] in shared memory, by step parity
  int* packet;            // one int in shared memory
  unsigned steps;

  // The next packet of the queue, the same in every thread of the group.
  __device__ __forceinline__ int take(int* queue) {
    steps = 0;
    if (kWarps == 1) {
      int p = 0;
      if ((threadIdx.x & 31) == 0) p = atomicAdd(queue, 1);
      return __shfl_sync(kFullWarp, p, 0);
    }
    // the group's last read of *packet lies before a barrier it has passed
    if (threadIdx.x == 0) *packet = atomicAdd(queue, 1);
    __syncthreads();
    return *packet;
  }

  // True where x is true in any thread of the group (once a packet).
  __device__ __forceinline__ bool any(bool x) {
    if (kWarps == 1) return __any_sync(kFullWarp, x);
    return __syncthreads_or(x);
  }

  // The packet-wide vote of a step from each thread's own: redux over the
  // warp; across warps, lane 0 of each writes its warp's vote into this
  // step's slot, ONE barrier follows, and every thread merges all slots.
  // The slots alternate with the step's parity: a warp can write step s +
  // 1 while another still reads step s, and none can reach step s + 2
  // before all have left step s + 1's barrier.
  __device__ __forceinline__ Vote vote(Vote v) {
    v.k0 = __reduce_min_sync(kFullWarp, v.k0);
    v.k1 = __reduce_min_sync(kFullWarp, v.k1);
    v.flags = __reduce_or_sync(kFullWarp, v.flags);
    if (kWarps == 1) return v;
    Vote* row = slots[steps++ & 1u];
    if ((threadIdx.x & 31) == 0) row[threadIdx.x >> 5] = v;
    __syncthreads();
    v = row[0];
    VRT_UNROLL
    for (int w = 1; w < kWarps; ++w) merge(v, row[w]);
    return v;
  }

  // A step's vote on one flag alone: true where x is true in any thread.
  __device__ __forceinline__ bool any_step(bool x) {
    if (kWarps == 1) return __any_sync(kFullWarp, x);
    return vote(Vote{~0u, ~0u, x ? kNotDone : 0u, 0u}).flags & kNotDone;
  }
};

// Blocks of `threads` for a persistent grid over n_packets packets: as
// many as the card holds at once, each serving `per_block` packets at a
// time, or as the packets need if fewer.  Returns the first CUDA error.
template <class K>
cudaError_t persistent_blocks(K kernel, int threads, int per_block,
                              int n_packets, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  blocks = per_sm * sms;
  const int needed = (n_packets + per_block - 1) / per_block;
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;  // a launch the card cannot hold fails at launch
  return err;
}

#else  // the CPU twins' stand-in for a Group

// The packet-wide vote from the votes of its 32 * kWarps threads: each
// warp's merge of its threads' votes, then the merge of the warps' slots,
// as Group::vote makes it.
template <int kWarps>
Vote packet_vote(const Vote* threads) {
  Vote slots[kWarps];
  for (int w = 0; w < kWarps; ++w) {
    slots[w] = threads[32 * w];
    for (int t = 1; t < 32; ++t) merge(slots[w], threads[32 * w + t]);
  }
  Vote v = slots[0];
  for (int w = 1; w < kWarps; ++w) merge(v, slots[w]);
  return v;
}

#endif  // __CUDACC__

}  // namespace packet
}  // namespace vrt
