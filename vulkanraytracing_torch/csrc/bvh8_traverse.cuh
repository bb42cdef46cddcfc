// BVH8 ray traversal: the node step and the leaf step of one ray's walk,
// closest-hit or any-hit.
//
// Replaces the Pallas kernel vulkanraytracing_tpu/ops/traverse_wide8.py
// (_kernel, driven by _traverse_wide8_packed) on an NVIDIA Hopper card.
// That kernel marches 128-ray rows through VMEM with a shared cursor per
// row; here every ray walks alone with its own stack, over a table in
// global memory (built by ops/traverse_wide8.py::build_table8), driven by
// the persistent warps of traverse_common.cuh.  The Hit contract it keeps
// is in traverse_common.cuh; the order of visits: closest-hit descends the
// nearest child first (a stable sort of the child entry distances); any-hit
// descends the nearest hit child and returns at the first occluder.
//
// What bounds it on the card: the table fits the L2 cache and the slab and
// triangle arithmetic is a small share of the fp32 peak, so a walk waits on
// the latency of dependent gathers (a node's record, then its child's) and
// pays for every instruction and every lane that idles in a diverged warp; on the
// incoherent rays of later bounces the walks of a launch ask the L2 for
// several TB/s of records.
// What the design does about it:
//   - a node is one 256-byte aligned record read as 14 16-byte loads that
//     all start before the first slab test, and a triangle is three
//     16-byte loads with its flags and id in the pads of its record;
//   - the children are sorted by a fixed compare-exchange network on
//     (distance, child) pairs in registers, and the any-hit arg-min is
//     unrolled, so no per-visit array is indexed at run time;
//   - the first kFastStack stack entries live in shared memory, the rest
//     in local memory;
//   - persistent warps refill idle lanes from a queue of rays and keep node
//     steps and leaf steps apart (traverse_common.cuh::traverse_kernel).
// A ray's sequence of visits and tests is the one of the plain PyTorch
// version (ops/traverse_wide8.py), so both agree bit for bit.
#pragma once

#include "traverse_common.cuh"

namespace vrt {

struct Table8 {
  // (M, 64): a node's record.  Children 0-3 at [0, 24) and 4-7 at [24, 48),
  // each half as lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4] hi.z[4]; the 8
  // child ids at [48, 56) as int32 bits: node id (> 0), leaf code (< 0),
  // 0 = empty; 8 pads.
  const float* node;
  // (T8, 12): v0 xyz, flags; e1 xyz, BVH-order triangle id; e2 xyz, pad
  // (flags and id as int32 bits).
  const float* tri;
};

// Orders (da, ca) before (db, cb) unless da > db.  Applied to neighbours
// only, equal distances never pass each other.
VRT_HD void compare_exchange(float& da, int& ca, float& db, int& cb) {
  const bool swap = da > db;
  const float lo = fminf(da, db), hi = fmaxf(da, db);
  const int c = swap ? cb : ca;
  cb = swap ? ca : cb;
  ca = c;
  da = lo;
  db = hi;
}

// Stable ascending sort of 8 (distance, child) pairs: odd-even
// transposition, 8 rounds of neighbour exchanges.  The order is that of a
// stable sort by distance, ties by lower slot.
VRT_HD void sort8(float (&dist)[8], int (&kid)[8]) {
  VRT_UNROLL
  for (int round = 0; round < 8; ++round) {
    VRT_UNROLL
    for (int i = round & 1; i + 1 < 8; i += 2)
      compare_exchange(dist[i], kid[i], dist[i + 1], kid[i + 1]);
  }
}

struct Bvh8 {
  using Table = Table8;
  static constexpr int kFastStack = 16;

  template <bool kAnyHit, class S>
  static VRT_HD void node_step(const Table8& tab, Walk& w, S& stack) {
    const float* rec = tab.node + 64 * static_cast<long long>(w.cur);
    Vec4 q[14];
    VRT_UNROLL
    for (int k = 0; k < 14; ++k) q[k] = load16(rec + 4 * k);
    float dist[8];
    int kid[8];
    VRT_UNROLL
    for (int k = 0; k < 8; ++k) {
      const Vec4* b = q + 6 * (k >> 2);
      const int j = k & 3;
      dist[k] = box_distance(b[0].f[j], b[1].f[j], b[2].f[j], b[3].f[j],
                             b[4].f[j], b[5].f[j], w.r, w.ix, w.iy, w.iz,
                             w.best);
      kid[k] = as_int(q[12 + (k >> 2)].f[j]);
    }
    if (kAnyHit) {
      // the nearest hit child (the lowest slot among equals), the other
      // hit children pushed in slot order
      int near = -1, first = 0;
      float dn = kBig;
      VRT_UNROLL
      for (int k = 0; k < 8; ++k)
        if (dist[k] < dn) {
          dn = dist[k];
          near = k;
          first = kid[k];
        }
      if (near >= 0) {
        VRT_UNROLL
        for (int k = 0; k < 8; ++k)
          if (k != near && dist[k] < kBig) stack.push(kid[k]);
        w.cur = first;
        return;
      }
    } else {
      // hit children nearest first (missed ones have distance kBig and
      // sort last): descend the first, push the others farthest first
      int n = 0;
      VRT_UNROLL
      for (int k = 0; k < 8; ++k) n += dist[k] < kBig ? 1 : 0;
      if (n == 1) {  // the common visit: nothing to sort or push
        int only = 0;
        VRT_UNROLL
        for (int k = 0; k < 8; ++k) only = dist[k] < kBig ? kid[k] : only;
        w.cur = only;
        return;
      }
      if (n > 0) {
        sort8(dist, kid);
        VRT_UNROLL
        for (int j = 7; j >= 1; --j)
          if (j < n) stack.push(kid[j]);
        w.cur = kid[0];
        return;
      }
    }
    w.cur = stack.pop();
  }

  template <bool kAnyHit, bool kCull, class S>
  static VRT_HD void leaf_step(const Table8& tab, Walk& w, S& stack) {
    const int packed = ~w.cur;
    const int start = packed >> 4, count = packed & 15;
    for (int s = start; s < start + count; ++s) {
      const float* rec = tab.tri + 12 * static_cast<long long>(s);
      const Vec4 a = load16(rec), b = load16(rec + 4), c = load16(rec + 8);
      const int flags = as_int(a.f[3]);
      if (!(flags & 6)) continue;
      if (test_triangle<kAnyHit, kCull>(a.f[0], a.f[1], a.f[2], b.f[0], b.f[1],
                                        b.f[2], c.f[0], c.f[1], c.f[2], flags,
                                        as_int(b.f[3]), w.r, w.best, w.h)) {
        w.cur = kDone;
        return;
      }
    }
    w.cur = stack.pop();
  }
};

}  // namespace vrt
