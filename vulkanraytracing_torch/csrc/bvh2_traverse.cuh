// BVH2 ray traversal: the node step and the leaf step of one ray's walk,
// closest-hit or any-hit.
//
// Replaces the Pallas kernel vulkanraytracing_tpu/ops/traverse_wide.py
// (_kernel, driven by _traverse_wide_packed) on an NVIDIA Hopper card.
// That kernel moves one cursor per 128-ray row through a unified
// node+triangle table in VMEM, in static waves of 64 rows, and tests all 8
// records of a fetched leaf row (pushing a continuation when a leaf spans
// two rows).  Here every ray walks alone with its own stack over the 2-wide
// BVH in global memory (ops/traverse_wide.py::Table2), driven by the
// persistent warps of traverse_common.cuh, and tests exactly the leaf's
// [start, start + count) triangles; the (t, id) rule of traverse_common.cuh
// makes the winner independent of visit order and of the TPU kernel's extra
// candidates.  The order of visits follows the TPU kernel: closest-hit
// descends the nearer hit child (child 0 on equal entry distances) and
// pushes the other; any-hit descends child 0 when it is hit, else child 1,
// pushes child 1 when both are hit, and returns at the first occluder.
// Triangle ids are record indices (the triangles are stored in BVH order),
// u, v and back face are committed here rather than recomputed for the
// winner afterwards.
//
// What bounds it on the card: the table fits the L2 cache and the 2-wide
// tree is about three times as deep as the 8-wide one, so a walk is a long
// chain of dependent gathers whose latency it waits on, and it pays for
// every instruction and every lane that idles in a diverged warp; on the
// incoherent rays of later bounces the walks of a launch ask the L2 for
// several TB/s of records.  What the design does about it: a node is one
// 64-byte aligned record (both boxes and both child ids) read as four
// 16-byte loads, a triangle three 16-byte loads with its flags in a pad of
// its record, the next one of a leaf loaded while this one is tested; the
// first kFastStack stack entries live in shared memory; persistent warps
// refill idle lanes from a queue of rays and keep node steps and leaf steps
// apart (traverse_common.cuh::traverse_kernel).  A ray's sequence of visits
// and tests is the one of the plain PyTorch version (ops/traverse_wide.py),
// so both agree bit for bit.
#pragma once

#include "traverse_common.cuh"

namespace vrt {

// The per-ray kernel's table: packed records.
struct Records2 {
  // (N, 16): c0.lo c0.hi c1.lo c1.hi, then the two child ids as int32 bits:
  // node id (>= 0) or leaf code (< 0); 2 pads.
  const float* node;
  // (T, 12): v0 xyz, e1 xyz, e2 xyz, the flags as int32 bits (bit0
  // cull-disable, bits 1-2 candidate), 2 pads.
  const float* tri;
};

// The packet kernels' table (packet_common.cuh): the BVH's own arrays.
struct Table2 {
  const float* nodes;    // (N, 12): c0.lo c0.hi c1.lo c1.hi
  const int* child;      // (N, 2): node id (>= 0) or leaf code (< 0)
  const float* tri;      // (T, 12): Records2::tri
  const int* tri_flags;  // (T,): bit0 cull-disable, bits 1-2 candidate
};

struct Bvh2 {
  using Table = Records2;
  static constexpr int kFastStack = 16;

  template <bool kAnyHit, class S>
  static VRT_HD void node_step(const Records2& tab, Walk& w, S& stack) {
    const float* rec = tab.node + 16 * static_cast<long long>(w.cur);
    const Vec4 q0 = load16(rec), q1 = load16(rec + 4), q2 = load16(rec + 8),
               q3 = load16(rec + 12);
    const float d0 = box_distance(q0.f[0], q0.f[1], q0.f[2], q0.f[3], q1.f[0],
                                  q1.f[1], w.r, w.ix, w.iy, w.iz, w.best);
    const float d1 = box_distance(q1.f[2], q1.f[3], q2.f[0], q2.f[1], q2.f[2],
                                  q2.f[3], w.r, w.ix, w.iy, w.iz, w.best);
    const int c0 = as_int(q3.f[0]), c1 = as_int(q3.f[1]);
    const bool h0 = d0 < kBig, h1 = d1 < kBig;
    if (h0 || h1) {
      const bool first0 = kAnyHit ? h0 : (h0 && h1 ? d0 <= d1 : h0);
      if (h0 && h1) stack.push(first0 ? c1 : c0);
      w.cur = first0 ? c0 : c1;
      return;
    }
    w.cur = stack.pop();
  }

  template <bool kAnyHit, bool kCull, class S>
  static VRT_HD void leaf_step(const Records2& tab, Walk& w, S& stack) {
    const int packed = ~w.cur;
    const int start = packed >> 4, count = packed & 15;
    // the next triangle's record is loaded while this one is tested
    const float* rec = tab.tri + 12 * static_cast<long long>(start);
    Vec4 na{}, nb{}, nc{};
    if (count > 0) {
      na = load16(rec);
      nb = load16(rec + 4);
      nc = load16(rec + 8);
    }
    for (int s = start; s < start + count; ++s) {
      const Vec4 a = na, b = nb, c = nc;
      if (s + 1 < start + count) {
        rec += 12;
        na = load16(rec);
        nb = load16(rec + 4);
        nc = load16(rec + 8);
      }
      const int flags = as_int(c.f[1]);
      if (!(flags & 6)) continue;
      if (test_triangle<kAnyHit, kCull>(a.f[0], a.f[1], a.f[2], a.f[3], b.f[0],
                                        b.f[1], b.f[2], b.f[3], c.f[0], flags,
                                        s, w.r, w.best, w.h)) {
        w.cur = kDone;
        return;
      }
    }
    w.cur = stack.pop();
  }
};

}  // namespace vrt
