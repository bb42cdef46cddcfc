// Packet traversal with a block-shared cursor and stack: closest-hit or
// any-hit over the 2-wide BVH, one 1024-ray packet per block.
//
// Replaces: vulkanraytracing_tpu/ops/traverse_pallas.py:114 (_kernel, driven
// by _traverse_pallas_packed).  That kernel marches ONE cursor per packet
// of 1024 consecutive rays, an (8, 128) VPU tile, with its 64-entry stack
// in SMEM and the tree packed into 128-lane VMEM rows.  Here a block of
// 1024 threads is the packet, a thread its lane: the cursor, the stack
// pointer and the 64-entry stack live in shared memory, and the tree is
// Table2 (the BVH's own arrays in global memory).  Each step, as
// traverse_pallas.py:224-290:
//   1. every live lane (any-hit: not yet hit) runs the slab test of both
//      children of the cursor node;
//   2. a child is hit when any lane hits it (__syncthreads_or); its entry
//      distance is the minimum tn over the lanes that hit it (warp
//      shuffles, then the 32 warp minima in shared memory);
//   3. hit leaf children are tested at once, child 0's leaf first;
//   4. thread 0 moves the cursor: the nearer of two hit interior children
//      with the other pushed, the one hit interior child, else a pop
//      (packet_common.cuh::shared_next);
//   5. any-hit ends once every live lane has a hit (__syncthreads_and).
// The packet starts at the root only if some lane is live.  Leaf tests and
// the window follow packet_common.cuh; the stack bound is proven there.
//
// What bounds it on this card: every lane waits for the union of the nodes
// its 1023 neighbours need, four block-wide barriers per step serialize
// the 32 warps, and the node and triangle loads are dependent global
// reads.  1024 threads leave at most 64 registers each
// (__launch_bounds__(1024)); a launch refused for resources returns its
// error to the wrapper, which raises.  The design is the simple one: the
// schedule is the TPU kernel's; the subpacket kernel (128-ray packets,
// persistent blocks) and the per-ray kernels are the card's better fits.
#include <cuda_runtime.h>

#include "packet_common.cuh"

namespace {

using vrt::HitRecord;
using vrt::Ray;
namespace pk = vrt::packet;

constexpr int kLanes = 1024;
constexpr int kWarps = kLanes / 32;

template <bool kAnyHit, bool kCull>
__global__ void __launch_bounds__(kLanes)
    shared_kernel(vrt::Table2 tab, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int n, float* out_t,
                  float* out_u, float* out_v, int* out_tri, bool* out_flag) {
  __shared__ int stack[vrt::kStackDepth];
  __shared__ int s_cur, s_sp;
  __shared__ float scratch[2][32];
  __shared__ float s_min[2];

  const long long i = static_cast<long long>(blockIdx.x) * kLanes + threadIdx.x;
  const Ray r = pk::load_lane(o, d, tmin, tmax, i, n);
  const float ix = vrt::safe_inv(r.dx), iy = vrt::safe_inv(r.dy),
              iz = vrt::safe_inv(r.dz);
  const bool live0 = r.tmin <= r.tmax;
  float best = pk::initial_best(r);
  HitRecord h{vrt::kBig, 0.0f, 0.0f, 0, false, false};

  const bool any_live = __syncthreads_or(live0);
  if (threadIdx.x == 0) {
    s_sp = 0;
    s_cur = any_live ? 0 : pk::kDone;
  }
  __syncthreads();
  for (;;) {
    const int cur = s_cur;
    if (cur == pk::kDone) break;
    const bool live = kAnyHit ? live0 && !h.hit : live0;
    const float* b = tab.nodes + 12 * static_cast<long long>(cur);
    const int c0 = tab.child[2 * static_cast<long long>(cur)];
    const int c1 = tab.child[2 * static_cast<long long>(cur) + 1];
    float tn0 = vrt::kBig, tn1 = vrt::kBig;
    const bool l0 = live && pk::slab(b, r, ix, iy, iz, best, tn0);
    const bool l1 = live && pk::slab(b + 6, r, ix, iy, iz, best, tn1);
    const bool hit0 = __syncthreads_or(l0);
    const bool hit1 = __syncthreads_or(l1);
    float te0 = l0 ? tn0 : vrt::kBig, te1 = l1 ? tn1 : vrt::kBig;
    pk::block_min2<kWarps>(te0, te1, scratch, s_min);
    if (hit0 && c0 < 0) pk::test_leaf<kCull>(tab, c0, r, live, best, h);
    if (hit1 && c1 < 0) pk::test_leaf<kCull>(tab, c1, r, live, best, h);
    const bool all_done = __syncthreads_and(h.hit || !live0);
    if (threadIdx.x == 0) {
      const int next = pk::shared_next(hit0, hit1, te0, te1, c0, c1, stack, s_sp);
      s_cur = kAnyHit && all_done ? pk::kDone : next;
    }
    __syncthreads();
  }
  if (i >= n) return;
  if (kAnyHit) {
    out_flag[i] = h.hit;
    return;
  }
  out_t[i] = h.hit ? best : vrt::kBig;
  out_u[i] = h.u;
  out_v[i] = h.v;
  out_tri[i] = h.tri;
  out_flag[i] = h.backface;
}

template <bool kAnyHit, bool kCull>
int launch(const vrt::Table2& tab, const float* o, const float* d,
           const float* tmin, const float* tmax, int n, float* out_t,
           float* out_u, float* out_v, int* out_tri, bool* out_flag,
           cudaStream_t s) {
  const int blocks = (n + kLanes - 1) / kLanes;
  shared_kernel<kAnyHit, kCull><<<blocks, kLanes, 0, s>>>(
      tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri, out_flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes; each returns cudaGetLastError()
// right after its launch on the caller's stream.
extern "C" int vrt_shared_closest(const float* nodes, const int* child,
                                  const float* tri, const int* tri_flags,
                                  const float* o, const float* d,
                                  const float* tmin, const float* tmax, int n,
                                  int cull, float* out_t, float* out_u,
                                  float* out_v, int* out_tri, bool* out_bf,
                                  void* stream) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  auto s = static_cast<cudaStream_t>(stream);
  return cull ? launch<false, true>(tab, o, d, tmin, tmax, n, out_t, out_u,
                                    out_v, out_tri, out_bf, s)
              : launch<false, false>(tab, o, d, tmin, tmax, n, out_t, out_u,
                                     out_v, out_tri, out_bf, s);
}

extern "C" int vrt_shared_any(const float* nodes, const int* child,
                              const float* tri, const int* tri_flags,
                              const float* o, const float* d,
                              const float* tmin, const float* tmax, int n,
                              bool* out_hit, void* stream) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  return launch<true, false>(tab, o, d, tmin, tmax, n, nullptr, nullptr,
                             nullptr, nullptr, out_hit,
                             static_cast<cudaStream_t>(stream));
}
