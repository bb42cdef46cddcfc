// Persistent packet traversal with work refill: closest-hit or any-hit
// over the 2-wide BVH, one 128-ray packet at a time per block.
//
// Replaces: vulkanraytracing_tpu/ops/traverse_subpacket.py:142 (_kernel,
// driven by _traverse_subpacket_packed).  That kernel keeps 8 packets of
// 128 consecutive rays resident, one per sublane row, each with its own
// cursor and SMEM stack, and refills a row from the chunk's ray pool the
// moment its packet retires.  Here a block of 128 threads serves one
// packet, a thread its lane, with the cursor, stack pointer and 64-entry
// stack in shared memory; a persistent grid of (resident blocks per SM) x
// (SMs) blocks loops, each taking its next packet from a global atomic
// counter, so a block never idles behind a slow packet.  Which block takes
// which packet changes between runs; packets are independent, so results
// do not.  The cursor may hold a leaf code.  Each step, as
// traverse_subpacket.py:256-316 and :386-452:
//   - interior: every lane runs the slab test of both children; a child's
//     packet distance is the minimum tn over the lanes where tn <= tf, and
//     it is hit when that minimum is below kBig; thread 0 moves the cursor
//     (packet_common.cuh::subpacket_next);
//   - leaf: every lane tests the leaf's own triangles in order, then the
//     packet pops; any-hit retires the packet once every lane has a hit or
//     is dead (t_min > best).
// Leaf tests and the window follow packet_common.cuh; the stack bound is
// proven there.
//
// What bounds it on this card: each step is a dependent chain of global
// loads shared by 128 lanes, followed by block-wide barriers; a packet
// visits the union of the nodes its lanes need, and the 4 warps of a
// block wait for each other at every step.  The persistent grid keeps the
// SMs full while packets finish at different times; the refill costs one
// atomic per packet.
#include <cuda_runtime.h>

#include "packet_common.cuh"

namespace {

using vrt::HitRecord;
using vrt::Ray;
namespace pk = vrt::packet;

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;

template <bool kAnyHit, bool kCull>
__global__ void __launch_bounds__(kLanes)
    subpacket_kernel(vrt::Table2 tab, const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n, int n_packets,
                     int* next_packet, float* out_t, float* out_u,
                     float* out_v, int* out_tri, bool* out_flag) {
  __shared__ int stack[vrt::kStackDepth];
  __shared__ int s_cur, s_sp, s_packet;
  __shared__ float scratch[2][32];
  __shared__ float s_min[2];

  for (;;) {
    if (threadIdx.x == 0) s_packet = atomicAdd(next_packet, 1);
    __syncthreads();
    const int p = s_packet;
    if (p >= n_packets) break;
    const long long i = static_cast<long long>(p) * kLanes + threadIdx.x;
    const Ray r = pk::load_lane(o, d, tmin, tmax, i, n);
    const float ix = vrt::safe_inv(r.dx), iy = vrt::safe_inv(r.dy),
                iz = vrt::safe_inv(r.dz);
    float best = pk::initial_best(r);
    HitRecord h{vrt::kBig, 0.0f, 0.0f, 0, false, false};

    const bool any_live = __syncthreads_or(r.tmin <= r.tmax);
    if (threadIdx.x == 0) {
      s_sp = 0;
      s_cur = any_live ? 0 : pk::kDone;
    }
    __syncthreads();
    for (;;) {
      const int cur = s_cur;
      if (cur == pk::kDone) break;
      if (cur >= 0) {
        const float* b = tab.nodes + 12 * static_cast<long long>(cur);
        const int c0 = tab.child[2 * static_cast<long long>(cur)];
        const int c1 = tab.child[2 * static_cast<long long>(cur) + 1];
        float tn0, tn1;
        float t0 = pk::slab(b, r, ix, iy, iz, best, tn0) ? tn0 : vrt::kBig;
        float t1 = pk::slab(b + 6, r, ix, iy, iz, best, tn1) ? tn1 : vrt::kBig;
        pk::block_min2<kWarps>(t0, t1, scratch, s_min);
        if (threadIdx.x == 0)
          s_cur = pk::subpacket_next<kAnyHit>(t0 < vrt::kBig, t1 < vrt::kBig,
                                              t0, t1, c0, c1, stack, s_sp);
      } else {
        pk::test_leaf<kCull>(tab, cur, r, true, best, h);
        // also orders every lane's read of s_cur before thread 0's write
        const bool all_done = __syncthreads_and(h.hit || r.tmin > best);
        if (threadIdx.x == 0)
          s_cur = kAnyHit && all_done ? pk::kDone : pk::pop(stack, s_sp);
      }
      __syncthreads();
    }
    if (i < n) {
      if (kAnyHit) {
        out_flag[i] = h.hit;
      } else {
        out_t[i] = h.hit ? best : vrt::kBig;
        out_u[i] = h.u;
        out_v[i] = h.v;
        out_tri[i] = h.tri;
        out_flag[i] = h.backface;
      }
    }
  }
}

template <bool kAnyHit, bool kCull>
int launch(const vrt::Table2& tab, const float* o, const float* d,
           const float* tmin, const float* tmax, int n, int* next_packet,
           float* out_t, float* out_u, float* out_v, int* out_tri,
           bool* out_flag, cudaStream_t s) {
  auto kernel = subpacket_kernel<kAnyHit, kCull>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLanes, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_packets = (n + kLanes - 1) / kLanes;
  int blocks = per_sm * sms;
  if (blocks > n_packets) blocks = n_packets;
  if (blocks < 1) blocks = 1;
  kernel<<<blocks, kLanes, 0, s>>>(tab, o, d, tmin, tmax, n, n_packets,
                                   next_packet, out_t, out_u, out_v, out_tri,
                                   out_flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes; each returns the first CUDA error
// of its set-up or cudaGetLastError() right after its launch on the
// caller's stream.  next_packet is one zeroed int32 on the device.
extern "C" int vrt_subpacket_closest(const float* nodes, const int* child,
                                     const float* tri, const int* tri_flags,
                                     const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     int n, int cull, int* next_packet,
                                     float* out_t, float* out_u, float* out_v,
                                     int* out_tri, bool* out_bf,
                                     void* stream) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  auto s = static_cast<cudaStream_t>(stream);
  return cull ? launch<false, true>(tab, o, d, tmin, tmax, n, next_packet,
                                    out_t, out_u, out_v, out_tri, out_bf, s)
              : launch<false, false>(tab, o, d, tmin, tmax, n, next_packet,
                                     out_t, out_u, out_v, out_tri, out_bf, s);
}

extern "C" int vrt_subpacket_any(const float* nodes, const int* child,
                                 const float* tri, const int* tri_flags,
                                 const float* o, const float* d,
                                 const float* tmin, const float* tmax, int n,
                                 int* next_packet, bool* out_hit,
                                 void* stream) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  return launch<true, false>(tab, o, d, tmin, tmax, n, next_packet, nullptr,
                             nullptr, nullptr, nullptr, out_hit,
                             static_cast<cudaStream_t>(stream));
}
