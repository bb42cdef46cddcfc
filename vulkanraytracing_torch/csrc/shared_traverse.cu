// Packet traversal with one cursor and stack per 1024-ray packet:
// closest-hit or any-hit over the 2-wide BVH, a packet per block.
//
// Replaces: vulkanraytracing_tpu/ops/traverse_pallas.py:114 (_kernel, driven
// by _traverse_pallas_packed).  That kernel marches ONE cursor per packet
// of 1024 consecutive rays, an (8, 128) VPU tile, with its 64-entry stack
// in SMEM and the tree packed into 128-lane VMEM rows.  Here a block of
// 1024 / kRaysPerThread = 256 threads is the packet: a thread carries 4 of
// its rays (rays thread + 256 j, so a warp's loads coalesce), the cursor
// and the stack pointer are registers that every thread holds alike, and
// each of the 8 warps keeps its own copy of the 64-entry stack in shared
// memory, written alike by all.  Persistent blocks loop, each taking its
// next packet from a global atomic counter.  Each step, as
// traverse_pallas.py:224-290:
//   1. every live ray (any-hit: not yet hit) runs the slab test of both
//      children of the cursor node;
//   2. a child is hit when any ray hits it; its entry distance is the
//      minimum tn over the rays that hit it: one vote of the packet
//      (packet_common.cuh::Group::vote: redux in a warp, a slot per warp in
//      shared memory, ONE barrier, every thread merges the 8 slots);
//   3. hit leaf children are tested at once, child 0's leaf first;
//   4. every thread moves the cursor alike: the nearer of two hit interior
//      children with the other pushed, the one hit interior child, else a
//      pop (packet_common.cuh::shared_decide);
//   5. any-hit ends once every live ray has a hit.  That flag rides the
//      next step's vote: a finished packet runs one more round of slab
//      tests, which change no result, and stops before that step's leaf
//      tests; so an any-hit step has one barrier too.
// The packet starts at the root only if some ray is live.  Leaf tests and
// the window follow packet_common.cuh; the stack bound is proven there.
//
// What bounds it on this card: every ray waits for the union of the nodes
// its 1023 neighbours need, a step cannot start before the last warp's
// vote, and a packet's state (16 registers a ray) lets two packets live on
// an SM.  What the design does about it: one barrier a step over 8 warps
// (not 6 over 32), no thread that decides for the others, 4 independent
// slab tests a thread, nodes and triangles as 16-byte loads of packed
// records, the next triangle of a leaf loaded while this one is tested.
// The subpacket kernel (128-ray packets) and the per-ray kernels
// remain the card's better fits: a packet this wide visits many nodes that
// few of its rays need.
#include <cuda_runtime.h>

#include "packet_common.cuh"

namespace {

namespace pk = vrt::packet;

constexpr int kLanes = 1024;
constexpr int kRays = pk::kRaysPerThread;
constexpr int kThreads = kLanes / kRays;  // the block that serves a packet
constexpr int kWarps = kThreads / 32;
static_assert(kWarps >= 1 && kWarps * 32 * kRays == kLanes,
              "a 1024-ray packet is a block of whole warps");
// Blocks per SM that the register budget must allow.
constexpr int kSharedBlocksPerSm = 2;

template <bool kAnyHit, bool kCull>
__global__ void __launch_bounds__(kThreads, kSharedBlocksPerSm)
    shared_kernel(pk::Table tab, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int n, int n_packets,
                  int* next_packet, float* out_t, float* out_u, float* out_v,
                  int* out_tri, bool* out_flag) {
  __shared__ int stacks[kWarps][vrt::kStackDepth];
  __shared__ pk::Vote slots[2][kWarps];
  __shared__ int s_packet;
  int* stack = stacks[threadIdx.x >> 5];
  pk::Group<kWarps> group{slots, &s_packet, 0u};

  for (;;) {
    const int p = group.take(next_packet);
    if (p >= n_packets) break;
    const long long first = static_cast<long long>(p) * kLanes + threadIdx.x;
    pk::Lane lanes[kRays];
    bool live0[kRays];
    bool mine = false;
    VRT_UNROLL
    for (int j = 0; j < kRays; ++j) {
      lanes[j] = pk::load_lane(o, d, tmin, tmax, first + kThreads * j, n);
      live0[j] = lanes[j].r.tmin <= lanes[j].r.tmax;
      mine = mine || live0[j];
    }
    int cur = group.any(mine) ? 0 : vrt::kDone;
    int sp = 0;
    while (cur != vrt::kDone) {
      const pk::Record rec = pk::load_node(tab, cur);
      const int c0 = pk::child0(rec), c1 = pk::child1(rec);
      bool live[kRays];
      float te0 = vrt::kBig, te1 = vrt::kBig;
      unsigned flags = 0u;
      VRT_UNROLL
      for (int j = 0; j < kRays; ++j) {
        live[j] = kAnyHit ? live0[j] && !lanes[j].h.hit : live0[j];
        float tn0, tn1;
        if (live[j] && pk::slab0(rec, lanes[j], tn0)) {
          te0 = fminf(te0, tn0);
          flags |= pk::kHit0;
        }
        if (live[j] && pk::slab1(rec, lanes[j], tn1)) {
          te1 = fminf(te1, tn1);
          flags |= pk::kHit1;
        }
        // as the leaf tests of the step before left it
        if (kAnyHit && live[j]) flags |= pk::kNotDone;
      }
      const pk::Vote v = group.vote(pk::thread_vote(te0, te1, flags));
      if (kAnyHit && !(v.flags & pk::kNotDone)) break;
      const bool hit0 = v.flags & pk::kHit0, hit1 = v.flags & pk::kHit1;
      if (hit0 && c0 < 0) pk::test_leaf<kCull>(tab, c0, live, lanes);
      if (hit1 && c1 < 0) pk::test_leaf<kCull>(tab, c1, live, lanes);
      cur = pk::shared_decide(v, c0, c1, stack, sp);
    }
    VRT_UNROLL
    for (int j = 0; j < kRays; ++j) {
      const long long i = first + kThreads * j;
      if (i < n)
        pk::store_lane<kAnyHit>(lanes[j], i, out_t, out_u, out_v, out_tri, out_flag);
    }
  }
}

template <bool kAnyHit, bool kCull>
int launch(const pk::Table& tab, const float* o, const float* d,
           const float* tmin, const float* tmax, int n, int* next_packet,
           float* out_t, float* out_u, float* out_v, int* out_tri,
           bool* out_flag, cudaStream_t s) {
  auto kernel = shared_kernel<kAnyHit, kCull>;
  const int n_packets = (n + kLanes - 1) / kLanes;
  int blocks = 0;
  const cudaError_t err =
      pk::persistent_blocks(kernel, kThreads, 1, n_packets, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, 0, s>>>(tab, o, d, tmin, tmax, n, n_packets,
                                     next_packet, out_t, out_u, out_v, out_tri,
                                     out_flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes; each returns the first CUDA error
// of its set-up or cudaGetLastError() right after its launch on the
// caller's stream.  next_packet is one zeroed int32 on the device.
extern "C" int vrt_shared_closest(const float* node, const float* tri,
                                  const float* o, const float* d,
                                  const float* tmin, const float* tmax, int n,
                                  int cull, int* next_packet, float* out_t,
                                  float* out_u, float* out_v, int* out_tri,
                                  bool* out_bf, void* stream) {
  const pk::Table tab{node, tri};
  auto s = static_cast<cudaStream_t>(stream);
  return cull ? launch<false, true>(tab, o, d, tmin, tmax, n, next_packet,
                                    out_t, out_u, out_v, out_tri, out_bf, s)
              : launch<false, false>(tab, o, d, tmin, tmax, n, next_packet,
                                     out_t, out_u, out_v, out_tri, out_bf, s);
}

extern "C" int vrt_shared_any(const float* node, const float* tri,
                              const float* o, const float* d,
                              const float* tmin, const float* tmax, int n,
                              int* next_packet, bool* out_hit, void* stream) {
  const pk::Table tab{node, tri};
  return launch<true, false>(tab, o, d, tmin, tmax, n, next_packet, nullptr,
                             nullptr, nullptr, nullptr, out_hit,
                             static_cast<cudaStream_t>(stream));
}
