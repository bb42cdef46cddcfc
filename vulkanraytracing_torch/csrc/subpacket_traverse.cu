// Persistent packet traversal with work refill: closest-hit or any-hit
// over the 2-wide BVH, one 128-ray packet at a time per warp.
//
// Replaces: vulkanraytracing_tpu/ops/traverse_subpacket.py:142 (_kernel,
// driven by _traverse_subpacket_packed).  That kernel keeps 8 packets of
// 128 consecutive rays resident, one per sublane row, each with its own
// cursor and SMEM stack, and refills a row from the chunk's ray pool the
// moment its packet retires.  Here ONE WARP serves a packet: a lane carries
// kRaysPerLane = 4 of its rays (rays lane + 32 j, so a warp's loads
// coalesce), the cursor and the stack pointer are registers that every lane
// holds alike, and the 64-entry stack is the warp's own row of shared
// memory.  Persistent warps loop, each taking its next packet from a global
// atomic counter, so none idles behind a slow packet.  Which warp takes
// which packet changes between runs; packets are independent, so results
// do not.  The cursor may hold a leaf code.  Each step, as
// traverse_subpacket.py:256-316 and :386-452:
//   - interior: every ray runs the slab test of both children; a child's
//     packet distance is the minimum tn over the rays where tn <= tf, and
//     it is hit when that minimum is below kBig; every lane moves the
//     cursor alike (packet_common.cuh::subpacket_decide);
//   - leaf: every ray tests the leaf's own triangles in order, then the
//     packet pops; any-hit retires the packet once every ray has a hit or
//     is dead (t_min > best).
// Leaf tests and the window follow packet_common.cuh; the stack bound is
// proven there.
//
// What bounds it on this card: a packet's walk is one chain of dependent
// steps over the union of the nodes its rays need, every step costs the
// slab or triangle tests of all 128 rays, and on incoherent rays that
// union is most of what the rays need one by one.  What the design does
// about it: no step has a block-wide barrier (a packet's minima are two
// redux instructions, its any-hit end one vote) and no lane decides for the
// others; a lane has 4 independent slab tests in flight; a node is one
// 64-byte record read as four 16-byte loads, a triangle three, the next
// triangle of a leaf loaded while this one is tested; a closest-hit leaf
// step reduces nothing.  With kRaysPerLane = 2 or 1 a packet is 2 or 4
// warps, which then share one barrier a step (Group::vote).
#include <cuda_runtime.h>

#include "packet_common.cuh"

namespace {

namespace pk = vrt::packet;

constexpr int kLanes = 128;
constexpr int kRays = pk::kRaysPerLane;
constexpr int kThreads = kLanes / kRays;  // the threads that serve a packet
constexpr int kWarps = kThreads / 32;
static_assert(kWarps >= 1 && kWarps * 32 * kRays == kLanes,
              "a 128-ray packet is 1, 2 or 4 whole warps");
// A block is one group of several warps, or 4 single-warp groups.
constexpr int kBlock = kWarps > 1 ? kThreads : 128;
constexpr int kGroups = kBlock / kThreads;
// Blocks per SM that the register budget must allow.
constexpr int kSubpacketBlocksPerSm = 4;

template <bool kAnyHit, bool kCull>
__global__ void __launch_bounds__(kBlock, kSubpacketBlocksPerSm)
    subpacket_kernel(pk::Table tab, const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax, int n, int n_packets,
                     int* next_packet, float* out_t, float* out_u,
                     float* out_v, int* out_tri, bool* out_flag) {
  __shared__ int stacks[kBlock / 32][vrt::kStackDepth];
  __shared__ pk::Vote slots[2][kWarps];
  __shared__ int s_packet;
  int* stack = stacks[threadIdx.x >> 5];
  pk::Group<kWarps> group{slots, &s_packet, 0u};
  const int member = threadIdx.x % kThreads;  // this thread within its group

  for (;;) {
    const int p = group.take(next_packet);
    if (p >= n_packets) break;
    const long long first = static_cast<long long>(p) * kLanes + member;
    pk::Lane lanes[kRays];
    bool live[kRays];  // a leaf step tests every ray, dead ones too
    bool mine = false;
    VRT_UNROLL
    for (int j = 0; j < kRays; ++j) {
      lanes[j] = pk::load_lane(o, d, tmin, tmax, first + kThreads * j, n);
      live[j] = true;
      mine = mine || lanes[j].r.tmin <= lanes[j].r.tmax;
    }
    int cur = group.any(mine) ? 0 : vrt::kDone;
    int sp = 0;
    while (cur != vrt::kDone) {
      if (cur >= 0) {
        const pk::Record rec = pk::load_node(tab, cur);
        const int c0 = pk::child0(rec), c1 = pk::child1(rec);
        float t0 = vrt::kBig, t1 = vrt::kBig;
        VRT_UNROLL
        for (int j = 0; j < kRays; ++j) {
          float tn0, tn1;
          if (pk::slab0(rec, lanes[j], tn0)) t0 = fminf(t0, tn0);
          if (pk::slab1(rec, lanes[j], tn1)) t1 = fminf(t1, tn1);
        }
        const pk::Vote v = group.vote(pk::thread_vote(t0, t1, 0u));
        cur = pk::subpacket_decide<kAnyHit>(v, c0, c1, stack, sp);
      } else {
        pk::test_leaf<kCull>(tab, cur, live, lanes);
        bool going = false;
        if (kAnyHit) {
          VRT_UNROLL
          for (int j = 0; j < kRays; ++j)
            going = going || !(lanes[j].h.hit || lanes[j].r.tmin > lanes[j].best);
        }
        cur = kAnyHit && !group.any_step(going) ? vrt::kDone : pk::pop(stack, sp);
      }
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
  auto kernel = subpacket_kernel<kAnyHit, kCull>;
  const int n_packets = (n + kLanes - 1) / kLanes;
  int blocks = 0;
  const cudaError_t err =
      pk::persistent_blocks(kernel, kBlock, kGroups, n_packets, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kBlock, 0, s>>>(tab, o, d, tmin, tmax, n, n_packets,
                                   next_packet, out_t, out_u, out_v, out_tri,
                                   out_flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes; each returns the first CUDA error
// of its set-up or cudaGetLastError() right after its launch on the
// caller's stream.  next_packet is one zeroed int32 on the device.
extern "C" int vrt_subpacket_closest(const float* node, const float* tri,
                                     const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     int n, int cull, int* next_packet,
                                     float* out_t, float* out_u, float* out_v,
                                     int* out_tri, bool* out_bf, void* stream) {
  const pk::Table tab{node, tri};
  auto s = static_cast<cudaStream_t>(stream);
  return cull ? launch<false, true>(tab, o, d, tmin, tmax, n, next_packet,
                                    out_t, out_u, out_v, out_tri, out_bf, s)
              : launch<false, false>(tab, o, d, tmin, tmax, n, next_packet,
                                     out_t, out_u, out_v, out_tri, out_bf, s);
}

extern "C" int vrt_subpacket_any(const float* node, const float* tri,
                                 const float* o, const float* d,
                                 const float* tmin, const float* tmax, int n,
                                 int* next_packet, bool* out_hit, void* stream) {
  const pk::Table tab{node, tri};
  return launch<true, false>(tab, o, d, tmin, tmax, n, next_packet, nullptr,
                             nullptr, nullptr, nullptr, out_hit,
                             static_cast<cudaStream_t>(stream));
}
