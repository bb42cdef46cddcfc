// CPU twin of the subpacket kernel (subpacket_traverse.cu): the same
// per-ray code, votes and decisions (packet_common.cuh) compiled by g++,
// with host loops over the threads and warps that serve a packet, packets
// in order.  A thread carries the kernel's kRaysPerLane rays in the
// kernel's layout; each warp merges its threads' votes, the warps' votes
// are merged as every warp of the kernel merges them, and the packet's one
// cursor and stack move by the decision every warp takes alike.  Used only
// by the tests, which hold it against the plain PyTorch version.
#include <vector>

#include "packet_common.cuh"

namespace {

namespace pk = vrt::packet;

constexpr int kLanes = 128;
constexpr int kRays = pk::kRaysPerLane;
constexpr int kThreads = kLanes / kRays;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps >= 1 && kWarps * 32 * kRays == kLanes,
              "a 128-ray packet is 1, 2 or 4 whole warps");

struct Thread {
  pk::Lane lanes[kRays];
};

template <bool kAnyHit, bool kCull>
void run(const pk::Table& tab, const float* o, const float* d,
        const float* tmin, const float* tmax, int n, float* out_t,
        float* out_u, float* out_v, int* out_tri, bool* out_flag) {
  std::vector<Thread> th(kThreads);
  std::vector<pk::Vote> votes(kThreads);
  bool live[kRays];
  for (int j = 0; j < kRays; ++j) live[j] = true;
  for (long long base = 0; base < n; base += kLanes) {
    bool any_live = false;
    for (int t = 0; t < kThreads; ++t)
      for (int j = 0; j < kRays; ++j) {
        pk::Lane& l = th[t].lanes[j];
        l = pk::load_lane(o, d, tmin, tmax, base + t + kThreads * j, n);
        any_live = any_live || l.r.tmin <= l.r.tmax;
      }
    int stack[vrt::kStackDepth];
    int cur = any_live ? 0 : vrt::kDone, sp = 0;
    while (cur != vrt::kDone) {
      if (cur >= 0) {
        const pk::Record rec = pk::load_node(tab, cur);
        const int c0 = pk::child0(rec), c1 = pk::child1(rec);
        for (int t = 0; t < kThreads; ++t) {
          float t0 = vrt::kBig, t1 = vrt::kBig;
          for (int j = 0; j < kRays; ++j) {
            float tn0, tn1;
            if (pk::slab0(rec, th[t].lanes[j], tn0)) t0 = fminf(t0, tn0);
            if (pk::slab1(rec, th[t].lanes[j], tn1)) t1 = fminf(t1, tn1);
          }
          votes[t] = pk::thread_vote(t0, t1, 0u);
        }
        const pk::Vote v = pk::packet_vote<kWarps>(votes.data());
        cur = pk::subpacket_decide<kAnyHit>(v, c0, c1, stack, sp);
      } else {
        bool going = false;
        for (int t = 0; t < kThreads; ++t) {
          pk::test_leaf<kCull>(tab, cur, live, th[t].lanes);
          for (int j = 0; j < kRays; ++j) {
            const pk::Lane& l = th[t].lanes[j];
            going = going || !(l.h.hit || l.r.tmin > l.best);
          }
        }
        cur = kAnyHit && !going ? vrt::kDone : pk::pop(stack, sp);
      }
    }
    for (int t = 0; t < kThreads; ++t)
      for (int j = 0; j < kRays; ++j) {
        const long long i = base + t + kThreads * j;
        if (i < n)
          pk::store_lane<kAnyHit>(th[t].lanes[j], i, out_t, out_u, out_v, out_tri,
                                  out_flag);
      }
  }
}

}  // namespace

extern "C" void vrt_subpacket_closest_cpu(const float* node, const float* tri,
                                          const float* o, const float* d,
                                          const float* tmin, const float* tmax,
                                          int n, int cull, float* out_t,
                                          float* out_u, float* out_v,
                                          int* out_tri, bool* out_bf) {
  const pk::Table tab{node, tri};
  if (cull)
    run<false, true>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri, out_bf);
  else
    run<false, false>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri, out_bf);
}

extern "C" void vrt_subpacket_any_cpu(const float* node, const float* tri,
                                      const float* o, const float* d,
                                      const float* tmin, const float* tmax,
                                      int n, bool* out_hit) {
  const pk::Table tab{node, tri};
  run<true, false>(tab, o, d, tmin, tmax, n, nullptr, nullptr, nullptr, nullptr,
                   out_hit);
}

// One interior step's vote and decision on given per-ray entry distances
// (128 each, kBig where a ray misses the child), through the kernel's
// layout of rays over threads and warps: returns the next cursor and moves
// stack / *sp as the step does (vrt_subpacket_next_cpu's arguments).
extern "C" int vrt_subpacket_decide_cpu(int any_hit, const float* t0,
                                        const float* t1, int c0, int c1,
                                        int* stack, int* sp) {
  std::vector<pk::Vote> votes(kThreads);
  for (int t = 0; t < kThreads; ++t) {
    float a = vrt::kBig, b = vrt::kBig;
    for (int j = 0; j < kRays; ++j) {
      a = fminf(a, t0[t + kThreads * j]);
      b = fminf(b, t1[t + kThreads * j]);
    }
    votes[t] = pk::thread_vote(a, b, 0u);
  }
  const pk::Vote v = pk::packet_vote<kWarps>(votes.data());
  return any_hit ? pk::subpacket_decide<true>(v, c0, c1, stack, *sp)
                 : pk::subpacket_decide<false>(v, c0, c1, stack, *sp);
}

// subpacket_next itself on whole-packet minima and hit flags.
extern "C" int vrt_subpacket_next_cpu(int any_hit, int h0, int h1, float t0,
                                      float t1, int c0, int c1, int* stack,
                                      int* sp) {
  return any_hit ? pk::subpacket_next<true>(h0, h1, t0, t1, c0, c1, stack, *sp)
                 : pk::subpacket_next<false>(h0, h1, t0, t1, c0, c1, stack, *sp);
}
