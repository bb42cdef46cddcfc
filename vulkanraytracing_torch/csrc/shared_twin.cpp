// CPU twin of the shared-cursor packet kernel (shared_traverse.cu): the
// same per-ray code, votes and decisions (packet_common.cuh) compiled by
// g++, with host loops over the threads and warps of the block that serves
// a packet, packets in order.  A thread carries the kernel's
// kRaysPerThread rays in the kernel's layout; each warp merges its
// threads' votes, the warps' votes are merged as every warp of the kernel
// merges them, and the packet's one cursor and stack move by the decision
// every warp takes alike.  The any-hit end rides the next step's vote, as
// in the kernel.
// Used only by the tests, which hold it against the plain PyTorch version.
#include <vector>

#include "packet_common.cuh"

namespace {

namespace pk = vrt::packet;

constexpr int kLanes = 1024;
constexpr int kRays = pk::kRaysPerThread;
constexpr int kThreads = kLanes / kRays;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps >= 1 && kWarps * 32 * kRays == kLanes,
              "a 1024-ray packet is a block of whole warps");

struct Thread {
  pk::Lane lanes[kRays];
  bool live0[kRays], live[kRays];
};

template <bool kAnyHit, bool kCull>
void run(const pk::Table& tab, const float* o, const float* d,
        const float* tmin, const float* tmax, int n, float* out_t,
        float* out_u, float* out_v, int* out_tri, bool* out_flag) {
  std::vector<Thread> th(kThreads);
  std::vector<pk::Vote> votes(kThreads);
  for (long long base = 0; base < n; base += kLanes) {
    bool any_live = false;
    for (int t = 0; t < kThreads; ++t)
      for (int j = 0; j < kRays; ++j) {
        pk::Lane& l = th[t].lanes[j];
        l = pk::load_lane(o, d, tmin, tmax, base + t + kThreads * j, n);
        th[t].live0[j] = l.r.tmin <= l.r.tmax;
        any_live = any_live || th[t].live0[j];
      }
    int stack[vrt::kStackDepth];
    int cur = any_live ? 0 : vrt::kDone, sp = 0;
    while (cur != vrt::kDone) {
      const pk::Record rec = pk::load_node(tab, cur);
      const int c0 = pk::child0(rec), c1 = pk::child1(rec);
      for (int t = 0; t < kThreads; ++t) {
        float te0 = vrt::kBig, te1 = vrt::kBig;
        unsigned flags = 0u;
        for (int j = 0; j < kRays; ++j) {
          const pk::Lane& l = th[t].lanes[j];
          const bool live = kAnyHit ? th[t].live0[j] && !l.h.hit : th[t].live0[j];
          th[t].live[j] = live;
          float tn0, tn1;
          if (live && pk::slab0(rec, l, tn0)) {
            te0 = fminf(te0, tn0);
            flags |= pk::kHit0;
          }
          if (live && pk::slab1(rec, l, tn1)) {
            te1 = fminf(te1, tn1);
            flags |= pk::kHit1;
          }
          if (kAnyHit && live) flags |= pk::kNotDone;
        }
        votes[t] = pk::thread_vote(te0, te1, flags);
      }
      const pk::Vote v = pk::packet_vote<kWarps>(votes.data());
      if (kAnyHit && !(v.flags & pk::kNotDone)) break;
      const bool hit0 = v.flags & pk::kHit0, hit1 = v.flags & pk::kHit1;
      for (int t = 0; t < kThreads; ++t) {
        if (hit0 && c0 < 0) pk::test_leaf<kCull>(tab, c0, th[t].live, th[t].lanes);
        if (hit1 && c1 < 0) pk::test_leaf<kCull>(tab, c1, th[t].live, th[t].lanes);
      }
      cur = pk::shared_decide(v, c0, c1, stack, sp);
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

extern "C" void vrt_shared_closest_cpu(const float* node, const float* tri,
                                       const float* o, const float* d,
                                       const float* tmin, const float* tmax,
                                       int n, int cull, float* out_t,
                                       float* out_u, float* out_v, int* out_tri,
                                       bool* out_bf) {
  const pk::Table tab{node, tri};
  if (cull)
    run<false, true>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri, out_bf);
  else
    run<false, false>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri, out_bf);
}

extern "C" void vrt_shared_any_cpu(const float* node, const float* tri,
                                   const float* o, const float* d,
                                   const float* tmin, const float* tmax, int n,
                                   bool* out_hit) {
  const pk::Table tab{node, tri};
  run<true, false>(tab, o, d, tmin, tmax, n, nullptr, nullptr, nullptr, nullptr,
                   out_hit);
}

// One step's vote and decision on given per-ray values (1024 each): hit0 /
// hit1 say whether the ray hit the child's box, tn0 / tn1 its entry
// distance there.  Through the kernel's layout of rays over threads and
// warps: returns the next cursor and moves stack / *sp as the step does
// (vrt_shared_next_cpu's arguments).
extern "C" int vrt_shared_decide_cpu(const bool* hit0, const bool* hit1,
                                     const float* tn0, const float* tn1,
                                     int c0, int c1, int* stack, int* sp) {
  std::vector<pk::Vote> votes(kThreads);
  for (int t = 0; t < kThreads; ++t) {
    float a = vrt::kBig, b = vrt::kBig;
    unsigned flags = 0u;
    for (int j = 0; j < kRays; ++j) {
      const int i = t + kThreads * j;
      if (hit0[i]) {
        a = fminf(a, tn0[i]);
        flags |= pk::kHit0;
      }
      if (hit1[i]) {
        b = fminf(b, tn1[i]);
        flags |= pk::kHit1;
      }
    }
    votes[t] = pk::thread_vote(a, b, flags);
  }
  const pk::Vote v = pk::packet_vote<kWarps>(votes.data());
  return pk::shared_decide(v, c0, c1, stack, *sp);
}

// shared_next itself on whole-packet minima and hit flags.
extern "C" int vrt_shared_next_cpu(int hit0, int hit1, float te0, float te1,
                                   int c0, int c1, int* stack, int* sp) {
  return pk::shared_next(hit0, hit1, te0, te1, c0, c1, stack, *sp);
}
