// CPU twin of the subpacket kernel (subpacket_traverse.cu): the same
// per-lane code and packet decisions (packet_common.cuh) compiled by g++,
// with host loops over the 128 lanes of each packet, packets in order.
// Used only by the tests, which hold it against the plain PyTorch version.
#include <vector>

#include "packet_common.cuh"

namespace {

using vrt::HitRecord;
using vrt::Ray;
namespace pk = vrt::packet;

constexpr int kLanes = 128;

template <bool kAnyHit, bool kCull>
void run(const vrt::Table2& tab, const float* o, const float* d,
         const float* tmin, const float* tmax, int n, float* out_t,
         float* out_u, float* out_v, int* out_tri, bool* out_flag) {
  std::vector<Ray> r(kLanes);
  std::vector<float> ix(kLanes), iy(kLanes), iz(kLanes), best(kLanes);
  std::vector<HitRecord> h(kLanes);
  int stack[vrt::kStackDepth];
  for (long long base = 0; base < n; base += kLanes) {
    bool any_live = false;
    for (int k = 0; k < kLanes; ++k) {
      r[k] = pk::load_lane(o, d, tmin, tmax, base + k, n);
      ix[k] = vrt::safe_inv(r[k].dx);
      iy[k] = vrt::safe_inv(r[k].dy);
      iz[k] = vrt::safe_inv(r[k].dz);
      best[k] = pk::initial_best(r[k]);
      h[k] = HitRecord{vrt::kBig, 0.0f, 0.0f, 0, false, false};
      any_live = any_live || r[k].tmin <= r[k].tmax;
    }
    int sp = 0;
    int cur = any_live ? 0 : pk::kDone;
    while (cur != pk::kDone) {
      if (cur >= 0) {
        const float* b = tab.nodes + 12 * static_cast<long long>(cur);
        const int c0 = tab.child[2 * static_cast<long long>(cur)];
        const int c1 = tab.child[2 * static_cast<long long>(cur) + 1];
        float t0 = vrt::kBig, t1 = vrt::kBig;
        for (int k = 0; k < kLanes; ++k) {
          float tn0, tn1;
          if (pk::slab(b, r[k], ix[k], iy[k], iz[k], best[k], tn0)) t0 = fminf(t0, tn0);
          if (pk::slab(b + 6, r[k], ix[k], iy[k], iz[k], best[k], tn1)) t1 = fminf(t1, tn1);
        }
        cur = pk::subpacket_next<kAnyHit>(t0 < vrt::kBig, t1 < vrt::kBig, t0,
                                          t1, c0, c1, stack, sp);
      } else {
        bool all_done = true;
        for (int k = 0; k < kLanes; ++k) {
          pk::test_leaf<kCull>(tab, cur, r[k], true, best[k], h[k]);
          all_done = all_done && (h[k].hit || r[k].tmin > best[k]);
        }
        cur = kAnyHit && all_done ? pk::kDone : pk::pop(stack, sp);
      }
    }
    for (int k = 0; k < kLanes && base + k < n; ++k) {
      const long long i = base + k;
      if (kAnyHit) {
        out_flag[i] = h[k].hit;
        continue;
      }
      out_t[i] = h[k].hit ? best[k] : vrt::kBig;
      out_u[i] = h[k].u;
      out_v[i] = h[k].v;
      out_tri[i] = h[k].tri;
      out_flag[i] = h[k].backface;
    }
  }
}

}  // namespace

extern "C" int vrt_subpacket_closest_cpu(const float* nodes, const int* child,
                                         const float* tri,
                                         const int* tri_flags, const float* o,
                                         const float* d, const float* tmin,
                                         const float* tmax, int n, int cull,
                                         float* out_t, float* out_u,
                                         float* out_v, int* out_tri,
                                         bool* out_bf) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  if (cull)
    run<false, true>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri, out_bf);
  else
    run<false, false>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri, out_bf);
  return 0;
}

extern "C" int vrt_subpacket_any_cpu(const float* nodes, const int* child,
                                     const float* tri, const int* tri_flags,
                                     const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     int n, bool* out_hit) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  run<true, false>(tab, o, d, tmin, tmax, n, nullptr, nullptr, nullptr,
                   nullptr, out_hit);
  return 0;
}
