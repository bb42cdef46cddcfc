// CPU twin of the BVH2 traversal kernel: the same per-ray code
// (bvh2_traverse.cuh) compiled by g++ and looped over the rays.  Used only
// by the tests, which hold it against the plain PyTorch traversal so the
// kernel's own logic (stack, leaf decoding, near-first order) runs where
// there is no card.
#include "bvh2_traverse.cuh"

namespace {

vrt::Ray load_ray(const float* o, const float* d, const float* tmin,
                  const float* tmax, int i) {
  return vrt::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
                  d[3 * i + 2], tmin[i], tmax[i]};
}

template <bool kCull>
void closest(const vrt::Table2& tab, const float* o, const float* d,
             const float* tmin, const float* tmax, int n, float* out_t,
             float* out_u, float* out_v, int* out_tri, bool* out_bf) {
  for (int i = 0; i < n; ++i) {
    const vrt::HitRecord h =
        vrt::traverse2<false, kCull>(tab, load_ray(o, d, tmin, tmax, i));
    out_t[i] = h.t;
    out_u[i] = h.u;
    out_v[i] = h.v;
    out_tri[i] = h.tri;
    out_bf[i] = h.backface;
  }
}

}  // namespace

extern "C" int vrt_bvh2_closest_cpu(const float* nodes, const int* child,
                                    const float* tri, const int* tri_flags,
                                    const float* o, const float* d,
                                    const float* tmin, const float* tmax,
                                    int n, int cull, float* out_t,
                                    float* out_u, float* out_v, int* out_tri,
                                    bool* out_bf) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  if (cull)
    closest<true>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri,
                  out_bf);
  else
    closest<false>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri,
                   out_bf);
  return 0;
}

extern "C" int vrt_bvh2_any_cpu(const float* nodes, const int* child,
                                const float* tri, const int* tri_flags,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                bool* out_hit) {
  const vrt::Table2 tab{nodes, child, tri, tri_flags};
  for (int i = 0; i < n; ++i)
    out_hit[i] =
        vrt::traverse2<true, false>(tab, load_ray(o, d, tmin, tmax, i)).hit;
  return 0;
}
