// CPU twin of the BVH2 traversal kernel: the same per-ray steps
// (bvh2_traverse.cuh) compiled by g++ and looped over the rays, each ray
// walked to its end (traverse_common.cuh::walk_ray).  Used only by the
// tests, which hold it against the plain PyTorch traversal so the kernel's
// own logic (packed records, split stack, leaf decoding, visit order) runs
// where there is no card.
#include "bvh2_traverse.cuh"

namespace {

template <bool kCull>
void closest(const vrt::Records2& tab, const float* o, const float* d,
             const float* tmin, const float* tmax, int n, float* out_t,
             float* out_u, float* out_v, int* out_tri, bool* out_bf) {
  for (int i = 0; i < n; ++i) {
    const vrt::HitRecord h = vrt::walk_ray<vrt::Bvh2, false, kCull>(
        tab, vrt::load_ray(o, d, tmin, tmax, i));
    out_t[i] = h.t;
    out_u[i] = h.u;
    out_v[i] = h.v;
    out_tri[i] = h.tri;
    out_bf[i] = h.backface;
  }
}

}  // namespace

extern "C" int vrt_bvh2_closest_cpu(const float* node, const float* tri,
                                    const float* o, const float* d,
                                    const float* tmin, const float* tmax,
                                    int n, int cull, float* out_t,
                                    float* out_u, float* out_v, int* out_tri,
                                    bool* out_bf) {
  const vrt::Records2 tab{node, tri};
  if (cull)
    closest<true>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri,
                  out_bf);
  else
    closest<false>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v, out_tri,
                   out_bf);
  return 0;
}

extern "C" int vrt_bvh2_any_cpu(const float* node, const float* tri,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                bool* out_hit) {
  const vrt::Records2 tab{node, tri};
  for (int i = 0; i < n; ++i)
    out_hit[i] = vrt::walk_ray<vrt::Bvh2, true, false>(
                     tab, vrt::load_ray(o, d, tmin, tmax, i))
                     .hit;
  return 0;
}
