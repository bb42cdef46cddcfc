// CPU twin of the BVH8 traversal kernel, both leaf tests: the same per-ray
// steps (bvh8_traverse.cuh) compiled by g++ and looped over the rays, each ray
// walked to its end (traverse_common.cuh::walk_ray).  Used only by the
// tests, which hold it against the plain PyTorch traversal so the kernel's
// own logic (packed records, sort network, split stack, leaf decoding,
// near-first order) runs where there is no card.
#include "bvh8_traverse.cuh"

namespace {

template <class T, bool kCull>
void closest_rays(const vrt::Table8& tab, const float* o, const float* d,
                  const float* tmin, const float* tmax, int n, float* out_t,
                  float* out_u, float* out_v, int* out_tri, bool* out_bf) {
  for (int i = 0; i < n; ++i) {
    const vrt::HitRecord h = vrt::walk_ray<T, false, kCull>(
        tab, vrt::load_ray(o, d, tmin, tmax, i));
    out_t[i] = h.t;
    out_u[i] = h.u;
    out_v[i] = h.v;
    out_tri[i] = h.tri;
    out_bf[i] = h.backface;
  }
}

template <class T>
int run_closest(const float* node, const float* tri, const float* o,
                const float* d, const float* tmin, const float* tmax, int n,
                int cull, float* out_t, float* out_u, float* out_v,
                int* out_tri, bool* out_bf) {
  const vrt::Table8 tab{node, tri};
  if (cull)
    closest_rays<T, true>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v,
                          out_tri, out_bf);
  else
    closest_rays<T, false>(tab, o, d, tmin, tmax, n, out_t, out_u, out_v,
                           out_tri, out_bf);
  return 0;
}

template <class T>
int run_any(const float* node, const float* tri, const float* o,
            const float* d, const float* tmin, const float* tmax, int n,
            bool* out_hit) {
  const vrt::Table8 tab{node, tri};
  for (int i = 0; i < n; ++i)
    out_hit[i] =
        vrt::walk_ray<T, true, false>(tab, vrt::load_ray(o, d, tmin, tmax, i))
            .hit;
  return 0;
}

}  // namespace

extern "C" int vrt_bvh8_closest_cpu(const float* node, const float* tri,
                                    const float* o, const float* d,
                                    const float* tmin, const float* tmax,
                                    int n, int cull, float* out_t,
                                    float* out_u, float* out_v, int* out_tri,
                                    bool* out_bf) {
  return run_closest<vrt::Bvh8>(node, tri, o, d, tmin, tmax, n, cull, out_t,
                                out_u, out_v, out_tri, out_bf);
}

extern "C" int vrt_bvh8_any_cpu(const float* node, const float* tri,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                bool* out_hit) {
  return run_any<vrt::Bvh8>(node, tri, o, d, tmin, tmax, n, out_hit);
}

// The same walks with the plane leaf test, over plane records.
extern "C" int vrt_bvh8_woop_closest_cpu(const float* node, const float* tri,
                                         const float* o, const float* d,
                                         const float* tmin, const float* tmax,
                                         int n, int cull, float* out_t,
                                         float* out_u, float* out_v,
                                         int* out_tri, bool* out_bf) {
  return run_closest<vrt::Bvh8Woop>(node, tri, o, d, tmin, tmax, n, cull,
                                    out_t, out_u, out_v, out_tri, out_bf);
}

extern "C" int vrt_bvh8_woop_any_cpu(const float* node, const float* tri,
                                     const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     int n, bool* out_hit) {
  return run_any<vrt::Bvh8Woop>(node, tri, o, d, tmin, tmax, n, out_hit);
}

// The sort network alone: n rows of 8 distances and 8 child ids, sorted in
// place.
extern "C" int vrt_bvh8_sort8_cpu(float* dist, int* kid, int n) {
  for (int i = 0; i < n; ++i) {
    float dd[8];
    int kk[8];
    for (int k = 0; k < 8; ++k) {
      dd[k] = dist[8 * i + k];
      kk[k] = kid[8 * i + k];
    }
    vrt::sort8(dd, kk);
    for (int k = 0; k < 8; ++k) {
      dist[8 * i + k] = dd[k];
      kid[8 * i + k] = kk[k];
    }
  }
  return 0;
}
