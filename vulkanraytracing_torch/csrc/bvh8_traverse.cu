// CUDA entry points of the BVH8 traversal (see bvh8_traverse.cuh): the
// persistent-warp kernel of traverse_common.cuh over the BVH8 walk, one
// launch per call on the caller's stream.  Plain C interface, loaded with
// ctypes; next_ray is one zeroed int32 on the device (the ray queue's
// counter), n must be positive; each function returns the first CUDA error
// of its set-up, else cudaGetLastError() right after its launch.
// Replaces: vulkanraytracing_tpu/ops/traverse_wide8.py:278 (_kernel)
#include <cuda_runtime.h>

#include "bvh8_traverse.cuh"

extern "C" int vrt_bvh8_closest(const float* node, const float* tri,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                int cull, int* next_ray, float* out_t,
                                float* out_u, float* out_v, int* out_tri,
                                bool* out_bf, void* stream) {
  const vrt::Table8 tab{node, tri};
  auto s = static_cast<cudaStream_t>(stream);
  return cull ? vrt::traverse_launch<vrt::Bvh8, false, true>(
                    tab, o, d, tmin, tmax, n, next_ray, out_t, out_u, out_v,
                    out_tri, out_bf, s)
              : vrt::traverse_launch<vrt::Bvh8, false, false>(
                    tab, o, d, tmin, tmax, n, next_ray, out_t, out_u, out_v,
                    out_tri, out_bf, s);
}

extern "C" int vrt_bvh8_any(const float* node, const float* tri,
                            const float* o, const float* d, const float* tmin,
                            const float* tmax, int n, int* next_ray,
                            bool* out_hit, void* stream) {
  const vrt::Table8 tab{node, tri};
  return vrt::traverse_launch<vrt::Bvh8, true, false>(
      tab, o, d, tmin, tmax, n, next_ray, nullptr, nullptr, nullptr, nullptr,
      out_hit, static_cast<cudaStream_t>(stream));
}
