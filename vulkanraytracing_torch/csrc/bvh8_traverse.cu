// CUDA entry points of the BVH8 traversal (see bvh8_traverse.cuh).
// One thread per ray, 128 threads per block, one launch per call on the
// caller's stream.  Plain C interface, loaded with ctypes; each function
// returns cudaGetLastError() right after its launch.
// Replaces: vulkanraytracing_tpu/ops/traverse_wide8.py:278 (_kernel)
#include <cuda_runtime.h>

#include "bvh8_traverse.cuh"

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ vrt::Ray load_ray(const float* o, const float* d,
                                             const float* tmin,
                                             const float* tmax, int i) {
  return vrt::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
                  d[3 * i + 2], tmin[i], tmax[i]};
}

template <bool kCull>
__global__ void __launch_bounds__(kBlock)
    closest_kernel(vrt::Table8 tab, const float* __restrict__ o,
                   const float* __restrict__ d, const float* __restrict__ tmin,
                   const float* __restrict__ tmax, int n, float* out_t,
                   float* out_u, float* out_v, int* out_tri, bool* out_bf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const vrt::HitRecord h =
      vrt::traverse<false, kCull>(tab, load_ray(o, d, tmin, tmax, i));
  out_t[i] = h.t;
  out_u[i] = h.u;
  out_v[i] = h.v;
  out_tri[i] = h.tri;
  out_bf[i] = h.backface;
}

__global__ void __launch_bounds__(kBlock)
    any_kernel(vrt::Table8 tab, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ tmin,
               const float* __restrict__ tmax, int n, bool* out_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out_hit[i] =
      vrt::traverse<true, false>(tab, load_ray(o, d, tmin, tmax, i)).hit;
}

}  // namespace

extern "C" int vrt_bvh8_closest(const float* boxes, const int* child,
                                const float* tri, const int* tri_meta,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax, int n,
                                int cull, float* out_t, float* out_u,
                                float* out_v, int* out_tri, bool* out_bf,
                                void* stream) {
  const vrt::Table8 tab{boxes, child, tri, tri_meta};
  const dim3 grid((n + kBlock - 1) / kBlock);
  auto s = static_cast<cudaStream_t>(stream);
  if (cull)
    closest_kernel<true><<<grid, kBlock, 0, s>>>(tab, o, d, tmin, tmax, n,
                                                 out_t, out_u, out_v, out_tri,
                                                 out_bf);
  else
    closest_kernel<false><<<grid, kBlock, 0, s>>>(tab, o, d, tmin, tmax, n,
                                                  out_t, out_u, out_v, out_tri,
                                                  out_bf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vrt_bvh8_any(const float* boxes, const int* child,
                            const float* tri, const int* tri_meta,
                            const float* o, const float* d, const float* tmin,
                            const float* tmax, int n, bool* out_hit,
                            void* stream) {
  const vrt::Table8 tab{boxes, child, tri, tri_meta};
  const dim3 grid((n + kBlock - 1) / kBlock);
  any_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, o, d, tmin, tmax, n, out_hit);
  return static_cast<int>(cudaGetLastError());
}
