// CUDA entry point of the point-light pick (see nee_select.cuh): one thread
// a lane, one launch per call on the caller's stream.  Plain C interface,
// loaded with ctypes; returns cudaGetLastError() right after the launch.
// Replaces no TPU kernel: the JAX package leaves the pick to XLA
// (vulkanraytracing_tpu/pt/integrator.py::sample_point_light), and the
// port's plain body, about 60 PyTorch ops with a cumsum over rows of 4, takes
// about 13 ms a call on an H100 at a 1080p frame's 2,088,960 lanes.  Bound
// by bytes: a lane reads its normal and point (24 B, the normal a strided
// column of the TBN frames) and its state (16 B) and writes idx, pdf and the
// state (28 B); the estimates, the CDF and the draw stay in registers.
#include <cuda_runtime.h>

#include "nee_select.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) nee_select_kernel(vrt::NeeArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i < a.lanes) vrt::select_lane(a, i);
}

}  // namespace

extern "C" int vrt_nee_select(const vrt::NeeArgs* args, void* stream) {
  const long long blocks = (args->lanes + kBlock - 1) / kBlock;
  nee_select_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
