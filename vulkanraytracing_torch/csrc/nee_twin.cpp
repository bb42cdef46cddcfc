// CPU twin of the point-light pick kernel: the same per-lane function
// (nee_select.cuh) compiled by g++ and looped over the lanes.  Used only by
// the tests, which hold it bit for bit against the plain PyTorch body so the
// kernel's own arithmetic runs where there is no card.
#include "nee_select.cuh"

extern "C" int vrt_nee_select_cpu(const vrt::NeeArgs* args) {
  for (long long i = 0; i < args->lanes; ++i) vrt::select_lane(*args, i);
  return 0;
}
