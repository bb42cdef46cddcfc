// The point-light pick of pt/integrator.py::sample_point_light for one lane:
// each light's unshadowed irradiance estimate lum * NoL / d^2, their running
// sum as a CDF, one xoroshiro64** draw, the light it picks and its pdf.
//
// The plain PyTorch body's rules, rule for rule:
//   - the estimate in _estimate_point_lights's operand order: the dot
//     products summed left to right, the reciprocal square root as torch's
//     CPU rsqrt rounds it (a square root, then 1 / it), clamp_min letting
//     NaN through;
//   - the CDF as torch's CPU cumsum forms it: a running sum in double,
//     each prefix rounded to float;
//   - the total > 0 guard (otherwise every CDF entry is 1: light 0, pdf 1),
//     and the last entry forced to 1;
//   - idx counts the entries i < L - 1 with x >= cdf[i], so NaN entries
//     count for nothing and a tie at a boundary goes to the next light;
//   - pdf = cdf[idx] - cdf[idx - 1], with cdf[-1] = 0.
// The lights are a table of any length L >= 1; nothing is kept per light,
// so the estimate is computed again in each of up to three passes (the
// total, the count, the chosen bin's edges).
//
// The same code is compiled by nvcc for the kernel (nee_select.cu) and by
// g++ for the CPU twin (nee_twin.cpp) used in the tests; both without FMA
// contraction (-fmad=false, -ffp-contract=off), so both round as the plain
// body does on the CPU.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define VRT_NEE_HD __host__ __device__ __forceinline__
#else
#define VRT_NEE_HD inline
#endif

namespace vrt {

// One call's tensors: element pointers and element strides.  The lights'
// position and color rows are (x, y, z, w); n and p are (lanes, 3) with any
// strides (the shading normal is a column of the TBN frames); the RNG state
// is uint32 held in int64, as the integrator keeps it.
struct NeeArgs {
  const float* light_pos;
  long long light_pos_row;
  const float* light_col;
  long long light_col_row;
  int lights;
  const float* n;
  long long n_row, n_col;
  const float* p;
  long long p_row, p_col;
  const long long* s0;
  long long s0_step;
  const long long* s1;
  long long s1_step;
  long long lanes;
  long long* out_idx;
  float* out_pdf;
  long long* out_s0;
  long long* out_s1;
};

// torch.clamp_min: NaN passes through, and x is kept when it equals lo
VRT_NEE_HD float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}

// torch.rsqrt on the CPU: the square root and the quotient each rounded
VRT_NEE_HD float rsqrt_rn(float x) { return 1.0f / sqrtf(x); }

VRT_NEE_HD uint32_t rotl32(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

VRT_NEE_HD float uint_as_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// core/rng.py::next_float: one xoroshiro64** draw, uniform in [0, 1) by the
// 0x3F800000 mantissa trick; advances (s0, s1)
VRT_NEE_HD float next_float(uint32_t& s0, uint32_t& s1) {
  const uint32_t bits = rotl32(s0 * 0x9E3779BBu, 5) * 5u;
  s1 ^= s0;
  s0 = rotl32(s0, 26) ^ s1 ^ (s1 << 9);
  s1 = rotl32(s1, 13);
  return uint_as_float(0x3F800000u | (bits >> 9)) - 1.0f;
}

struct Lane {
  float nx, ny, nz, px, py, pz;
};

// pt/integrator.py::_estimate_point_lights for light i
VRT_NEE_HD float estimate(const NeeArgs& a, int i, const Lane& l) {
  const float* lp = a.light_pos + i * a.light_pos_row;
  const float* lc = a.light_col + i * a.light_col_row;
  const float dx = lp[0] - l.px, dy = lp[1] - l.py, dz = lp[2] - l.pz;
  const float dist_sq = dx * dx + dy * dy + dz * dz;
  const float inv = rsqrt_rn(clamp_min(dist_sq, 1e-20f));
  const float lx = dx * inv, ly = dy * inv, lz = dz * inv;
  const float nol = clamp_min(l.nx * lx + l.ny * ly + l.nz * lz, 0.0f);
  const float lum = lc[0] * 0.2126f + lc[1] * 0.7152f + lc[2] * 0.0722f;
  return lum * nol / clamp_min(dist_sq, 1e-20f);
}

// Lane i's pick: writes idx, pdf and the advanced state.
VRT_NEE_HD void select_lane(const NeeArgs& a, long long i) {
  const float* n = a.n + i * a.n_row;
  const float* p = a.p + i * a.p_row;
  const Lane l{n[0], n[a.n_col], n[2 * a.n_col], p[0], p[a.p_col], p[2 * a.p_col]};
  const int last = a.lights - 1;

  double acc = 0.0;
  for (int k = 0; k < a.lights; ++k) acc += static_cast<double>(estimate(a, k, l));
  const float total = static_cast<float>(acc);
  const bool live = total > 0.0f;

  uint32_t s0 = static_cast<uint32_t>(a.s0[i * a.s0_step]);
  uint32_t s1 = static_cast<uint32_t>(a.s1[i * a.s1_step]);
  const float x = next_float(s0, s1);

  acc = 0.0;
  long long idx = 0;
  for (int k = 0; k < last; ++k) {
    acc += static_cast<double>(estimate(a, k, l));
    idx += x >= (live ? static_cast<float>(acc) / total : 1.0f);
  }

  acc = 0.0;
  float lo = 0.0f, hi = 1.0f;
  for (int k = 0; k < last && k <= idx; ++k) {
    acc += static_cast<double>(estimate(a, k, l));
    const float c = live ? static_cast<float>(acc) / total : 1.0f;
    if (k == idx)
      hi = c;
    else
      lo = c;
  }

  a.out_idx[i] = idx;
  a.out_pdf[i] = hi - lo;
  a.out_s0[i] = static_cast<long long>(s0);
  a.out_s1[i] = static_cast<long long>(s1);
}

}  // namespace vrt
