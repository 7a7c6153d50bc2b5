// The port's one noise stream, shared by every kernel source.
//
// Philox4x32-10 (Salmon et al. 2011) keyed by a 64-bit seed, with the
// counter (chain, absolute step, draw, purpose), so neither the block shape
// nor the chunking of launches changes a trajectory.  The bits-to-uniform
// map u = ((bits >> 8) + 1) * 2^-24 in (0, 1] is exact in f32.  A
// Box-Muller normal takes a quarter of a draw: element e reads draw
// floor(e / 4) (purpose kPurposeNoise), whose words (x, y) give r1 cos t1
// and r1 sin t1 for elements 4q and 4q + 1, and (z, w) r2 cos t2 and
// r2 sin t2 for 4q + 2 and 4q + 3 (r = sqrt(-2 log u_first), t = 2 pi
// u_second).  The MXU-CLT generator's normals (fused_body.cuh) take all
// four words of a draw as uniforms.  The plain PyTorch versions implement
// the same stream in int64 arithmetic (pysgmcmc_tpu_torch/ops/
// fused_step.py: philox4x32_10, philox_normals, clt_normals,
// philox_windows).

#pragma once

#include <cuda_runtime.h>

constexpr unsigned kPurposeWindow = 0u;
constexpr unsigned kPurposeNoise = 1u;
constexpr unsigned kPurposeClt = 2u;
constexpr float kPi = 3.14159265358979f;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float bits_to_uniform(unsigned bits) {
  return static_cast<float>((bits >> 8) + 1u) * (1.0f / 16777216.0f);
}

// The four words of the stream at (chain, step, element, purpose).
__device__ __forceinline__ uint4 philox_draw(unsigned long long seed,
                                             unsigned chain, unsigned step,
                                             unsigned element,
                                             unsigned purpose) {
  return philox4x32_10(make_uint4(chain, step, element, purpose),
                       static_cast<unsigned>(seed),
                       static_cast<unsigned>(seed >> 32));
}

// The square root on the special-function unit (sqrt.approx.f32, within
// about an ulp of the correctly rounded root that sqrtf spends some eight
// instructions on), for Box-Muller's root and the fused sampling rules'
// noise scales: no check resolves the difference.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Box-Muller on words (w0, w1) of a draw: (r cos t, r sin t) with r =
// sqrt(-2 log u(w0)) and t = 2 pi u(w1), the angle taken as t - pi (its
// cosine and sine negated) so that the fast sine and cosine see an argument
// in (-pi, pi], where each is within 2^-21.4, and the root by sqrt_approx:
// each normal within 2.4e-6 of the exact transform (|r| <= 5.8), which no
// check resolves.
__device__ __forceinline__ float2 box_muller(unsigned w0, unsigned w1) {
  float s, c;
  __sincosf(fmaf(kTwoPi, bits_to_uniform(w1), -kPi), &s, &c);
  const float r = -sqrt_approx(-2.0f * logf(bits_to_uniform(w0)));
  return make_float2(r * c, r * s);
}

// The four normals of draw q of `chain` at absolute `step`: elements 4q ..
// 4q + 3.
__device__ __forceinline__ float4 philox_normal_quad(unsigned long long seed,
                                                     unsigned chain,
                                                     unsigned step,
                                                     unsigned q) {
  const uint4 r = philox_draw(seed, chain, step, q, kPurposeNoise);
  const float2 lo = box_muller(r.x, r.y), hi = box_muller(r.z, r.w);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The standard normal of parameter `element` of `chain` at absolute `step`:
// its quarter of draw element / 4 (the same value as philox_normal_quad's).
__device__ __forceinline__ float philox_normal(unsigned long long seed,
                                               unsigned chain, unsigned step,
                                               unsigned element) {
  const uint4 r = philox_draw(seed, chain, step, element >> 2, kPurposeNoise);
  const bool second = element & 2u;
  const float2 z = box_muller(second ? r.z : r.x, second ? r.w : r.y);
  return element & 1u ? z.y : z.x;
}
