// The port's one noise stream, shared by every kernel source.
//
// Philox4x32-10 (Salmon et al. 2011) keyed by a 64-bit seed, with the
// counter (chain, absolute step, element, purpose), so neither the block
// shape nor the chunking of launches changes a trajectory.  The
// bits-to-uniform map u = ((bits >> 8) + 1) * 2^-24 in (0, 1] is exact in f32;
// a normal is Box-Muller on the first two words, or one of the MXU-CLT
// generator's (fused_body.cuh), which takes all four words of a draw as
// uniforms.  The plain PyTorch versions implement the same stream in int64
// arithmetic (pysgmcmc_tpu_torch/ops/fused_step.py: philox4x32_10,
// philox_normals, clt_normals, philox_windows).

#pragma once

#include <cuda_runtime.h>

constexpr unsigned kPurposeWindow = 0u;
constexpr unsigned kPurposeNoise = 1u;
constexpr unsigned kPurposeClt = 2u;
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

// The standard normal of parameter `element` of `chain` at absolute `step`.
__device__ __forceinline__ float philox_normal(unsigned long long seed,
                                               unsigned chain, unsigned step,
                                               unsigned element) {
  const uint4 r = philox_draw(seed, chain, step, element, kPurposeNoise);
  const float u1 = bits_to_uniform(r.x), u2 = bits_to_uniform(r.y);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}
