// Slim elementwise sampler updates for Hopper: one pass over the packed
// (n_chains, P) state per step of the chains-on-lanes drivers.
//
// Replaces the TPU Pallas kernels of pysgmcmc_tpu/ops/slim_update.py
//   B7        slim_sghmc_update          SGHMC sampling update, frozen minv
//   B8-sgld   slim_sgld_update           SGLD sampling update, frozen minv
//   B8-psgld  slim_psgld_update          pSGLD: RMSprop accumulator + update
//   B8-rsghmc slim_rsghmc_update         relativistic SGHMC update
//   B8-sgnht  slim_sgnht_update          SGNHT update with a per-chain xi
//   B9-sghmc  slim_sghmc_burnin_update   tau/g/v_hat EMAs + SGHMC update
//   B9-sgld   slim_sgld_burnin_update    tau/g/v_hat EMAs + SGLD update
// with the same semantics (_update_math, _sgld_math, _psgld_math,
// _rsghmc_math, _sgnht_math, _sghmc_burnin_math, _sgld_burnin_math): the
// gradient arrives from the driver's autograd pass, the kernel folds the
// Gaussian weight prior (g + prior_scale * theta), draws the noise and
// applies the rule.  Burn-in reads OLD tau, g and v_hat for every EMA and
// uses minv = 1/sqrt(old v_hat) with the reference's guards, and returns
// that minv (the value the sampling phase freezes).  SGNHT's thermostat
// update is a reduction over each chain's row and stays in the driver.
//
// Bound.  Every element is read and written once, so these kernels are bound
// by device memory: per element B7 moves 6 f32 words (theta, v, grad, minv in;
// theta, v out), B8-sgld 4, B8-psgld, B8-rsghmc and B8-sgnht 5 (theta, the
// accumulator or momentum, grad in; theta and it out), B9-sghmc 12 and
// B9-sgld 10; at the flagship (8192 chains x 5,252 parameters) that is
// 0.21-0.62 ms per launch at 3.35 TB/s.  Each element also pays one
// Philox4x32-10 draw and a log, a cos and a sqrt.
//
// Design.  The layout is the port's own: chain rows of P floats, leaves in
// the network dict's order, no padding (the TPU's (rows, n_chains) layout
// with 8-aligned slots and its mask is a Mosaic choice).  A 2-D grid: blockIdx.y
// walks the chains, blockIdx.x and the threads the chain's parameters, so
// neighbouring threads touch neighbouring words and no thread divides an
// index.  What depends on the chain alone (its eps, RSGHMC's noise scale,
// SGNHT's noise scale and xi) is computed once per chain row.  The noise is
// the stream of philox.cuh at (chain, absolute step, element, purpose),
// which is what the fused kernels B1-B6 draw: on the dense network the lanes
// drivers and the fused drivers see the same normals.  A per-chain eps
// vector may replace the scalar stepsize (the TracedStepsizeSchedule sweep
// pattern), and injected noise may replace the draw (the tests).  All
// arithmetic is f32; outputs are new buffers, not aliases of the inputs.
//
// bf16 operands.  As JAX's slim kernels, v (the momentum or accumulator),
// minv and the gradient may arrive as bf16 (the gradient of a bf16 network
// pass, state_dtype=bfloat16 state); the flags v_bf16, minv_bf16 and
// grad_bf16 say which, per launch, so one body serves every combination.
// The flags are read only in the instantiation with kMixed set; with all
// operands f32 the launch takes the kMixed = false one, whose loads and
// stores are plain f32, as the kernels before bf16 operands had them.
// Each is widened to f32 on load, and v_out keeps v's type (the new value
// rounded to nearest even); theta, tau, g, v_hat and minv_out are f32.  A
// bf16 operand halves its bytes: at the flagship, B7 with bf16 v, minv and
// grad moves 16 bytes per element instead of 24.
//
// Built with nvcc into a shared library with a plain C interface, one entry
// per TPU kernel; each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;
constexpr int kMaxBlocksY = 65535;
constexpr float kSmall = 1e-16f;

enum Rule { kSghmc = 0, kSgld = 1, kPsgld = 2, kRsghmc = 3, kSgnht = 4 };

struct Args {
  const float* theta;
  const void* v;         // SGHMC momentum, pSGLD accumulator, RSGHMC and
                         // SGNHT momentum: f32, or bf16 where v_bf16
  const void* minv;      // SGHMC / SGLD sampling only: f32 or bf16
  const float* tau;      // burn-in only
  const float* g;        // burn-in only
  const float* v_hat;    // burn-in only
  const void* grad;      // f32 or bf16
  const float* xi;       // SGNHT only: (n_chains,) thermostat
  const float* eps_vec;  // optional (n_chains,): replaces eps
  const float* noise;    // optional (n_chains, n_params): replaces the draw
  float* theta_out;
  void* v_out;           // the rules with a v, in v's type
  float* tau_out;        // burn-in only
  float* g_out;          // burn-in only
  float* v_hat_out;      // burn-in only
  float* minv_out;       // burn-in only: the minv this step used
  int n_chains, n_params;
  unsigned long long seed;
  unsigned step;
  // eps: the scalar stepsize.  The rule's constants, computed on the host
  // in f32 (the TPU kernels' scalar operands):
  //   SGHMC   sqrt_sg = sqrt(scale_grad), coef = mdecay (eps_s = eps/sqrt_sg)
  //   SGLD    coef = A, cdiv = A / scale_grad in sampling, sg_safe =
  //           scale_grad + 2 sign(scale_grad) 1e-16 + 1e-16 in burn-in
  //   pSGLD   coef = alpha, cdiv = lambda, c2 = 1 / scale_grad
  //   RSGHMC  coef = D, cdiv = Bhat, c2 = 1 / m, c3 = 1 / (m^2 c^2)
  //   SGNHT   coef = 2 A, cdiv = scale_grad
  float eps, sqrt_sg, coef, cdiv, c2, c3, prior_scale;
  int v_bf16, minv_bf16, grad_bf16;  // which of v, minv, grad are bf16
};

// kMixed: some operand may be bf16 (the flag says whether this one is);
// without it every operand is f32 and the flag is not read.
template <bool kMixed>
__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  return kMixed && bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

template <bool kMixed>
__device__ __forceinline__ void store(void* p, size_t i, int bf16, float x) {
  if (kMixed && bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

template <int kRule, bool kBurnin, bool kMixed>
__global__ void __launch_bounds__(kThreads) slim_kernel(Args a) {
  const int P = a.n_params;
  for (int c = blockIdx.y; c < a.n_chains; c += gridDim.y) {
    const size_t base = static_cast<size_t>(c) * P;
    const float eps = a.eps_vec != nullptr ? a.eps_vec[c] : a.eps;
    // the chain's noise scale (RSGHMC, SGNHT) and thermostat (SGNHT)
    float chain_sigma = 0.0f, xi = 0.0f;
    if constexpr (kRule == kRsghmc) {
      chain_sigma = sqrtf(fmaxf(eps * (2.0f * a.coef - eps * a.cdiv), 0.0f));
    } else if constexpr (kRule == kSgnht) {
      chain_sigma = sqrtf(fmaxf(a.coef * eps / a.cdiv, 0.0f));
      xi = a.xi[c];
    }
    for (int p = blockIdx.x * kThreads + threadIdx.x; p < P;
         p += gridDim.x * kThreads) {
      const size_t i = base + p;
      const float eta = a.noise != nullptr
                            ? a.noise[i]
                            : philox_normal(a.seed, static_cast<unsigned>(c),
                                            a.step, static_cast<unsigned>(p));
      const float th = a.theta[i];
      const float gg =
          load<kMixed>(a.grad, i, a.grad_bf16) + a.prior_scale * th;
      if constexpr (kRule == kSghmc || kRule == kSgld) {
        float minv;
        if constexpr (kBurnin) {
          // every EMA reads the OLD tau, g and v_hat
          const float tau = a.tau[i], gm = a.g[i], vh = a.v_hat[i];
          const float sq = sqrtf(fmaxf(vh, 0.0f));
          minv = 1.0f / (sq + 2.0f * sign_of(sq) * kSmall + kSmall);
          const float denom = vh + 2.0f * sign_of(vh) * kSmall + kSmall;
          const float r = 1.0f / (tau + 1.0f);
          a.tau_out[i] = tau + (-gm * gm * tau) / denom + 1.0f;
          a.g_out[i] = gm - r * gm + r * gg;
          a.v_hat_out[i] = vh - r * vh + r * gg * gg;
          a.minv_out[i] = minv;
        } else {
          minv = load<kMixed>(a.minv, i, a.minv_bf16);
        }
        if constexpr (kRule == kSghmc) {
          const float es = eps / a.sqrt_sg;
          const float es2 = es * es;
          const float mdecay = a.coef;
          const float vv = load<kMixed>(a.v, i, a.v_bf16);
          const float sigma =
              sqrtf(fmaxf(2.0f * es2 * mdecay * minv - es2 * es2, 1e-16f));
          const float vn =
              vv - eps * eps * minv * gg - mdecay * vv + sigma * eta;
          store<kMixed>(a.v_out, i, a.v_bf16, vn);
          a.theta_out[i] = th + vn;
        } else {
          const float A = a.coef;
          const float sigma =
              kBurnin ? sqrtf(fmaxf(2.0f * eps * ((minv * A) / a.cdiv), 0.0f))
                      : sqrtf(fmaxf(2.0f * eps * minv * a.cdiv, 0.0f));
          a.theta_out[i] = th + (-eps * minv * A * gg + sigma * eta);
        }
      } else if constexpr (kRule == kPsgld) {
        // RMSprop accumulator, then G = 1 / (lambda + sqrt(v'))
        const float alpha = a.coef;
        const float vn = alpha * load<kMixed>(a.v, i, a.v_bf16) +
                         (1.0f - alpha) * gg * gg;
        const float precond = 1.0f / (a.cdiv + sqrtf(fmaxf(vn, 0.0f)));
        const float sigma = sqrtf(fmaxf(eps * precond * a.c2, 0.0f));
        store<kMixed>(a.v_out, i, a.v_bf16, vn);
        a.theta_out[i] = th + (-0.5f * eps * precond * gg + sigma * eta);
      } else if constexpr (kRule == kRsghmc) {
        // the dynamics use the log-likelihood gradient, -gg; the velocity is
        // eps p / m / sqrt(p^2 / (m^2 c^2) + 1)
        const float pv = load<kMixed>(a.v, i, a.v_bf16);
        const float vel = eps * pv * a.c2 * rsqrtf(pv * pv * a.c3 + 1.0f);
        const float pn = pv + eps * -gg + chain_sigma * eta - a.coef * vel;
        store<kMixed>(a.v_out, i, a.v_bf16, pn);
        a.theta_out[i] = th + eps * pn * a.c2 * rsqrtf(pn * pn * a.c3 + 1.0f);
      } else {  // kSgnht
        const float pv = load<kMixed>(a.v, i, a.v_bf16);
        const float pn = pv - xi * eps * pv - eps * gg + chain_sigma * eta;
        store<kMixed>(a.v_out, i, a.v_bf16, pn);
        a.theta_out[i] = th + eps * pn;
      }
    }
  }
}

template <int kRule, bool kBurnin>
int launch(const Args& a, void* stream) {
  if (a.n_chains <= 0 || a.n_params <= 0) return 0;
  const int bx = std::min((a.n_params + kThreads - 1) / kThreads, kMaxBlocksX);
  const int by = std::min(a.n_chains, kMaxBlocksY);
  const dim3 grid(bx, by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.v_bf16 || a.minv_bf16 || a.grad_bf16)
    slim_kernel<kRule, kBurnin, true><<<grid, kThreads, 0, s>>>(a);
  else
    slim_kernel<kRule, kBurnin, false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* slim_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One entry per TPU kernel, all with the same arguments (the Args fields in
// order, then the stream); a kernel reads only the operands of its rule and
// phase, and the others may be NULL.  The three flags give the storage of
// v (and v_out), minv and grad: 0 f32, 1 bf16.
#define SLIM_ENTRY(entry, rule, burnin)                                       \
  int entry(const float* theta, const void* v, const void* minv,            \
            const float* tau, const float* g, const float* v_hat,           \
            const void* grad, const float* xi, const float* eps_vec,        \
            const float* noise, float* theta_out, void* v_out,              \
            float* tau_out, float* g_out, float* v_hat_out,                 \
            float* minv_out, int n_chains, int n_params,                    \
            unsigned long long seed, unsigned step, float eps,              \
            float sqrt_sg, float coef, float cdiv, float c2, float c3,      \
            float prior_scale, int v_bf16, int minv_bf16, int grad_bf16,    \
            void* stream) {                                                 \
    const Args a = {theta,     v,         minv,     tau,      g,            \
                    v_hat,     grad,      xi,       eps_vec,  noise,        \
                    theta_out, v_out,     tau_out,  g_out,    v_hat_out,    \
                    minv_out,  n_chains,  n_params, seed,     step,         \
                    eps,       sqrt_sg,   coef,     cdiv,     c2,           \
                    c3,        prior_scale, v_bf16, minv_bf16, grad_bf16};  \
    return launch<rule, burnin>(a, stream);                                 \
  }

// B7: SGHMC sampling update with a frozen minv.
SLIM_ENTRY(slim_sghmc_update_launch, kSghmc, false)
// B8-sgld: SGLD sampling update with a frozen minv.
SLIM_ENTRY(slim_sgld_update_launch, kSgld, false)
// B8-psgld: pSGLD update; v_out gets the new accumulator.
SLIM_ENTRY(slim_psgld_update_launch, kPsgld, false)
// B8-rsghmc: relativistic SGHMC update; v_out gets the new momentum.
SLIM_ENTRY(slim_rsghmc_update_launch, kRsghmc, false)
// B8-sgnht: SGNHT update with the per-chain xi; v_out gets the new momentum.
SLIM_ENTRY(slim_sgnht_update_launch, kSgnht, false)
// B9-sghmc: SGHMC burn-in step; minv_out gets the minv it used.
SLIM_ENTRY(slim_sghmc_burnin_update_launch, kSghmc, true)
// B9-sgld: SGLD burn-in step; minv_out gets the minv it used.
SLIM_ENTRY(slim_sgld_burnin_update_launch, kSgld, true)

}  // extern "C"
