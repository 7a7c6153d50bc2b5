// Slim elementwise sampler updates for Hopper: one pass over the packed
// (n_chains, P) state per step of the chains-on-lanes, packed and stacked
// drivers and of FusedSGHMC.
//
// Replaces the TPU Pallas kernels of pysgmcmc_tpu/ops/slim_update.py
//   B7        slim_sghmc_update          SGHMC sampling update, frozen minv;
//   B7 mask                              with a (P,) mask row multiplying v'
//   B7'       slim_sghmc_update_tree     B7 over every leaf of a stacked tree
//   B8-sgld   slim_sgld_update           SGLD sampling update, frozen minv
//   B8-psgld  slim_psgld_update          pSGLD: RMSprop accumulator + update
//   B8-rsghmc slim_rsghmc_update         relativistic SGHMC update
//   B8-sgnht  slim_sgnht_update          SGNHT update with a per-chain xi
//   B9-sghmc  slim_sghmc_burnin_update   tau/g/v_hat EMAs + SGHMC update
//   B9-sgld   slim_sgld_burnin_update    tau/g/v_hat EMAs + SGLD update
// and of pysgmcmc_tpu/ops/fused_update.py
//   B10       fused_sghmc_update         FusedSGHMC's whole step: the EMAs
//                                        every step, the fresh or the given
//                                        minv by a run-time burning_in flag
// with the same semantics (_update_math, _sgld_math, _psgld_math,
// _rsghmc_math, _sgnht_math, _sghmc_burnin_math, _sgld_burnin_math): the
// gradient arrives from the driver's autograd pass, the kernel folds the
// Gaussian weight prior (g + prior_scale * theta), draws the noise and
// applies the rule.  Burn-in reads OLD tau, g and v_hat for every EMA and
// uses minv = 1/sqrt(old v_hat) with the reference's guards, and returns
// that minv (the value the sampling phase freezes).  B10 is B9-sghmc's math
// without the prior fold, and with minv = burning_in ? 1/sqrt(old v_hat) :
// the minv it is given; like JAX's kernel it adapts the EMAs in both phases.
// SGNHT's thermostat update is a reduction over each chain's row and stays
// in the driver.
//
// Bound.  Every element is read and written once, so these kernels are bound
// by device memory: per element B7 moves 6 f32 words (theta, v, grad, minv in;
// theta, v out), B8-sgld 4, B8-psgld, B8-rsghmc and B8-sgnht 5 (theta, the
// accumulator or momentum, grad in; theta and it out), B9-sghmc 12 and
// B9-sgld 10, B10 13 (7 in, 6 out); B7 mask adds nothing per element (its
// mask and noise-index rows are read once per column, from L2), and B7'
// moves B7's 6 words, plus a bf16 copy of theta with emit_bf16.  At the
// flagship (8192 chains x 5,252 parameters; B10 padded to 5,376, B7 mask
// 5,888 in 128-column slots) that is 0.21-0.68 ms per launch at 3.35 TB/s.
// Each element also pays a Philox4x32-10 draw and a Box-Muller transform
// (a log, a root, a sine and a cosine), or a quarter and a half of them
// where its warp shares each draw among four columns: with a whole draw a
// column, of which it took its quarter, B7 mask ran 5-7 % slower than the
// earlier stream's draw a column (H100, PERF.md section 6).
//
// Design.  The lanes layout is the port's own: chain rows of P floats, leaves
// in the network dict's order, no padding (the TPU's (rows, n_chains) layout
// with 8-aligned slots and its mask is a Mosaic choice).  The packed layout
// of sample_chain_packed keeps JAX's public slots (sorted leaves, each in a
// 128-aligned slot) and its mask; B10's rows are padded to 128 columns as
// JAX's FusedSGHMC state.  B7' reads a stacked tree in place: a device table
// of the leaves' pointers, first columns and sizes makes their elements one
// virtual chain row, so one launch covers every leaf whatever their number
// (JAX launches once per leaf).  A 2-D grid: blockIdx.y
// walks the chains, blockIdx.x and the warps the chain's parameters.  The
// sampling updates (B7, B7 mask, B8-*) take 128 columns a warp a pass:
// each lane makes one draw, the four normals of four of the columns, and
// stages them in shared memory, then the warp updates the 128 columns a
// lane per column 32 apart; the burn-in updates and B7' take a column a
// thread, which draws its own (rounds_of).  Either way neighbouring threads
// touch neighbouring words and no thread divides an index.  What depends on the chain alone (its eps, RSGHMC's noise scale,
// SGNHT's noise scale and xi) is computed once per chain row.  The noise is
// the stream of philox.cuh, element e a quarter of the draw at (chain,
// absolute step, e / 4, purpose), which is what the fused kernels B1-B6
// draw: on the dense network the lanes drivers and the fused drivers see
// the same normals.  The packed (mask)
// and stacked (tree) layouts key each normal by the element's index in the
// chain's unpadded lanes row (the position dict's order): given per column
// by the packed driver (noise_index), the virtual row's column in the tree's
// order, so the packed, stacked and lanes drivers draw the same normals for
// the same element (a warp's draws are those of its first column's element
// on; a masked column whose element lies outside them, another leaf's or
// the padding's, draws its own).  A per-chain eps
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

// kFusedSghmc is B10: SGHMC with the EMAs of every step (kBurnin set) and a
// run-time choice of minv
enum Rule {
  kSghmc = 0,
  kSgld = 1,
  kPsgld = 2,
  kRsghmc = 3,
  kSgnht = 4,
  kFusedSghmc = 5
};
// where an element's operands lie: the flat (n_chains, P) row, the same with
// B7's mask row (and noise-index row), or a stacked tree's leaf (B7')
enum Layout { kFlat = 0, kMasked = 1, kTree = 2 };

// One leaf of a stacked tree (B7'): (n_chains, size) arrays, theta, v, minv
// f32 and grad f32 or bf16.  Its columns are [start, start + size) of the
// chain's virtual row, the leaves in the tree's order without gaps, and
// column p draws the stream's element p: the element's index in the
// chain's unpadded row.  The wrapper fills the table with 10 int64 words
// per leaf in this order.
struct Leaf {
  const float* theta;
  const float* v;
  const void* grad;
  const float* minv;
  const float* noise;          // optional: replaces the draw
  float* theta_out;
  float* v_out;
  __nv_bfloat16* theta_bf16;   // optional (emit_bf16): theta' rounded
  long long start, size;
};

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
  // Appended after the fields above, which keep their places (a field
  // inserted mid-struct moved the fused kernels' register allocation):
  const float* mask;        // B7 mask: optional (n_params,) row times v'
  const int* noise_index;   // with a mask: each column's noise element
  int burning_in;           // B10: 1 the fresh minv, 0 the given one
  const Leaf* leaves;       // B7': the leaf table, n_leaves entries
  int n_leaves;
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

// The operands of one element: where theta, v, grad, minv, the injected
// noise and the two outputs lie, the element's index i in them, and the
// stream element of its normal.
struct Element {
  const float* theta;
  const void* v;
  const void* grad;
  const void* minv;
  const float* noise;
  float* theta_out;
  void* v_out;
  __nv_bfloat16* theta_bf16;
  size_t i;
  unsigned col;
};

// Columns a lane takes in turn in a pass of its warp: 4 where the warp
// stages the normals of its 128 columns (one draw a lane), 1 where each
// column draws its own.  The burn-in updates (B9-*, B10) and B7' take one:
// with four (on an H100) B9-sghmc ran 35 % and B9-sgld 29 % slower than
// with a draw a column, the bf16 B7' 6 % (ptxas's 32 registers serialised
// their longer bodies), where the sampling updates ran 5-30 % faster.
template <bool kBurnin, int kLayout>
__host__ __device__ constexpr int rounds_of() {
  return !kBurnin && kLayout != kTree ? 4 : 1;
}

// The operands of column p of chain c (base c * P): kTree finds its leaf,
// which only grows over a thread's columns of a chain.
template <int kLayout>
__device__ __forceinline__ Element element_of(const Args& a, int c,
                                              size_t base, int p, int& leaf) {
  if constexpr (kLayout == kTree) {
    while (leaf + 1 < a.n_leaves && p >= a.leaves[leaf + 1].start) ++leaf;
    const Leaf& l = a.leaves[leaf];
    const long long j = p - l.start;
    return {l.theta, l.v, l.grad, l.minv, l.noise, l.theta_out, l.v_out,
            l.theta_bf16, static_cast<size_t>(c * l.size + j),
            static_cast<unsigned>(p)};
  } else {
    return {a.theta, a.v, a.grad, a.minv, a.noise, a.theta_out, a.v_out,
            nullptr, base + p,
            kLayout == kMasked && a.noise_index != nullptr
                ? static_cast<unsigned>(a.noise_index[p])
                : static_cast<unsigned>(p)};
  }
}

// Each rule's update of column p (element e) with its normal eta.
template <int kRule, bool kBurnin, bool kMixed, int kLayout>
__device__ __forceinline__ void update_element(const Args& a, const Element& e,
                                               int p, float eps,
                                               float chain_sigma, float xi,
                                               float eta) {
  const size_t i = e.i;
  const float th = e.theta[i];
  // B10 folds no prior (JAX's fused_sghmc_update has none)
  const float gr = load<kMixed>(e.grad, i, a.grad_bf16);
  const float gg = kRule == kFusedSghmc ? gr : gr + a.prior_scale * th;
  if constexpr (kRule == kSghmc || kRule == kSgld ||
                kRule == kFusedSghmc) {
    float minv;
    if constexpr (kBurnin) {
      // every EMA reads the OLD tau, g and v_hat
      const float tau = a.tau[i], gm = a.g[i], vh = a.v_hat[i];
      const float sq = sqrtf(fmaxf(vh, 0.0f));
      minv = 1.0f / (sq + 2.0f * sign_of(sq) * kSmall + kSmall);
      if constexpr (kRule == kFusedSghmc) {
        if (!a.burning_in) minv = load<kMixed>(e.minv, i, a.minv_bf16);
      }
      const float denom = vh + 2.0f * sign_of(vh) * kSmall + kSmall;
      const float r = 1.0f / (tau + 1.0f);
      a.tau_out[i] = tau + (-gm * gm * tau) / denom + 1.0f;
      a.g_out[i] = gm - r * gm + r * gg;
      a.v_hat_out[i] = vh - r * vh + r * gg * gg;
      a.minv_out[i] = minv;
    } else {
      minv = load<kMixed>(e.minv, i, a.minv_bf16);
    }
    if constexpr (kRule == kSghmc || kRule == kFusedSghmc) {
      const float es = eps / a.sqrt_sg;
      const float es2 = es * es;
      const float mdecay = a.coef;
      const float vv = load<kMixed>(e.v, i, a.v_bf16);
      const float sigma =
          sqrtf(fmaxf(2.0f * es2 * mdecay * minv - es2 * es2, 1e-16f));
      float vn = vv - eps * eps * minv * gg - mdecay * vv + sigma * eta;
      if constexpr (kLayout == kMasked) vn *= a.mask[p];
      store<kMixed>(e.v_out, i, a.v_bf16, vn);
      e.theta_out[i] = th + vn;
      if constexpr (kLayout == kTree) {
        if (e.theta_bf16 != nullptr)
          e.theta_bf16[i] = __float2bfloat16_rn(th + vn);
      }
    } else {
      const float A = a.coef;
      const float sigma =
          kBurnin ? sqrtf(fmaxf(2.0f * eps * ((minv * A) / a.cdiv), 0.0f))
                  : sqrtf(fmaxf(2.0f * eps * minv * a.cdiv, 0.0f));
      e.theta_out[i] = th + (-eps * minv * A * gg + sigma * eta);
    }
  } else if constexpr (kRule == kPsgld) {
    // RMSprop accumulator, then G = 1 / (lambda + sqrt(v'))
    const float alpha = a.coef;
    const float vn = alpha * load<kMixed>(e.v, i, a.v_bf16) +
                     (1.0f - alpha) * gg * gg;
    const float precond = 1.0f / (a.cdiv + sqrtf(fmaxf(vn, 0.0f)));
    const float sigma = sqrtf(fmaxf(eps * precond * a.c2, 0.0f));
    store<kMixed>(e.v_out, i, a.v_bf16, vn);
    e.theta_out[i] = th + (-0.5f * eps * precond * gg + sigma * eta);
  } else if constexpr (kRule == kRsghmc) {
    // the dynamics use the log-likelihood gradient, -gg; the velocity is
    // eps p / m / sqrt(p^2 / (m^2 c^2) + 1)
    const float pv = load<kMixed>(e.v, i, a.v_bf16);
    const float vel = eps * pv * a.c2 * rsqrtf(pv * pv * a.c3 + 1.0f);
    const float pn = pv + eps * -gg + chain_sigma * eta - a.coef * vel;
    store<kMixed>(e.v_out, i, a.v_bf16, pn);
    e.theta_out[i] = th + eps * pn * a.c2 * rsqrtf(pn * pn * a.c3 + 1.0f);
  } else {  // kSgnht
    const float pv = load<kMixed>(e.v, i, a.v_bf16);
    const float pn = pv - xi * eps * pv - eps * gg + chain_sigma * eta;
    store<kMixed>(e.v_out, i, a.v_bf16, pn);
    e.theta_out[i] = th + eps * pn;
  }
}

// The body of every instantiation; the two entries below differ only in
// their launch bounds.
template <int kRule, bool kBurnin, bool kMixed, int kLayout>
__device__ __forceinline__ void slim_body(const Args& a) {
  constexpr int kRounds = rounds_of<kBurnin, kLayout>();
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
    if constexpr (kRounds == 1) {
      // a column a thread, which draws its own normal
      int leaf = 0;  // kTree: the leaf of column p
      for (int p = blockIdx.x * kThreads + threadIdx.x; p < P;
           p += gridDim.x * kThreads) {
        const Element e = element_of<kLayout>(a, c, base, p, leaf);
        const float eta = e.noise != nullptr
                              ? e.noise[e.i]
                              : philox_normal(a.seed, static_cast<unsigned>(c),
                                              a.step, e.col);
        update_element<kRule, kBurnin, kMixed, kLayout>(a, e, p, eps,
                                                        chain_sigma, xi, eta);
      }
    } else {
      // 128 columns a warp a pass: one draw a lane from the first column's
      // element on (the stream's elements 4 q0 .. 4 q0 + 127), staged in
      // shared memory
      __shared__ float4 stage_all[kThreads / 32][32];
      float4* stage = stage_all[threadIdx.x / 32];
      const float* stage_f = reinterpret_cast<const float*>(stage);
      const int lane = threadIdx.x & 31;
      int leaf = 0;
      for (int p0 = (blockIdx.x * kThreads + (threadIdx.x & ~31)) * kRounds;
           p0 < P; p0 += gridDim.x * kThreads * kRounds) {
        const unsigned q0 =
            (kLayout == kMasked && a.noise_index != nullptr
                 ? static_cast<unsigned>(a.noise_index[p0])
                 : static_cast<unsigned>(p0)) >> 2;
        if (a.noise == nullptr)
          stage[lane] = philox_normal_quad(a.seed, static_cast<unsigned>(c),
                                           a.step, q0 + lane);
        __syncwarp();
        for (int round = 0; round < kRounds; ++round) {
          const int p = p0 + 32 * round + lane;
          if (p >= P) continue;
          const Element e = element_of<kLayout>(a, c, base, p, leaf);
          // staged, or (a masked column whose element lies elsewhere:
          // another leaf's, the padding's) drawn alone
          const unsigned k = e.col - 4u * q0;
          const float eta =
              e.noise != nullptr
                  ? e.noise[e.i]
                  : k < 128u ? stage_f[k]
                             : philox_normal(a.seed, static_cast<unsigned>(c),
                                             a.step, e.col);
          update_element<kRule, kBurnin, kMixed, kLayout>(
              a, e, p, eps, chain_sigma, xi, eta);
        }
        __syncwarp();
      }
    }
  }
}

// The flat row (B7-B10) and B7 mask with an f32 gradient: ptxas's own
// register choice, which fits 8 blocks of kThreads an SM.  A minimum-blocks
// hint of 1 moved B7 from 29 to 40 registers and cost it 15 %.
template <int kRule, bool kBurnin, bool kMixed, int kLayout = kFlat>
__global__ void __launch_bounds__(kThreads) slim_kernel(Args a) {
  slim_body<kRule, kBurnin, kMixed, kLayout>(a);
}

// B7 mask with a bf16 gradient and B7', held to 8 resident blocks (at most
// 32 registers a thread): ptxas's own choice gave them 35 and 40
// registers, room for 6 blocks, and ran them 10-11 % slower.  B7 mask with
// an f32 gradient fits 8 blocks on its own choice (31 registers) and runs
// 1 % faster on it than hinted.
constexpr int kFullBlocks = 2048 / kThreads;

template <int kRule, bool kBurnin, bool kMixed, int kLayout>
__global__ void __launch_bounds__(kThreads, kFullBlocks)
    slim_kernel_full(Args a) {
  slim_body<kRule, kBurnin, kMixed, kLayout>(a);
}

template <int kRule, bool kBurnin, bool kMixed, int kLayout>
void start(const dim3& grid, cudaStream_t s, const Args& a) {
  if constexpr (kLayout == kFlat || (kLayout == kMasked && !kMixed))
    slim_kernel<kRule, kBurnin, kMixed, kLayout><<<grid, kThreads, 0, s>>>(a);
  else
    slim_kernel_full<kRule, kBurnin, kMixed, kLayout>
        <<<grid, kThreads, 0, s>>>(a);
}

template <int kRule, bool kBurnin, int kLayout = kFlat>
int launch(const Args& a, void* stream) {
  if (a.n_chains <= 0 || a.n_params <= 0) return 0;
  constexpr int kCols = kThreads * rounds_of<kBurnin, kLayout>();
  const int bx = std::min((a.n_params + kCols - 1) / kCols, kMaxBlocksX);
  const int by = std::min(a.n_chains, kMaxBlocksY);
  const dim3 grid(bx, by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kRule == kFusedSghmc) {  // B10 takes f32 operands only
    start<kRule, kBurnin, false, kLayout>(grid, s, a);
  } else if (a.v_bf16 || a.minv_bf16 || a.grad_bf16) {
    start<kRule, kBurnin, true, kLayout>(grid, s, a);
  } else {
    start<kRule, kBurnin, false, kLayout>(grid, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The flat entries' layout: B7 with a mask row takes the masked one (a null
// mask keeps B7's own instantiation); the others ignore mask and
// noise_index, which their wrappers refuse.
template <int kRule, bool kBurnin>
int dispatch(const Args& a, void* stream) {
  if constexpr (kRule == kSghmc && !kBurnin) {
    if (a.mask != nullptr) return launch<kRule, kBurnin, kMasked>(a, stream);
  }
  return launch<kRule, kBurnin>(a, stream);
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
            const float* mask, const int* noise_index, int burning_in,      \
            void* stream) {                                                 \
    const Args a = {theta,     v,         minv,     tau,      g,            \
                    v_hat,     grad,      xi,       eps_vec,  noise,        \
                    theta_out, v_out,     tau_out,  g_out,    v_hat_out,    \
                    minv_out,  n_chains,  n_params, seed,     step,         \
                    eps,       sqrt_sg,   coef,     cdiv,     c2,           \
                    c3,        prior_scale, v_bf16, minv_bf16, grad_bf16,   \
                    mask,      noise_index, burning_in, nullptr, 0};        \
    return dispatch<rule, burnin>(a, stream);                               \
  }

// B7: SGHMC sampling update with a frozen minv; B7 mask with a mask row
// (and, optionally, each column's noise element).
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
// B10: FusedSGHMC's step; the EMAs every step, minv_out gets the minv used
// (the fresh one where burning_in, else the given minv).
SLIM_ENTRY(fused_sghmc_update_launch, kFusedSghmc, true)

// B7': B7 over every leaf of a stacked tree in one launch.  `leaves` is a
// device table of n_leaves Leaf entries (void here: Leaf is internal to
// this file) whose columns tile [0, n_params) in order; the scalars are
// B7's.
int slim_sghmc_update_tree_launch(const void* leaves, int n_leaves,
                                  int n_chains, int n_params,
                                  unsigned long long seed, unsigned step,
                                  float eps, float sqrt_sg, float mdecay,
                                  float prior_scale, int grad_bf16,
                                  void* stream) {
  Args a = {};
  a.n_chains = n_chains;
  a.n_params = n_params;
  a.seed = seed;
  a.step = step;
  a.eps = eps;
  a.sqrt_sg = sqrt_sg;
  a.coef = mdecay;
  a.prior_scale = prior_scale;
  a.grad_bf16 = grad_bf16;
  a.leaves = static_cast<const Leaf*>(leaves);
  a.n_leaves = n_leaves;
  return launch<kSghmc, false, kTree>(a, stream);
}

}  // extern "C"
