// flash-SGHMC, flash-SGLD, pSGLD, SGNHT and relativistic SGHMC for Hopper:
// whole SG-MCMC steps of the dense tanh BNN per launch.
//
// Replaces the TPU Pallas kernels of pysgmcmc_tpu/ops/fused_step.py
//   B1        fused_bnn_multistep              k SGHMC sampling steps
//   B2        fused_bnn_multistep_burnin       k SGHMC self-tuning burn-in steps
//   B3        fused_bnn_step                   one SGHMC step, gathered minibatch
//   B4-sgld   fused_bnn_step_sgld              one SGLD step, gathered minibatch
//   B4-psgld  fused_bnn_step_psgld             one pSGLD step, gathered minibatch
//   B4-sgnht  fused_bnn_step_sgnht             one SGNHT step, gathered minibatch
//   B4-rsghmc fused_bnn_step_rsghmc            one relativistic SGHMC step, ditto
//   B5-sgld   fused_bnn_multistep_sgld         k SGLD sampling steps
//   B5-psgld  fused_bnn_multistep_psgld        k pSGLD steps
//   B5-sgnht  fused_bnn_multistep_sgnht        k SGNHT steps
//   B5-rsghmc fused_bnn_multistep_rsghmc       k relativistic SGHMC steps
//   B6        fused_bnn_multistep_burnin_sgld  k SGLD burn-in steps
// (generators _make_kernel_family, _make_multistep_kernel_family and
// _make_multistep_kernel_burnin) with the same semantics at the
// unpacked-parameter level: per step, take the chain's minibatch (a window
// drawn from the shared window table, or the rows the caller gathered), run
// the forward pass, the heteroscedastic Gaussian NLL plus the log-variance
// prior, the hand-written backward pass, fold the Gaussian weight prior into
// the gradient, draw the noise and apply the rule's update (JAX's
// _sghmc_rule, _sgld_rule, _psgld_rule, _sgnht_rule, _rsghmc_rule).
// Sampling phase: frozen minv.  Burn-in: the tau/g/v_hat EMAs and minv =
// 1/sqrt(old v_hat), all reading OLD values.  SGHMC moves v then theta; SGLD
// moves theta alone, with noise sqrt(2 eps minv A / scale_grad), i.e.
// scaling with eps.  pSGLD, SGNHT and relativistic SGHMC have no mass matrix
// and no burn-in phase: pSGLD adapts its RMSprop accumulator every step,
// SGNHT moves its per-chain thermostat xi by eps (p'^T p' / P - 1) after
// every element has read the old xi, and relativistic SGHMC moves theta by
// the relativistic velocity of the new momentum.  The TPU kernels' validity
// masks mark the padding of its slab layout; the flat layout has none.
//
// Design.  One kernel body, templated on the rule, the phase (sampling /
// burn-in) and the minibatch source (window table / gathered rows), as JAX's
// KernelRule.  One thread block of 256 threads owns one chain.  At launch it
// loads the chain's theta, then v for SGHMC, the accumulator or momentum
// for pSGLD, SGNHT and relativistic SGHMC, then minv (sampling) plus a
// gradient buffer into dynamic shared memory, runs the k steps there and
// writes the state back once: the counterpart of the TPU kernel's VMEM
// residency.  The burn-in's tau, g and v_hat are touched once a step, by
// the update alone, element by element: they stay in the caller's output
// arrays in device memory (copied there from the inputs at launch; the
// chains in flight keep their working set in L2), so that B2 needs 87,544
// bytes of shared memory at the flagship (3x50, batch 20) instead of 146
// KB, and two blocks of 8 warps fit an SM, as B1's 108,552.  SGNHT's
// p'^T p' is a block reduction each step (warp shuffles, then one partial
// sum per warp in shared memory), summed in another order than torch.sum;
// no barrier of its own: every thread forms the new thermostat itself from
// the eight partials after the next barrier that stands anyway (the next
// step's first, or the one before the launch stores its state).
//
// The six batch x H x H products of a step (two forward layers, two weight
// gradients and two backward products at depth 3) run on the tensor cores
// (tc_product: 3xTF32 mma.sync m16n8k8 through tf32.cuh, as the SVGD
// transport's).  Register tiles on the CUDA cores were bound by shared
// memory (each operand loaded fed one FMA, and an SM reads 32 words a clock
// but issues 128 FMAs): the products were 44 % of B1 and B5-sgld.  What
// bounds the tensor-core products instead is the instructions around each
// mma (the loads, the hi / lo split of every operand, the addresses), so
// the design spends as few as it can: operand order pads least (the
// forward and backward products run transposed, an (H, batch) output, so
// that the batch sits on the 8-wide side of a tile: 20 -> 24, H = 50 ->
// 64 rows; the weight gradients are (H + 1) x H with the batch as their
// depth); a job of a forward or backward product is 16 x 24 outputs (4
// jobs at H = 50, batch 20); in the sampling and one-step kernels a
// forward product splits each job's depth across a pair of warps
// (tc_product_split: each warp sums half of the
// k-steps, 4 and 3 of 7 at H = 50, and the pair adds the two partial tiles
// through shared memory before the epilogue), so that it runs on all 8
// warps: on 4, with the other 4 waiting at the barrier, a forward phase was
// bound by latency (3.9 K cycles, PERF.md §6; the burn-in kernels keep a
// warp a job, fwd_bwd); a backward product's jobs
// run on 4 warps beside the weight gradient's 8 jobs of 32 x 16 outputs
// (split as the forward ones, they gained nothing measurable and needed
// shared memory of their own); each operand a warp splits feeds 2 or 3
// tiles; the split is integer arithmetic (split_finite, 3 instructions);
// the depth pads with the zeros the activations and gradients keep past
// their last column and row, so only the last k-step of a product clamps
// an index and no branch guards an mma; and every k-step's three passes
// form one chain of tensor-core sums from 0, added to f32 running sums by
// FADDs (chained
// over k-steps, the tensor core's truncating sums flipped bf16 roundings
// of the momentum several times as often as the plain version's: PERF.md
// §6).  The rows of the activations and gradients are act_stride(H)
// words apart (56 at H = 50), which puts a warp's fragment loads of them
// on 32 banks.  The layers whose depth is the input width (layer 1's
// forward product and weight gradient, the latter one output a thread) and
// the head stay on the CUDA cores.  Each activation row carries a trailing
// 1, so a layer's bias is one more row of its weight matrix (the flat
// layout stores b_l right after w_l): the forward product adds the bias and
// the weight-gradient product yields the bias gradient, in the same pass.
// The head and the likelihood run on one warp, each backward layer's weight
// gradient beside the previous layer's pre-activation gradient (two
// buffers in turn), and every thread that copies the minibatch finds its
// window itself: nine barriers a step at depth 3.  The update is
// elementwise f32 on the CUDA cores, with cheaper forms where no check
// resolves a difference: Box-Muller's four normals of a draw
// (philox_normal_quad, one draw a lane for four consecutive elements,
// staged in shared memory for the warp's element loop) by the fast sine
// and cosine of an argument in (-pi, pi] and the root by sqrt_approx
// (philox.cuh's box_muller), the sampling rules' noise scales by
// sqrt_approx; and the CLT's groups run two at a time where both are
// pairs of matrix slabs (for_each_clt_eta, multi-step sampling kernels).
// The
// one-step kernels (B3, B4-*) load and store the whole state every step: at
// the flagship (8192 chains x 5,252 parameters) B4-psgld, B4-sgnht and
// B4-rsghmc read theta and one state array and write both, 0.69 GB, 0.205
// ms at 3.35 TB/s.
//
// bf16 state (JAX's state_dtype=jnp.bfloat16).  The momentum (SGHMC,
// SGNHT, relativistic SGHMC) or accumulator (pSGLD) may be stored as bf16,
// and so may the frozen minv of SGHMC and SGLD; the flags v_bf16 and
// minv_bf16 say which, per launch: one body serves both types, v's as a
// template parameter (its rounding sits in every step's update), minv's
// read at run time (once per launch).  The
// working copy stays f32 in the block's state.  As the TPU kernels, which
// write the aux state back to its bf16 ref after every inner step, the
// kernel rounds the new momentum to bf16 (round to nearest even) after each
// step's update, while theta moves by the unrounded value and SGNHT's
// p'^T p' sums the unrounded values: two launches of k steps equal one of
// 2k.  minv is read once (its bf16 values are exact in f32).
//
// Placement.  A chain's P-long arrays (theta, the aux state, the gradient,
// minv) live in the block's shared memory when they fit
// (fused_step_smem_bytes <= 232,448 bytes).  A wider network (JAX's fused
// path takes hidden widths up to 114, where theta alone is 104 KB at depth
// 3) runs the same body, instantiated with kDevice, with those arrays in a
// per-chain workspace in device memory that the wrapper allocates
// (Args::work); the activations and the scalars stay in shared memory.
// The choice depends on the count alone and is made by the wrapper before
// the launch.  In device memory
// every product reads its weights through L1/L2: such launches are several
// times their operation bound (a cluster design is later work).
//
// The layout is the port's flat per-chain vector (pysgmcmc_tpu_torch/ops/
// fused_step.py, FusedLayout):
//   w1 (k*H) | b1 (H) | w2 (H*H) | b2 (H) | ... | wD (H*H) | bD (H)
//   | w_head (H) | b_head (1) | log_variance_bias (1)
// Weight matrices are row-major (in, out).
//
// Randomness is the Philox4x32-10 stream of philox.cuh, keyed by the 64-bit
// seed with the counter (chain, absolute step, draw, purpose), so neither
// the block shape nor the chunking of launches changes a trajectory; a
// Box-Muller draw gives the normals of four consecutive elements (element
// e reads draw e / 4), and the plain PyTorch version implements the same
// stream.
//
// Three variants of every kernel, one per source that includes this header
// (FUSED_STEP_VARIANT, set before the include), each a shared library with
// a plain C interface, one entry per TPU kernel that returns
// cudaGetLastError() after its launch:
//   fused_step.cu         Box-Muller normals, four per Philox draw.
//   fused_step_clt.cu     the MXU-CLT generator (JAX's _normal_clt, its
//                         default on the chip): normals of groups of n
//                         uniforms, z = bf16(u - 1/2) H_n sqrt(12 / n) with
//                         H_n the +-1 Sylvester-Hadamard matrix, n = 2s for
//                         each pair of matrix slabs and s for an odd last
//                         matrix and the vector rows, in the geometry of
//                         JAX's _block_etas (s = 64, or 128 above H = 50).
//                         One warp owns a group: each lane draws one Philox
//                         word per value it holds, the transform runs as a
//                         fast Walsh-Hadamard transform (its first log2(32)
//                         stages across lanes by shuffles, the rest in
//                         registers), and each normal feeds the update of
//                         its element at once; dead slots draw and mix but
//                         update nothing.  No buffer: the placement and the
//                         shared memory are those of Box-Muller.
//   fused_step_paired.cu  Box-Muller, with JAX's pair_dots rounding: under
//                         bf16 state the matrix slabs' momentum (w2, b2, ...,
//                         wD, bD) stays f32 for the whole launch and rounds
//                         to bf16 once, at its end; the vector rows round
//                         every step.  The TPU's block-diagonal chain pairs
//                         are an MXU layout; one block still owns one chain,
//                         and each normal and window is keyed as unpaired,
//                         so at f32 state the paired kernels equal the
//                         unpaired ones bit for bit.  State in shared memory
//                         only (JAX's pairing takes H <= 50 at depth 3).
// Each source compiles in three parts at once (FUSED_PART, set by the
// build: 0 the SGHMC entries, 1 SGLD's and pSGLD's, 2 SGNHT's and
// relativistic SGHMC's), linked into one library: ptxas on the tensor-core
// body takes most of a build, and one nvcc for a whole source took 110 s.
// Unset, one compile holds every entry.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "tf32.cuh"

#ifndef FUSED_STEP_VARIANT
#define FUSED_STEP_VARIANT 0
#endif
#ifndef FUSED_PART
#define FUSED_PART -1
#endif
// whether this compile holds the entries of part i
#define FUSED_PART_HAS(i) (FUSED_PART < 0 || FUSED_PART == (i))

namespace {

enum Variant { kBoxMuller = 0, kClt = 1, kPairedBm = 2 };
constexpr int kVariant = FUSED_STEP_VARIANT;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLogMeanPrior = -13.815510557964274f;  // log(1e-6)
constexpr float kVarPrior = 0.01f;
constexpr float kHalfLogVarPrior = -2.302585092994046f;  // 0.5 * log(0.01)
constexpr float kSmall = 1e-16f;

// The kernels, numbered as the TPU kernels they replace (ROADMAP.md queue B).
enum KernelId {
  kB1 = 1, kB2, kB3, kB4Sgld, kB5Sgld, kB6,
  kB4Psgld, kB4Sgnht, kB4Rsghmc, kB5Psgld, kB5Sgnht, kB5Rsghmc
};
// numbered as the rules of slim_update.cu
enum Rule { kSghmc = 0, kSgld = 1, kPsgld = 2, kRsghmc = 3, kSgnht = 4 };

struct Args {
  const float* theta;
  const void* v;       // SGHMC momentum, pSGLD accumulator, SGNHT and
                       // relativistic SGHMC momentum: f32, or bf16 where
                       // v_bf16
  const void* minv;    // SGHMC / SGLD sampling phase only: f32, or bf16
                       // where minv_bf16
  const float* tau;    // burn-in only
  const float* g;      // burn-in only
  const float* v_hat;  // burn-in only
  // window tables (n_windows, batch, n_inputs) and (n_windows, batch), or
  // for the one-step kernels each chain's rows (n_chains, batch, n_inputs)
  // and (n_chains, batch)
  const float* x_win;
  const float* y_win;
  // per-step table: SGHMC (k_steps, 2) = eps, eps / sqrt(scale_grad);
  // SGLD and pSGLD (k_steps,) = eps; SGNHT (k_steps, 2) = eps,
  // sqrt(max(2 A eps / scale_grad, 0)); relativistic SGHMC (k_steps, 2) =
  // eps, sqrt(max(eps (2 D - eps Bhat), 0))
  const float* tab;
  const float* noise;  // optional (k_steps, n_chains, n_params)
  const int* widx;     // optional (k_steps, n_chains)
  float* theta_out;
  void* v_out;         // the rules with a v, in v's type
  float* tau_out;      // burn-in only
  float* g_out;        // burn-in only
  float* v_hat_out;    // burn-in only
  float* minv_out;     // burn-in only: the minv the final step used
  float* cost_out;     // (n_chains,): the final step's cost
  int n_chains, n_inputs, hidden, depth, batch, n_windows, k_steps, n_params;
  unsigned long long seed;
  unsigned step0;
  // The rule's constants, computed on the host in f32:
  //   SGHMC   coef = mdecay
  //   SGLD    coef = A, cdiv = A / scale_grad in sampling, sg_safe =
  //           scale_grad + 2 sign(scale_grad) 1e-16 + 1e-16 in burn-in
  //   pSGLD   coef = alpha, cdiv = lambda, c2 = 1 / scale_grad
  //   SGNHT   c2 = 1 / P
  //   RSGHMC  coef = D, c2 = 1 / m, c3 = 1 / (m^2 c^2)
  float coef, cdiv, prior_scale, inv_b, inv_n;
  // The fields of pSGLD, SGNHT and relativistic SGHMC come last, so that
  // the others keep their parameter offsets (and the compiler its register
  // allocation of B1-B6).
  float c2, c3;
  const float* xi;     // SGNHT only: (n_chains,) thermostat
  float* xi_out;       // SGNHT only
  // bf16 state and device-memory placement come last for the same reason.
  int v_bf16, minv_bf16;  // v (and v_out) / minv stored as bf16
  float* work;  // nullptr: the state in shared memory; else (n_chains,
                // state_arrays, P) f32 in device memory
};

// The sampling rules' noise scales take sqrt_approx (philox.cuh).  The
// burn-in's own roots (minv and the noise scale) keep sqrtf: there a bf16
// momentum check resolved it, and the burned-in states (the checks'
// starting points) move with every rounding.

// bf16 storage of the aux state: values rounded to nearest even, arithmetic
// in f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_state(const void* p, size_t i,
                                            int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}


__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Row stride (words) of the activation and pre-activation-gradient rows in
// shared memory: hidden + 1 (the trailing 1 column) rounded up to a
// multiple of 8, so that the products' depth pads to whole k-steps inside
// the row (tc_product), and 8 or 24 modulo 32, so that a warp's fragment
// loads hit 32 distinct banks: 4 words of each of 8 rows, or a float2 of
// each of 4 rows per half-warp.
__host__ __device__ constexpr int act_stride(int hidden) {
  return (hidden + 8) / 8 * 8 + ((hidden + 8) / 8 % 2 == 0 ? 8 : 0);
}

// Rows of a pre-activation gradient in shared memory: the batch rounded up
// to a multiple of 8 (zero rows past it pad the weight gradients' depth).
__host__ __device__ constexpr int grad_rows(int batch) {
  return (batch + 7) / 8 * 8;
}

// Offsets of the parameter groups in the flat per-chain vector.
struct Layout {
  int w1, b1, head_w, head_b, lvb;
  __device__ int w(int l, int hidden, int n_inputs) const {  // l = 2..depth
    return n_inputs * hidden + hidden + (l - 2) * (hidden * hidden + hidden);
  }
  __device__ int b(int l, int hidden, int n_inputs) const {
    return w(l, hidden, n_inputs) + hidden * hidden;
  }
};

__device__ Layout make_layout(int n_inputs, int hidden, int depth) {
  Layout L;
  L.w1 = 0;
  L.b1 = n_inputs * hidden;
  L.head_w = n_inputs * hidden + hidden + (depth - 1) * (hidden * hidden + hidden);
  L.head_b = L.head_w + hidden;
  L.lvb = L.head_b + 1;
  return L;
}

// Shared-memory scratch besides the state arrays.  Every activation row
// carries a trailing 1 (column hidden, or n_inputs for x), so that a layer's
// bias is one more row of its weight matrix: in the flat layout w_l (in x
// out) is followed by b_l, and the products below run over in + 1 rows.
// The activation and gradient rows are act_stride(hidden) words apart,
// with zeros past the 1 (and past the last column of a gradient), and a
// gradient has grad_rows(batch) rows, zeros past the batch: the
// tensor-core products pad their depth with them.  x's rows are n_inputs +
// 1 apart.
struct Scratch {
  float* act;    // depth x batch x act_stride: post-tanh activations, 1
  float* dz0;    // grad_rows x act_stride: a layer's pre-activation gradient,
  float* dz1;    // and the next one's (the backward pass alternates them)
  float* xchg;   // kXchgFloats from dz0 on (xchg_floats): the forward
                 // products' partial tiles (tc_product_split), then each
                 // warp's 128 staged Box-Muller normals in the update, while
                 // no gradient lives there; each user leaves zeros behind
  float* x;      // batch x (n_inputs + 1): the minibatch's inputs, 1
  float* y;      // batch
  float* dmean;  // batch
  float* scal;   // [0]: cost; SGNHT: [1 .. 1 + kWarps) the per-warp
                 // partial sums of p'^T p'
};

// out(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, summed in order of k
// by fmaf and handed to epi(m, n, out); A(m, k) = a[m * a_m + k * a_k],
// B(k, n) = b[k * b_k + n * b_n].  Register-tiled: a thread computes kTM
// consecutive rows by kTN columns ceil(N / kTN) apart (neighbouring threads
// on neighbouring columns), so each value it loads feeds kTN or kTM FMAs
// and its kTM x kTN sums are independent.
template <int kTM, int kTN, class Epi>
__device__ __forceinline__ void tiled_product(int M, int N, int Kd,
                                              const float* a, int a_m,
                                              int a_k, const float* b,
                                              int b_k, int b_n, Epi&& epi) {
  const int cols = (N + kTN - 1) / kTN;
  const int tiles = cols * ((M + kTM - 1) / kTM);
  for (int u = threadIdx.x; u < tiles; u += kThreads) {
    const int m0 = (u / cols) * kTM, n0 = u - (u / cols) * cols;
    int ao[kTM], bo[kTN];
#pragma unroll
    for (int r = 0; r < kTM; ++r) ao[r] = min(m0 + r, M - 1) * a_m;
#pragma unroll
    for (int c = 0; c < kTN; ++c) bo[c] = min(n0 + c * cols, N - 1) * b_n;
    float acc[kTM][kTN];
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < Kd; ++k) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int r = 0; r < kTM; ++r) av[r] = a[ao[r] + k * a_k];
#pragma unroll
      for (int c = 0; c < kTN; ++c) bv[c] = b[bo[c] + k * b_k];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c)
        if (m0 + r < M && n0 + c * cols < N) epi(m0 + r, n0 + c * cols, acc[r][c]);
  }
}

// Jobs of tc_product<kMT, kNT> for an M x N output.
__host__ __device__ constexpr int tc_jobs(int kMT, int kNT, int M, int N) {
  return ((M + 16 * kMT - 1) / (16 * kMT)) * ((N + 8 * kNT - 1) / (8 * kNT));
}

// One k-step of 8 of a tc_product job, added to run: the fragments' slots
// t and t + 4 hold k = kk + t and kk + t + 4, or with kPairK kk + 2 t and
// kk + 2 t + 1 (a bijection all the same, taken by both operands; B's two
// then lie side by side and load as one float2 where kBUnit).  The three
// passes (a_lo b_hi, a_hi b_lo, then a_hi b_hi) form one chain of sums from
// 0 in the tensor core, which aligns its terms to the largest and drops the
// bits below it; the chain's sum goes into the f32 running sums by FADDs,
// rounded to nearest.  kTail: the k-step reaches past Kd; A's k is clamped
// to Kd - 1 there, and B's values past Kd are the zeros of its padding.
// kAUnit / kBUnit: a_k / b_k is 1.
template <int kMT, int kNT, bool kPairK, bool kTail, bool kAUnit,
          bool kBUnit>
__device__ __forceinline__ void tc_kstep(float (&run)[kMT][kNT][4],
                                         const float* (&a_row)[kMT][2],
                                         const float* (&b_col)[kNT], int a_k,
                                         int b_k, int kk, int Kd) {
  const int t = threadIdx.x & 3;
  const int s0 = kk + (kPairK ? 2 * t : t);
  const int s1 = kk + (kPairK ? 2 * t + 1 : t + 4);
  const int ao0 = (kTail ? min(s0, Kd - 1) : s0) * (kAUnit ? 1 : a_k);
  const int ao1 = (kTail ? min(s1, Kd - 1) : s1) * (kAUnit ? 1 : a_k);
  uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    split_finite(a_row[i][0][ao0], ah[i][0], al[i][0]);
    split_finite(a_row[i][1][ao0], ah[i][1], al[i][1]);
    split_finite(a_row[i][0][ao1], ah[i][2], al[i][2]);
    split_finite(a_row[i][1][ao1], ah[i][3], al[i][3]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    float b0, b1;
    if constexpr (kPairK && kBUnit) {
      const float2 v = *reinterpret_cast<const float2*>(b_col[j] + s0);
      b0 = v.x;
      b1 = v.y;
    } else {
      b0 = b_col[j][s0 * (kBUnit ? 1 : b_k)];
      b1 = b_col[j][s1 * (kBUnit ? 1 : b_k)];
    }
    split_finite(b0, bh[j][0], bl[j][0]);
    split_finite(b1, bh[j][1], bl[j][1]);
  }
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma(acc[i][j], al[i], bh[j]);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma(acc[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma(acc[i][j], ah[i], bh[j]);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[i][j][e] += acc[i][j][e];
}

// The running sums `run` of the job whose tiles start at row m0 and column
// n0, over k-steps k_lo .. k_hi - 1 of 8 (the last one the tail where Kd is
// not a multiple of 8), each summed from 0 in f32.
template <int kMT, int kNT, bool kPairK, bool kAUnit, bool kBUnit>
__device__ __forceinline__ void tc_job_sum(float (&run)[kMT][kNT][4], int N,
                                           int Kd, const float* a, int a_m,
                                           int a_k, const float* b, int b_k,
                                           int b_n, int m0, int n0, int k_lo,
                                           int k_hi) {
  const int g = (threadIdx.x & 31) >> 2;
  const float* a_row[kMT][2];
  const float* b_col[kNT];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a_row[i][r] = a + (m0 + 16 * i + 8 * r + g) * a_m;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    b_col[j] = b + min(n0 + 8 * j + g, N - 1) * b_n;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[i][j][e] = 0.0f;
  const int n_full = Kd / 8;
  for (int ks = k_lo; ks < min(k_hi, n_full); ++ks)
    tc_kstep<kMT, kNT, kPairK, false, kAUnit, kBUnit>(run, a_row, b_col, a_k,
                                                      b_k, 8 * ks, Kd);
  if (n_full >= k_lo && n_full < k_hi)  // the tail k-step
    tc_kstep<kMT, kNT, kPairK, true, kAUnit, kBUnit>(run, a_row, b_col, a_k,
                                                     b_k, 8 * n_full, Kd);
}

// out(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, at f32 accuracy on
// the tensor cores (3xTF32 mma.sync m16n8k8, tf32.cuh), handed to epi(m, n,
// out); A(m, k) = a[m * a_m + k * a_k], B(k, n) = b[k * b_k + n * b_n].  A
// job is kMT 16-row tiles by kNT 8-column tiles; the jobs are dealt to the
// warps in turn, job j to warp (j + first) % kWarps (so that two products
// between the same barriers share the warps out).  Every tile of a job is
// computed, and no branch stands between a warp and its mma: rows past M
// read on past the operand (the rows that follow it in the chain's arrays
// or the scratch: A's row stride is H or 1, and its rows end within 16 H
// of the last real one), columns past N read column N - 1, and neither is
// handed on.
// The depth is padded to a multiple of 8 by B's own zeros: B(k, n) for Kd
// <= k < Kd rounded up to 8 must read 0 (the activations and gradients
// keep zeroed padding for it), while A's k is clamped to Kd - 1 (a value
// of the operand itself, so nothing past it is read).  No chain of
// tensor-core sums is longer than one k-step's three passes (tc_kstep):
// chained over k-steps, the tensor core's truncating sums flip bf16
// roundings of the momentum several times as often as f32 sums do.
template <int kMT, int kNT, bool kPairK, bool kAUnit, bool kBUnit,
          class Epi>
__device__ __forceinline__ void tc_product(int M, int N, int Kd,
                                           const float* a, int a_m, int a_k,
                                           const float* b, int b_k, int b_n,
                                           int first, Epi&& epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_groups = (N + 8 * kNT - 1) / (8 * kNT);
  const int jobs = tc_jobs(kMT, kNT, M, N);
  for (int job = (threadIdx.x / 32 + kWarps - first % kWarps) % kWarps;
       job < jobs; job += kWarps) {
    const int m0 = (job / n_groups) * 16 * kMT;
    const int n0 = (job - (job / n_groups) * n_groups) * 8 * kNT;
    float run[kMT][kNT][4];
    tc_job_sum<kMT, kNT, kPairK, kAUnit, kBUnit>(
        run, N, Kd, a, a_m, a_k, b, b_k, b_n, m0, n0, 0, (Kd + 7) / 8);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 16 * i + g + 8 * (e >> 1);
          const int n = n0 + 8 * j + 2 * t + (e & 1);
          if (m < M && n < N) epi(m, n, run[i][j][e]);
        }
      }
    }
  }
}

// A barrier of the two warps of pair `pair` (named barriers 1 .. kWarps / 2;
// __syncthreads is barrier 0).
__device__ __forceinline__ void pair_barrier(int pair) {
  asm volatile("bar.sync %0, 64;" ::"r"(pair + 1) : "memory");
}

// Floats of Scratch::xchg: a warp's half of a split job's partial tile
// (tc_product_split<1, 3>: 6 values a lane), or its 128 staged normals.
constexpr int kXchgFloats = kWarps * 32 * 6;

// tc_product with each job's depth split across a pair of warps, so that a
// product of kWarps / 2 jobs runs on every warp: warps w and w + kWarps / 2
// share job j (the jobs dealt to the pairs in turn), the first summing the
// first half of the k-steps, the second the rest (the tail among them), each
// from 0 in f32 as tc_product's one warp does.  Each warp finishes half of
// the tile, rows g (first warp) or g + 8 (second) of every 16-row tile: it
// hands the other half of its partial to the other warp through xchg
// (kWarps x 32 x 2 kMT kNT floats), meets it at a barrier of the pair, and
// adds the other's partial of its own half, first half + second half,
// zeroing the slots it read.
template <int kMT, int kNT, bool kPairK, bool kAUnit, bool kBUnit,
          class Epi>
__device__ __forceinline__ void tc_product_split(int M, int N, int Kd,
                                                 const float* a, int a_m,
                                                 int a_k, const float* b,
                                                 int b_k, int b_n, float* xchg,
                                                 Epi&& epi) {
  constexpr int kPairs = kWarps / 2;
  constexpr int kSend = 2 * kMT * kNT;  // values a lane hands on
  static_assert(kWarps * 32 * kSend <= kXchgFloats, "xchg too small");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x / 32, pair = warp % kPairs;
  const int half = warp / kPairs;
  const int n_groups = (N + 8 * kNT - 1) / (8 * kNT);
  const int jobs = tc_jobs(kMT, kNT, M, N);
  const int n_steps = (Kd + 7) / 8;
  const int k_lo = half ? (n_steps + 1) / 2 : 0;
  const int k_hi = half ? n_steps : (n_steps + 1) / 2;
  float* mine = xchg + (2 * pair + half) * 32 * kSend + lane;
  float* theirs = xchg + (2 * pair + 1 - half) * 32 * kSend + lane;
  for (int job = pair; job < jobs; job += kPairs) {
    const int m0 = (job / n_groups) * 16 * kMT;
    const int n0 = (job - (job / n_groups) * n_groups) * 8 * kNT;
    float run[kMT][kNT][4];
    tc_job_sum<kMT, kNT, kPairK, kAUnit, kBUnit>(
        run, N, Kd, a, a_m, a_k, b, b_k, b_n, m0, n0, k_lo, k_hi);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          mine[32 * ((i * kNT + j) * 2 + c)] =
              half ? run[i][j][c] : run[i][j][2 + c];
    pair_barrier(pair);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& slot = theirs[32 * ((i * kNT + j) * 2 + c)];
          const float other = slot;
          slot = 0.0f;  // xchg holds zeros between its uses
          const float own = half ? run[i][j][2 + c] : run[i][j][c];
          const int m = m0 + 16 * i + g + 8 * half;
          const int n = n0 + 8 * j + 2 * t + c;
          if (m < M && n < N) epi(m, n, half ? other + own : own + other);
        }
      }
    }
    // the next job's partials overwrite xchg once both have read it
    if (job + kPairs < jobs) pair_barrier(pair);
  }
}

// Forward, likelihood and backward for the chain whose parameters are in
// `th`; writes the likelihood gradient (without the weight prior) to `grad`
// and the cost to s.scal[0].  Ends with a barrier.  Eight barriers at depth
// 3: one after each layer, after the head and likelihood (warp 0), after
// the head's gradient, after each hidden layer's backward phase (its weight
// and bias gradient beside the previous layer's pre-activation gradient)
// and after layer 1's gradient.  The hidden layers' products run on the
// tensor cores (tc_product), in both placements; with kSplit the forward
// ones split each job's depth across a warp pair (tc_product_split).  The
// burn-in kernels keep a warp a job: their outputs are the states that
// every check of chip_smoke.py starts from, and with the split's order of
// sums the CLT-burned SGLD state amplified a 1e-7 nudge of theta to 6.5e-4
// of a row over 16 plain SGLD steps on the CLT stream (H100, PERF.md §6),
// beyond what that check resolves.
template <bool kSplit>
__device__ void fwd_bwd(const Args& a, const Layout& L, const float* th,
                        float* grad, const Scratch& s) {
  const int tid = threadIdx.x;
  const int H = a.hidden, K = a.n_inputs, B = a.batch, D = a.depth;
  const int SA = act_stride(H), SX = K + 1;  // row strides
  const int BA = B * SA;

  // layer 1: tanh([x 1] [w1; b1])
  tiled_product<2, 2>(B, H, K + 1, s.x, SX, 1, th + L.w1, H, 1,
                      [&](int b, int j, float z) {
                        s.act[b * SA + j] = tanhf(z);
                      });
  __syncthreads();
  // hidden layers 2..D
  for (int l = 2; l <= D; ++l) {
    const float* a_in = s.act + (l - 2) * BA;
    float* a_out = s.act + (l - 1) * BA;
    // transposed, (j, b) = [w_l; b_l]^T [a 1]^T: the batch on the 8-wide
    // side pads least (20 -> 24, H = 50 -> 64); its 4 jobs on all 8 warps
    // (kSplit) or on 4
    const auto epi = [&](int j, int b, float z) {
      a_out[b * SA + j] = tanhf(z);
    };
    if constexpr (kSplit)
      tc_product_split<1, 3, true, false, true>(
          H, B, H + 1, th + L.w(l, H, K), 1, H, a_in, 1, SA, s.xchg, epi);
    else
      tc_product<1, 3, true, false, true>(H, B, H + 1, th + L.w(l, H, K), 1,
                                          H, a_in, 1, SA, 0, epi);
    __syncthreads();
  }
  const float* a_last = s.act + (D - 1) * BA;
  // mean head ([a 1] [w_head; b_head]), heteroscedastic likelihood and
  // log-variance prior: warp 0, a lane per batch row
  if (tid < 32) {
    const float lvb = th[L.lvb];
    const float e_lv = expf(lvb);
    const float var_inv = 1.0f / (e_lv + kSmall);
    float ll = 0.0f, dl = 0.0f;
    for (int b = tid; b < B; b += 32) {
      float f = 0.0f;
      for (int j = 0; j <= H; ++j)
        f = fmaf(a_last[b * SA + j], th[L.head_w + j], f);
      const float diff = f - s.y[b];
      const float mse = diff * diff;
      ll += -mse * (0.5f * var_inv) - 0.5f * lvb;
      dl += mse * (0.5f * e_lv) * (var_inv * var_inv) - 0.5f;
      s.dmean[b] = diff * var_inv * a.inv_b;
    }
    ll = warp_sum(ll);
    dl = warp_sum(dl);
    if (tid == 0) {
      const float dev = lvb - kLogMeanPrior;
      const float p_term = -(dev * dev) / (2.0f * kVarPrior) - kHalfLogVarPrior;
      s.scal[0] = -(ll * a.inv_b + p_term * a.inv_n);
      grad[L.lvb] = -dl * a.inv_b + dev / kVarPrior * a.inv_n;
    }
  }
  __syncthreads();
  // the head's weight and bias gradient (j = H: the 1 column), and the last
  // layer's pre-activation gradient
  for (int j = tid; j <= H; j += kThreads) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc = fmaf(a_last[b * SA + j], s.dmean[b], acc);
    grad[L.head_w + j] = acc;
  }
  for (int o = tid; o < B * H; o += kThreads) {
    const int b = o / H, j = o - b * H;
    const float act = a_last[b * SA + j];
    s.dz0[b * SA + j] = (s.dmean[b] * th[L.head_w + j]) * (1.0f - act * act);
  }
  __syncthreads();
  // hidden layers D..2: the weight and bias gradient ([a 1]^T dz, the bias
  // row after the matrix as in the layout) beside the backward product
  float* dz = s.dz0;
  float* dz_prev = s.dz1;
  for (int l = D; l >= 2; --l) {
    const float* a_in = s.act + (l - 2) * BA;
    const float* w = th + L.w(l, H, K);
    float* gw = grad + L.w(l, H, K);
    // the backward product transposed, (i, b) = w_l dz^T, then the weight
    // gradient on the warps after its jobs
    tc_product<1, 3, true, true, true>(
        H, B, H, w, H, 1, dz, 1, SA, 0, [&](int i, int b, float acc) {
          const float act = a_in[b * SA + i];
          dz_prev[b * SA + i] = acc * (1.0f - act * act);
        });
    tc_product<2, 2, false, false, false>(
        H + 1, H, B, a_in, 1, SA, dz, SA, 1, tc_jobs(1, 3, H, B),
        [&](int i, int j, float acc) { gw[i * H + j] = acc; });
    __syncthreads();
    float* done = dz;
    dz = dz_prev;
    dz_prev = done;
  }
  // layer 1's weight and bias gradient: (K + 1) x H outputs, one a thread
  tiled_product<1, 1>(K + 1, H, B, s.x, 1, SX, dz, SA, 1,
                      [&](int i, int j, float acc) {
                        grad[L.w1 + i * H + j] = acc;
                      });
  __syncthreads();
}

// Stages this step's minibatch rows in shared memory: the chain's own
// gathered rows, or a window drawn (or read from widx) from the shared table.
// Each thread that copies finds the window itself, so one barrier suffices;
// the previous step read x last before fwd_bwd's closing barrier.
template <bool kGathered>
__device__ void load_batch(const Args& a, int t, unsigned step,
                           const Scratch& s) {
  const int c = blockIdx.x;
  const int K = a.n_inputs, bk = a.batch * K;
  if (threadIdx.x < max(bk, a.batch)) {
    int row = c;
    if constexpr (!kGathered) {
      if (a.widx != nullptr) {
        row = a.widx[static_cast<size_t>(t) * a.n_chains + c];
      } else {
        const float u = bits_to_uniform(
            philox_draw(a.seed, c, step, 0u, kPurposeWindow).x);
        row = min(static_cast<int>(u * static_cast<float>(a.n_windows)),
                  a.n_windows - 1);
      }
    }
    for (int i = threadIdx.x; i < bk; i += kThreads)
      s.x[(i / K) * (K + 1) + i % K] =
          a.x_win[static_cast<size_t>(row) * bk + i];
    for (int i = threadIdx.x; i < a.batch; i += kThreads)
      s.y[i] = a.y_win[static_cast<size_t>(row) * a.batch + i];
  }
  __syncthreads();
}

// Elements each warp updates in a round of the Box-Muller loop, `rest` of
// them left: 128 (one draw a lane), and in the last round a multiple of 4
// that spreads the rest over all the warps.
__device__ __forceinline__ int box_muller_width(int rest) {
  return min(128, ((rest + kWarps - 1) / kWarps + 3) / 4 * 4);
}

// ---- the MXU-CLT generator (kClt) -----------------------------------------
//
// Slots, JAX's _block_etas: the matrix slabs in pairs, each pair an (s, 2s)
// array whose lanes 0:s are the first matrix and s:2s the second, an odd
// last matrix (s, s), then the 8 vector rows (8, s), numbered row by row in
// that order.  In a matrix slab, row r < H is w[r, :] and the bias rides row
// 50 (114 where s = 128); lanes >= H are dead.  The vector rows are w1
// (n_inputs rows), b1, w_head, then b_head and lvb at lanes 0 and 1.  A
// group is one row: its n uniforms are the words of the n / 4 Philox draws
// at elements slot / 4 + e (slot the group's first), word w giving lane
// w * n / 4 + e.  Only rows that hold values are drawn.

// One group: lane i < half is element base0 + i, lane half + i (a pair's
// second matrix) base1 + i, where i < lim; other lanes are dead (-1).
struct CltGroup {
  unsigned slot;
  int half, lim, base0, base1;
  __device__ __forceinline__ int element(int i) const {
    const bool second = i >= half;
    const int col = second ? i - half : i;
    if (col >= lim) return -1;
    return (second ? base1 : base0) + col;
  }
};

// Groups that hold values: H + 1 rows (0..H-1 and the bias row) of each
// matrix section, then n_inputs + 3 vector rows.
__device__ __forceinline__ int clt_groups(const Args& a) {
  const int n_mats = a.depth - 1;
  return (n_mats / 2 + n_mats % 2) * (a.hidden + 1) + a.n_inputs + 3;
}

// Group g of clt_groups in slot order, and its size n.
__device__ CltGroup clt_group(const Args& a, const Layout& L, int g, int s,
                              int& n) {
  const int H = a.hidden, K = a.n_inputs;
  const int n_mats = a.depth - 1, n_pairs = n_mats / 2;
  const int mat_groups = (n_pairs + n_mats % 2) * (H + 1);
  CltGroup G;
  G.half = s;
  G.base1 = 0;
  if (g < mat_groups) {
    const int sec = g / (H + 1), gi = g - sec * (H + 1);
    const int r = gi < H ? gi : (s == 64 ? 50 : 114);
    const bool pair = sec < n_pairs;
    const int l = pair ? 2 + 2 * sec : 1 + n_mats;  // w_l, the first matrix
    n = pair ? 2 * s : s;
    G.slot = static_cast<unsigned>(sec * 2 * s * s + r * n);
    G.lim = H;
    G.base0 = r < H ? L.w(l, H, K) + r * H : L.b(l, H, K);
    if (pair) G.base1 = r < H ? L.w(l + 1, H, K) + r * H : L.b(l + 1, H, K);
  } else {
    const int r = g - mat_groups;
    n = s;
    G.slot = static_cast<unsigned>(n_mats * s * s + r * s);
    G.lim = r == K + 2 ? 2 : H;  // b_head, lvb
    G.base0 = r < K ? L.w1 + r * H
                    : r == K ? L.b1 : r == K + 1 ? L.head_w : L.head_b;
  }
  return G;
}

// A uniform's input to the transform: u - 1/2 rounded to bf16 (to nearest
// even), as JAX's astype(bfloat16) of the MXU operand.
__device__ __forceinline__ float clt_input(unsigned bits) {
  // u - 1/2 = ((bits >> 8) + 1 - 2^23) 2^-24, exact as bits_to_uniform's
  // u and the subtraction are, one add fewer
  return round_bf16(
      static_cast<float>(static_cast<int>(bits >> 8) - 8388607) *
      (1.0f / 16777216.0f));
}

// The kN normals of group G at `step`, into x: lane l holds values 32 j +
// l (j < kN / 32).  The transform x H_n is a fast Walsh-Hadamard transform,
// stages of stride 1, 2, 4, ... in that order, each (a, b) -> (a + b, a -
// b): strides below 32 across lanes, the others in registers.
template <int kN>
__device__ __forceinline__ void clt_group_normals(const Args& a, unsigned step,
                                                  const CltGroup& G,
                                                  float (&x)[kN / 32]) {
  constexpr int kPer = kN / 32;
  const int lane = threadIdx.x & 31;
  const unsigned c = blockIdx.x, d0 = G.slot / 4;
  if constexpr (kN == 64) {  // lanes l and l + 16 share a draw
    const uint4 r = philox_draw(a.seed, c, step, d0 + (lane & 15),
                                kPurposeClt);
    const bool hi = lane >= 16;
    x[0] = clt_input(hi ? r.y : r.x);
    x[1] = clt_input(hi ? r.w : r.z);
  } else if constexpr (kN == 128) {
    const uint4 r = philox_draw(a.seed, c, step, d0 + lane, kPurposeClt);
    x[0] = clt_input(r.x);
    x[1] = clt_input(r.y);
    x[2] = clt_input(r.z);
    x[3] = clt_input(r.w);
  } else {  // kN == 256: two draws
    const uint4 r0 = philox_draw(a.seed, c, step, d0 + lane, kPurposeClt);
    const uint4 r1 =
        philox_draw(a.seed, c, step, d0 + 32 + lane, kPurposeClt);
    x[0] = clt_input(r0.x);
    x[1] = clt_input(r1.x);
    x[2] = clt_input(r0.y);
    x[3] = clt_input(r1.y);
    x[4] = clt_input(r0.z);
    x[5] = clt_input(r1.z);
    x[6] = clt_input(r0.w);
    x[7] = clt_input(r1.w);
  }
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float o = __shfl_xor_sync(0xffffffffu, x[j], h);
      x[j] = fmaf((lane & h) ? -1.0f : 1.0f, x[j], o);  // o - x or x + o
    }
  }
#pragma unroll
  for (int m = 1; m < kPer; m <<= 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!(j & m)) {
        const float lo = x[j], hi = x[j | m];
        x[j] = lo + hi;
        x[j | m] = lo - hi;
      }
    }
  }
  // sqrt(12 / kN) in f32
  constexpr float kScale = kN == 64    ? 0.4330127018922193f
                           : kN == 128 ? 0.30618621784789724f
                                       : 0.21650635094610965f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] *= kScale;
}

// Hands each normal x of group G to update(p, eta) for its element p.
template <int kN, class F>
__device__ __forceinline__ void clt_group_apply(const CltGroup& G,
                                                const float (&x)[kN / 32],
                                                F& update) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kN / 32; ++j) {
    const int p = G.element(32 * j + lane);
    if (p >= 0) update(p, x[j]);
  }
}

template <int kN, class F>
__device__ __forceinline__ void clt_group_update(const Args& a, unsigned step,
                                                 const CltGroup& G,
                                                 F& update) {
  float x[kN / 32];
  clt_group_normals<kN>(a, step, G, x);
  clt_group_apply<kN>(G, x, update);
}

// Calls update(p, eta) once for every element p of the block's chain, eta
// its CLT normal at `step`: one group per warp in turn, with kPairs two at
// a time where both are pairs of matrix slabs (their Philox draws and
// transforms side by side, then the updates in the order of the groups).
// The burn-in and one-step kernels take one group a warp-iteration: two
// groups' registers made them slower, and a loop over two groups inlines
// every group's code twice (B6's CLT kernel: 300 shuffles and 171 calls of
// the roots' and divisions' slow paths, against 160 and 87 in the earlier
// CUDA-core body, which took one group a warp-iteration; 5 % slower than
// this loop on an H100).
template <bool kPairs, class F>
__device__ __forceinline__ void for_each_clt_eta(const Args& a,
                                                 const Layout& L,
                                                 unsigned step, F&& update) {
  const int s = a.hidden <= 50 ? 64 : 128;
  const int n_groups = clt_groups(a);
  const auto one = [&](const CltGroup& G, int n) {
    if (n == 64)
      clt_group_update<64>(a, step, G, update);
    else if (n == 128)
      clt_group_update<128>(a, step, G, update);
    else
      clt_group_update<256>(a, step, G, update);
  };
  if constexpr (!kPairs) {
    for (int g = threadIdx.x / 32; g < n_groups; g += kWarps) {
      int n;
      const CltGroup G = clt_group(a, L, g, s, n);
      one(G, n);
    }
    return;
  }
  for (int g = threadIdx.x / 32; g < n_groups; g += 2 * kWarps) {
    int n0, n1 = 0;
    const CltGroup G0 = clt_group(a, L, g, s, n0);
    const bool second = g + kWarps < n_groups;
    CltGroup G1 = G0;
    if (second) G1 = clt_group(a, L, g + kWarps, s, n1);
    if (n1 == 2 * s && n0 == 2 * s) {
      if (s == 64) {
        float x0[4], x1[4];
        clt_group_normals<128>(a, step, G0, x0);
        clt_group_normals<128>(a, step, G1, x1);
        clt_group_apply<128>(G0, x0, update);
        clt_group_apply<128>(G1, x1, update);
      } else {
        float x0[8], x1[8];
        clt_group_normals<256>(a, step, G0, x0);
        clt_group_normals<256>(a, step, G1, x1);
        clt_group_apply<256>(G0, x0, update);
        clt_group_apply<256>(G1, x1, update);
      }
    } else {
      one(G0, n0);
      if (second) one(G1, n1);
    }
  }
}

// Whether element p's new momentum waits for the launch's end to be
// rounded to bf16: in the paired kernels, the matrix slabs' [lo, hi).
__device__ __forceinline__ bool deferred(int p, int lo, int hi) {
  return kVariant == kPairedBm && p >= lo && p < hi;
}

// The burn-in EMAs at element p, all reading OLD values (JAX
// _sghmc_burnin_step_math / _sgld_burnin_step_math); returns the minv this
// step uses, 1/sqrt(old v_hat) with the reference's guards.
__device__ __forceinline__ float adapt(float* s_tau, float* s_g, float* s_vhat,
                                       int p, float gg) {
  const float tau = s_tau[p], gm = s_g[p], vh = s_vhat[p];
  const float sq = sqrtf(fmaxf(vh, 0.0f));
  const float minv = 1.0f / (sq + 2.0f * sign_of(sq) * kSmall + kSmall);
  const float denom = vh + 2.0f * sign_of(vh) * kSmall + kSmall;
  const float r = 1.0f / (tau + 1.0f);
  s_tau[p] = tau + (-gm * gm * tau) / denom + 1.0f;
  s_g[p] = gm - r * gm + r * gg;
  s_vhat[p] = vh - r * vh + r * gg * gg;
  return minv;
}

// SGNHT's thermostat after a step of stepsize eps: xi + eps (p'^T p' / P -
// 1), p'^T p' the sum of the kWarps partials in warp order (c2 = 1 / P).
__device__ __forceinline__ float thermostat(float xi, float eps,
                                            const float* partial, float c2) {
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += partial[w];
  return xi + eps * (total * c2 - 1.0f);
}

// Number of P-long arrays a block keeps in shared memory (or its
// workspace): theta, v (all rules but SGLD), the gradient, then minv (SGHMC
// and SGLD sampling).  The burn-in's tau, g and v_hat are read and written
// once a step, element by element, by the update alone: they stay in the
// caller's output arrays in device memory (L2 holds the working set of the
// chains in flight), which halves B2's shared memory so that two blocks fit
// an SM.
__host__ __device__ constexpr int state_arrays(int rule, bool burnin) {
  return 1 + (rule == kSgld ? 0 : 1) + 1 +
         (!burnin && (rule == kSghmc || rule == kSgld) ? 1 : 0);
}

// Where the scratch starts after `floats` of resident state: on a 16-byte
// boundary, as the products' float2 loads of it need.
__host__ __device__ constexpr size_t scratch_offset(int floats) {
  return (static_cast<size_t>(floats) + 3) / 4 * 4;
}

// Floats from dz0 to x: the two gradients, or Scratch::xchg where that is
// longer (small networks; 2,688 against 1,536 at H = 50, batch 20).
__host__ __device__ constexpr int xchg_floats(int batch, int sa) {
  return 2 * grad_rows(batch) * sa > kXchgFloats ? 2 * grad_rows(batch) * sa
                                                 : kXchgFloats;
}

// Floats of Scratch::scal.
__host__ __device__ constexpr int scalar_slots(int rule) {
  return rule == kSgnht ? 1 + kWarps : 2;
}

// kDevice: the P-long arrays live in the device-memory workspace Args::work
// instead of shared memory.  kVBf16: v is stored as bf16 (Args::v_bf16).
// Template parameters, not runtime choices: a pointer that may point to
// either memory compiles to generic loads and stores, and either choice
// made at run time moved the f32 resident kernels' register allocation
// (B1 +17 %, B2 +4 % against the kernels before bf16 state).
// The body of every instantiation; the __global__ entries below differ only
// in the hint they give ptxas.
template <int kRule, bool kBurnin, bool kGathered, bool kDevice,
          bool kVBf16>
__device__ __forceinline__ void fused_body(const Args& a) {
  constexpr bool kAux = kRule != kSgld;
  constexpr bool kMinv = !kBurnin && (kRule == kSghmc || kRule == kSgld);
  constexpr int kCols = kRule == kSgld || kRule == kPsgld ? 1 : 2;
  constexpr int kState = state_arrays(kRule, kBurnin);
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = a.n_params;
  const size_t base = static_cast<size_t>(c) * P;
  const Layout L = make_layout(a.n_inputs, a.hidden, a.depth);

  // the chain's P-long arrays: in shared memory, or in its slice of the
  // device-memory workspace (then shared memory holds the scratch alone)
  float* s_theta;
  float* rest;
  if constexpr (kDevice) {
    s_theta = a.work + static_cast<size_t>(c) * kState * P;
    rest = smem;
  } else {
    s_theta = smem;
    rest = smem + scratch_offset(kState * P);
  }
  float* s_v = s_theta + P;                       // kAux
  float* s_grad = s_theta + (kAux ? 2 : 1) * P;
  float* s_minv = s_grad + P;                     // kMinv
  // burn-in: the EMAs in the output arrays (device memory), updated in place
  float* s_tau = a.tau_out + base;
  float* s_g = a.g_out + base;
  float* s_vhat = a.v_hat_out + base;
  const int SA = act_stride(a.hidden), SX = a.n_inputs + 1;
  Scratch s;
  s.act = rest;
  s.dz0 = s.act + a.depth * a.batch * SA;
  s.dz1 = s.dz0 + grad_rows(a.batch) * SA;
  s.xchg = s.dz0;
  s.x = s.dz0 + xchg_floats(a.batch, SA);
  s.y = s.x + a.batch * SX;
  s.dmean = s.y + a.batch;
  s.scal = s.dmean + a.batch;

  for (int p = tid; p < P; p += kThreads) {
    s_theta[p] = a.theta[base + p];
    if constexpr (kAux) s_v[p] = load_state(a.v, base + p, kVBf16);
    if constexpr (kBurnin) {
      s_tau[p] = a.tau[base + p];
      s_g[p] = a.g[base + p];
      s_vhat[p] = a.v_hat[base + p];
    }
    if constexpr (kMinv) s_minv[p] = load_state(a.minv, base + p, a.minv_bf16);
  }
  // the 1 columns of the activations and inputs, and the zeros that pad the
  // activations and gradients (no product writes either) and fill xchg
  const int n_act = a.depth * a.batch * SA;
  for (int i = tid; i < n_act + xchg_floats(a.batch, SA); i += kThreads)
    s.act[i] = i < n_act && i % SA == a.hidden ? 1.0f : 0.0f;
  for (int b = tid; b < a.batch; b += kThreads) s.x[b * SX + a.n_inputs] = 1.0f;
  // SGNHT: the thermostat, each thread's own copy, and the stepsize that
  // moves it next (step t forms its xi from step t - 1's partial sums)
  float xi = 0.0f, xi_eps = 0.0f;
  if constexpr (kRule == kSgnht) xi = a.xi[c];
  __syncthreads();

  // the paired kernels round the matrix slabs' momentum (the elements from
  // w2 up to the head) once, when the launch stores it
  const int mat_lo = L.b1 + a.hidden, mat_hi = L.head_w;
  // the Box-Muller loop: each warp's 128 staged normals
  const int lane = tid & 31;
  float4* stage = reinterpret_cast<float4*>(s.xchg) + (tid / 32) * 32;

  for (int t = 0; t < a.k_steps; ++t) {
    const unsigned step = a.step0 + static_cast<unsigned>(t);
    load_batch<kGathered>(a, t, step, s);
    if constexpr (kRule == kSgnht) {
      // the previous step's p'^T p', its partials written before
      // load_batch's barrier, summed in warp order by every thread
      // (fwd_bwd's barriers keep them until all have read them)
      if (t > 0) xi = thermostat(xi, xi_eps, s.scal + 1, a.c2);
    }
    fwd_bwd<!kBurnin>(a, L, s_theta, s_grad, s);
    // injected normals, if any, of this step
    const float* injected =
        a.noise == nullptr
            ? nullptr
            : a.noise + (static_cast<size_t>(t) * a.n_chains + c) * P;
    const float* row = a.tab + static_cast<size_t>(t) * kCols;
    const bool last = t == a.k_steps - 1;
    const float prior_scale = a.prior_scale;
// Each rule's update of element p with its normal eta (FUSED_ELEMENT),
// written once for the two noise loops: the Box-Muller loop and the CLT
// generator's groups.  The Box-Muller loop gives each warp 128 consecutive
// elements a round (box_muller_width: fewer in the last round, shared by
// all warps): each lane makes the one draw of its four
// (philox_normal_quad) and stages them in shared memory (xchg, zeroed
// after the loop), then the warp updates them, a lane per element 32
// apart, so that the state's loads and stores stay one contiguous word a
// lane.  A macro, not a lambda: called through a lambda, the Box-Muller
// loop took other registers from ptxas (B5-sgnht 123 instead of 72, B6 in
// device memory 110 instead of 80).
#define FUSED_FOR_EACH_ELEMENT                                            \
  if constexpr (kVariant == kClt) {                                       \
    for_each_clt_eta<!kBurnin && !kGathered>(                             \
        a, L, step, [&](int p, float eta) { FUSED_ELEMENT });             \
  } else {                                                                \
    for (int r0 = 0; r0 < P; r0 += 4 * kThreads) {                        \
      const int width = box_muller_width(P - r0);                         \
      const int p0 = r0 + tid / 32 * width;                               \
      if (injected == nullptr && 4 * lane < width)                        \
        stage[lane] = philox_normal_quad(a.seed, c, step, (p0 >> 2) + lane); \
      __syncwarp();                                                       \
      _Pragma("unroll") for (int j = 0; j < 4; ++j) {                     \
        const int i = 32 * j + lane, p = p0 + i;                          \
        if (i < width && p < P) {                                         \
          const float eta =                                               \
              injected != nullptr                                         \
                  ? injected[p]                                           \
                  : reinterpret_cast<const float*>(stage)[i];             \
          FUSED_ELEMENT                                                   \
        }                                                                 \
      }                                                                   \
      __syncwarp();                                                       \
    }                                                                     \
    stage[lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);                    \
  }
    if constexpr (kRule == kSghmc) {
      const float eps = row[0];
      const float es = row[1];
      const float es2 = es * es;
      const float mdecay = a.coef;
#define FUSED_ELEMENT                                                     \
  const float th = s_theta[p];                                            \
  const float vv = s_v[p];                                                \
  const float gg = s_grad[p] + prior_scale * th;                          \
  float minv;                                                             \
  if constexpr (kBurnin) {                                                \
    minv = adapt(s_tau, s_g, s_vhat, p, gg);                              \
    if (last) a.minv_out[base + p] = minv;                                \
  } else {                                                                \
    minv = s_minv[p];                                                     \
  }                                                                       \
  const float var = fmaxf(2.0f * es2 * mdecay * minv - es2 * es2, 1e-16f); \
  const float sigma = kBurnin ? sqrtf(var) : sqrt_approx(var);            \
  float vn = vv - eps * eps * minv * gg - mdecay * vv + sigma * eta;      \
  if (!kBurnin && !(minv > 0.0f)) vn = 0.0f;                              \
  s_v[p] = kVBf16 && !deferred(p, mat_lo, mat_hi) ? round_bf16(vn) : vn;  \
  s_theta[p] = th + vn;
      FUSED_FOR_EACH_ELEMENT
#undef FUSED_ELEMENT
    } else if constexpr (kRule == kSgld) {
      // JAX _sgld_rule (sampling) and _sgld_burnin_step_math (burn-in)
      const float eps = row[0];
      const float A = a.coef;
      const float cdiv = a.cdiv;
#define FUSED_ELEMENT                                                     \
  const float th = s_theta[p];                                            \
  const float gg = s_grad[p] + prior_scale * th;                          \
  if constexpr (kBurnin) {                                                \
    const float minv = adapt(s_tau, s_g, s_vhat, p, gg);                  \
    if (last) a.minv_out[base + p] = minv;                                \
    const float sigma =                                                   \
        sqrtf(fmaxf(2.0f * eps * ((minv * A) / cdiv), 0.0f));             \
    s_theta[p] = th + (-eps * minv * A * gg + sigma * eta);               \
  } else {                                                                \
    const float minv = s_minv[p];                                         \
    const float sigma = sqrt_approx(fmaxf(2.0f * eps * minv * cdiv, 0.0f)); \
    float delta = -eps * minv * A * gg + sigma * eta;                     \
    if (!(minv > 0.0f)) delta = 0.0f;                                     \
    s_theta[p] = th + delta;                                              \
  }
      FUSED_FOR_EACH_ELEMENT
#undef FUSED_ELEMENT
    } else if constexpr (kRule == kPsgld) {
      // JAX _psgld_rule: the RMSprop accumulator adapts every step, then
      // theta moves by the preconditioned Langevin step
      const float eps = row[0];
      const float alpha = a.coef, lambda = a.cdiv, inv_sg = a.c2;
#define FUSED_ELEMENT                                                     \
  const float th = s_theta[p];                                            \
  const float gg = s_grad[p] + prior_scale * th;                          \
  const float vn = alpha * s_v[p] + (1.0f - alpha) * gg * gg;             \
  const float precond = 1.0f / (lambda + sqrtf(fmaxf(vn, 0.0f)));         \
  const float sigma = sqrtf(fmaxf(eps * precond * inv_sg, 0.0f));         \
  s_v[p] = kVBf16 && !deferred(p, mat_lo, mat_hi) ? round_bf16(vn) : vn;  \
  s_theta[p] = th + (-0.5f * eps * precond * gg + sigma * eta);
      FUSED_FOR_EACH_ELEMENT
#undef FUSED_ELEMENT
    } else if constexpr (kRule == kRsghmc) {
      // JAX _rsghmc_rule: the dynamics use the log-likelihood gradient, -gg;
      // the velocity is eps p / m / sqrt(p^2 / (m^2 c^2) + 1)
      const float eps = row[0];
      const float noise_scale = row[1];
      const float d = a.coef, inv_m = a.c2, inv_mc2 = a.c3;
#define FUSED_ELEMENT                                                     \
  const float th = s_theta[p];                                            \
  const float gg = s_grad[p] + prior_scale * th;                          \
  const float pv = s_v[p];                                                \
  const float vel = eps * pv * inv_m * rsqrtf(pv * pv * inv_mc2 + 1.0f);  \
  const float pn = pv + eps * -gg + noise_scale * eta - d * vel;          \
  s_v[p] = kVBf16 && !deferred(p, mat_lo, mat_hi) ? round_bf16(pn) : pn;  \
  s_theta[p] = th + eps * pn * inv_m * rsqrtf(pn * pn * inv_mc2 + 1.0f);
      FUSED_FOR_EACH_ELEMENT
#undef FUSED_ELEMENT
    } else {
      // JAX _sgnht_rule, then the thermostat: every element reads the old
      // xi; each warp leaves its part of p'^T p', and xi moves by it after
      // the next barrier (the next step's first, or the launch's end)
      const float eps = row[0];
      const float sigma = row[1];
      float kinetic = 0.0f;
#define FUSED_ELEMENT                                                     \
  const float th = s_theta[p];                                            \
  const float gg = s_grad[p] + prior_scale * th;                          \
  const float pv = s_v[p];                                                \
  const float pn = pv - xi * eps * pv - eps * gg + sigma * eta;           \
  s_v[p] = kVBf16 && !deferred(p, mat_lo, mat_hi) ? round_bf16(pn) : pn;  \
  s_theta[p] = th + eps * pn;                                             \
  kinetic += pn * pn;
      FUSED_FOR_EACH_ELEMENT
#undef FUSED_ELEMENT
      kinetic = warp_sum(kinetic);
      if (lane == 0) s.scal[1 + tid / 32] = kinetic;
      xi_eps = eps;
    }
#undef FUSED_FOR_EACH_ELEMENT
    if (last && tid == 0) a.cost_out[c] = s.scal[0];
    // no barrier: the next step opens with one before any thread reads
    // theta
  }
  __syncthreads();
  if constexpr (kRule == kSgnht) {
    if (tid == 0 && a.k_steps > 0)
      a.xi_out[c] = thermostat(xi, xi_eps, s.scal + 1, a.c2);
  }

  for (int p = tid; p < P; p += kThreads) {
    a.theta_out[base + p] = s_theta[p];
    if constexpr (kAux) {
      if constexpr (kVBf16)
        static_cast<__nv_bfloat16*>(a.v_out)[base + p] =
            __float2bfloat16_rn(s_v[p]);
      else
        static_cast<float*>(a.v_out)[base + p] = s_v[p];
    }
  }
}

// kMinBlocks: two blocks per SM (at most 128 registers a thread).  Without
// that hint ptxas picked 32-64 registers per instantiation, and its choice
// moved single kernels by up to 9 % with unrelated changes of the source
// (H100: B5-rsghmc at 32 registers, 293 ms against 40 and 270 ms); with it the
// resident kernels take 64-128 registers and none is slower than before,
// and the sampling kernels with their state in device memory (80-128
// registers) run twice as fast at H = 100.
constexpr int kMinBlocks = 2;

// (kBlocks comes last: chip_smoke.py reads the others from ptxas's names)
template <int kRule, bool kBurnin, bool kGathered, bool kDevice,
          bool kVBf16, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks) fused_kernel(Args a) {
  fused_body<kRule, kBurnin, kGathered, kDevice, kVBf16>(a);
}

// The burn-in kernels with their state in device memory: under the CLT
// ptxas's own choice (100-128 registers; the two-block hint gave the
// earlier, untiled body's 114 and 128 and made them 11-27 % slower at H =
// 100 on an H100), on Box-Muller three blocks an SM (at most 80
// registers: ptxas chose 74 for the loop of a draw per element, 96 for the
// loop of four normals a draw, which held B2 at H = 100 to two blocks and
// made it 10 % slower on an H100).
template <int kRule, bool kBurnin, bool kGathered, bool kDevice,
          bool kVBf16>
__global__ void __launch_bounds__(kThreads) fused_kernel_unhinted(Args a) {
  fused_body<kRule, kBurnin, kGathered, kDevice, kVBf16>(a);
}

template <int kRule, bool kBurnin, bool kGathered, bool kDevice,
          bool kVBf16>
constexpr auto kernel_of() {
  if constexpr (kDevice && kBurnin && kVariant == kClt)
    return &fused_kernel_unhinted<kRule, kBurnin, kGathered, kDevice, kVBf16>;
  else if constexpr (kDevice && kBurnin)
    return &fused_kernel<kRule, kBurnin, kGathered, kDevice, kVBf16, 3>;
  else
    return &fused_kernel<kRule, kBurnin, kGathered, kDevice, kVBf16,
                         kMinBlocks>;
}

// Shared memory of one block: the scratch, plus the P-long arrays where they
// are resident (no device-memory workspace).
size_t smem_bytes(int rule, bool burnin, int n_params, int n_inputs,
                  int hidden, int depth, int batch, bool resident) {
  const size_t state =
      resident ? scratch_offset(state_arrays(rule, burnin) * n_params) : 0;
  const size_t scratch =
      static_cast<size_t>(depth * batch) * act_stride(hidden) +
      xchg_floats(batch, act_stride(hidden)) +
      static_cast<size_t>(batch) * (n_inputs + 1) + 2 * batch +
      scalar_slots(rule);
  return (state + scratch) * sizeof(float);
}

template <int kRule, bool kBurnin, bool kGathered, bool kDevice,
          bool kVBf16>
int launch_placed(const Args& a, void* stream) {
  const size_t bytes = smem_bytes(kRule, kBurnin, a.n_params, a.n_inputs,
                                  a.hidden, a.depth, a.batch, !kDevice);
  constexpr auto kernel =
      kernel_of<kRule, kBurnin, kGathered, kDevice, kVBf16>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_chains, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <int kRule, bool kBurnin, bool kGathered, bool kDevice>
int launch_typed(const Args& a, void* stream) {
  if constexpr (kRule != kSgld) {  // SGLD has no v
    if (a.v_bf16)
      return launch_placed<kRule, kBurnin, kGathered, kDevice, true>(a,
                                                                     stream);
  }
  return launch_placed<kRule, kBurnin, kGathered, kDevice, false>(a, stream);
}

// The wrapper chose the placement (a workspace or none) from
// fused_step_smem_bytes and the storage of v; the launch follows them.
// The paired kernels keep their state resident (the wrapper refuses their
// launch where it does not fit).
template <int kRule, bool kBurnin, bool kGathered>
int launch(const Args& a, void* stream) {
  if (a.work != nullptr) {
    if constexpr (kVariant == kPairedBm)
      return static_cast<int>(cudaErrorInvalidValue);
    else
      return launch_typed<kRule, kBurnin, kGathered, true>(a, stream);
  }
  return launch_typed<kRule, kBurnin, kGathered, false>(a, stream);
}

int rule_of(int kernel) {
  switch (kernel) {
    case kB1: case kB2: case kB3: return kSghmc;
    case kB4Psgld: case kB5Psgld: return kPsgld;
    case kB4Sgnht: case kB5Sgnht: return kSgnht;
    case kB4Rsghmc: case kB5Rsghmc: return kRsghmc;
    default: return kSgld;
  }
}

bool burnin_of(int kernel) { return kernel == kB2 || kernel == kB6; }

}  // namespace

// One entry per TPU kernel, all with the same arguments (the Args fields in
// order, then the stream); a kernel reads only the operands of its rule and
// phase, and the others may be NULL.  v_bf16 / minv_bf16 give the storage
// of v and v_out / minv; work is NULL, or the device-memory workspace of
// fused_step_workspace_floats per chain.  The one-step kernels (B3, B4-*)
// take each chain's gathered rows as x/y (n_windows = n_chains, k_steps =
// 1) and the noise of absolute step `step0`.
#define FUSED_STEP_ENTRY(entry, rule, burnin, gathered)                      \
  int entry(const float* theta, const void* v, const void* minv,            \
            const float* tau, const float* g, const float* v_hat,           \
            const float* xi, const float* x, const float* y,                \
            const float* tab, const float* noise, const int* widx,          \
            float* theta_out, void* v_out, float* tau_out, float* g_out,    \
            float* v_hat_out, float* minv_out, float* xi_out,               \
            float* cost_out, int n_chains, int n_inputs, int hidden,        \
            int depth, int batch, int n_windows, int k_steps,               \
            int n_params, unsigned long long seed, unsigned step0,          \
            float coef, float cdiv, float c2, float c3, float prior_scale,  \
            float inv_b, float inv_n, int v_bf16, int minv_bf16,            \
            float* work, void* stream) {                                    \
    const Args a = {theta,     v,         minv,      tau,       g,          \
                    v_hat,     x,         y,         tab,       noise,      \
                    widx,      theta_out, v_out,     tau_out,   g_out,      \
                    v_hat_out, minv_out,  cost_out,  n_chains,  n_inputs,   \
                    hidden,    depth,     batch,     n_windows, k_steps,    \
                    n_params,  seed,      step0,     coef,      cdiv,       \
                    prior_scale, inv_b,   inv_n,     c2,        c3,         \
                    xi,        xi_out,    v_bf16,    minv_bf16, work};      \
    return launch<rule, burnin, gathered>(a, stream);                       \
  }
