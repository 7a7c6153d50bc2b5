// SVGD transport for Hopper, without materialising the n x n kernel matrix.
//
// Replaces the TPU Pallas kernel B11 of pysgmcmc_tpu/ops/svgd_streaming.py
// (svgd_phi_streaming, kernel _kernel), with its semantics: for particles X
// (n, d), cost gradients G (n, d) and a bandwidth h,
//
//   K_ij  = exp(-max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0) / (2 h^2))
//   phi_i = (sum_j K_ij (-g_j) + (x_i sum_j K_ij - sum_j K_ij x_j) / h^2) / n
//         = (sum_j K_ij v_j + x_i sum_j K_ij / h^2) / n,  v_j = -g_j - x_j / h^2
//
// The second form folds the two accumulations into one product, K V.
//
// Columns j >= n are masked by an integer compare (the TPU kernel compares
// them as f32, exact only below 2^24 columns).
//
// Bound.  The function needs the Gram matrix X X^T (n^2 d operations, the
// matrix being symmetric) and one product K V (2 n^2 d): 3 n^2 d f32
// operations, against 2 n d words read and n d written.  The kernel
// computes the full Gram (4 n^2 d operations), on the CUDA cores: f32 FMA,
// no tensor cores, no TF32.
//
// Design.  One block of 256 threads owns a row tile of kTI = 32 particles
// and walks the columns in tiles of kTJ = 512.  Per column tile:
//   1. the Gram tile X_i X_j^T (32 x 512) as a register-tiled product: the
//      features stream through shared memory in chunks of kKC, stored
//      feature-major so that each thread reads its 8 rows and 8 columns as
//      float4s, and the next chunk is loaded into registers while the
//      current one is multiplied.  The sum over d runs in two levels:
//      each block of kGB features in registers, the blocks' partial sums
//      added into the thread's own slots of the K tile (free until 2.), so
//      that its rounding stays that of a blocked product (cuBLAS, the CPU's
//      BLAS), not of one chain of d additions;
//   2. K = exp(...) into shared memory (64 KB), with the squared norms of a
//      pre-pass (one warp per particle); the row sums of K are added to a
//      running sum in shared memory in a fixed order;
//   3. the accumulation K V_j, again register-tiled (8 x 8 per thread), over
//      the features in chunks of kDC, V = -G - X / h^2 from a pre-pass: each
//      chunk's running sums come from the block's own rows of the output
//      (n, d) and go back there.  No other block touches
//      those rows: no atomics, and the summation order is fixed, so two
//      launches agree bit for bit.
// A last pass over the block's rows forms phi.  Memory stays O(n d).  h is
// read through a device pointer (the step never waits for the host); n and d
// are arbitrary, nothing is padded.
//
// Built with nvcc into a shared library with a plain C interface; the entry
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTI = 32;    // rows (particles i) per block
constexpr int kTJ = 512;   // columns (particles j) per K tile
constexpr int kKC = 16;    // features per Gram step
constexpr int kGB = 256;   // features per partial sum of the Gram
constexpr int kJC = 16;    // columns per accumulation step
constexpr int kDC = 512;   // features per accumulation chunk
// shared-memory row strides, float4-aligned and off the bank period
constexpr int kPadI = kTI + 4;
constexpr int kPadJ = kTJ + 4;
constexpr int kPadD = kDC + 4;
// shared-memory layout, in floats
constexpr int kStageA = kKC * kPadI + kKC * kPadJ;  // X_i, X_j chunks
constexpr int kStageB = kJC * kPadD;                // V_j chunk
constexpr int kStage = kStageA > kStageB ? kStageA : kStageB;
constexpr int kKOff = 0;                  // K, column-major: [kTJ][kPadI]
constexpr int kStageOff = kTJ * kPadI;
constexpr int kPartOff = kStageOff + kStage;   // [kWarps][kTI] row-sum parts
constexpr int kSumOff = kPartOff + kWarps * kTI;  // [kTI] running row sums
constexpr int kSmemFloats = kSumOff + kTI;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kTI == 32 && kThreads == 256 && kDC == 2 * kThreads,
              "the thread layout below assumes these sizes");
static_assert(kDC == kTJ, "a thread's columns are the same in 1. and 3.");
static_assert(kGB % kKC == 0, "a Gram partial sum spans whole steps");
static_assert(kTJ == kWarps * 64, "one warp per 64 columns of a K tile");

// |x_i|^2 of every particle: one warp per particle.
__global__ void __launch_bounds__(kThreads)
    squared_norms(const float* __restrict__ x, float* __restrict__ sqn, int n,
                  int d) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s = fmaf(xr[k], xr[k], s);
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) sqn[row] = s;
}

// v = -g - x / h^2, elementwise over n d values (the folded accumulation's
// right-hand side).
__global__ void __launch_bounds__(kThreads)
    fold_rhs(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ h_ptr, float* __restrict__ v,
             size_t total) {
  const float h = *h_ptr;
  const float inv_h2 = 1.0f / (h * h);
  for (size_t e = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * kThreads)
    v[e] = -fmaf(x[e], inv_h2, g[e]);
}

// acc[r][c] += sum_k a[k][r] * b[k][col(c)] over kDepth steps, with a_s at
// the thread's first row (rows r = 0..7 contiguous) and b_s at its first
// column (columns 0..3 and 32..35 from there), both feature-major.
template <int kDepth>
__device__ __forceinline__ void tile_product(float (&acc)[8][8],
                                             const float* a_s, int a_stride,
                                             const float* b_s, int b_stride) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_s + k * a_stride);
    const float4 a1 = *reinterpret_cast<const float4*>(a_s + k * a_stride + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b_s + k * b_stride);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b_s + k * b_stride + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// the column offset of a thread's c-th column (0..3, then 32..35)
__device__ __forceinline__ int col_of(int c) { return c < 4 ? c : 28 + c; }

__global__ void __launch_bounds__(kThreads)
    svgd_transport(const float* __restrict__ x, const float* __restrict__ v,
                   const float* __restrict__ h_ptr,
                   const float* __restrict__ sqn, float* __restrict__ phi,
                   int n, int d) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem + kKOff;
  float* xi_s = smem + kStageOff;        // [kKC][kPadI]
  float* xj_s = xi_s + kKC * kPadI;      // [kKC][kPadJ]
  float* vb_s = smem + kStageOff;        // [kJC][kPadD]
  float* part_s = smem + kPartOff;
  float* ksum_s = smem + kSumOff;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = (lane / 8) * 8;               // the thread's 8 rows
  const int i0 = blockIdx.x * kTI;
  const float h = *h_ptr;
  const float inv_two_h2 = 1.0f / (2.0f * h * h);
  const float inv_h2 = 1.0f / (h * h);

  // Gram staging: feature ld_k of rows ld_r + 16 q
  const int ld_k = tid % kKC;
  const int ld_r = tid / kKC;
  // the thread's first column of a Gram tile and of a feature chunk
  const int gcol = warp * 64 + (lane % 8) * 4;
  const float* rows_i = x + static_cast<size_t>(i0) * d;

  float sq_i[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    sq_i[r] = i0 + r0 + r < n ? sqn[i0 + r0 + r] : 0.f;
  if (tid < kTI) ksum_s[tid] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kTJ) {
    // ---- 1. Gram tile X_i X_j^T ----
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    float pre_i[kTI / 16], pre_j[kTJ / 16];
    auto load_gram = [&](int k0) {
      const int k = k0 + ld_k;
      const bool k_in = k < d;
#pragma unroll
      for (int q = 0; q < kTI / 16; ++q) {
        const int i = i0 + ld_r + 16 * q;
        pre_i[q] = k_in && i < n ? x[static_cast<size_t>(i) * d + k] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kTJ / 16; ++q) {
        const int j = j0 + ld_r + 16 * q;
        pre_j[q] = k_in && j < n ? x[static_cast<size_t>(j) * d + k] : 0.f;
      }
    };
    // the thread's slots of the K tile hold the Gram's running sum
    auto fold_partial = [&](bool first) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float4* t = reinterpret_cast<float4*>(
              k_s + (gcol + col_of(c)) * kPadI + r0 + 4 * half);
          float4 sum = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *t;
          sum.x += acc[4 * half][c];
          sum.y += acc[4 * half + 1][c];
          sum.z += acc[4 * half + 2][c];
          sum.w += acc[4 * half + 3][c];
          *t = sum;
#pragma unroll
          for (int r = 4 * half; r < 4 * half + 4; ++r) acc[r][c] = 0.f;
        }
      }
    };
    load_gram(0);
    for (int k0 = 0; k0 < d; k0 += kKC) {
      __syncthreads();  // the previous chunk is no longer read
#pragma unroll
      for (int q = 0; q < kTI / 16; ++q)
        xi_s[ld_k * kPadI + ld_r + 16 * q] = pre_i[q];
#pragma unroll
      for (int q = 0; q < kTJ / 16; ++q)
        xj_s[ld_k * kPadJ + ld_r + 16 * q] = pre_j[q];
      __syncthreads();
      if (k0 + kKC < d) load_gram(k0 + kKC);  // in flight during the product
      tile_product<kKC>(acc, xi_s + r0, kPadI, xj_s + gcol, kPadJ);
      if ((k0 + kKC) % kGB == 0 || k0 + kKC >= d) fold_partial(k0 < kGB);
    }

    // ---- 2. K tile (over the Gram in the same slots), and its row sums ----
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int jl = gcol + col_of(c);
      const int j = j0 + jl;
      const bool j_in = j < n;  // integer column mask
      const float sq_j = j_in ? sqn[j] : 0.f;
      const float4 t0 = *reinterpret_cast<const float4*>(k_s + jl * kPadI + r0);
      const float4 t1 =
          *reinterpret_cast<const float4*>(k_s + jl * kPadI + r0 + 4);
      const float gram[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      float kv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float d2 = sq_i[r] + sq_j - 2.0f * gram[r];
        kv[r] = j_in ? expf(-fmaxf(d2, 0.f) * inv_two_h2) : 0.f;
      }
      *reinterpret_cast<float4*>(k_s + jl * kPadI + r0) =
          make_float4(kv[0], kv[1], kv[2], kv[3]);
      *reinterpret_cast<float4*>(k_s + jl * kPadI + r0 + 4) =
          make_float4(kv[4], kv[5], kv[6], kv[7]);
    }
    __syncthreads();
    {
      // row tid % 32, columns of one warp's 64
      const int r = tid % kTI, c_begin = (tid / kTI) * (kTJ / kWarps);
      float s = 0.f;
      for (int c = c_begin; c < c_begin + kTJ / kWarps; ++c)
        s += k_s[c * kPadI + r];
      part_s[(tid / kTI) * kTI + r] = s;
    }
    __syncthreads();
    if (tid < kTI) {
      float s = ksum_s[tid];
      for (int w = 0; w < kWarps; ++w) s += part_s[w * kTI + tid];
      ksum_s[tid] = s;
    }

    // ---- 3. K V_j, over the features in chunks of kDC ----
    const int j_valid = min(kTJ, n - j0);
    const int n_steps = (j_valid + kJC - 1) / kJC;
    for (int dc0 = 0; dc0 < d; dc0 += kDC) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + r0 + r;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int f = dc0 + gcol + col_of(c);
          acc[r][c] = j0 > 0 && i < n && f < d
                          ? phi[static_cast<size_t>(i) * d + f]
                          : 0.f;
        }
      }
      // features dc0 + tid and dc0 + tid + kThreads of kJC columns
      float pre_v[2][kJC];
      auto load_acc = [&](int step) {
#pragma unroll
        for (int q = 0; q < kJC; ++q) {
          const int j = j0 + step * kJC + q;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int f = dc0 + tid + half * kThreads;
            pre_v[half][q] =
                j < n && f < d ? v[static_cast<size_t>(j) * d + f] : 0.f;
          }
        }
      };
      load_acc(0);
      for (int step = 0; step < n_steps; ++step) {
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kJC; ++q) {
          vb_s[q * kPadD + tid] = pre_v[0][q];
          vb_s[q * kPadD + tid + kThreads] = pre_v[1][q];
        }
        __syncthreads();
        if (step + 1 < n_steps) load_acc(step + 1);
        tile_product<kJC>(acc, k_s + step * kJC * kPadI + r0, kPadI,
                          vb_s + gcol, kPadD);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + r0 + r;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int f = dc0 + gcol + col_of(c);
          if (i < n && f < d) phi[static_cast<size_t>(i) * d + f] = acc[r][c];
        }
      }
    }
    __syncthreads();  // K and the staging buffers are rewritten next tile
  }

  // ---- phi of the block's rows (their running sums are this block's) ----
  const float n_f = static_cast<float>(n);
  const int rows = min(kTI, n - i0);
  for (int r = 0; r < rows; ++r) {
    const float ksum_h2 = ksum_s[r] * inv_h2;
    const size_t base = static_cast<size_t>(i0 + r) * d;
    for (int f = tid; f < d; f += kThreads)
      phi[base + f] = fmaf(rows_i[static_cast<size_t>(r) * d + f], ksum_h2,
                           phi[base + f]) / n_f;
  }
}

}  // namespace

extern "C" {

const char* svgd_streaming_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block of the transport kernel, in bytes.
unsigned long long svgd_streaming_smem_bytes() { return kSmemBytes; }

// B11: phi (n, d) from x, g (n, d) and h (a device scalar); v (n, d) and
// sqn (n,) are scratch.  All pointers are device memory, float32, row-major.
int svgd_phi_streaming_launch(const float* x, const float* g, const float* h,
                              float* phi, float* v, float* sqn, int n, int d,
                              void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  squared_norms<<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(x, sqn, n, d);
  const size_t total = static_cast<size_t>(n) * d;
  const size_t rhs_blocks = (total + kThreads - 1) / kThreads;
  fold_rhs<<<static_cast<unsigned>(rhs_blocks < 4096 ? rhs_blocks : 4096),
             kThreads, 0, s>>>(x, g, h, v, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(svgd_transport,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  svgd_transport<<<(n + kTI - 1) / kTI, kThreads, kSmemBytes, s>>>(
      x, v, h, sqn, phi, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
