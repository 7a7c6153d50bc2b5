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
// Columns j >= n are masked by an integer compare (the TPU kernel compares
// them as f32, exact only below 2^24 columns).
//
// Bound.  The function needs the Gram matrix X X^T (n^2 d operations, the
// matrix being symmetric) and one product K V (2 n^2 d): 3 n^2 d f32
// operations, against 2 n d words read and n d written.  This kernel
// computes the full Gram (4 n^2 d) on the tensor cores as three TF32 passes
// ("3xTF32"): 12 n^2 d TF32 operations.  What holds it back at the
// flagship (n = 4096, d = 5,252) is the staging more than the products:
// with 64-row tiles every block streams all n columns of X and V over its
// features, n / 64 x 2 n d x 4 bytes = 11 GB from L2 a call, and reads
// phi's running sums back once per column tile, n^2 d x 8 / 256 bytes =
// 2.8 GB from HBM.
//
// Design.  Both products run on the tensor cores (mma.sync m16n8k8 TF32)
// at f32 accuracy: every f32 operand a is split into a TF32 high part and a
// TF32 low part, a = a_hi + a_lo, and a b is taken as a_lo b_hi + a_hi b_lo
// + a_hi b_hi, accumulated in f32 (the dropped a_lo b_lo is 2^-22 of a b;
// tf32.cuh, which the fused body's products share).  One TF32 pass would
// keep about three digits, and the Gram's |x_i|^2 + |x_j|^2 - 2 <x_i,
// x_j> cancels.  On
// the diagonal it cancels to 0 exactly: the kernel takes K_ii = 1 rather
// than the exponential of the split's rounding of 2 |x_i|^2 (K_ii, the
// largest entry, moved by it, moved an SVGD path's samples several times
// further than rounding in f32 does).  A
// tensor-core accumulator does not round as an f32 add, so no chain of
// products is longer than one stage of 32 (12 products, see warp_step);
// the chains are added up by f32 adds in registers.  The exponentials, the
// row sums of K, the column mask and the last pass that forms phi stay in
// f32.
//
//   * Work split: a cluster of kCluster = 2 blocks owns a row tile of
//     kBM = 64 particles; block r of the cluster owns the r-th half of the
//     features.  It walks the columns in tiles of kBN = 256:
//       1. the partial Gram of its features, X_i[:, F_r] X_j[:, F_r]^T
//          (64 x 256; 16 warps of 32 x 32), into its shared memory;
//       2. a cluster barrier; each block reads its partner's partial
//          through distributed shared memory and adds it to its own (both
//          blocks hold the same Gram, bit for bit), forms K in registers
//          and its row sums (a fixed order: per thread, across the four
//          lanes of a group, then the eight column warps); a second barrier
//          frees the partials, and K overwrites the block's own;
//       3. its features of K V_j, in chunks of kDN = 256 features, each
//          chunk's tile sum added to its rows of phi (read back from HBM,
//          prefetched into L2 while the chunk's product runs).
//     n / 64 row tiles x 2 blocks: 128 blocks at the flagship (n = 4096),
//     one wave of one block of 16 warps per SM (clusters of 4 would split
//     the features further, but an H100's GPCs hold fewer clusters of 4
//     such blocks than a quarter of its SMs: 256 blocks in three waves).
//     No block shares an output with another: no atomics, and every sum
//     runs in a fixed order, so two launches agree bit for bit.  The Gram's mirror half is
//     computed, not skipped: a block that reused a mirror tile would wait
//     on, or store, another row tile's results (memory beyond O(n d), or an
//     order of blocks that the card does not give).
//   * Staging: the operand tiles (X_i and X_j 32 features deep, V 32
//     columns deep) go to shared memory by cp.async (16 bytes a copy where
//     d is a multiple of 4 and the rows are aligned, else 4) through three
//     buffers, two chunks ahead of the product, one barrier a chunk.  Row
//     strides of 36, 260 and 264 words put the fragment loads of a warp on
//     32 different banks.
//   * Memory: 207,104 bytes of shared memory a block; O(n d) in all (v and
//     the squared norms, from two pre-passes).
// The last column tile forms phi in its store.  h is read through a device
// pointer (the step never waits for the host); n and d are arbitrary,
// nothing is padded.
//
// Built with nvcc into a shared library with a plain C interface; the entry
// returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kColWarps = 8;   // warps across a tile's columns
constexpr int kThreads = 64 * kColWarps;   // (x 2 across its rows)
constexpr int kNT = 256 / kColWarps / 8;   // n-tiles of 8 a warp
constexpr int kCluster = 2;   // blocks per row tile, one feature slice each
constexpr int kBM = 64;       // rows (particles i) per block
constexpr int kBN = 256;      // columns (particles j) per K tile
constexpr int kBK = 32;       // features per Gram stage
constexpr int kDN = 256;      // features per K V chunk
constexpr int kBJ = 32;       // columns per K V stage
constexpr int kStages = 3;    // staging buffers
// shared-memory row strides (words), multiples of 4 (16-byte copies) and
// off the bank period for the fragment loads
constexpr int kSkStride = kBN + 4;  // = 4 (mod 32)
constexpr int kXStride = kBK + 4;   // = 4 (mod 32)
constexpr int kVStride = kDN + 8;   // = 8 (mod 32)
constexpr int kGramStage = (kBM + kBN) * kXStride;
constexpr int kVStage = kBJ * kVStride;
constexpr int kStage = kGramStage > kVStage ? kGramStage : kVStage;
// shared-memory layout, in floats
constexpr int kSkOff = 0;                      // partial Gram, then K
constexpr int kStageOff = kBM * kSkStride;     // kStages stages
constexpr int kPartOff = kStageOff + kStages * kStage;  // [kColWarps][kBM]
constexpr int kSumOff = kPartOff + kColWarps * kBM;  // [kBM] row sums
constexpr int kSmemFloats = kSumOff + kBM;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kCluster == 2, "a block adds its partner's Gram partial");
static_assert(kBM == 64 && kBN == 8 * kNT * kColWarps && kDN == kBN,
              "warps of 2 x kColWarps: warp tiles of 32 x 8 kNT");
static_assert(kStageOff % 4 == 0 && kStage % 4 == 0 &&
                  (kBM * kXStride) % 4 == 0,
              "16-byte copies need 16-byte aligned stages");
static_assert(kSmemBytes <= 232448, "one block's shared memory");

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

// ---- asynchronous copies -------------------------------------------------

// kVec floats from src to shared dst, or zeros where !valid (src is then
// not read).
template <int kVec>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 * kVec : 0;
  if constexpr (kVec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Both products stream their operand tiles through kStages = 3 buffers:
// the copies of chunks 0 and 1 first, then per chunk c: wait for all but
// the newest group (chunk c has landed), a barrier (every warp is done with
// chunk c - 1, whose buffer is free), the copies of chunk c + 2 into it,
// and the product of chunk c.  One barrier per chunk.

// Gram stage: rows 0..kBM-1 of dst are X_i, rows kBM..kBM+kBN-1 X_j, kBK
// features from k0 each (zeros beyond n rows or f_hi features).
template <int kVec>
__device__ __forceinline__ void load_gram(float* dst, const float* x, int i0,
                                          int j0, int k0, int f_hi, int n,
                                          int d) {
  constexpr int kPerRow = kBK / kVec;
  for (int q = threadIdx.x; q < (kBM + kBN) * kPerRow; q += kThreads) {
    const int r = q / kPerRow, kk = (q % kPerRow) * kVec;
    const int row = r < kBM ? i0 + r : j0 + r - kBM;
    const bool valid = row < n && k0 + kk < f_hi;
    copy_async<kVec>(dst + r * kXStride + kk,
                     valid ? x + static_cast<size_t>(row) * d + k0 + kk : x,
                     valid);
  }
}

// K V stage: kBJ rows j of V from jc, kDN features from f0 each.
template <int kVec>
__device__ __forceinline__ void load_rhs(float* dst, const float* v, int jc,
                                         int f0, int f_hi, int n, int d) {
  constexpr int kPerRow = kDN / kVec;
  for (int q = threadIdx.x; q < kBJ * kPerRow; q += kThreads) {
    const int r = q / kPerRow, ff = (q % kPerRow) * kVec;
    const bool valid = jc + r < n && f0 + ff < f_hi;
    copy_async<kVec>(dst + r * kVStride + ff,
                     valid ? v + static_cast<size_t>(jc + r) * d + f0 + ff
                           : v,
                     valid);
  }
}

// ---- 3xTF32 on the tensor cores (tf32.cuh: to_tf32, split, mma) -------

// acc[mt][nt] += A B over one k-step of 8, the warp's 32 x 32 tile: A(m, k)
// at a_s[m * a_stride + k] from the warp's first row, B(k, n) at
// b_s[k * b_k + n * b_n] from its first column; n-tiles at or beyond
// nt_end are skipped.  The three passes run one after the other over the
// eight tiles, so that no product waits on the one before it.
//
// A tensor-core sum does not round as an f32 add: a long chain of products
// into one accumulator drifts (over the flagship's 4096 columns, chained,
// by a share of a row's scale close to the checks' tolerance).  So a chain
// spans one stage (4 k-steps, 12 products); it starts from 0 and is added
// to the thread's f32 running sums by FADDs.
__device__ __forceinline__ void warp_step(float (&acc)[2][kNT][4],
                                          const float* a_s, int a_stride,
                                          const float* b_s, int b_k, int b_n,
                                          int nt_end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ahi[2][4], alo[2][4], bhi[kNT][2], blo[kNT][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* a = a_s + (16 * mt + g) * a_stride + t;
    split(a[0], ahi[mt][0], alo[mt][0]);
    split(a[8 * a_stride], ahi[mt][1], alo[mt][1]);
    split(a[4], ahi[mt][2], alo[mt][2]);
    split(a[8 * a_stride + 4], ahi[mt][3], alo[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    if (nt < nt_end) {
      const float* b = b_s + t * b_k + (8 * nt + g) * b_n;
      split(b[0], bhi[nt][0], blo[nt][0]);
      split(b[4 * b_k], bhi[nt][1], blo[nt][1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (nt < nt_end) mma(acc[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (nt < nt_end) mma(acc[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (nt < nt_end) mma(acc[mt][nt], ahi[mt], bhi[nt]);
}

__device__ __forceinline__ void zero(float (&acc)[2][kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// run += acc, element by element (f32 adds, rounded to nearest)
__device__ __forceinline__ void fold(float (&run)[2][kNT][4],
                                     const float (&acc)[2][kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mt][nt][e] += acc[mt][nt][e];
}

// The accumulator fragment of (mt, nt), element e: row and column within
// the warp's tile (m16n8 C layout).
__device__ __forceinline__ int frag_row(int mt, int e) {
  return 16 * mt + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int nt, int e) {
  return 8 * nt + 2 * (threadIdx.x & 3) + (e & 1);
}

// The thread's fragments of the K tile (or Gram partial) in shared memory,
// as (mt, nt, h) -> the float2 at rows frag_row(mt, 2 h) of the warp.
__device__ __forceinline__ float2* sk_at(float* sk, int wm, int wn, int mt,
                                         int nt, int hh) {
  return reinterpret_cast<float2*>(
      sk + (32 * wm + frag_row(mt, 2 * hh)) * kSkStride + 8 * kNT * wn +
      frag_col(nt, 0));
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
    svgd_transport(const float* __restrict__ x, const float* __restrict__ v,
                   const float* __restrict__ h_ptr,
                   const float* __restrict__ sqn, float* __restrict__ phi,
                   int n, int d) {
  extern __shared__ __align__(16) float smem[];
  float* sk = smem + kSkOff;
  float* stage = smem + kStageOff;
  float* part = smem + kPartOff;
  float* ksum = smem + kSumOff;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp & 1, wn = warp >> 1;  // 32-row half, 32-column eighth
  const int t = lane & 3;
  const int rank = static_cast<int>(cluster.block_rank());
  const int i0 = (blockIdx.x / kCluster) * kBM;
  // the block's features [f_lo, f_hi): d / kCluster rounded up to 4
  const int slice = ((d + 4 * kCluster - 1) / (4 * kCluster)) * 4;
  const int f_lo = min(d, rank * slice);
  const int f_hi = min(d, f_lo + slice);
  const float h = *h_ptr;
  const float inv_two_h2 = 1.0f / (2.0f * h * h);
  const float inv_h2 = 1.0f / (h * h);
  const float n_f = static_cast<float>(n);

  float sq_i[2][2];
  int i_of[2][2];  // the thread's rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      i_of[mt][hh] = i0 + 32 * wm + frag_row(mt, 2 * hh);
      sq_i[mt][hh] = i_of[mt][hh] < n ? sqn[i_of[mt][hh]] : 0.f;
    }
  if (tid < kBM) ksum[tid] = 0.f;

  float acc[2][kNT][4], run[2][kNT][4];
  const int n_tiles = (n + kBN - 1) / kBN;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kBN;
    // ---- 1. the partial Gram of the block's features, into sk ----
    const int k_chunks = (f_hi - f_lo + kBK - 1) / kBK;
    for (int c = 0; c < 2; ++c) {
      if (c < k_chunks)
        load_gram<kVec>(stage + c * kStage, x, i0, j0, f_lo + c * kBK, f_hi,
                        n, d);
      copy_commit();
    }
    zero(run);
    for (int c = 0; c < k_chunks; ++c) {
      copy_wait_all_but_one();
      __syncthreads();
      if (c + 2 < k_chunks)
        load_gram<kVec>(stage + ((c + 2) % kStages) * kStage, x, i0, j0,
                        f_lo + (c + 2) * kBK, f_hi, n, d);
      copy_commit();
      const float* xa = stage + (c % kStages) * kStage + 32 * wm * kXStride;
      const float* xb =
          stage + (c % kStages) * kStage + (kBM + 8 * kNT * wn) * kXStride;
      zero(acc);
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8)
        warp_step(acc, xa + ks, kXStride, xb + ks, 1, kXStride, kNT);
      fold(run, acc);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *sk_at(sk, wm, wn, mt, nt, hh) =
              make_float2(run[mt][nt][2 * hh], run[mt][nt][2 * hh + 1]);

    // ---- 2. the cluster's Gram, K and its row sums ----
    cluster.sync();  // every block's partial is in place
    float* sk_other = cluster.map_shared_rank(sk, rank ^ 1);
    float rows[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float sq_j[2];
      bool j_in[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * kNT * wn + frag_col(nt, e);
        j_in[e] = j < n;  // integer column mask
        sq_j[e] = j_in[e] ? sqn[j] : 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 mine = *sk_at(sk, wm, wn, mt, nt, hh);
          const float2 other = *sk_at(sk_other, wm, wn, mt, nt, hh);
          // the same sum in both blocks (f32 addition commutes)
          const float gv[2] = {mine.x + other.x, mine.y + other.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // a particle's distance to itself is 0, not the rounding of
            // |x_i|^2 (the pre-pass) against <x_i, x_i> (the tensor cores)
            const float d2 =
                i_of[mt][hh] == j0 + 8 * kNT * wn + frag_col(nt, e)
                    ? 0.f
                    : sq_i[mt][hh] + sq_j[e] - 2.0f * gv[e];
            const float kv =
                j_in[e] ? expf(-fmaxf(d2, 0.f) * inv_two_h2) : 0.f;
            acc[mt][nt][2 * hh + e] = kv;
            rows[mt][hh] += kv;
          }
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float s = rows[mt][hh];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) part[wn * kBM + 32 * wm + frag_row(mt, 2 * hh)] = s;
      }
    cluster.sync();  // the partials are read, the row parts written
    if (tid < kBM) {
      float s = part[tid];
      for (int w = 1; w < kColWarps; ++w) s += part[w * kBM + tid];
      ksum[tid] += s;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *sk_at(sk, wm, wn, mt, nt, hh) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
    // (the first stage barrier below orders these stores before K is read)

    // ---- 3. K V_j over the block's features, kDN at a time ----
    const bool last = jt == n_tiles - 1;
    const int j_chunks = (min(kBN, n - j0) + kBJ - 1) / kBJ;
    for (int f0 = f_lo; f0 < f_hi; f0 += kDN) {
      const int fw = f0 + 8 * kNT * wn;  // the warp's first feature
      const int nt_end = min(kNT, (f_hi - fw + 7) / 8);
      for (int c = 0; c < 2; ++c) {
        if (c < j_chunks)
          load_rhs<kVec>(stage + c * kStage, v, j0 + c * kBJ, f0, f_hi, n, d);
        copy_commit();
      }
      if (jt > 0) {
        // this chunk's running sums into L2, kBM rows x 8 lines of 128
        // bytes: one a thread
        for (int q = tid; q < kBM * (kDN / 32); q += kThreads) {
          const int i = i0 + q / (kDN / 32);
          const int f = f0 + (q % (kDN / 32)) * 32;
          if (i < n && f < f_hi)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                phi + static_cast<size_t>(i) * d + f));
        }
      }
      zero(run);
      for (int c = 0; c < j_chunks; ++c) {
        copy_wait_all_but_one();
        __syncthreads();
        if (c + 2 < j_chunks)
          load_rhs<kVec>(stage + ((c + 2) % kStages) * kStage, v,
                         j0 + (c + 2) * kBJ, f0, f_hi, n, d);
        copy_commit();
        const float* ka = sk + 32 * wm * kSkStride + c * kBJ;
        const float* vb = stage + (c % kStages) * kStage + 8 * kNT * wn;
        zero(acc);
#pragma unroll
        for (int ks = 0; ks < kBJ; ks += 8)
          warp_step(acc, ka + ks, kSkStride, vb + ks * kVStride, kVStride, 1,
                    nt_end);
        fold(run, acc);
      }
      // the tile's sums onto the running ones; the last tile forms phi
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 32 * wm + frag_row(mt, e);
            const int i = i0 + r;
            const int f = fw + frag_col(nt, e);
            if (i >= n || f >= f_hi) continue;
            const size_t at = static_cast<size_t>(i) * d + f;
            const float sum = jt > 0 ? phi[at] + run[mt][nt][e]
                                     : run[mt][nt][e];
            phi[at] = last ? fmaf(x[at], ksum[r] * inv_h2, sum) / n_f : sum;
          }
      __syncthreads();  // the stages are reloaded by the next chunk
    }
    __syncthreads();  // K is rewritten next tile
  }
}

// 16-byte copies where every row of x and v starts on 16 bytes
bool vector_copies(const float* x, const float* v, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

template <int kVec>
cudaError_t launch_transport(const float* x, const float* v, const float* h,
                             const float* sqn, float* phi, int n, int d,
                             cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      svgd_transport<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + kBM - 1) / kBM) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, svgd_transport<kVec>, x, v, h, sqn, phi, n,
                            d);
}

}  // namespace

extern "C" {

const char* svgd_streaming_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block of the transport kernel, in bytes.
unsigned long long svgd_streaming_smem_bytes() { return kSmemBytes; }

// Clusters of the transport kernel the current device holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
int svgd_streaming_active_clusters() {
  if (cudaFuncSetAttribute(svgd_transport<4>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes)) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);  // the flagship's 4096 particles
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(
          &clusters, reinterpret_cast<const void*>(svgd_transport<4>), &cfg) !=
      cudaSuccess)
    return -1;
  return clusters;
}

// B11: phi (n, d) from x, g (n, d) and h (a device scalar); v (n, d) and
// sqn (n,) are scratch.  All pointers are device memory, float32, row-major.
int svgd_phi_streaming_launch(const float* x, const float* g, const float* h,
                              float* phi, float* v, float* sqn, int n, int d,
                              void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  squared_norms<<<(n + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                  s>>>(x, sqn, n, d);
  const size_t total = static_cast<size_t>(n) * d;
  const size_t rhs_blocks = (total + kThreads - 1) / kThreads;
  fold_rhs<<<static_cast<unsigned>(rhs_blocks < 4096 ? rhs_blocks : 4096),
             kThreads, 0, s>>>(x, g, h, v, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vector_copies(x, v, d)
            ? launch_transport<4>(x, v, h, sqn, phi, n, d, s)
            : launch_transport<1>(x, v, h, sqn, phi, n, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
