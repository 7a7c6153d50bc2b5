// flash-SGHMC for Hopper: k SGHMC steps of the dense tanh BNN per launch.
//
// Replaces the TPU Pallas kernels
//   B1  pysgmcmc_tpu/ops/fused_step.py::fused_bnn_multistep
//       (generator _make_multistep_kernel_family, sampling phase)
//   B2  pysgmcmc_tpu/ops/fused_step.py::fused_bnn_multistep_burnin
//       (generator _make_multistep_kernel_burnin, self-tuning burn-in)
// with the same semantics at the unpacked-parameter level: per step, draw a
// minibatch window, run the forward pass, the heteroscedastic Gaussian NLL
// plus the log-variance prior, the hand-written backward pass, fold the
// Gaussian weight prior into the gradient, draw the noise and apply the
// SGHMC update (B1: frozen minv; B2: the tau/g/v_hat EMAs and
// minv = 1/sqrt(old v_hat), all reading OLD values).
//
// Design.  One thread block owns one chain.  At launch it loads the chain's
// whole state (theta, v and minv, or theta, v, tau, g, v_hat) plus a
// gradient buffer into dynamic shared memory, runs the k steps there and
// writes the state back once: the counterpart of the TPU kernel's VMEM
// residency.  Device memory then sees only the state's load and store per
// launch and the small window reads per step, so once the state is resident
// the kernel is bound by FP32 FMA issue and shared-memory bandwidth in the
// six batch x H x H products of each step, not by HBM.  All arithmetic is
// f32 on the CUDA cores (no tensor cores yet) and the layout is the port's
// flat per-chain vector (pysgmcmc_tpu_torch/ops/fused_step.py, FusedLayout):
//   w1 (k*H) | b1 (H) | w2 (H*H) | b2 (H) | ... | wD (H*H) | bD (H)
//   | w_head (H) | b_head (1) | log_variance_bias (1)
// Weight matrices are row-major (in, out).
//
// Randomness is Philox4x32-10 keyed by the 64-bit seed, with the counter
// (chain, absolute step, element, purpose), so neither the block shape nor
// the chunking of launches changes a trajectory.  The bits-to-uniform map
// u = ((bits >> 8) + 1) * 2^-24 in (0, 1] is exact in f32 and shared with
// the plain PyTorch version, which implements the same stream.
//
// Built with nvcc into a shared library with a plain C interface; each
// entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kPurposeWindow = 0u;
constexpr unsigned kPurposeNoise = 1u;
constexpr float kLogMeanPrior = -13.815510557964274f;  // log(1e-6)
constexpr float kVarPrior = 0.01f;
constexpr float kHalfLogVarPrior = -2.302585092994046f;  // 0.5 * log(0.01)
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kSmall = 1e-16f;

struct Args {
  const float* theta;
  const float* v;
  const float* minv;   // B1 only
  const float* tau;    // B2 only
  const float* g;      // B2 only
  const float* v_hat;  // B2 only
  float* theta_out;
  float* v_out;
  float* tau_out;      // B2 only
  float* g_out;        // B2 only
  float* v_hat_out;    // B2 only
  float* minv_out;     // B2 only: the minv the final step used
  float* cost_out;     // (n_chains,): the final step's cost
  const float* x_win;  // (n_windows, batch, n_inputs)
  const float* y_win;  // (n_windows, batch)
  const float* eps_tab;  // (k_steps, 2): eps, eps / sqrt(scale_grad)
  const float* noise;    // optional (k_steps, n_chains, n_params)
  const int* widx;       // optional (k_steps, n_chains)
  int n_chains, n_inputs, hidden, depth, batch, n_windows, k_steps, n_params;
  unsigned long long seed;
  unsigned step0;
  float mdecay, prior_scale, inv_b, inv_n;
};

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

__device__ __forceinline__ uint4 draw(const Args& a, unsigned chain,
                                      unsigned step, unsigned element,
                                      unsigned purpose) {
  return philox4x32_10(make_uint4(chain, step, element, purpose),
                       static_cast<unsigned>(a.seed),
                       static_cast<unsigned>(a.seed >> 32));
}

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

// Shared-memory scratch besides the state arrays.
struct Scratch {
  float* act;    // depth x (batch x hidden): post-tanh activations
  float* dz;     // batch x hidden
  float* da;     // batch x hidden
  float* x;      // batch x n_inputs
  float* y;      // batch
  float* fmean;  // batch
  float* dmean;  // batch
  float* scal;   // [0]: cost; [1]: window index (as int bits)
};

// Forward, likelihood and backward for the chain whose parameters are in
// `th`; writes the likelihood gradient (without the weight prior) to `grad`
// and the cost to s.scal[0].  Ends with a barrier.
__device__ void fwd_bwd(const Args& a, const Layout& L, const float* th,
                        float* grad, const Scratch& s) {
  const int tid = threadIdx.x;
  const int H = a.hidden, K = a.n_inputs, B = a.batch, D = a.depth;
  const int BH = B * H;

  // layer 1
  for (int o = tid; o < BH; o += kThreads) {
    const int b = o / H, j = o - b * H;
    float z = 0.0f;
    for (int i = 0; i < K; ++i) z += s.x[b * K + i] * th[L.w1 + i * H + j];
    s.act[o] = tanhf(z + th[L.b1 + j]);
  }
  __syncthreads();
  // hidden layers 2..D
  for (int l = 2; l <= D; ++l) {
    const float* w = th + L.w(l, H, K);
    const float* bias = th + L.b(l, H, K);
    const float* a_in = s.act + (l - 2) * BH;
    float* a_out = s.act + (l - 1) * BH;
    for (int o = tid; o < BH; o += kThreads) {
      const int b = o / H, j = o - b * H;
      const float* row = a_in + b * H;
      float z = 0.0f;
      for (int i = 0; i < H; ++i) z += row[i] * w[i * H + j];
      a_out[o] = tanhf(z + bias[j]);
    }
    __syncthreads();
  }
  const float* a_last = s.act + (D - 1) * BH;
  // mean head: one warp per batch row
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int b = warp; b < B; b += kWarps) {
      float acc = 0.0f;
      for (int j = lane; j < H; j += 32) acc += a_last[b * H + j] * th[L.head_w + j];
      acc = warp_sum(acc);
      if (lane == 0) s.fmean[b] = acc + th[L.head_b];
    }
  }
  __syncthreads();
  // heteroscedastic likelihood + log-variance prior (warp 0)
  if (tid < 32) {
    const float lvb = th[L.lvb];
    const float e_lv = expf(lvb);
    const float var_inv = 1.0f / (e_lv + kSmall);
    float ll = 0.0f, dl = 0.0f, gb = 0.0f;
    for (int b = tid; b < B; b += 32) {
      const float diff = s.fmean[b] - s.y[b];
      const float mse = diff * diff;
      ll += -mse * (0.5f * var_inv) - 0.5f * lvb;
      dl += mse * (0.5f * e_lv) * (var_inv * var_inv) - 0.5f;
      const float dm = diff * var_inv * a.inv_b;
      s.dmean[b] = dm;
      gb += dm;
    }
    ll = warp_sum(ll);
    dl = warp_sum(dl);
    gb = warp_sum(gb);
    if (tid == 0) {
      const float dev = lvb - kLogMeanPrior;
      const float p_term = -(dev * dev) / (2.0f * kVarPrior) - kHalfLogVarPrior;
      s.scal[0] = -(ll * a.inv_b + p_term * a.inv_n);
      grad[L.lvb] = -dl * a.inv_b + dev / kVarPrior * a.inv_n;
      grad[L.head_b] = gb;
    }
  }
  __syncthreads();
  // head weight gradient and the last layer's pre-activation gradient
  for (int j = tid; j < H; j += kThreads) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += a_last[b * H + j] * s.dmean[b];
    grad[L.head_w + j] = acc;
  }
  for (int o = tid; o < BH; o += kThreads) {
    const int b = o / H, j = o - b * H;
    const float act = a_last[o];
    s.dz[o] = (s.dmean[b] * th[L.head_w + j]) * (1.0f - act * act);
  }
  __syncthreads();
  // hidden layers D..2: weight/bias gradients and the backward product
  for (int l = D; l >= 2; --l) {
    const float* w = th + L.w(l, H, K);
    const float* a_in = s.act + (l - 2) * BH;
    float* gw = grad + L.w(l, H, K);
    float* gbias = grad + L.b(l, H, K);
    for (int o = tid; o < H * H; o += kThreads) {
      const int i = o / H, j = o - i * H;
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc += a_in[b * H + i] * s.dz[b * H + j];
      gw[o] = acc;
    }
    for (int j = tid; j < H; j += kThreads) {
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc += s.dz[b * H + j];
      gbias[j] = acc;
    }
    for (int o = tid; o < BH; o += kThreads) {
      const int b = o / H, i = o - b * H;
      const float* dz_row = s.dz + b * H;
      const float* w_row = w + i * H;
      float acc = 0.0f;
      for (int j = 0; j < H; ++j) acc += dz_row[j] * w_row[j];
      s.da[o] = acc;
    }
    __syncthreads();
    for (int o = tid; o < BH; o += kThreads) {
      const float act = a_in[o];
      s.dz[o] = s.da[o] * (1.0f - act * act);
    }
    __syncthreads();
  }
  // layer 1
  for (int o = tid; o < K * H; o += kThreads) {
    const int i = o / H, j = o - i * H;
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += s.x[b * K + i] * s.dz[b * H + j];
    grad[L.w1 + o] = acc;
  }
  for (int j = tid; j < H; j += kThreads) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += s.dz[b * H + j];
    grad[L.b1 + j] = acc;
  }
  __syncthreads();
}

// Draws (or reads) this step's window and stages its rows in shared memory.
__device__ void load_window(const Args& a, int t, unsigned step,
                            const Scratch& s) {
  const int c = blockIdx.x;
  if (threadIdx.x == 0) {
    int w;
    if (a.widx != nullptr) {
      w = a.widx[static_cast<size_t>(t) * a.n_chains + c];
    } else {
      const float u = bits_to_uniform(draw(a, c, step, 0u, kPurposeWindow).x);
      w = min(static_cast<int>(u * static_cast<float>(a.n_windows)),
              a.n_windows - 1);
    }
    reinterpret_cast<int*>(s.scal)[1] = w;
  }
  __syncthreads();
  const int w = reinterpret_cast<const int*>(s.scal)[1];
  const int bk = a.batch * a.n_inputs;
  for (int i = threadIdx.x; i < bk; i += kThreads)
    s.x[i] = a.x_win[static_cast<size_t>(w) * bk + i];
  for (int i = threadIdx.x; i < a.batch; i += kThreads)
    s.y[i] = a.y_win[static_cast<size_t>(w) * a.batch + i];
  __syncthreads();
}

__device__ __forceinline__ float noise_at(const Args& a, int t, unsigned step,
                                          int p) {
  const int c = blockIdx.x;
  if (a.noise != nullptr)
    return a.noise[(static_cast<size_t>(t) * a.n_chains + c) * a.n_params + p];
  const uint4 r = draw(a, c, step, static_cast<unsigned>(p), kPurposeNoise);
  const float u1 = bits_to_uniform(r.x), u2 = bits_to_uniform(r.y);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

template <bool kBurnin>
__global__ void __launch_bounds__(kThreads) multistep_kernel(Args a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = a.n_params;
  const size_t base = static_cast<size_t>(c) * P;
  const Layout L = make_layout(a.n_inputs, a.hidden, a.depth);

  float* s_theta = smem;
  float* s_v = s_theta + P;
  float* s_grad = s_v + P;
  float* s_minv = s_grad + P;  // B1
  float* s_tau = s_grad + P;   // B2
  float* s_g = s_tau + P;      // B2
  float* s_vhat = s_g + P;     // B2
  float* rest = s_grad + (kBurnin ? 4 : 2) * P;
  Scratch s;
  s.act = rest;
  s.dz = s.act + a.depth * a.batch * a.hidden;
  s.da = s.dz + a.batch * a.hidden;
  s.x = s.da + a.batch * a.hidden;
  s.y = s.x + a.batch * a.n_inputs;
  s.fmean = s.y + a.batch;
  s.dmean = s.fmean + a.batch;
  s.scal = s.dmean + a.batch;

  for (int p = tid; p < P; p += kThreads) {
    s_theta[p] = a.theta[base + p];
    s_v[p] = a.v[base + p];
    if (kBurnin) {
      s_tau[p] = a.tau[base + p];
      s_g[p] = a.g[base + p];
      s_vhat[p] = a.v_hat[base + p];
    } else {
      s_minv[p] = a.minv[base + p];
    }
  }
  __syncthreads();

  for (int t = 0; t < a.k_steps; ++t) {
    const unsigned step = a.step0 + static_cast<unsigned>(t);
    load_window(a, t, step, s);
    fwd_bwd(a, L, s_theta, s_grad, s);
    const float eps = a.eps_tab[2 * t];
    const float es = a.eps_tab[2 * t + 1];
    const float es2 = es * es;
    const bool last = t == a.k_steps - 1;
    for (int p = tid; p < P; p += kThreads) {
      const float eta = noise_at(a, t, step, p);
      const float th = s_theta[p];
      const float vv = s_v[p];
      const float gg = s_grad[p] + a.prior_scale * th;
      float minv;
      if (kBurnin) {
        const float tau = s_tau[p], gm = s_g[p], vh = s_vhat[p];
        const float sq = sqrtf(fmaxf(vh, 0.0f));
        minv = 1.0f / (sq + 2.0f * sign_of(sq) * kSmall + kSmall);
        const float denom = vh + 2.0f * sign_of(vh) * kSmall + kSmall;
        const float r = 1.0f / (tau + 1.0f);
        s_tau[p] = tau + (-gm * gm * tau) / denom + 1.0f;
        s_g[p] = gm - r * gm + r * gg;
        s_vhat[p] = vh - r * vh + r * gg * gg;
        if (last) a.minv_out[base + p] = minv;
      } else {
        minv = s_minv[p];
      }
      const float sigma =
          sqrtf(fmaxf(2.0f * es2 * a.mdecay * minv - es2 * es2, 1e-16f));
      float vn = vv - eps * eps * minv * gg - a.mdecay * vv + sigma * eta;
      if (!kBurnin && !(minv > 0.0f)) vn = 0.0f;
      s_v[p] = vn;
      s_theta[p] = th + vn;
    }
    if (last && tid == 0) a.cost_out[c] = s.scal[0];
    __syncthreads();
  }

  for (int p = tid; p < P; p += kThreads) {
    a.theta_out[base + p] = s_theta[p];
    a.v_out[base + p] = s_v[p];
    if (kBurnin) {
      a.tau_out[base + p] = s_tau[p];
      a.g_out[base + p] = s_g[p];
      a.v_hat_out[base + p] = s_vhat[p];
    }
  }
}

size_t smem_bytes(bool burnin, int n_params, int n_inputs, int hidden,
                  int depth, int batch) {
  const size_t state = static_cast<size_t>(burnin ? 6 : 4) * n_params;
  const size_t scratch = static_cast<size_t>(depth + 2) * batch * hidden +
                         static_cast<size_t>(batch) * n_inputs + 3 * batch + 2;
  return (state + scratch) * sizeof(float);
}

template <bool kBurnin>
int launch(const Args& a, void* stream) {
  const size_t bytes = smem_bytes(kBurnin, a.n_params, a.n_inputs, a.hidden,
                                  a.depth, a.batch);
  cudaError_t err = cudaFuncSetAttribute(
      multistep_kernel<kBurnin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  multistep_kernel<kBurnin><<<a.n_chains, kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of a kernel needs, in bytes (burnin: B2 if 1).
unsigned long long fused_step_smem_bytes(int burnin, int n_params,
                                         int n_inputs, int hidden, int depth,
                                         int batch) {
  return smem_bytes(burnin != 0, n_params, n_inputs, hidden, depth, batch);
}

const char* fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1: k sampling steps with a frozen minv.
int fused_bnn_multistep_launch(
    const float* theta, const float* v, const float* minv, const float* x_win,
    const float* y_win, const float* eps_tab, const float* noise,
    const int* widx, float* theta_out, float* v_out, float* cost_out,
    int n_chains, int n_inputs, int hidden, int depth, int batch,
    int n_windows, int k_steps, int n_params, unsigned long long seed,
    unsigned step0, float mdecay, float prior_scale, float inv_b, float inv_n,
    void* stream) {
  Args a = {};
  a.theta = theta;
  a.v = v;
  a.minv = minv;
  a.theta_out = theta_out;
  a.v_out = v_out;
  a.cost_out = cost_out;
  a.x_win = x_win;
  a.y_win = y_win;
  a.eps_tab = eps_tab;
  a.noise = noise;
  a.widx = widx;
  a.n_chains = n_chains;
  a.n_inputs = n_inputs;
  a.hidden = hidden;
  a.depth = depth;
  a.batch = batch;
  a.n_windows = n_windows;
  a.k_steps = k_steps;
  a.n_params = n_params;
  a.seed = seed;
  a.step0 = step0;
  a.mdecay = mdecay;
  a.prior_scale = prior_scale;
  a.inv_b = inv_b;
  a.inv_n = inv_n;
  return launch<false>(a, stream);
}

// B2: k self-tuning burn-in steps; minv_out gets the final step's minv.
int fused_bnn_multistep_burnin_launch(
    const float* theta, const float* v, const float* tau, const float* g,
    const float* v_hat, const float* x_win, const float* y_win,
    const float* eps_tab, const float* noise, const int* widx,
    float* theta_out, float* v_out, float* tau_out, float* g_out,
    float* v_hat_out, float* minv_out, float* cost_out, int n_chains,
    int n_inputs, int hidden, int depth, int batch, int n_windows,
    int k_steps, int n_params, unsigned long long seed, unsigned step0,
    float mdecay, float prior_scale, float inv_b, float inv_n, void* stream) {
  Args a = {};
  a.theta = theta;
  a.v = v;
  a.tau = tau;
  a.g = g;
  a.v_hat = v_hat;
  a.theta_out = theta_out;
  a.v_out = v_out;
  a.tau_out = tau_out;
  a.g_out = g_out;
  a.v_hat_out = v_hat_out;
  a.minv_out = minv_out;
  a.cost_out = cost_out;
  a.x_win = x_win;
  a.y_win = y_win;
  a.eps_tab = eps_tab;
  a.noise = noise;
  a.widx = widx;
  a.n_chains = n_chains;
  a.n_inputs = n_inputs;
  a.hidden = hidden;
  a.depth = depth;
  a.batch = batch;
  a.n_windows = n_windows;
  a.k_steps = k_steps;
  a.n_params = n_params;
  a.seed = seed;
  a.step0 = step0;
  a.mdecay = mdecay;
  a.prior_scale = prior_scale;
  a.inv_b = inv_b;
  a.inv_n = inv_n;
  return launch<true>(a, stream);
}

}  // extern "C"
