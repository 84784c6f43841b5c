// Scaled (Rabiner) forward-backward of discrete HMM chains, for Hopper (sm_90a).
//
// Replaces the TPU kernels cortex_tpu/ops/pallas_hmm.py::hmm_forward_backward_pallas
// (_fb_kernel -> _fwd_bwd) and ::hmm_forward_backward_counts_pallas (_fb_alpha_kernel
// plus the two einsums that assemble the pairwise counts outside it).  One source, a
// compile-time switch COUNTS for the pairwise counts, two C entry points.
//
// Inputs: lik (R, T, K) float32 per-step likelihoods in linear space, row-major, one
// replica per (T, K) block; A (K, K) row-stochastic (row = from-state) and its
// transpose At; pi (K,).  Outputs: gamma (R, T, K) state marginals, log_evidence (R,)
// and, with COUNTS, xi_sum (R, K, K), the pairwise marginals summed over time.
// Per replica:
//   forward   a_0 = pi * lik_0,  a_t = (At a_{t-1}) * lik_t,  each divided by
//             n_t = max(sum a_t, 1e-30);  log_evidence = sum_t log n_t
//   backward  b_{T-1} = 1;  w = lik_{t+1} * b_{t+1};  u = A w;  b_t = u / max(sum u, 1e-30)
//             gamma_t = a_t b_t / max(sum a_t b_t, 1e-30)   (gamma_{T-1} = a_{T-1})
//   counts    N_t = sum_j a_t(j) u(j) + 1e-30 (= sum_k (At a_t)(k) w(k) + 1e-30)
//             xi_sum[j,k] = A[j,k] * sum_t (a_t(j) / N_t) * w(k)
// The counts are those of the TPU wrapper's formula (pallas_hmm.py:237-247), whose beta
// is gamma / alpha: a scale of b_t that cancels in w / N_t.  Here they are summed
// inside the backward pass, so no alpha ever leaves the kernel.
//
// What bounds it: bytes, in the least time.  lik is read once (the backward pass reads
// it again, from L2) and gamma written once, 8 K B per replica-step, plus K*K*4 B of
// xi_sum and 4 B of log_evidence per replica: 8.4 MB at 4096 x 64 x 4, 2.5 us at
// 3.35 TB/s.  The operations (about 6 K^2 flops per replica-step) are far below the
// card's rate at small K.  But each replica is a serial chain of 2T steps, each a few
// shuffles, butterfly sums and IEEE divisions long, and that chain sets the time: on an
// H100 SXM at 700 W the kernel takes about 12x its bound at 4096 replicas and 4x at
// 65,536 (PERF.md), and keeping the lik loads eight steps ahead instead of one moved
// neither time.
//
// Design:
//   * small-K path (K <= 32): a group of G lanes (G = K rounded up to a power of two)
//     runs one replica, lane k holding state k.  The K x K products are K shuffles
//     within the group against the lane's column (forward) or row (backward) of A,
//     held in registers; the sums over states are xor-butterflies, which leave the
//     same total in every lane.  A step's lik load is issued one step ahead.  Lanes
//     k >= K and replicas past R hold zeros and store nothing: no padding.
//   * general path (any K): one block per replica, threads striding over the states,
//     the state vectors in shared memory, sums over states by block reduction; A is
//     read through the cache (forward, column access) and At (backward), so that
//     neighbouring threads read neighbouring addresses.  The counts accumulate in the
//     xi_sum output, each element owned by one thread.
//   * alphas: kept in shared memory while they fit (small path: 32 * T floats per warp,
//     T <= 454 at 4 warps a block; general path: T * K floats per block); otherwise
//     they go through the gamma output in device memory, which the backward pass
//     overwrites with the marginals, as the TPU kernel does in VMEM.
//   * IEEE division and logf throughout: no approximate reciprocal.

#include <cuda_runtime.h>

namespace {

constexpr float kFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallBlock = 128;   // threads per block of the small-K path (4 warps)
constexpr int kGeneralMaxBlock = 256;
constexpr int kReduceSlots = 32;   // one per warp of a general-path block

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, G);
  return v;
}

template <int G, bool COUNTS, bool ALPHA_SMEM>
__global__ void __launch_bounds__(kSmallBlock)
fb_small_kernel(const float* __restrict__ lik, const float* __restrict__ A,
                const float* __restrict__ pi, float* __restrict__ gamma,
                float* __restrict__ xi, float* __restrict__ logz, long long R, int T, int K) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = lane & (G - 1);
  const long long r =
      (static_cast<long long>(blockIdx.x) * (kSmallBlock / 32) + warp) * (32 / G) + lane / G;
  const bool live = r < R && k < K;
  const long long row = live ? r * T * K : 0;
  const float* L = lik + row;
  float* out = gamma + row;
  float* s_alpha = smem + warp * 32 * T;  // ALPHA_SMEM: alpha_t of this lane at t * 32 + lane

  float a_col[G], a_row[G];  // A[j][k] and A[k][j]; zero outside K
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool in = k < K && j < K;
    a_col[j] = in ? A[j * K + k] : 0.f;
    a_row[j] = in ? A[k * K + j] : 0.f;
  }

  // -- forward, renormalized at every step ---------------------------------------
  float a = (k < K ? pi[k] : 0.f) * (live ? L[k] : 0.f);
  float n = fmaxf(group_sum<G>(a), kFloor);
  a = a / n;
  float lz = logf(n);
  if (ALPHA_SMEM) {
    s_alpha[lane] = a;
  } else if (live) {
    out[k] = a;
  }
  float lik_next = (live && T > 1) ? L[K + k] : 0.f;
  for (int t = 1; t < T; ++t) {
    const float lik_t = lik_next;
    if (t + 1 < T) lik_next = live ? L[(t + 1) * K + k] : 0.f;
    float pred = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) pred = fmaf(a_col[j], __shfl_sync(kFull, a, j, G), pred);
    a = pred * lik_t;
    n = fmaxf(group_sum<G>(a), kFloor);
    a = a / n;
    lz += logf(n);
    if (ALPHA_SMEM) {
      s_alpha[t * 32 + lane] = a;
    } else if (live) {
      out[t * K + k] = a;
    }
  }
  if (r < R && k == 0) logz[r] = lz;

  // -- backward, emitting the marginals (and summing the pairwise counts) ---------
  if (ALPHA_SMEM && live) out[(T - 1) * K + k] = a;  // gamma_{T-1} = alpha_{T-1}
  float S[COUNTS ? G : 1];
#pragma unroll
  for (int j = 0; j < (COUNTS ? G : 1); ++j) S[j] = 0.f;
  float b = 1.f;
  float lik_up = live ? L[(T - 1) * K + k] : 0.f;  // lik_{t+1}
  for (int t = T - 2; t >= 0; --t) {
    const float lik_t = live ? L[t * K + k] : 0.f;  // lik_{t+1} of the next step
    const float w = lik_up * b;
    float u = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) u = fmaf(a_row[j], __shfl_sync(kFull, w, j, G), u);
    const float a_t = ALPHA_SMEM ? s_alpha[t * 32 + lane] : (live ? out[t * K + k] : 0.f);
    const float s = fmaxf(group_sum<G>(u), kFloor);
    b = u / s;
    const float g = a_t * b;
    const float gs = fmaxf(group_sum<G>(g), kFloor);
    if (live) out[t * K + k] = g / gs;
    if (COUNTS) {
      const float N = group_sum<G>(a_t * u) + kFloor;
      const float q = a_t / N;
#pragma unroll
      for (int j = 0; j < G; ++j) S[j] = fmaf(__shfl_sync(kFull, q, j, G), w, S[j]);
    }
    lik_up = lik_t;
  }
  if (COUNTS && live) {
    float* X = xi + r * K * K;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < K) X[j * K + k] = a_col[j] * S[j];
    }
  }
}

// Sum of v over the block; every thread returns the same value.  s_red holds one
// slot per warp.
__device__ __forceinline__ float block_sum(float v, float* s_red) {
  v = group_sum<32>(v);
  __syncthreads();  // the previous reduction's slots have been read
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = (blockDim.x + 31) >> 5;
  for (int i = 0; i < warps; ++i) total += s_red[i];
  return total;
}

template <bool COUNTS, bool ALPHA_SMEM>
__global__ void fb_general_kernel(const float* __restrict__ lik, const float* __restrict__ A,
                                  const float* __restrict__ At, const float* __restrict__ pi,
                                  float* __restrict__ gamma, float* __restrict__ xi,
                                  float* __restrict__ logz, int T, int K) {
  extern __shared__ float smem[];
  float* s_a = smem;             // K: alpha_{t-1} (forward)
  float* s_v = s_a + K;          // K: the unnormalized alpha_t, then b_{t+1} / u (backward)
  float* s_w = s_v + K;          // K: w = lik_{t+1} * b_{t+1}
  float* s_q = s_w + K;          // K: alpha_t / N_t (counts)
  float* s_red = s_q + K;        // kReduceSlots
  float* s_alpha = s_red + kReduceSlots;  // ALPHA_SMEM: T * K
  const long long r = blockIdx.x;
  const float* L = lik + r * T * K;
  float* out = gamma + r * T * K;
  float* alpha = ALPHA_SMEM ? s_alpha : out;
  const int tid = threadIdx.x, nt = blockDim.x;

  // -- forward ---------------------------------------------------------------------
  float part = 0.f;
  for (int k = tid; k < K; k += nt) {
    const float v = pi[k] * L[k];
    s_v[k] = v;
    part += v;
  }
  float n = fmaxf(block_sum(part, s_red), kFloor);
  float lz = logf(n);
  for (int k = tid; k < K; k += nt) {
    const float v = s_v[k] / n;
    s_a[k] = v;
    alpha[k] = v;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    part = 0.f;
    for (int k = tid; k < K; k += nt) {
      float pred = 0.f;
      for (int j = 0; j < K; ++j) pred = fmaf(A[j * K + k], s_a[j], pred);
      const float v = pred * L[t * K + k];
      s_v[k] = v;
      part += v;
    }
    n = fmaxf(block_sum(part, s_red), kFloor);  // its barriers end every read of s_a
    lz += logf(n);
    for (int k = tid; k < K; k += nt) {
      const float v = s_v[k] / n;
      s_a[k] = v;
      alpha[t * K + k] = v;
    }
    __syncthreads();
  }
  if (tid == 0) logz[r] = lz;

  // -- backward ----------------------------------------------------------------------
  float* X = COUNTS ? xi + r * K * K : nullptr;
  for (int k = tid; k < K; k += nt) {
    if (ALPHA_SMEM) out[(T - 1) * K + k] = alpha[(T - 1) * K + k];
    s_v[k] = 1.f;  // b_{T-1}
  }
  if (COUNTS) {
    for (int i = tid; i < K * K; i += nt) X[i] = 0.f;
  }
  __syncthreads();
  for (int t = T - 2; t >= 0; --t) {
    for (int k = tid; k < K; k += nt) s_w[k] = L[(t + 1) * K + k] * s_v[k];
    __syncthreads();
    float part_u = 0.f, part_au = 0.f;
    for (int j = tid; j < K; j += nt) {
      float u = 0.f;
      for (int k = 0; k < K; ++k) u = fmaf(At[k * K + j], s_w[k], u);
      s_v[j] = u;
      part_u += u;
      part_au += alpha[t * K + j] * u;
    }
    const float s = fmaxf(block_sum(part_u, s_red), kFloor);
    const float N = COUNTS ? block_sum(part_au, s_red) + kFloor : 1.f;
    float part_g = 0.f;
    for (int j = tid; j < K; j += nt) {
      const float a_t = alpha[t * K + j];
      const float b = s_v[j] / s;
      s_v[j] = b;
      const float g = a_t * b;
      alpha[t * K + j] = g;  // alpha_t is used up: keep the unnormalized marginal there
      part_g += g;
      if (COUNTS) s_q[j] = a_t / N;
    }
    const float gs = fmaxf(block_sum(part_g, s_red), kFloor);  // also publishes s_q, s_v
    for (int j = tid; j < K; j += nt) out[t * K + j] = alpha[t * K + j] / gs;
    if (COUNTS) {
      for (int i = tid; i < K * K; i += nt) {
        const int j = i / K;
        X[i] = fmaf(s_q[j], s_w[i - j * K], X[i]);
      }
    }
    __syncthreads();  // s_w is rewritten by the next step
  }
  if (COUNTS) {
    for (int i = tid; i < K * K; i += nt) X[i] = A[i] * X[i];
  }
}

template <int G, bool COUNTS>
int launch_small(const float* lik, const float* A, const float* pi, float* gamma, float* xi,
                 float* logz, long long R, int T, int K, bool alpha_smem, cudaStream_t stream) {
  const long long per_block = (kSmallBlock / 32) * (32 / G);
  const unsigned grid = static_cast<unsigned>((R + per_block - 1) / per_block);
  if (alpha_smem) {
    const int smem = (kSmallBlock / 32) * 32 * T * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(fb_small_kernel<G, COUNTS, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fb_small_kernel<G, COUNTS, true><<<grid, kSmallBlock, smem, stream>>>(
        lik, A, pi, gamma, xi, logz, R, T, K);
  } else {
    fb_small_kernel<G, COUNTS, false><<<grid, kSmallBlock, 0, stream>>>(
        lik, A, pi, gamma, xi, logz, R, T, K);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool COUNTS>
int launch_general(const float* lik, const float* A, const float* At, const float* pi,
                   float* gamma, float* xi, float* logz, long long R, int T, int K,
                   bool alpha_smem, cudaStream_t stream) {
  const int block = K >= kGeneralMaxBlock ? kGeneralMaxBlock : (K + 31) / 32 * 32;
  const long long floats = 4LL * K + kReduceSlots + (alpha_smem ? static_cast<long long>(T) * K : 0);
  const int smem = static_cast<int>(floats * sizeof(float));
  const unsigned grid = static_cast<unsigned>(R);
  cudaError_t err;
  if (alpha_smem) {
    err = cudaFuncSetAttribute(fb_general_kernel<COUNTS, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fb_general_kernel<COUNTS, true><<<grid, block, smem, stream>>>(lik, A, At, pi, gamma, xi,
                                                                   logz, T, K);
  } else {
    err = cudaFuncSetAttribute(fb_general_kernel<COUNTS, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fb_general_kernel<COUNTS, false><<<grid, block, smem, stream>>>(lik, A, At, pi, gamma, xi,
                                                                    logz, T, K);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool COUNTS>
int launch(const float* lik, const float* A, const float* At, const float* pi, float* gamma,
           float* xi, float* logz, long long R, int T, int K, int group, int alpha_smem,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool sm = alpha_smem != 0;
  switch (group) {
    case 0: return launch_general<COUNTS>(lik, A, At, pi, gamma, xi, logz, R, T, K, sm, stream);
    case 1: return launch_small<1, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, sm, stream);
    case 2: return launch_small<2, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, sm, stream);
    case 4: return launch_small<4, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, sm, stream);
    case 8: return launch_small<8, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, sm, stream);
    case 16: return launch_small<16, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, sm, stream);
    case 32: return launch_small<32, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, sm, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// group: 0 for the general path, else the small path's lanes per replica (a power of two
// from K up to 32).  alpha_in_smem: keep the alphas in shared memory (the caller has
// checked that they fit).  Returns the cudaError_t of the launch (0 on success).
int hmm_forward_backward_f32(const float* lik, const float* A, const float* At, const float* pi,
                             float* gamma, float* log_evidence, long long R, int T, int K,
                             int group, int alpha_in_smem, void* stream) {
  return launch<false>(lik, A, At, pi, gamma, nullptr, log_evidence, R, T, K, group,
                       alpha_in_smem, stream);
}

int hmm_forward_backward_counts_f32(const float* lik, const float* A, const float* At,
                                    const float* pi, float* gamma, float* xi_sum,
                                    float* log_evidence, long long R, int T, int K, int group,
                                    int alpha_in_smem, void* stream) {
  return launch<true>(lik, A, At, pi, gamma, xi_sum, log_evidence, R, T, K, group,
                      alpha_in_smem, stream);
}

}  // extern "C"
