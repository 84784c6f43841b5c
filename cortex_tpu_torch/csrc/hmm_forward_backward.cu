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
// inside the kernel (the pair path's combine, the other paths' backward pass), so no
// alpha ever leaves it.
//
// What bounds it: bytes, in the least time.  lik is read once and gamma written once,
// 8 K B per replica-step, plus K*K*4 B of xi_sum and 4 B of log_evidence per replica:
// 8.4 MB at 4096 x 64 x 4, 2.5 us at 3.35 TB/s.  The operations (about 6 K^2 flops per
// replica-step) are far below the card's rate at small K.  But each replica is a serial
// chain of 2T steps, and with 4,096 replicas (the main path) a warp per SM at most holds
// them: the chain's latency sets the time.  On an H100 SXM at 700 W (PERF.md,
// kernel_probe.py) the lane-group path took 29 us (K2) and 35 us (K3) at 4096 x 64 x 4;
// one thread running a replica's whole chain with lik staged in chunks took 45 and 54 us
// (one warp per SM on one of its four schedulers); the pair path below takes 16 and 19 us,
// of which the two chains (running at once) are about 10 us.
//
// Design:
//   * pair path (K <= 8 while the block's rows fit; the wrapper's kernel_plan): a block
//     of four warps for 32 replicas.  The backward recursion for b does not depend on
//     alpha, so warp 0 runs the replicas' forward chains while warp 1 runs their backward
//     chains, each thread holding its replica's K states (padded to KP = 1, 2, 4 or 8 with
//     zeros) and A's K^2 entries in registers: a step's product is KP independent FMA
//     chains of depth KP, its sums over states register adds, no shuffle and no butterfly.
//     Then all four warps combine, a quarter of T each: gamma_t = alpha_t b_t / sum and, with
//     COUNTS, the pairwise counts (alpha_t / N_t) w, N_t = alpha_t . A w + 1e-30,
//     w = lik_{t+1} b_{t+1}, no chain left.  The block's rows of lik come in whole by
//     16-byte cp.async copies, coalesced (the rows are contiguous); lik, alpha and b rows
//     sit in shared memory at a pitch of 4 mod 8 floats, so eight rows' 16-byte accesses
//     at one step hit 32 banks; the marginals replace the alphas in place and leave
//     coalesced.  Each normalization is one correctly rounded reciprocal and K multiplies;
//     logf(n) accumulates beside the chain.
//   * lane-group path (K <= 32, where the pair path does not run): a group of G lanes
//     (G = K rounded up to a power of two) runs one replica, lane k holding state k.  The
//     K x K products are K shuffles within the group against the lane's column (forward)
//     or row (backward) of A, held in registers; the sums over states are
//     xor-butterflies, which leave the same total in every lane.  A step's lik load is
//     issued one step ahead.  Lanes k >= K and replicas past R hold zeros and store
//     nothing: no padding.  Alphas in shared memory (32 * T floats per warp, T <= 454 at
//     4 warps a block) or through gamma in device memory, which the backward pass
//     overwrites with the marginals, as the TPU kernel does in VMEM.  IEEE divisions.
//   * general path (any K): one block per replica, threads striding over the states,
//     the state vectors in shared memory, sums over states by block reduction; A is
//     read through the cache (forward, column access) and At (backward), so that
//     neighbouring threads read neighbouring addresses.  The counts accumulate in the
//     xi_sum output, each element owned by one thread.  Alphas in shared memory (T * K
//     floats per block) or through gamma in device memory.  IEEE divisions.

#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr float kFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallBlock = 128;   // threads per block of the lane-group path (4 warps)
constexpr int kGeneralMaxBlock = 256;
constexpr int kReduceSlots = 32;   // one per warp of a general-path block

// -- lane-group path ------------------------------------------------------------------------

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

// -- pair path -------------------------------------------------------------------------------

// KP states at p (K of them; zeros past K).  p is 16-byte aligned when K == KP >= 4.
template <int KP>
__device__ __forceinline__ void read_states(const float* p, int K, float (&v)[KP]) {
  if (KP >= 4 && K == KP) {
#pragma unroll
    for (int q = 0; q < KP / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KP; ++k) v[k] = k < K ? p[k] : 0.f;
  }
}

template <int KP>
__device__ __forceinline__ void write_states(float* p, int K, const float (&v)[KP]) {
  if (KP >= 4 && K == KP) {
#pragma unroll
    for (int q = 0; q < KP / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < K) p[k] = v[k];
    }
  }
}

template <int KP>
__device__ __forceinline__ float sum_states(const float (&v)[KP]) {
  float part[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) part[k] = v[k];
#pragma unroll
  for (int width = KP / 2; width > 0; width /= 2) {
#pragma unroll
    for (int k = 0; k < width; ++k) part[k] += part[k + width];
  }
  return part[0];
}

constexpr int kPairRows = 32;   // replicas per block of the pair path
constexpr int kPairWarps = 4;   // warps per block: two run the chains, all share the rest

// Floats per row of a whole replica (T * K) in shared memory: rounded up to a multiple of 4
// (16-byte rows) that is 4 mod 8, so eight rows' 16-byte accesses at one step hit 32 banks.
__host__ __device__ constexpr long long row_pitch(long long n) {
  return (n + 3) / 4 * 4 % 8 == 0 ? (n + 3) / 4 * 4 + 4 : (n + 3) / 4 * 4;
}

// Shared memory of a pair block: lik, alpha and b rows of its replicas, and the count sums
// of every warp but the first.
__host__ __device__ constexpr long long pair_smem_bytes(int T, int K) {
  return 4LL * kPairRows * (3 * row_pitch(static_cast<long long>(T) * K) +
                            (kPairWarps - 1LL) * K * K);
}

// Block of kPairWarps warps, 32 replicas whose rows of lik are staged whole in shared
// memory by all of them.  Phase 1: warp 0 runs the replicas' forward chains (alpha_t,
// log-evidence), warp 1 at the same time their backward chains (b_t), which do not depend
// on alpha; the other warps wait.  Phase 2: every warp combines a quarter of T:
// gamma_t = alpha_t b_t / sum, and with COUNTS the pairwise counts from alpha_t, b_{t+1}
// and lik_{t+1}.  Each normalization is one correctly rounded reciprocal and K multiplies
// (its float32 torch twin: tests/test_torch_hmm_kernels.py); the counts' sum over t is
// taken in four parts, added in order.  vec: lik and gamma move 16 bytes at a time.
template <int KP, bool COUNTS>
__global__ void __launch_bounds__(kPairWarps * 32)
fb_pair_kernel(const float* __restrict__ lik, const float* __restrict__ A,
               const float* __restrict__ pi, float* __restrict__ gamma,
               float* __restrict__ xi, float* __restrict__ logz, long long R, int T, int K,
               bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int n = T * K;
  const int PL = static_cast<int>(row_pitch(n));
  float* s_lik = smem;
  float* s_alpha = s_lik + kPairRows * PL;  // alpha_t, then gamma_t
  float* s_b = s_alpha + kPairRows * PL;
  float* s_part = s_b + kPairRows * PL;  // COUNTS: warps 1.. their sums, K * K a replica
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * kPairRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kPairRows), R - r0));
  const bool live = lane < rows;  // a thread past R computes on stale rows, stores nothing
  const float* L = lik + r0 * n;  // the block's rows are contiguous
  float* G = gamma + r0 * n;

  if (vec) {
    const int q = n / 4;
    for (int e = threadIdx.x; e < rows * q; e += 32 * kPairWarps) {
      const int i = e / q, m = e - i * q;
      async_copy::copy16(s_lik + i * PL + 4 * m, L + 4LL * e);
    }
  } else {
    for (int e = threadIdx.x; e < rows * n; e += 32 * kPairWarps) {
      const int i = e / n, m = e - i * n;
      async_copy::copy4(s_lik + i * PL + m, L + e);
    }
  }

  float a_m[KP][KP];  // A[j][k]; zero outside K
#pragma unroll
  for (int j = 0; j < KP; ++j) {
#pragma unroll
    for (int k = 0; k < KP; ++k) a_m[j][k] = j < K && k < K ? A[j * K + k] : 0.f;
  }
  async_copy::copy_wait_all();
  __syncthreads();

  const float* lrow = s_lik + lane * PL;
  float* arow = s_alpha + lane * PL;
  float* brow = s_b + lane * PL;
  if (warp == 0) {  // -- forward, renormalized at every step ------------------------------
    float al[KP], l[KP], v[KP];
    read_states<KP>(lrow, K, l);
#pragma unroll
    for (int k = 0; k < KP; ++k) v[k] = (k < K ? pi[k] : 0.f) * l[k];
    float lz = 0.f;
    for (int t = 0;;) {
      const float norm = fmaxf(sum_states<KP>(v), kFloor);
      const float inv = __frcp_rn(norm);
#pragma unroll
      for (int k = 0; k < KP; ++k) al[k] = v[k] * inv;
      lz += logf(norm);
      write_states<KP>(arow + t * K, K, al);
      if (++t == T) break;
      read_states<KP>(lrow + t * K, K, l);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        float pred = 0.f;
#pragma unroll
        for (int i = 0; i < KP; ++i) pred = fmaf(a_m[i][k], al[i], pred);
        v[k] = pred * l[k];
      }
    }
    if (live) logz[r0 + lane] = lz;
  } else if (warp == 1) {  // -- backward: b_{T-1} = 1, b_t = A (lik_{t+1} b_{t+1}) / sum --------------------
    float b[KP], l[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) b[k] = 1.f;
    write_states<KP>(brow + (T - 1) * K, K, b);
    for (int t = T - 2; t >= 0; --t) {
      read_states<KP>(lrow + (t + 1) * K, K, l);
      float w[KP], u[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k) w[k] = l[k] * b[k];
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < KP; ++k) acc = fmaf(a_m[i][k], w[k], acc);
        u[i] = acc;
      }
      const float inv_s = __frcp_rn(fmaxf(sum_states<KP>(u), kFloor));
#pragma unroll
      for (int k = 0; k < KP; ++k) b[k] = u[k] * inv_s;
      write_states<KP>(brow + t * K, K, b);
    }
  }
  __syncthreads();

  // -- combine: warp w takes steps [w * span, (w + 1) * span) of its lane's replica ------
  const int span = (T + kPairWarps - 1) / kPairWarps;
  float S[COUNTS ? KP : 1][COUNTS ? KP : 1];
#pragma unroll
  for (int i = 0; i < (COUNTS ? KP : 1); ++i) {
#pragma unroll
    for (int k = 0; k < (COUNTS ? KP : 1); ++k) S[i][k] = 0.f;
  }
  const int t_end = min(T, (warp + 1) * span);
  for (int t = warp * span; t < t_end; ++t) {
    float at[KP];
    read_states<KP>(arow + t * K, K, at);
    if (t == T - 1) continue;  // gamma_{T-1} = alpha_{T-1}, already in place
    float b[KP], g[KP];
    read_states<KP>(brow + t * K, K, b);
#pragma unroll
    for (int k = 0; k < KP; ++k) g[k] = at[k] * b[k];
    const float inv_g = __frcp_rn(fmaxf(sum_states<KP>(g), kFloor));
#pragma unroll
    for (int k = 0; k < KP; ++k) g[k] *= inv_g;
    write_states<KP>(arow + t * K, K, g);
    if (COUNTS) {
      float l[KP], b1[KP], w[KP], au[KP];
      read_states<KP>(lrow + (t + 1) * K, K, l);
      read_states<KP>(brow + (t + 1) * K, K, b1);
#pragma unroll
      for (int k = 0; k < KP; ++k) w[k] = l[k] * b1[k];
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < KP; ++k) acc = fmaf(a_m[i][k], w[k], acc);
        au[i] = at[i] * acc;
      }
      const float inv_n = __frcp_rn(sum_states<KP>(au) + kFloor);
#pragma unroll
      for (int i = 0; i < (COUNTS ? KP : 1); ++i) {
        const float q = at[i] * inv_n;
#pragma unroll
        for (int k = 0; k < (COUNTS ? KP : 1); ++k) S[i][k] = fmaf(q, w[k], S[i][k]);
      }
    }
  }
  const int KK = K * K;
  if (COUNTS && warp > 0) {
    float* part = s_part + ((warp - 1) * kPairRows + lane) * KK;
#pragma unroll
    for (int i = 0; i < (COUNTS ? KP : 1); ++i) {
#pragma unroll
      for (int k = 0; k < (COUNTS ? KP : 1); ++k) {
        if (i < K && k < K) part[i * K + k] = S[i][k];
      }
    }
  }
  __syncthreads();
  if (COUNTS && warp == 0 && live) {  // the warps' sums added in order
    float* X = xi + (r0 + lane) * KK;
#pragma unroll
    for (int i = 0; i < (COUNTS ? KP : 1); ++i) {
#pragma unroll
      for (int k = 0; k < (COUNTS ? KP : 1); ++k) {
        if (i >= K || k >= K) continue;
        float total = S[i][k];
        for (int w = 1; w < kPairWarps; ++w) {
          total += s_part[((w - 1) * kPairRows + lane) * KK + i * K + k];
        }
        X[i * K + k] = a_m[i][k] * total;
      }
    }
  }

  // -- the marginals out, coalesced: the block's rows are contiguous in gamma -------------
  if (vec) {
    const int q = n / 4;
    for (int e = threadIdx.x; e < rows * q; e += 32 * kPairWarps) {
      const int i = e / q, m = e - i * q;
      *reinterpret_cast<float4*>(G + 4LL * e) =
          *reinterpret_cast<const float4*>(s_alpha + i * PL + 4 * m);
    }
  } else {
    for (int e = threadIdx.x; e < rows * n; e += 32 * kPairWarps) {
      const int i = e / n, m = e - i * n;
      G[e] = s_alpha[i * PL + m];
    }
  }
}

// -- general path ----------------------------------------------------------------------------

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

template <int KP, bool COUNTS>
int launch_pair(const float* lik, const float* A, const float* pi, float* gamma, float* xi,
                float* logz, long long R, int T, int K, cudaStream_t stream) {
  const bool vec = static_cast<long long>(T) * K % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(lik) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(gamma) & 15) == 0;
  const unsigned grid = static_cast<unsigned>((R + kPairRows - 1) / kPairRows);
  const int smem = static_cast<int>(pair_smem_bytes(T, K));
  cudaError_t err = cudaFuncSetAttribute(fb_pair_kernel<KP, COUNTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_pair_kernel<KP, COUNTS><<<grid, 32 * kPairWarps, smem, stream>>>(lik, A, pi, gamma, xi, logz,
                                                                    R, T, K, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool COUNTS>
int launch_pair_k(const float* lik, const float* A, const float* pi, float* gamma, float* xi,
                  float* logz, long long R, int T, int K, cudaStream_t stream) {
  if (K <= 1) return launch_pair<1, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, stream);
  if (K <= 2) return launch_pair<2, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, stream);
  if (K <= 4) return launch_pair<4, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, stream);
  if (K <= 8) return launch_pair<8, COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool COUNTS>
int launch(const float* lik, const float* A, const float* At, const float* pi, float* gamma,
           float* xi, float* logz, long long R, int T, int K, int group, int alpha_smem,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool sm = alpha_smem != 0;
  switch (group) {
    case 0: return launch_general<COUNTS>(lik, A, At, pi, gamma, xi, logz, R, T, K, sm, stream);
    case -1: return launch_pair_k<COUNTS>(lik, A, pi, gamma, xi, logz, R, T, K, stream);
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

// group: -1 for the pair path (K <= 8; the caller has checked that its rows fit), the
// lanes of a group that runs a replica for the lane-group path (a power of two from K up to
// 32), 0 for the general path.  alpha_in_smem: keep the alphas in shared memory (the caller
// has checked that they fit; the pair path always does).  Returns the cudaError_t of the
// launch (0 on success).
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
