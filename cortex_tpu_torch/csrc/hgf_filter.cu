// 2-level continuous HGF filtering (Mathys et al. 2011) of many replicas, for Hopper (sm_90a).
//
// Replaces the TPU kernel cortex_tpu/ops/pallas_hgf.py::hgf_filter_pallas: both of its
// Pallas kernels, _hgf_sublane_kernel and the row-major _hgf_kernel, which differ only in
// how the TPU's registers hold a step's operands.  Input u is (R, T) float32, row-major,
// one replica per row; the state starts at mu = 0, pi = 1.  Outputs: the final (mu1, pi1,
// mu2, pi2) as one (4, R) float32 array, and only the requested tracks among (mu1, pi1,
// mu2, pi2, delta1), each (R, T) in float32 or bfloat16.  The guards are the model's:
// log-volatility clipped to +-max_log_nu, pi2 floored at min_pi2, the mu2 step clipped to
// +-max_mu2_step.
//
// What bounds it on the H100.  The bytes (u read once, 4 B a replica-step; 24 B with all
// five float32 tracks) take 20 to 120 us at 3.35 TB/s for R=65,536 x T=256.  Each replica
// is a chain of T dependent steps, one thread per replica, and R / 132 = 496 threads per
// SM is all there is to hide it.  Measured on the earlier design (kernel_probe.py
// breakdown; PERF.md): its step alone, u made in registers and nothing stored, took 100 us
// of its 151 us filter-only, ~110 instructions a step on a dependent chain of ~770 cycles,
// each correctly rounded reciprocal and the division a branchy sequence on that chain.
// Staging u through shared memory (a load with no prefetch and two barriers per 16-step
// chunk) cost the other ~45 us, and with five tracks the stores, issued after each chunk's
// steps, 115 us more.
//
// Design:
//   * One thread per replica, its state in registers for all T steps.
//   * u is prefetched into registers one 16-step chunk ahead (16-byte loads when T is a
//     multiple of 4), so no step waits on device memory.
//   * The step is the plain version's (ops/kernels_hgf.py::hgf_update, shared with
//     HGF.step) operation for operation, each rounded as torch rounds it: __fadd_rn /
//     __fmul_rn keep nvcc from contracting a multiply and an add into one FMA, 1/x is the
//     correctly rounded reciprocal, a/x the correctly rounded division, and the constants
//     0.5*kappa^2 and 0.5*kappa come from the host, computed in double and rounded once.
//     The kernel equals its plain version bit for bit.  A shorter step that rounds
//     otherwise (FMAs, MUFU reciprocals with a Newton step, the fast exp) ran 40% faster
//     filter-only, but the recursion grows any rounding difference past the 1e-5 bar within
//     a few thousand steps.  Writing out the intrinsics' fast paths without their branches
//     kept the bits and, with these track stores, gained nothing: the chain of correctly
//     rounded operations, not the branches, sets the step's time.
//   * Tracks: each thread writes every step's values to its own row of a shared tile per
//     track (an odd number of words a row, so a warp's 32 writes hit 32 banks), and after
//     each 16-step chunk the block writes its tiles out coalesced, between two barriers;
//     no barrier at all without tracks.  Measured against this (kernel_probe.py compare;
//     PERF.md) and dropped: one bulk store (the Tensor Memory Accelerator) per row, track
//     and chunk, with or without an L2 evict-last hint, 16-byte stores from registers,
//     and two tiles flushed every 8 steps; each was slower with tracks.
//   * Which tracks are written is decided at run time by which output pointers are
//     non-null, so one instantiation per track type serves every subset.  Any T fits.
// Clamps propagate NaN, as torch.clamp does.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;   // replicas per block, one thread each
constexpr int kChunk = 16;  // steps of u prefetched, and of the tracks per write-out
constexpr int kTracks = 5;  // mu1, pi1, mu2, pi2, delta1

struct Params {
  float kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step;
  float half_kappa_sq, half_kappa;  // 0.5 * kappa^2, 0.5 * kappa
};

struct TrackPtrs {
  void* p[kTracks];  // nullptr: the track is not written
};

// Row pitch, in elements, of a track's shared tile: a chunk rounded up to an odd number of
// 4-byte words (17 words float32, 9 bf16), so the 32 lanes of a warp, each writing one step
// of its own row, hit 32 distinct banks.
template <typename T>
__host__ __device__ constexpr int pitch() {
  return ((kChunk * static_cast<int>(sizeof(T)) / 4) | 1) * 4 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * pitch<T>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// One HGF step, as the plain version computes it.  Returns delta1.
__device__ __forceinline__ float hgf_step(float& mu1, float& pi1, float& mu2, float& pi2,
                                          float x, const Params& p) {
  const float log_nu =
      clamp_nan(__fadd_rn(__fmul_rn(p.kappa, mu2), p.omega), -p.max_log_nu, p.max_log_nu);
  const float nu = expf(log_nu);
  const float pihat1 = __frcp_rn(__fadd_rn(__frcp_rn(pi1), nu));
  const float pi1_new = __fadd_rn(pihat1, p.pi_u);
  const float inv_pi1 = __frcp_rn(pi1_new);
  const float mu1_new = __fadd_rn(mu1, __fmul_rn(__fmul_rn(p.pi_u, inv_pi1), __fsub_rn(x, mu1)));
  const float d = __fsub_rn(mu1_new, mu1);
  const float delta1 = __fsub_rn(__fmul_rn(__fadd_rn(inv_pi1, __fmul_rn(d, d)), pihat1), 1.f);
  const float pihat2 = __frcp_rn(__fadd_rn(__frcp_rn(pi2), p.theta));
  const float w1 = __fmul_rn(nu, pihat1);
  const float inner = __fadd_rn(w1, __fmul_rn(__fsub_rn(__fmul_rn(2.f, w1), 1.f), delta1));
  float pi2_new = __fadd_rn(pihat2, __fmul_rn(__fmul_rn(p.half_kappa_sq, w1), inner));
  pi2_new = pi2_new != pi2_new ? pi2_new : fmaxf(pi2_new, p.min_pi2);
  const float mu2_step = clamp_nan(__fmul_rn(__fmul_rn(p.half_kappa, __fdiv_rn(w1, pi2_new)), delta1),
                                   -p.max_mu2_step, p.max_mu2_step);
  mu1 = mu1_new;
  pi1 = pi1_new;
  mu2 = __fadd_rn(mu2, mu2_step);
  pi2 = pi2_new;
  return delta1;
}

// u[t0 .. t0 + kChunk) of one replica's row; steps past T read as 0.
__device__ __forceinline__ void load_chunk(float (&dst)[kChunk], const float* row, int t0, int T,
                                           bool vec_u) {
  if (vec_u && t0 + kChunk <= T) {
    const float4* src = reinterpret_cast<const float4*>(row + t0);
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 v = __ldg(src + q);
      dst[4 * q] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) dst[j] = t0 + j < T ? __ldg(row + t0 + j) : 0.f;
  }
}

// vec_u: u is read 16 bytes at a time (T a multiple of 4, u 16-byte aligned).
template <typename TrackT>
__global__ void __launch_bounds__(kTile, 8) hgf_filter_kernel(
    const float* __restrict__ u, float* __restrict__ finals, TrackPtrs tracks, long long R,
    int T, Params p, bool vec_u) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PT = pitch<TrackT>();
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), R - r0));
  // A thread past the last replica runs the block's first replica, so that it reaches the
  // block's barriers, and writes nothing of its own.
  const bool active = threadIdx.x < rows;
  const long long r = r0 + (active ? threadIdx.x : 0);

  // Each requested track's (kTile, PT) shared tile.
  TrackT* tile[kTracks];
  int slot = 0;
#pragma unroll
  for (int k = 0; k < kTracks; ++k) {
    tile[k] = reinterpret_cast<TrackT*>(smem) + slot * kTile * PT;
    slot += tracks.p[k] != nullptr;
  }
  const bool any = slot > 0;

  const float* row = u + r * T;
  float next[kChunk];
  load_chunk(next, row, 0, T, vec_u);
  float mu1 = 0.f, pi1 = 1.f, mu2 = 0.f, pi2 = 1.f;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    float x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) x[j] = next[j];
    if (t0 + kChunk < T) load_chunk(next, row, t0 + kChunk, T, vec_u);
    const int n = min(kChunk, T - t0);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j >= n) break;
      const float delta1 = hgf_step(mu1, pi1, mu2, pi2, x[j], p);
      const float values[kTracks] = {mu1, pi1, mu2, pi2, delta1};
#pragma unroll
      for (int k = 0; k < kTracks; ++k) {
        if (tracks.p[k]) put(tile[k] + threadIdx.x * PT + j, values[k]);
      }
    }
    if (any) {  // the block's chunk of each track: rows x n values, out row by row
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTracks; ++k) {
        if (!tracks.p[k]) continue;
        TrackT* out = static_cast<TrackT*>(tracks.p[k]) + r0 * T + t0;
        for (int e = threadIdx.x; e < rows * n; e += kTile) {
          const int i = n == kChunk ? e / kChunk : e / n;
          const int j = e - i * n;
          out[static_cast<long long>(i) * T + j] = tile[k][i * PT + j];
        }
      }
      __syncthreads();
    }
  }

  if (active) {
    finals[r] = mu1;
    finals[R + r] = pi1;
    finals[2 * R + r] = mu2;
    finals[3 * R + r] = pi2;
  }
}

template <typename TrackT>
int launch(const float* u, float* finals, const TrackPtrs& tracks, long long R, int T,
           const Params& p, cudaStream_t stream) {
  int n_tracks = 0;
  for (int k = 0; k < kTracks; ++k) n_tracks += tracks.p[k] != nullptr;
  const bool vec_u = T % 4 == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0;
  // At most five tiles of 4,352 bytes: below the 48 KB a block gets without opting in, and
  // eight blocks (all 65,536 replicas of the main path resident at once) fit an SM.
  const int smem = n_tracks * tile_bytes<TrackT>();
  const unsigned grid = static_cast<unsigned>((R + kTile - 1) / kTile);
  hgf_filter_kernel<TrackT><<<grid, kTile, smem, stream>>>(u, finals, tracks, R, T, p, vec_u);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// finals: (4, R) float32.  mu1 .. delta1: (R, T) outputs of the track type, or null for a
// track not written.  bf16 selects bfloat16 tracks (else float32).  Returns the
// cudaError_t of the launch (0 on success).
int hgf_filter_f32(const float* u, float* finals, void* mu1, void* pi1, void* mu2, void* pi2,
                   void* delta1, long long R, int T, int bf16, float kappa, float omega,
                   float theta, float pi_u, float max_log_nu, float min_pi2,
                   float max_mu2_step, float half_kappa_sq, float half_kappa, void* stream) {
  const TrackPtrs tracks{{mu1, pi1, mu2, pi2, delta1}};
  const Params p{kappa,        omega,         theta,     pi_u,      max_log_nu,
                 min_pi2,      max_mu2_step,  half_kappa_sq, half_kappa};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(u, finals, tracks, R, T, p, s)
              : launch<float>(u, finals, tracks, R, T, p, s);
}

}  // extern "C"
