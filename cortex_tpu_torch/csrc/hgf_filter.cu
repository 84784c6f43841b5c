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
// What bounds it: at R=65,536 x T=256 the bytes (u read once, 4 B a replica-step; 24 B with
// all five float32 tracks) take 20 to 120 us at 3.35 TB/s.  But each replica is a chain of
// T dependent steps of about 35 float32 operations, one exp and five IEEE divisions or
// reciprocals, and one thread runs one replica, so there are only R / 132 threads per SM
// to hide the chain's latency: the instruction stream, not the bytes, is expected to set
// the time.
//
// Design: one thread per replica, its state in registers for all T steps.  A block of
// kTile replicas walks T in chunks of kChunk steps.  Per chunk it stages its (kTile,
// kChunk) block of u through shared memory with coalesced loads (rows padded to an odd
// number of 32-bit words, so the threads of a warp, each on its own row, hit distinct
// banks), runs the chunk's steps, writes each requested track into a shared tile of the
// same layout in the track's type, and stores the tiles back coalesced.  Any T fits: only
// a chunk is ever in shared memory.  The ragged last block and chunk are masked; nothing
// is padded in device memory.  Which tracks are written is decided at run time by which
// output pointers are non-null, so one instantiation per track type serves every subset.
//
// Arithmetic: the step is the plain version's (ops/kernels_hgf.py::hgf_update) operation
// for operation, each rounded as torch rounds it: __fadd_rn / __fmul_rn keep nvcc from
// contracting a multiply and an add into one FMA, 1/x is the correctly rounded
// reciprocal, and the constants 0.5*kappa^2 and 0.5*kappa come from the host, computed in
// double and rounded once to float.  Clamps propagate NaN, as torch.clamp does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;   // replicas per block, one thread each
constexpr int kChunk = 16;  // steps staged per pass
constexpr int kTracks = 5;  // mu1, pi1, mu2, pi2, delta1

struct Params {
  float kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step;
  float half_kappa_sq, half_kappa;  // 0.5 * kappa^2, 0.5 * kappa
};

struct TrackPtrs {
  void* p[kTracks];  // nullptr: the track is not written
};

// Row stride, in elements, of a (kTile, kChunk) shared tile: an odd number of words.
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

// Element k of a chunk of n steps: row i, step j.
__device__ __forceinline__ void split(int k, int n, int& i, int& j) {
  if (n == kChunk) {
    i = k / kChunk;
    j = k % kChunk;
  } else {
    i = k / n;
    j = k - i * n;
  }
}

template <typename TrackT>
__global__ void __launch_bounds__(kTile) hgf_filter_kernel(
    const float* __restrict__ u, float* __restrict__ finals, TrackPtrs tracks, long long R,
    int T, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PU = pitch<float>();
  constexpr int PT = pitch<TrackT>();
  float* s_u = reinterpret_cast<float*>(smem);
  TrackT* s_track[kTracks];
  unsigned char* next = smem + tile_bytes<float>();
#pragma unroll
  for (int k = 0; k < kTracks; ++k) {
    s_track[k] = tracks.p[k] ? reinterpret_cast<TrackT*>(next) : nullptr;
    if (tracks.p[k]) next += tile_bytes<TrackT>();
  }

  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), R - r0));
  const int r = threadIdx.x;
  float mu1 = 0.f, pi1 = 1.f, mu2 = 0.f, pi2 = 1.f;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    const int count = rows * n;
    for (int k = threadIdx.x; k < count; k += kTile) {
      int i, j;
      split(k, n, i, j);
      s_u[i * PU + j] = u[(r0 + i) * T + t0 + j];
    }
    __syncthreads();

    if (r < rows) {
      for (int j = 0; j < n; ++j) {
        const float x = s_u[r * PU + j];
        const float log_nu =
            clamp_nan(__fadd_rn(__fmul_rn(p.kappa, mu2), p.omega), -p.max_log_nu, p.max_log_nu);
        const float nu = expf(log_nu);
        const float pihat1 = __frcp_rn(__fadd_rn(__frcp_rn(pi1), nu));
        const float pi1_new = __fadd_rn(pihat1, p.pi_u);
        const float inv_pi1 = __frcp_rn(pi1_new);
        const float mu1_new =
            __fadd_rn(mu1, __fmul_rn(__fmul_rn(p.pi_u, inv_pi1), __fsub_rn(x, mu1)));
        const float d = __fsub_rn(mu1_new, mu1);
        const float delta1 = __fsub_rn(__fmul_rn(__fadd_rn(inv_pi1, __fmul_rn(d, d)), pihat1), 1.f);
        const float pihat2 = __frcp_rn(__fadd_rn(__frcp_rn(pi2), p.theta));
        const float w1 = __fmul_rn(nu, pihat1);
        const float inner =
            __fadd_rn(w1, __fmul_rn(__fsub_rn(__fmul_rn(2.f, w1), 1.f), delta1));
        float pi2_new = __fadd_rn(pihat2, __fmul_rn(__fmul_rn(p.half_kappa_sq, w1), inner));
        pi2_new = pi2_new != pi2_new ? pi2_new : fmaxf(pi2_new, p.min_pi2);
        const float mu2_step =
            clamp_nan(__fmul_rn(__fmul_rn(p.half_kappa, __fdiv_rn(w1, pi2_new)), delta1),
                      -p.max_mu2_step, p.max_mu2_step);
        mu1 = mu1_new;
        pi1 = pi1_new;
        mu2 = __fadd_rn(mu2, mu2_step);
        pi2 = pi2_new;
        const float values[kTracks] = {mu1, pi1, mu2, pi2, delta1};
#pragma unroll
        for (int k = 0; k < kTracks; ++k) {
          if (s_track[k]) put(s_track[k] + r * PT + j, values[k]);
        }
      }
    }
    __syncthreads();

    // No barrier after the stores: the next pass writes only s_u before its first
    // barrier, and every thread has passed the one above, so s_u is no longer read.
#pragma unroll
    for (int k8 = 0; k8 < kTracks; ++k8) {
      if (!s_track[k8]) continue;
      TrackT* out = static_cast<TrackT*>(tracks.p[k8]);
      for (int k = threadIdx.x; k < count; k += kTile) {
        int i, j;
        split(k, n, i, j);
        out[(r0 + i) * T + t0 + j] = s_track[k8][i * PT + j];
      }
    }
  }

  if (r < rows) {
    finals[r0 + r] = mu1;
    finals[R + r0 + r] = pi1;
    finals[2 * R + r0 + r] = mu2;
    finals[3 * R + r0 + r] = pi2;
  }
}

template <typename TrackT>
int launch(const float* u, float* finals, const TrackPtrs& tracks, long long R, int T,
           const Params& p, cudaStream_t stream) {
  int n_tracks = 0;
  for (int k = 0; k < kTracks; ++k) n_tracks += tracks.p[k] != nullptr;
  // At most 6 tiles of 4,352 bytes: below the 48 KB a block gets without opting in.
  const int smem = tile_bytes<float>() + n_tracks * tile_bytes<TrackT>();
  const unsigned grid = static_cast<unsigned>((R + kTile - 1) / kTile);
  hgf_filter_kernel<TrackT><<<grid, kTile, smem, stream>>>(u, finals, tracks, R, T, p);
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
