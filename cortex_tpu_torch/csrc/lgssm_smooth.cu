// Fused Belief-Propagation smoothing sweep of a scalar LGSSM chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel cortex_tpu/ops/pallas_kernels.py::lgssm_smooth_pallas
// (_smooth_kernel -> _smooth_time_major).  Input y is (n, T) float32, row-major, one
// replica per row; outputs are the marginal mean and variance, (n, T) each.  The
// contract is the TPU kernel's: dense data, no prior, scalar A, Q, H, R.
//
// The arithmetic.  Every precision of the TPU kernel's 1/w recursion depends on A, Q, H,
// R and T only, never on y, so the wrapper computes them once, in float64, as rows of T
// coefficients (ops/kernels.py::sweep_coefficients, the kernel's input `coef`):
//   gf[t]  forward gain:   xi_f[t]  = gf[t] * (xi_obs[t-1] + xi_f[t-1])   (t >= 1)
//   gb[t]  backward gain:  xi_b[t]  = gb[t] * (xi_obs[t+1] + xi_b[t+1])   (t <= T-2)
//   var[t] marginal variance, 1 / (w_obs + w_f[t] + w_b[t])
//   pf[t], pb[t]  products of gf from the start of t's time segment to t, and of gb
//                 from t to the segment's end
// and the information means are linear in y: one multiply-add per step each way.
//
// What bounds it on the H100: bytes, 12 B per replica-step (y read once, mean and var
// written once), 3.6 us at 10,000 replicas x T=100.  The earlier design (one thread ran
// one replica's 2T-step chain over a 64-replica tile staged by ordinary loads, 157 blocks
// on 132 SMs) took 16.2 us there.  Cut apart (kernel_probe.py breakdown; PERF.md), its
// stores alone took 8.5 us, staging y 2.8 us more and the sweep 4.9 us more: the phases
// added up, since each SM held one or two blocks, each loading, sweeping, then storing.
//
// Design: time segments, and bulk copies in flight.
//   * Each replica's T steps are split into S = 4 segments of L steps (L odd), one thread
//     each; a warp holds 8 replicas x 4 segments.  A thread runs its segment's forward
//     recursion from a zero carry, then its backward recursion from a zero carry, keeping
//     obs + xi_f + xi_b (local parts) in shared memory.  The true carries cross the
//     segments in S - 1 warp shuffles each way (carry_out = local end + carry_in * product
//     of the segment's gains), and each thread adds carry * pf[t] + carry * pb[t] to its
//     steps.  The chain is about 2L + 2S steps instead of 2T.
//   * A block is 16 replicas (64 threads), so at 10,000 replicas 625 blocks share the 132
//     SMs, several per SM, and one block's load, sweep and store overlap another's.
//   * When T is a multiple of 4, one thread stages the block's rows with bulk copies (the
//     Tensor Memory Accelerator) completing on an mbarrier, and the marginals leave with
//     bulk stores (the variance straight from its coefficient row); otherwise with
//     ordinary coalesced loads and 16-byte stores.
//   * Rows are padded to a pitch P = 4 (mod 8) words and L is odd, so the 32 lanes of a
//     warp, stepping through their segments, touch 32 distinct banks.
//   * The ragged last block is masked: no padding in device memory.
//   * Long T (the tile no longer fits in shared memory, T > 2,764): the earlier design's
//     device-memory path, one thread per replica with its forward messages in a time-major
//     scratch, which reads only the first three coefficient rows.

#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kSegments = 4;  // threads per replica, one per time segment
constexpr int kGlobalBlock = 128;

// Shared-memory path.  Layout: mbarrier (16 B), y then the marginal mean (tile, P), local
// forward messages (tile, P), coefficient rows gf, gb, var, pf, pb (5, T).
__global__ void smooth_segments_kernel(const float* __restrict__ y, float* __restrict__ mean,
                                       float* __restrict__ var, const float* __restrict__ coef,
                                       long long n, int T, int P, int L, float h_over_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x;
  const int tile = threads / kSegments;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_y = reinterpret_cast<float*>(smem + 16);
  float* s_x = s_y + tile * P;
  float* s_coef = s_x + tile * P;
  const float* s_gf = s_coef;
  const float* s_gb = s_coef + T;
  const float* s_var = s_coef + 2 * T;
  const float* s_pf = s_coef + 3 * T;
  const float* s_pb = s_coef + 4 * T;

  const long long r0 = static_cast<long long>(blockIdx.x) * tile;
  const int rows = static_cast<int>(min(static_cast<long long>(tile), n - r0));
  const long long base = r0 * T;
  const bool aligned = (T & 3) == 0;
  const bool bulk_in = aligned && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const bool bulk_out =
      aligned && ((reinterpret_cast<uintptr_t>(mean) | reinterpret_cast<uintptr_t>(var)) & 15) == 0;

  // Stage y: bulk copies of whole rows, or coalesced loads, several in flight per thread.
  if (bulk_in) {
    if (threadIdx.x == 0) async_copy::barrier_init(bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      async_copy::barrier_expect_bytes(bar, static_cast<uint32_t>(rows * T * 4));
      for (int r = 0; r < rows; ++r) {
        async_copy::load(s_y + r * P, y + base + static_cast<long long>(r) * T, T * 4, bar);
      }
    }
  } else {
    const int count = rows * T;
#pragma unroll 4
    for (int k = threadIdx.x; k < count; k += threads) {
      const int r = k / T;
      s_y[r * P + (k - r * T)] = y[base + k];
    }
  }
  for (int k = threadIdx.x; k < 5 * T; k += threads) s_coef[k] = coef[k];
  if (bulk_in) async_copy::barrier_wait(bar, 0);
  __syncthreads();

  // Local recursions of segment [a, b) of replica r, from zero carries.
  const int r = threadIdx.x / kSegments;
  const int s = threadIdx.x % kSegments;
  const int a = min(s * L, T);
  const int b = min(a + L, T);
  float* yr = s_y + r * P;
  float* xr = s_x + r * P;
  float xi = 0.f;  // local information of the filtered belief: obs + forward message
  for (int t = a; t < b; ++t) {
    const float g = s_gf[t];
    const float obs = h_over_r * yr[t];
    xr[t] = g * xi;
    xi = fmaf(g, xi, obs);
  }
  float xb = 0.f;  // local information of the observation times the backward message
  for (int t = b - 1; t >= a; --t) {
    const float g = s_gb[t];
    const float obs = h_over_r * yr[t];
    yr[t] = obs + xr[t] + g * xb;
    xb = fmaf(g, xb, obs);
  }

  // True carries: c = xi_c[a - 1] from the segments before, d = xi_bc[b] from those after.
  // An empty segment passes its carry through (product 1, local end 0).
  const float pf_end = b > a ? s_pf[b - 1] : 1.f;
  const float pb_start = b > a ? s_pb[a] : 1.f;
  float c = 0.f, d = 0.f;
#pragma unroll
  for (int i = 1; i < kSegments; ++i) {
    const float from_left = __shfl_up_sync(0xffffffffu, fmaf(c, pf_end, xi), 1, kSegments);
    const float from_right = __shfl_down_sync(0xffffffffu, fmaf(d, pb_start, xb), 1, kSegments);
    c = s == 0 ? 0.f : from_left;
    d = s == kSegments - 1 ? 0.f : from_right;
  }
  for (int t = a; t < b; ++t) {
    yr[t] = fmaf(d, s_pb[t], fmaf(c, s_pf[t], yr[t])) * s_var[t];
  }
  if (bulk_out) async_copy::fence_shared_to_async();  // before the bulk stores read them
  __syncthreads();

  // Store mean and var.
  if (bulk_out) {
    if (threadIdx.x < rows) {
      const long long row = base + static_cast<long long>(threadIdx.x) * T;
      async_copy::store(mean + row, s_y + threadIdx.x * P, T * 4);
      async_copy::store(var + row, s_var, T * 4);
      async_copy::store_commit();
      async_copy::store_wait_read();
    }
    return;
  }
  const int count = rows * T;
  const bool vec = ((reinterpret_cast<uintptr_t>(mean) | reinterpret_cast<uintptr_t>(var) |
                     static_cast<uintptr_t>(base * 4)) & 15) == 0;
  const int count4 = vec ? count / 4 : 0;
  float4* mean4 = reinterpret_cast<float4*>(mean + base);
  float4* var4 = reinterpret_cast<float4*>(var + base);
  for (int q = threadIdx.x; q < count4; q += threads) {
    float m[4], v[4];
    int k = 4 * q;
    int row = k / T;
    int t = k - row * T;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = s_y[row * P + t];
      v[j] = s_var[t];
      if (++t == T) {
        t = 0;
        ++row;
      }
    }
    mean4[q] = make_float4(m[0], m[1], m[2], m[3]);
    var4[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int k = 4 * count4 + threadIdx.x; k < count; k += threads) {
    const int row = k / T;
    const int t = k - row * T;
    mean[base + k] = s_y[row * P + t];
    var[base + k] = s_var[t];
  }
}

// One replica's sweep over its rows in device memory; xf holds its forward messages with
// element stride fs.  mean may alias y: every step reads y[t] before it writes mean[t].
__device__ __forceinline__ void sweep(const float* y, float* mean, float* xf, long long fs,
                                      int T, const float* gf, const float* gb,
                                      const float* var, float h_over_r) {
  float xi = h_over_r * y[0];  // obs message + forward message of the current state
  xf[0] = 0.f;
#pragma unroll 4
  for (int t = 1; t < T; ++t) {
    const float msg = gf[t] * xi;
    xf[t * fs] = msg;
    xi = fmaf(h_over_r, y[t], msg);
  }
  float xi_b = h_over_r * y[T - 1];  // obs message + backward message of the state
  mean[T - 1] = (xi_b + xf[(T - 1) * fs]) * var[T - 1];
#pragma unroll 4
  for (int t = T - 2; t >= 0; --t) {
    const float msg = gb[t] * xi_b;
    const float obs = h_over_r * y[t];
    mean[t] = (obs + xf[t * fs] + msg) * var[t];
    xi_b = obs + msg;
  }
}

__global__ void smooth_global_kernel(const float* __restrict__ y, float* __restrict__ mean,
                                     float* __restrict__ var, const float* __restrict__ coef,
                                     float* __restrict__ xf, long long n, int T,
                                     float h_over_r) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long row = r * T;
  sweep(y + row, mean + row, xf + r, n, T, coef, coef + T, coef + 2 * T, h_over_r);
  for (int t = 0; t < T; ++t) var[row + t] = coef[2 * T + t];
}

}  // namespace

extern "C" {

// Shared-memory path: `tile` replicas per block (a multiple of 8), rows padded to `pitch`
// floats (a multiple of 4), segments of `seg` steps; `coef` holds the five rows.  Shared
// memory: 16 + 4 * (2 * tile * pitch + 5 * T) bytes.  Returns the cudaError_t of the launch
// (0 on success).
int lgssm_smooth_smem_f32(const float* y, float* mean, float* var, const float* coef,
                          long long n, int T, int tile, int pitch, int seg, float h_over_r,
                          void* stream) {
  const int smem = 16 + 4 * (2 * tile * pitch + 5 * T);
  cudaError_t err = cudaFuncSetAttribute(
      smooth_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((n + tile - 1) / tile);
  smooth_segments_kernel<<<grid, tile * kSegments, smem, static_cast<cudaStream_t>(stream)>>>(
      y, mean, var, coef, n, T, pitch, seg, h_over_r);
  return static_cast<int>(cudaGetLastError());
}

// Device-memory path: `scratch` holds T * n floats (the forward messages, time-major).
// Returns the cudaError_t of the launch (0 on success).
int lgssm_smooth_global_f32(const float* y, float* mean, float* var, const float* coef,
                            float* scratch, long long n, int T, float h_over_r,
                            void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kGlobalBlock - 1) / kGlobalBlock);
  smooth_global_kernel<<<grid, kGlobalBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      y, mean, var, coef, scratch, n, T, h_over_r);
  return static_cast<int>(cudaGetLastError());
}

const char* lgssm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
