// Fused Belief-Propagation smoothing sweep of a scalar LGSSM chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel cortex_tpu/ops/pallas_kernels.py::lgssm_smooth_pallas
// (_smooth_kernel -> _smooth_time_major).  Input y is (n, T) float32, row-major, one
// replica per row; outputs are the marginal mean and variance, (n, T) each.  The
// contract is the TPU kernel's: dense data, no prior, scalar A, Q, H, R.
//
// What bounds it: bytes, at 12 B per replica-step (y read once, mean and var written
// once): 12 MB at 10,000 replicas x T=100.  The TPU kernel runs the 1/w recursion for
// every replica, about ten IEEE divisions per replica-step, which on this card costs
// as much as the bytes and sits on each replica's serial chain.  But every precision
// in that recursion (w of the forward, backward and marginal beliefs) depends only on
// A, Q, H, R and T, never on y.  So the wrapper computes them once, in float64, as
// three rows of T coefficients (the kernel's inputs `coef`):
//   gf[t]  forward gain:   xi_f[t]  = gf[t] * (xi_obs[t-1] + xi_f[t-1])   (t >= 1)
//   gb[t]  backward gain:  xi_b[t]  = gb[t] * (xi_obs[t+1] + xi_b[t+1])   (t <= T-2)
//   var[t] marginal variance, 1 / (w_obs + w_f[t] + w_b[t])
// and the per-replica work is one multiply-add per step each way: the information
// means are linear in y.  The kernel is then left with the bytes.
//
// Design: one thread runs one replica's forward pass, then its backward pass.
//   * smem path (the main path, T up to 867): a block of `tile` replicas (64 or 32)
//     holds the coefficient rows and two (tile, P) float buffers in shared memory,
//     P = T rounded up to an odd count so that the threads of a warp, each on its own
//     row, hit distinct banks.  The block stages its contiguous tile x T chunk of y
//     with coalesced 16-byte loads, several in flight per thread, runs the sweeps in
//     shared memory (the forward messages never leave the SM), writes the mean over y
//     once consumed, and stores mean and var back with coalesced 16-byte writes.
//     At tile 64 and T=100 that is 53 KB: four blocks per SM.
//   * global path (longer T): the forward messages go to a time-major (T, n) scratch
//     in device memory, so a warp's 32 replicas touch one contiguous 128-byte line per
//     step; y, mean and var are read and written in place, through L1.
// The ragged last block is masked (threads past n do no work): no padding.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLoadBatch = 4;  // 16-byte loads in flight per thread while staging y
constexpr int kGlobalBlock = 128;

// One replica's sweep.  y and mean are that replica's rows (stride 1); xf holds its
// forward messages with element stride fs.  mean may alias y: every step reads y[t]
// before it writes mean[t].
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

// Shared-memory slot of element k (row r = k / T, step t) of a block's chunk, and the
// step to the next element.
struct Pos {
  int r, t;
  __device__ __forceinline__ Pos(int k, int T) : r(k / T), t(k - (k / T) * T) {}
  __device__ __forceinline__ int slot(int P) const { return r * P + t; }
  __device__ __forceinline__ void next(int T) {
    if (++t == T) {
      t = 0;
      ++r;
    }
  }
};

__global__ void smooth_smem_kernel(const float* __restrict__ y, float* __restrict__ mean,
                                   float* __restrict__ var, const float* __restrict__ coef,
                                   long long n, int T, int P, float h_over_r) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  float* s_coef = smem;            // gf, gb, var: 3 rows of T
  float* s_y = smem + 3 * T;       // y, then the marginal mean: (tile, P)
  float* s_xf = s_y + tile * P;    // forward messages: (tile, P)
  const long long r0 = static_cast<long long>(blockIdx.x) * tile;
  const int rows = static_cast<int>(min(static_cast<long long>(tile), n - r0));
  const int count = rows * T;
  const long long base = r0 * T;  // a multiple of 32 floats: keeps 16-byte alignment

  for (int k = threadIdx.x; k < 3 * T; k += tile) s_coef[k] = coef[k];

  const bool vec_in = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const int count4 = vec_in ? count / 4 : 0;
  const float4* y4 = reinterpret_cast<const float4*>(y + base);
  for (int q0 = threadIdx.x; q0 < count4; q0 += kLoadBatch * tile) {
    float4 v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int q = q0 + j * tile;
      if (q < count4) v[j] = y4[q];
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int q = q0 + j * tile;
      if (q < count4) {
        Pos p(4 * q, T);
        s_y[p.slot(P)] = v[j].x;
        p.next(T);
        s_y[p.slot(P)] = v[j].y;
        p.next(T);
        s_y[p.slot(P)] = v[j].z;
        p.next(T);
        s_y[p.slot(P)] = v[j].w;
      }
    }
  }
  for (int k = 4 * count4 + threadIdx.x; k < count; k += tile) {
    s_y[Pos(k, T).slot(P)] = y[base + k];
  }
  __syncthreads();

  if (threadIdx.x < rows) {
    float* row = s_y + threadIdx.x * P;
    sweep(row, row, s_xf + threadIdx.x * P, 1, T, s_coef, s_coef + T, s_coef + 2 * T,
          h_over_r);
  }
  __syncthreads();

  const float* s_var = s_coef + 2 * T;
  const bool vec_out =
      ((reinterpret_cast<uintptr_t>(mean) | reinterpret_cast<uintptr_t>(var)) & 15) == 0;
  const int out4 = vec_out ? count / 4 : 0;
  float4* mean4 = reinterpret_cast<float4*>(mean + base);
  float4* var4 = reinterpret_cast<float4*>(var + base);
  for (int q = threadIdx.x; q < out4; q += tile) {
    Pos p(4 * q, T);
    float4 m, v;
    m.x = s_y[p.slot(P)];
    v.x = s_var[p.t];
    p.next(T);
    m.y = s_y[p.slot(P)];
    v.y = s_var[p.t];
    p.next(T);
    m.z = s_y[p.slot(P)];
    v.z = s_var[p.t];
    p.next(T);
    m.w = s_y[p.slot(P)];
    v.w = s_var[p.t];
    mean4[q] = m;
    var4[q] = v;
  }
  for (int k = 4 * out4 + threadIdx.x; k < count; k += tile) {
    const Pos p(k, T);
    mean[base + k] = s_y[p.slot(P)];
    var[base + k] = s_var[p.t];
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

// Shared-memory path: `tile` replicas per block and 3 * T + 2 * tile * (T | 1) floats of
// shared memory.  Returns the cudaError_t of the launch (0 on success).
int lgssm_smooth_smem_f32(const float* y, float* mean, float* var, const float* coef,
                          long long n, int T, int tile, float h_over_r, void* stream) {
  const int P = T | 1;
  const int smem = (3 * T + 2 * tile * P) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      smooth_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((n + tile - 1) / tile);
  smooth_smem_kernel<<<grid, tile, smem, static_cast<cudaStream_t>(stream)>>>(
      y, mean, var, coef, n, T, P, h_over_r);
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
