// One rank's local sweep of the time-sharded scalar LGSSM smoother, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's time-sharded smoother
// (cortex_tpu/parallel/time_sharded.py) runs lax.associative_scan over each rank's block,
// and the port ran the same log-depth scan as ATen elementwise kernels (ops/chains.py::
// _associative_scan, 14 + 14 Hillis-Steele rounds at 16,384 steps, every intermediate in
// device memory).  These three passes do the rank's O(T) work with each input read once;
// parallel/time_sharded.py exchanges the block's totals between them (ops/
// kernels_time_sharded.py::LocalSweep launches them and holds their plain versions).
//
// Input y is this rank's block, (lanes, T) float32, row-major, one lane (replica) per row.
// The model is scalar, A, Q, H, R; the elements and combines are those of ops/chains.py
// (Sarkka and Garcia-Fernandez 2020): filter elements (A, b, C, eta, J), where A, C and J
// are the same for every step but the chain's first and b = k y, eta = eta y; smoother
// elements (E, g, L) built from the filtered moments.
//   1. filter_total: fold every step's filter element in time order; the block's 5-tuple
//      per lane (5, lanes), and each segment's (lanes, segments, 5).
//   2. filter_fillin: from the belief entering the block (the exclusive prefix of the
//      ranks' 5-tuples, b and C) run the filter over the block, writing the filtered mean
//      and variance into the outputs; fold the smoother elements front to back into the
//      block's 3-tuple per lane (3, lanes), and each segment's (lanes, segments, 3).
//   3. smoother_fillin: from the composition of the later blocks' smoother elements, run
//      the RTS recursion backwards over the filtered moments, overwriting them in place
//      with the marginal mean and variance.
//
// What bounds it on the H100: bytes.  y is read twice (passes 1, 2), the filtered moments
// written and read once, the marginals written once: 32 B per step-lane, 5.2 GB and
// 1.56 ms at 10,000 lanes x 16,384 steps, against ~5.5 KB per step-lane of the scan.
//
// Design: time segments, staged through shared memory a warp at a time.
//   * Each lane's T steps are cut into S segments of L steps (S a power of two up to 32,
//     L a multiple of kChunk = 32; LocalSweep's plan: S = 16, L = 1,024 at 10,000 x
//     16,384: 160,000 threads, about three waves at three 128-thread blocks an SM, as
//     many warps as hide each step's chain of dependent operations).  One thread runs
//     one segment, its "row"; the S rows of a lane are adjacent in one warp.
//   * A segment's pass starts from the composition of the totals of the segments before
//     it (after it, in pass 3), which the previous pass wrote per segment: at most S - 1
//     combines, then one combine a step.  The lane's total is folded from its segments'
//     totals by warp shuffles.
//   * The 32 rows of a warp lie in 32 places of the block, so a thread reading its own
//     row would touch 32 lines a load.  Instead each warp stages tiles of its rows, 32
//     steps (128 bytes) each: eight threads copy a row's 128 bytes with 16-byte
//     asynchronous copies (cp.async), so each request fills four whole lines, with two
//     more tiles in flight (one a stream in pass 3) while the threads run through the
//     tile that has landed.  The outputs go back into the tile and leave the same way, by
//     whole lines.  Rows are padded to 36 floats, so that a thread's 16-byte reads of its
//     own row and the copies' writes hit distinct banks.  A block's 4 warps take 57 KB
//     (pass 1) or 74 KB of shared memory.  Rows whose steps are not 16-byte aligned (T
//     not a multiple of 4) are copied in 4-byte pieces.
//   * A combine's divisions by its denominator are one correctly rounded reciprocal times
//     the numerators; the smoother gain E = C A / (A^2 C + Q) is a rounded division.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // steps a row stages at a time
constexpr unsigned kFull = 0xffffffffu;

// The numbers of the elements, in ops/kernels_time_sharded.py::SweepModel's order.
struct Model {
  float a, c, j;  // A, C, J of every filter element but the chain's first
  float k, eta;   // b = k y, eta = eta y
  float h, r, c1; // the chain's first element: b = y / h, C = c1 without a prior
  float A, AA, Q; // the smoother elements
};

struct Filt {
  float A, b, C, eta, J;
};

struct Smooth {
  float E, g, L;
};

// ops/chains.py::_filter_combine: e1 the earlier.
__device__ __forceinline__ Filt fcombine(const Filt& e1, const Filt& e2) {
  const float inv = __frcp_rn(1.f + e1.C * e2.J);
  Filt r;
  r.A = e2.A * e1.A * inv;
  r.b = e2.A * (e1.b + e1.C * e2.eta) * inv + e2.b;
  r.C = e2.A * e2.A * e1.C * inv + e2.C;
  r.eta = e1.A * (e2.eta - e2.J * e1.b) * inv + e1.eta;
  r.J = e1.A * e1.A * e2.J * inv + e1.J;
  return r;
}

// ops/chains.py::_smoother_combine: e1 the later.
__device__ __forceinline__ Smooth scombine(const Smooth& e1, const Smooth& e2) {
  return {e2.E * e1.E, e2.E * e1.g + e2.g, e2.E * e2.E * e1.L + e2.L};
}

// The belief (b, C) carried through the generic element of observation yt.
__device__ __forceinline__ void step_belief(float& b, float& C, float yt, const Model& m) {
  const float inv = __frcp_rn(1.f + C * m.j);
  const float nb = m.a * (b + C * (m.eta * yt)) * inv + m.k * yt;
  C = m.a * m.a * C * inv + m.c;
  b = nb;
}

// The smoother element of filtered moments (fm, fP); the chain's last is terminal.
__device__ __forceinline__ Smooth smoother_element(float fm, float fP, bool terminal,
                                                   const Model& m) {
  if (terminal) return {0.f, fm, fP};
  const float Pp = m.AA * fP + m.Q;
  const float E = __fdiv_rn(fP * m.A, Pp);
  return {E, fm - E * m.A * fm, fP - E * m.A * fP};
}

// The chain's first element, (b, C): the prior's update by y0, or y0 alone.
__device__ __forceinline__ void first_element(float y0, const float* m0, const float* P0,
                                              long long lane, const Model& m, float& b,
                                              float& C) {
  if (m0 == nullptr) {
    b = y0 / m.h;
    C = m.c1;
    return;
  }
  const float pm = m0[lane], pv = P0[lane];
  const float s1 = m.h * pv * m.h + m.r;
  const float k1 = pv * m.h / s1;
  b = pm + k1 * (y0 - m.h * pm);
  C = pv - k1 * m.h * pv;
}

// Each warp's 32 rows (one a thread: its lane's segment), in shared memory: the row's
// first step within the block and its number of steps.
struct Rows {
  long long off[32];
  int n[32];
};

constexpr int kWarps = kThreads / 32;
constexpr int kPitch = kChunk + 4;  // floats a staged row: 16-byte rows, 4 (mod 32) banks apart
constexpr int kTile = 32 * kPitch;  // floats a staged tile: a warp's rows, kChunk steps each
constexpr int kStagesFilter = 3;    // tiles of y in flight in passes 1 and 2
constexpr int kStagesSmooth = 2;    // tiles of each of the filtered moments in pass 3

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's committed copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Steps [col, col + kChunk) of the warp's rows from `base` into `tile`, in pieces of kV
// floats: eight threads a row (kV = 4), each row's 128 bytes in one request; 4-byte
// pieces where the rows are not 16-byte aligned.  Steps past a row's end are not copied.
template <int kV>
__device__ __forceinline__ void load_tile(float* tile, const float* base, const Rows& rows,
                                          int col, int wl) {
  constexpr int kPer = kChunk / kV;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int piece = wl + 32 * i;
    const int r = piece / kPer, c = (piece % kPer) * kV;
    if (col + c < rows.n[r]) {
      if constexpr (kV == 4) {
        async_copy::copy16(tile + r * kPitch + c, base + rows.off[r] + col + c);
      } else {
        async_copy::copy4(tile + r * kPitch + c, base + rows.off[r] + col + c);
      }
    }
  }
}

// The same pieces from `tile` to `base`, by ordinary stores.
template <int kV>
__device__ __forceinline__ void store_tile(float* base, const float* tile, const Rows& rows,
                                           int col, int wl) {
  constexpr int kPer = kChunk / kV;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int piece = wl + 32 * i;
    const int r = piece / kPer, c = (piece % kPer) * kV;
    if (col + c < rows.n[r]) {
      float* dst = base + rows.off[r] + col + c;
      const float* src = tile + r * kPitch + c;
      if constexpr (kV == 4) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        *dst = *src;
      }
    }
  }
}

// This thread's lane, segment and steps [a, b).
struct Seg {
  long long lane;
  int s, a, b;
  bool live;
};

__device__ __forceinline__ Seg segment(long long lanes, int T, int S, int L) {
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Seg g;
  g.lane = gid / S;
  g.s = static_cast<int>(gid - g.lane * S);
  g.live = g.lane < lanes;
  g.a = min(g.s * L, T);
  g.b = min(g.a + L, T);
  if (!g.live) g.b = g.a;
  return g;
}

// The warp's row table (each thread writes its own row), and this warp's staging area.
__device__ __forceinline__ Rows& warp_rows(unsigned char* smem, const Seg& g, int T, int wl) {
  Rows& rows = reinterpret_cast<Rows*>(smem)[threadIdx.x / 32];
  rows.off[wl] = g.lane * T + g.a;
  rows.n[wl] = g.b - g.a;
  __syncwarp();
  return rows;
}

__device__ __forceinline__ float* warp_tiles(unsigned char* smem, int tiles) {
  return reinterpret_cast<float*>(smem + kWarps * sizeof(Rows)) +
         (threadIdx.x / 32) * tiles * kTile;
}

// Pass 1.  Every thread of every warp reaches the copies, barriers and shuffles.
template <int kV>
__global__ void __launch_bounds__(kThreads)
    filter_total_kernel(const float* __restrict__ y, float* __restrict__ lane_total,
                        float* __restrict__ seg_total, const float* __restrict__ m0,
                        const float* __restrict__ P0, long long lanes, int T, int S, int L,
                        int first, Model m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wl = threadIdx.x % 32;
  const Seg g = segment(lanes, T, S, L);
  const Rows& rows = warp_rows(smem, g, T, wl);
  float* ring = warp_tiles(smem, kStagesFilter);
  const int chunks = (L + kChunk - 1) / kChunk;
  for (int k = 0; k < kStagesFilter - 1; ++k) {
    if (k < chunks) load_tile<kV>(ring + k * kTile, y, rows, k * kChunk, wl);
    commit_copies();
  }
  const int n = g.b - g.a;
  const bool head = first && g.s == 0;
  Filt acc{1.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < chunks; ++k) {
    const int ahead = k + kStagesFilter - 1;
    if (ahead < chunks) {
      load_tile<kV>(ring + (ahead % kStagesFilter) * kTile, y, rows, ahead * kChunk, wl);
    }
    commit_copies();
    wait_copies<kStagesFilter - 1>();
    __syncwarp();
    const float* row = ring + (k % kStagesFilter) * kTile + wl * kPitch;
    const int len = min(n - k * kChunk, kChunk);
#pragma unroll
    for (int q = 0; q < kChunk; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + q);
      const float yq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q + i < len) {
          if (q + i == 0 && k == 0 && head) {
            acc.A = acc.eta = acc.J = 0.f;
            first_element(yq[i], m0, P0, g.lane, m, acc.b, acc.C);
          } else {
            const Filt e{m.a, m.k * yq[i], m.c, m.eta * yq[i], m.j};
            acc = fcombine(acc, e);
          }
        }
      }
    }
    __syncwarp();  // the tile is refilled next
  }
  if (g.live) {
    float* out = seg_total + (g.lane * S + g.s) * 5;
    out[0] = acc.A;
    out[1] = acc.b;
    out[2] = acc.C;
    out[3] = acc.eta;
    out[4] = acc.J;
  }
  // The lane's total: its segments' totals in order, gathered by the segment-0 thread.
  Filt tot{1.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < S; ++j) {
    Filt e;
    e.A = __shfl_sync(kFull, acc.A, j, S);
    e.b = __shfl_sync(kFull, acc.b, j, S);
    e.C = __shfl_sync(kFull, acc.C, j, S);
    e.eta = __shfl_sync(kFull, acc.eta, j, S);
    e.J = __shfl_sync(kFull, acc.J, j, S);
    tot = fcombine(tot, e);
  }
  if (g.live && g.s == 0) {
    lane_total[g.lane] = tot.A;
    lane_total[lanes + g.lane] = tot.b;
    lane_total[2 * lanes + g.lane] = tot.C;
    lane_total[3 * lanes + g.lane] = tot.eta;
    lane_total[4 * lanes + g.lane] = tot.J;
  }
}

// Pass 2.  The filtered means replace y in its tile; the variances fill a tile of their own.
template <int kV>
__global__ void __launch_bounds__(kThreads)
    filter_fillin_kernel(const float* __restrict__ y, float* __restrict__ fm,
                         float* __restrict__ fP, float* __restrict__ lane_total,
                         float* __restrict__ sseg_total, const float* __restrict__ seg_total,
                         const float* __restrict__ pre_b, const float* __restrict__ pre_C,
                         const float* __restrict__ m0, const float* __restrict__ P0,
                         long long lanes, int T, int S, int L, int first, int last, Model m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wl = threadIdx.x % 32;
  const Seg g = segment(lanes, T, S, L);
  const Rows& rows = warp_rows(smem, g, T, wl);
  float* ring = warp_tiles(smem, kStagesFilter + 1);
  float* vtile = ring + kStagesFilter * kTile;
  const int chunks = (L + kChunk - 1) / kChunk;
  for (int k = 0; k < kStagesFilter - 1; ++k) {
    if (k < chunks) load_tile<kV>(ring + k * kTile, y, rows, k * kChunk, wl);
    commit_copies();
  }
  const int n = g.b - g.a;
  // The belief entering the segment: the block's, through the segments before it.
  float b = 0.f, C = 0.f;
  if (n > 0) {
    b = pre_b[g.lane];
    C = pre_C[g.lane];
    for (int j = 0; j < g.s; ++j) {
      const float* e = seg_total + (g.lane * S + j) * 5;
      const float inv = __frcp_rn(1.f + C * e[4]);
      const float nb = e[0] * (b + C * e[3]) * inv + e[1];
      C = e[0] * e[0] * C * inv + e[2];
      b = nb;
    }
  }
  const bool head = first && g.s == 0;
  const int end = last ? T - 1 - g.a : -1;  // the chain's last step, within the segment
  Smooth acc{1.f, 0.f, 0.f};
  for (int k = 0; k < chunks; ++k) {
    const int ahead = k + kStagesFilter - 1;
    if (ahead < chunks) {
      load_tile<kV>(ring + (ahead % kStagesFilter) * kTile, y, rows, ahead * kChunk, wl);
    }
    commit_copies();
    wait_copies<kStagesFilter - 1>();
    __syncwarp();
    float* tile = ring + (k % kStagesFilter) * kTile;
    float* row = tile + wl * kPitch;
    float* vrow = vtile + wl * kPitch;
    const int len = min(n - k * kChunk, kChunk);
#pragma unroll
    for (int q = 0; q < kChunk; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + q);
      const float yq[4] = {v.x, v.y, v.z, v.w};
      float bq[4], Cq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q + i < len) {
          if (q + i == 0 && k == 0 && head) {
            first_element(yq[i], m0, P0, g.lane, m, b, C);
          } else {
            step_belief(b, C, yq[i], m);
          }
          const Smooth e = smoother_element(b, C, k * kChunk + q + i == end, m);
          acc = scombine(e, acc);
        }
        bq[i] = b;
        Cq[i] = C;
      }
      *reinterpret_cast<float4*>(row + q) = make_float4(bq[0], bq[1], bq[2], bq[3]);
      *reinterpret_cast<float4*>(vrow + q) = make_float4(Cq[0], Cq[1], Cq[2], Cq[3]);
    }
    __syncwarp();
    store_tile<kV>(fm, tile, rows, k * kChunk, wl);
    store_tile<kV>(fP, vtile, rows, k * kChunk, wl);
    __syncwarp();  // the tiles are refilled next
  }
  if (g.live) {
    float* out = sseg_total + (g.lane * S + g.s) * 3;
    out[0] = acc.E;
    out[1] = acc.g;
    out[2] = acc.L;
  }
  // The lane's total: its segments' totals front to back (the later segment is e1).
  Smooth tot{1.f, 0.f, 0.f};
  for (int j = 0; j < S; ++j) {
    Smooth e;
    e.E = __shfl_sync(kFull, acc.E, j, S);
    e.g = __shfl_sync(kFull, acc.g, j, S);
    e.L = __shfl_sync(kFull, acc.L, j, S);
    tot = scombine(e, tot);
  }
  if (g.live && g.s == 0) {
    lane_total[g.lane] = tot.E;
    lane_total[lanes + g.lane] = tot.g;
    lane_total[2 * lanes + g.lane] = tot.L;
  }
}

// Pass 3, backwards through the chunks: mean and var hold the filtered moments and receive
// the marginals in place (so not restrict: each chunk is read before it is written).
template <int kV>
__global__ void __launch_bounds__(kThreads)
    smoother_fillin_kernel(float* mean, float* var, const float* __restrict__ sseg_total,
                           const float* __restrict__ suf_E, const float* __restrict__ suf_g,
                           const float* __restrict__ suf_L, long long lanes, int T, int S,
                           int L, int last, Model m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wl = threadIdx.x % 32;
  const Seg g = segment(lanes, T, S, L);
  const Rows& rows = warp_rows(smem, g, T, wl);
  float* mring = warp_tiles(smem, 2 * kStagesSmooth);
  float* vring = mring + kStagesSmooth * kTile;
  const int chunks = (L + kChunk - 1) / kChunk;
  for (int k = 0; k < kStagesSmooth - 1; ++k) {
    if (k < chunks) {
      const int col = (chunks - 1 - k) * kChunk;
      load_tile<kV>(mring + k * kTile, mean, rows, col, wl);
      load_tile<kV>(vring + k * kTile, var, rows, col, wl);
    }
    commit_copies();
  }
  const int n = g.b - g.a;
  // The composition after the segment: the later blocks', then the later segments'.
  Smooth acc{1.f, 0.f, 0.f};
  if (n > 0) {
    acc = Smooth{suf_E[g.lane], suf_g[g.lane], suf_L[g.lane]};
    for (int j = S - 1; j > g.s; --j) {
      const float* e = sseg_total + (g.lane * S + j) * 3;
      acc = scombine(acc, Smooth{e[0], e[1], e[2]});
    }
  }
  const int end = last ? T - 1 - g.a : -1;
  for (int k = 0; k < chunks; ++k) {
    const int ahead = k + kStagesSmooth - 1;
    if (ahead < chunks) {
      const int col = (chunks - 1 - ahead) * kChunk;
      load_tile<kV>(mring + (ahead % kStagesSmooth) * kTile, mean, rows, col, wl);
      load_tile<kV>(vring + (ahead % kStagesSmooth) * kTile, var, rows, col, wl);
    }
    commit_copies();
    wait_copies<kStagesSmooth - 1>();
    __syncwarp();
    const int col = (chunks - 1 - k) * kChunk;
    float* mtile = mring + (k % kStagesSmooth) * kTile;
    float* vtile = vring + (k % kStagesSmooth) * kTile;
    float* mrow = mtile + wl * kPitch;
    float* vrow = vtile + wl * kPitch;
    const int len = min(n - col, kChunk);
#pragma unroll
    for (int q = kChunk - 4; q >= 0; q -= 4) {
      const float4 fm4 = *reinterpret_cast<const float4*>(mrow + q);
      const float4 fv4 = *reinterpret_cast<const float4*>(vrow + q);
      float mq[4] = {fm4.x, fm4.y, fm4.z, fm4.w};
      float vq[4] = {fv4.x, fv4.y, fv4.z, fv4.w};
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        if (q + i < len) {
          const Smooth e = smoother_element(mq[i], vq[i], col + q + i == end, m);
          acc = scombine(acc, e);
          mq[i] = acc.g;
          vq[i] = acc.L;
        }
      }
      *reinterpret_cast<float4*>(mrow + q) = make_float4(mq[0], mq[1], mq[2], mq[3]);
      *reinterpret_cast<float4*>(vrow + q) = make_float4(vq[0], vq[1], vq[2], vq[3]);
    }
    __syncwarp();
    store_tile<kV>(mean, mtile, rows, col, wl);
    store_tile<kV>(var, vtile, rows, col, wl);
    __syncwarp();  // the tiles are refilled next
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

Model model_of(const float* numbers) {
  Model m;
  m.a = numbers[0];
  m.c = numbers[1];
  m.j = numbers[2];
  m.k = numbers[3];
  m.eta = numbers[4];
  m.h = numbers[5];
  m.r = numbers[6];
  m.c1 = numbers[7];
  m.A = numbers[8];
  m.AA = numbers[9];
  m.Q = numbers[10];
  return m;
}

unsigned grid_of(long long lanes, int S) {
  return static_cast<unsigned>((lanes * S + kThreads - 1) / kThreads);
}

// Dynamic shared memory of a block: the warps' row tables and `tiles` tiles a warp.
constexpr int smem_bytes(int tiles) {
  return static_cast<int>(kWarps * sizeof(Rows)) + kWarps * tiles * kTile * 4;
}

// Devices whose opt-in `launch` remembers; a process with more asks the runtime each launch.
constexpr int kMaxDevices = 64;

// Opt `kernel` into `bytes` of shared memory, at its first launch on each device, then
// launch it.  Each instantiation holds one kernel's flags; the sizes are constants.
template <auto kernel, typename... Args>
int launch(int bytes, long long lanes, int S, void* stream, Args... args) {
  static std::atomic<bool> opted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool remembered = device < kMaxDevices;
  if (!remembered || !opted[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (remembered) opted[device].store(true, std::memory_order_release);
  }
  kernel<<<grid_of(lanes, S), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pass 1.  lane_total: (5, lanes); seg_total: (lanes, segments, 5); m0, P0: (lanes,) or
// null (no prior); model: SweepModel's 11 numbers, read on the host.  Returns the
// cudaError_t of the launch (0 on success).
int lgssm_ts_filter_total_f32(const float* y, float* lane_total, float* seg_total,
                              const float* m0, const float* P0, long long lanes, int T,
                              int segments, int seg_len, int first, const float* model,
                              void* stream) {
  const Model m = model_of(model);
  const bool vec = (T & 3) == 0 && aligned16(y);
  const int bytes = smem_bytes(kStagesFilter);
  return vec ? launch<filter_total_kernel<4>>(bytes, lanes, segments, stream, y, lane_total,
                                              seg_total, m0, P0, lanes, T, segments, seg_len,
                                              first, m)
             : launch<filter_total_kernel<1>>(bytes, lanes, segments, stream, y, lane_total,
                                              seg_total, m0, P0, lanes, T, segments, seg_len,
                                              first, m);
}

// Pass 2.  fm, fP: (lanes, T), the filtered moments; lane_total: (3, lanes); sseg_total:
// (lanes, segments, 3); seg_total: pass 1's; pre_b, pre_C: (lanes,).
int lgssm_ts_filter_fillin_f32(const float* y, float* fm, float* fP, float* lane_total,
                               float* sseg_total, const float* seg_total, const float* pre_b,
                               const float* pre_C, const float* m0, const float* P0,
                               long long lanes, int T, int segments, int seg_len, int first,
                               int last, const float* model, void* stream) {
  const Model m = model_of(model);
  const bool vec = (T & 3) == 0 && aligned16(y) && aligned16(fm) && aligned16(fP);
  const int bytes = smem_bytes(kStagesFilter + 1);
  return vec ? launch<filter_fillin_kernel<4>>(bytes, lanes, segments, stream, y, fm, fP,
                                               lane_total, sseg_total, seg_total, pre_b, pre_C,
                                               m0, P0, lanes, T, segments, seg_len, first, last,
                                               m)
             : launch<filter_fillin_kernel<1>>(bytes, lanes, segments, stream, y, fm, fP,
                                               lane_total, sseg_total, seg_total, pre_b, pre_C,
                                               m0, P0, lanes, T, segments, seg_len, first, last,
                                               m);
}

// Pass 3.  mean, var: pass 2's fm, fP, overwritten with the marginals; suf_E, suf_g,
// suf_L: (lanes,).
int lgssm_ts_smoother_fillin_f32(float* mean, float* var, const float* sseg_total,
                                 const float* suf_E, const float* suf_g, const float* suf_L,
                                 long long lanes, int T, int segments, int seg_len, int last,
                                 const float* model, void* stream) {
  const Model m = model_of(model);
  const bool vec = (T & 3) == 0 && aligned16(mean) && aligned16(var);
  const int bytes = smem_bytes(2 * kStagesSmooth);
  return vec ? launch<smoother_fillin_kernel<4>>(bytes, lanes, segments, stream, mean, var,
                                                 sseg_total, suf_E, suf_g, suf_L, lanes, T,
                                                 segments, seg_len, last, m)
             : launch<smoother_fillin_kernel<1>>(bytes, lanes, segments, stream, mean, var,
                                                 sseg_total, suf_E, suf_g, suf_L, lanes, T,
                                                 segments, seg_len, last, m);
}

}  // extern "C"
