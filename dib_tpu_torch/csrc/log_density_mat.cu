// The full Gaussian log-density matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel dib_tpu/ops/pallas_density.py::_density_kernel
// (called through gaussian_log_density_mat_pallas). For u [N, d] and the
// diagonal Gaussians (mu, lv) [M, d] it writes the [N, M] float32 matrix
//
//   out[i, j] = log p(u_i | x_j) = -1/2 sum_k z_k^2 + h_j,
//   h_j = -1/2 (sum_k lv_jk + d log 2pi),   z_k = (u_ik - mu_jk) * exp(-lv_jk / 2)
//
// z uses the direct difference, never the |u|^2 + |mu|^2 - 2 u.mu expansion
// nor fma(u, s, -mu * s): on the diagonal u ~= mu and both cancel.
//
// What bounds it on an H100: the FP32 issue rate of the CUDA cores (tensor
// cores cannot form a direct difference). Each (entry, channel) costs an
// FADD, an FMUL and an FFMA, three issue slots; Hopper has no packed f32
// FMA. At N = M = 4096, d = 32 that is about 48 us at 1.98 GHz, against
// 20 us to write the 67 MB output, which has to hide under it.
//
// Design, two kernels launched in order on one stream by the C entry:
//
// 1. log_density_stage_kernel writes the inputs into the caller's workspace
//    once per call, channel-major and cut into ring steps (see the layout
//    below): u, mu, s = exp(-lv/2), and each column's h. Channels are padded
//    to dp (a multiple of kChunk), rows and columns to multiples of kTile,
//    with zeros: a padded channel adds ((0 - 0) * 0)^2 = 0, so the main
//    kernel has no ragged inputs and only aligned 16-byte copies. A block
//    transposes 32 entries through shared memory, 32 channels at a time, so
//    any d works; sum_k lv is taken in double, in channel order, so h adds
//    no rounding of its own at the log-variances of -26..20 that the
//    untrained flagship reaches. The column terms are computed once per
//    call, not once per tile.
//
// 2. log_density_mat_kernel: one block of 256 threads per 128 x 128 output
//    tile, on a one-dimensional grid (no row limit). Each thread owns an
//    8 x 8 micro-tile (rows and columns t*4 + {0..3} and 64 + t*4 + {0..3},
//    t its thread row or column), so each channel reads 2 float4 each of u,
//    mu and s from shared memory, all distinct and conflict-free, for
//    3 x 64 FP32 instructions. u, mu and s arrive through a kStages-deep
//    cp.async ring of kChunk-channel steps, each step one contiguous run of
//    the workspace (one __syncthreads per step both publishes step i and
//    frees step i-1). Each entry's sum is one chain over channels 0..dp-1.
//    Then each row is stored as two float4 runs per thread with
//    st.global.cs: a half-warp writes 256 contiguous bytes of one row, and
//    the output, larger than L2 and never read back, streams past it. The
//    stores are fire-and-forget and drain under the other resident block's
//    arithmetic (128 registers and 48 KB of shared memory per block: two
//    blocks per SM). Only edge tiles check bounds, and a matrix whose rows
//    are not 16-byte aligned (M % 4 != 0) is stored one float at a time.
//    A persistent grid that carried the ring across tiles, 64-row tiles and
//    a programmatic launch overlapping the staging pass were each timed
//    against this on an H100 and won nothing (PERF.md).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 128;                   // rows and columns of an output tile
constexpr int kThreadRows = 16;              // thread rows (tm) x thread columns (tn)
constexpr int kThreadCols = 16;
constexpr int kThreads = kThreadRows * kThreadCols;
constexpr int kMicro = 8;                    // rows and columns per thread
constexpr int kChunk = 8;                    // channels per ring step
constexpr int kStages = 4;                   // depth of the cp.async ring
constexpr int kMinBlocks = 2;                // blocks per SM the register cap is set for
constexpr int kStageEntries = 32;            // entries per staging block
constexpr int kStageChunk = 32;              // channels per staging round
constexpr int kRowStep = kChunk * kTile;     // floats of u in one ring step
constexpr int kColStep = 2 * kChunk * kTile; // floats of mu and s in one ring step
constexpr int kStepFloats = kRowStep + kColStep;
constexpr int kSmemBytes = kStages * kStepFloats * static_cast<int>(sizeof(float));
constexpr double kLog2Pi = 1.8378770664093453;
static_assert(kThreadRows * 4 * 2 == kTile && kThreadCols * 4 * 2 == kTile,
              "a thread's 8 rows (columns) are two float4 runs, one per tile half");
static_assert(kRowStep % (4 * kThreads) == 0, "a ring step is whole copies per thread");
static_assert(kStageEntries <= kTile && kTile % kStageEntries == 0,
              "a staging block lies inside one tile");
static_assert(kStageEntries * kStageChunk % kThreads == 0, "a staging round is whole loads");
static_assert(kSmemBytes <= 48 * 1024, "the ring fits without opting in to more shared memory");

long long round_up(long long x, long long to) { return (x + to - 1) / to * to; }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Workspace layout, in ring steps: u_t [row tile][chunk][kChunk][kTile] and
// c_t [column tile][chunk][mu, s][kChunk][kTile], so that one ring step of
// a tile is one contiguous run of each, and h [mp].
__global__ void __launch_bounds__(kThreads)
log_density_stage_kernel(const float* __restrict__ u, const float* __restrict__ mu,
                         const float* __restrict__ lv, float* __restrict__ u_t,
                         float* __restrict__ c_t, float* __restrict__ h, long long n,
                         long long m, int d, int dp, unsigned u_blocks) {
  __shared__ float a[kStageEntries][kStageChunk + 1];   // u or mu, entry-major (odd stride)
  __shared__ float b[kStageEntries][kStageChunk + 1];   // lv
  const bool is_u = blockIdx.x < u_blocks;
  const long long e0 = static_cast<long long>(is_u ? blockIdx.x : blockIdx.x - u_blocks) *
                       kStageEntries;
  const long long count = is_u ? n : m;
  const float* src = is_u ? u : mu;
  const int chunks = dp / kChunk;
  // this block's entries lie in one tile: its ring steps start here
  const size_t tile_base = static_cast<size_t>(e0 / kTile) * chunks *
                               (is_u ? kRowStep : kColStep) + e0 % kTile;
  float* dst = (is_u ? u_t : c_t) + tile_base;
  double lv_sum = 0.0;   // thread j < kStageEntries of a column block: column e0 + j
  constexpr int per_thread = kStageEntries * kStageChunk / kThreads;
  for (int k0 = 0; k0 < dp; k0 += kStageChunk) {
#pragma unroll  // every load of the round in flight at once
    for (int i = 0; i < per_thread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int j = e / kStageChunk;
      const int k = e % kStageChunk;
      const bool ok = e0 + j < count && k0 + k < d;
      const size_t at = static_cast<size_t>(e0 + j) * d + k0 + k;
      a[j][k] = ok ? src[at] : 0.f;
      if (!is_u) b[j][k] = ok ? lv[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < per_thread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int k = e / kStageEntries;
      const int j = e % kStageEntries;
      const int kk = k0 + k;
      if (kk >= dp) break;   // k only grows with i
      const size_t at = static_cast<size_t>(kk / kChunk) * (is_u ? kRowStep : kColStep) +
                        (kk % kChunk) * kTile + j;
      dst[at] = a[j][k];
      if (!is_u) dst[at + kChunk * kTile] = (e0 + j < m && kk < d) ? expf(-0.5f * b[j][k]) : 0.f;
    }
    if (!is_u && threadIdx.x < kStageEntries)
      for (int k = 0; k < kStageChunk && k0 + k < d; ++k) lv_sum += b[threadIdx.x][k];
    __syncthreads();
  }
  if (!is_u && threadIdx.x < kStageEntries)   // padded columns get a finite h, never stored
    h[e0 + threadIdx.x] = static_cast<float>(-0.5 * (lv_sum + d * kLog2Pi));
}

// One float4 run of a row: columns col .. col + 3 of the row at `at`.
__device__ __forceinline__ void store_run(float* at, long long m, long long col, float4 v,
                                          bool edge, bool vec) {
  if (!edge) {
    __stcs(reinterpret_cast<float4*>(at), v);
  } else if (vec) {   // M % 4 == 0: a run lies wholly inside or wholly outside the matrix
    if (col < m) __stcs(reinterpret_cast<float4*>(at), v);
  } else {
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < m) __stcs(at + i, w[i]);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
log_density_mat_kernel(const float* __restrict__ u_t, const float* __restrict__ c_t,
                       const float* __restrict__ h, float* __restrict__ out, long long n,
                       long long m, int chunks, unsigned col_tiles, bool vec) {
  extern __shared__ __align__(16) float smem[];   // kStages x (u, mu, s) [kChunk][kTile]
  const int tid = threadIdx.x;
  const int tn = tid % kThreadCols;
  const int tm = tid / kThreadCols;
  const unsigned rt = blockIdx.x / col_tiles;
  const unsigned ct = blockIdx.x % col_tiles;
  const float* u_src = u_t + static_cast<size_t>(rt) * chunks * kRowStep;
  const float* c_src = c_t + static_cast<size_t>(ct) * chunks * kColStep;

  auto load = [&](int kc) {
    if (kc < chunks) {
      float* st = smem + (kc % kStages) * kStepFloats;
      const float* us = u_src + static_cast<size_t>(kc) * kRowStep;
      const float* cs = c_src + static_cast<size_t>(kc) * kColStep;
#pragma unroll
      for (int i = 0; i < kRowStep / (4 * kThreads); ++i)
        cp_async16(st + 4 * (tid + i * kThreads), us + 4 * (tid + i * kThreads));
#pragma unroll
      for (int i = 0; i < kColStep / (4 * kThreads); ++i)
        cp_async16(st + kRowStep + 4 * (tid + i * kThreads), cs + 4 * (tid + i * kThreads));
    }
    cp_async_commit();  // an empty group past the end keeps the counting uniform
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load(i);

  float q[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) q[r][c] = 0.f;

  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's copies visible to all; every thread done with the last
    load(kc + kStages - 1);
    const float* su = smem + (kc % kStages) * kStepFloats;
    const float* sm = su + kRowStep;
    const float* ss = sm + kChunk * kTile;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 u0 = *reinterpret_cast<const float4*>(su + kk * kTile + tm * 4);
      const float4 u1 = *reinterpret_cast<const float4*>(su + kk * kTile + kTile / 2 + tm * 4);
      const float4 m0 = *reinterpret_cast<const float4*>(sm + kk * kTile + tn * 4);
      const float4 m1 = *reinterpret_cast<const float4*>(sm + kk * kTile + kTile / 2 + tn * 4);
      const float4 s0 = *reinterpret_cast<const float4*>(ss + kk * kTile + tn * 4);
      const float4 s1 = *reinterpret_cast<const float4*>(ss + kk * kTile + kTile / 2 + tn * 4);
      const float ur[kMicro] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const float mr[kMicro] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      const float sr[kMicro] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const float z = (ur[r] - mr[c]) * sr[c];
          q[r][c] = fmaf(z, z, q[r][c]);
        }
    }
  }

  // the tile is summed: h joins, and each of the 8 rows goes out as two float4 runs
  const long long row0 = static_cast<long long>(rt) * kTile + tm * 4;
  const long long col0 = static_cast<long long>(ct) * kTile + tn * 4;
  const float4 h0 = __ldg(reinterpret_cast<const float4*>(h + col0));
  const float4 h1 = __ldg(reinterpret_cast<const float4*>(h + col0 + kTile / 2));
  const float hc[kMicro] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const bool edge = !vec || static_cast<long long>(rt + 1) * kTile > n ||
                    static_cast<long long>(ct + 1) * kTile > m;
  float* at = out + static_cast<size_t>(row0) * m + col0;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    float v[kMicro];
#pragma unroll
    for (int c = 0; c < kMicro; ++c) v[c] = fmaf(q[r][c], -0.5f, hc[c]);
    const int dr = (r / 4) * (kTile / 2) + r % 4;
    if (edge && row0 + dr >= n) continue;
    float* row = at + static_cast<size_t>(dr) * m;
    store_run(row, m, col0, make_float4(v[0], v[1], v[2], v[3]), edge, vec);
    store_run(row + kTile / 2, m, col0 + kTile / 2, make_float4(v[4], v[5], v[6], v[7]), edge,
              vec);
  }
}

struct Layout {
  int dp;
  long long np, mp, row_tiles, col_tiles;
  size_t u_t, c_t, h, total;  // float offsets into the workspace
};

Layout layout(long long n, long long m, int d) {
  Layout l;
  l.dp = static_cast<int>(round_up(d, kChunk));
  l.np = round_up(n, kTile);
  l.mp = round_up(m, kTile);
  l.row_tiles = l.np / kTile;
  l.col_tiles = l.mp / kTile;
  l.u_t = 0;
  l.c_t = l.u_t + static_cast<size_t>(l.dp) * l.np;
  l.h = l.c_t + 2 * static_cast<size_t>(l.dp) * l.mp;
  l.total = l.h + l.mp;
  return l;
}

}  // namespace

// The output tile's rows and columns: what the edge tiles are counted in.
extern "C" int log_density_mat_tile() { return kTile; }

// Floats of f32 workspace that log_density_mat_launch needs for these sizes.
extern "C" long long log_density_mat_workspace_floats(long long n, long long m, long long d) {
  if (n < 1 || m < 1 || d < 1 || d > INT_MAX - kChunk) return -1;
  return static_cast<long long>(layout(n, m, static_cast<int>(d)).total);
}

// u [n, d]; mu, lv [m, d]; out [n, m]; all float32 and contiguous.
// `workspace` holds at least log_density_mat_workspace_floats(n, m, d)
// floats, 16-byte aligned. Launches the staging pass and the main kernel (one
// block per 128 x 128 tile, on a one-dimensional grid) on `stream` and
// returns the first cudaError_t of the launches; does not synchronise.
extern "C" int log_density_mat_launch(const float* u, const float* mu, const float* lv,
                                      float* out, float* workspace, long long workspace_floats,
                                      long long n, long long m, long long d, int device,
                                      void* stream) {
  if (n < 1 || m < 1 || d < 1 || d > INT_MAX - kChunk || workspace == nullptr ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n, m, static_cast<int>(d));
  const long long stage_blocks = (l.np + l.mp) / kStageEntries;
  const long long tiles = l.row_tiles * l.col_tiles;
  if (workspace_floats < static_cast<long long>(l.total) || stage_blocks > INT_MAX ||
      tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  log_density_stage_kernel<<<static_cast<unsigned>(stage_blocks), kThreads, 0, s>>>(
      u, mu, lv, workspace + l.u_t, workspace + l.c_t, workspace + l.h, n, m,
      static_cast<int>(d), l.dp, static_cast<unsigned>(l.np / kStageEntries));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  log_density_mat_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes, s>>>(
      workspace + l.u_t, workspace + l.c_t, workspace + l.h, out, n, m, l.dp / kChunk,
      static_cast<unsigned>(l.col_tiles), vec);
  return static_cast<int>(cudaGetLastError());
}
