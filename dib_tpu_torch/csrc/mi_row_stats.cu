// One-pass MI-sandwich row statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel dib_tpu/ops/pallas_density.py::_row_stats_kernel
// (called through mi_row_stats_pallas, square and probe mode). For every row
// i of u and every group g (the feature axis) it computes, in f32:
//
//   diag[g, i] = log p(u_i | x_i)                       (square mode only)
//   full[g, i] = logsumexp_j      log p(u_i | x_j)
//   off[g, i]  = logsumexp_{j!=i} log p(u_i | x_j)      (square mode only)
//
//   log p(u_i | x_j) = -1/2 sum_k z_k^2 + h_j,   h_j = -1/2 (sum_k lv_jk + d log 2pi),
//   z_k = (u_ik - mu_jk) * exp(-lv_jk / 2)
//
// The [N, M] matrix never exists. z uses the direct difference, never the
// |u|^2 + |mu|^2 - 2 u.mu expansion: on the diagonal u ~= mu and the
// expansion cancels catastrophically. Masked outputs use the large-finite
// -1e30 (never -inf), so a row with every entry masked (the off-diagonal
// reduction at N = 1) gives -1e30, as the TPU kernel does.
//
// What bounds it on an H100: operations on the CUDA cores (tensor cores
// cannot form a direct difference). Each (row, column) pair costs 3d FP32
// instructions (subtract, scale, square-accumulate) plus about 7 for the
// value and its online logsumexp, against O((N + M) d) bytes per group.
//
// Design, three kernels launched in order on one stream by the C entry:
//
// 1. stage_kernel converts the inputs to f32 once per call and writes them
//    channel-major into the caller's workspace: u_t [G][dp][np],
//    mu_t and s_t = exp(-lv/2) [G][dp][mp], and h [G][mp]. The channel axis
//    is padded to dp (a multiple of kChunk), rows to np and columns to mp
//    (multiples of kTile). Padding holds u = mu = s = 0 and h = -inf, so a
//    padded column adds exp(-inf) = 0 and the main kernel has no ragged
//    edges, no bf16 path and only aligned 16-byte copies. Column terms are
//    computed once per group instead of once per row block.
//
// 2. row_stats_kernel: a block of 256 threads owns kTile = 128 rows of one
//    group and walks a range of 128-column tiles. Each thread owns an 8 x 8
//    micro-tile (rows and columns t*4 + {0..3} and 64 + t*4 + {0..3}, t its
//    thread row or column), so each channel step reads 2 float4 of u and
//    2 each of mu and s from shared memory, all distinct and conflict-free,
//    for 3 x 64 FP32 instructions: the shared-memory pipe stays at about
//    half of the FP32 pipe's time. The u tile stays resident; mu, s and h
//    stream through a kStages-deep cp.async ring of kChunk-channel steps
//    (one __syncthreads per step both publishes step i and frees step i-1).
//    After a tile's last chunk each row folds its 8 values into ONE online
//    logsumexp over j != i: the diagonal entry (square mode) is written to
//    diag and left out, and full = logsumexp(off, diag) is formed once at
//    the end. Exponentials are ex2.approx of (v - m) * log2(e); v - m is
//    formed first because at |v| ~ 1e12 (log-variances of -26) m * log2(e)
//    rounded in an FMA would lose the whole argument. The running max starts
//    at -1e30 and excluded entries are -inf, so exp(-inf - m) = 0 and
//    (-1e30) - (-1e30) = 0: no NaN. The 16 threads of a row (one half-warp)
//    merge their states by shuffles.
//
// 3. Column split: a block walks its tiles in order, so the last wave of
//    blocks sets the tail. When the row blocks x G make fewer than about
//    eight waves of the card, the caller asks for `splits` > 1 (a host rule,
//    density.column_splits, fed the tile and blocks per SM that this file
//    exports: mi_row_stats_tile, mi_row_stats_blocks_per_sm); block
//    (rb, split, g) then reduces one run of
//    ceil(tiles / splits) tiles into a partial (m, s) state in the workspace
//    and merge_kernel combines the states of each row. With one split the
//    main kernel writes the outputs itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 128;                   // rows per block, columns per tile
constexpr int kThreadRows = 16;              // thread rows (tm) x thread columns (tn)
constexpr int kThreadCols = 16;
constexpr int kThreads = kThreadRows * kThreadCols;
constexpr int kMicro = 8;                    // rows and columns per thread
constexpr int kChunk = 16;                   // channels per pipeline step
constexpr int kStages = 4;                   // depth of the cp.async ring
constexpr int kMaxDim = 64;                  // widest channel axis
constexpr int kMinBlocks = 2;                // blocks per SM the register cap is set for
constexpr int kStageRows = 32;               // entries per staging block
constexpr int kStageFloats = 2 * kChunk * kTile + kTile;   // mu, s, h of one step
// dynamic shared memory of the main kernel: the u tile and the ring
constexpr int smem_bytes(int dp) {
  return (dp * kTile + kStages * kStageFloats) * static_cast<int>(sizeof(float));
}
constexpr float kNegInf = -1e30f;
constexpr double kLog2Pi = 1.8378770664093453;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreadRows * 4 * 2 == kTile && kThreadCols * 4 * 2 == kTile,
              "a thread's 8 rows (columns) are two float4 runs, one per tile half");
static_assert(kMaxDim % kChunk == 0, "the widest channel axis is whole chunks");

int round_up(int x, int to) { return (x + to - 1) / to * to; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Online logsumexp: running max m and the sum s of exp(v - m).
struct Lse {
  float m;
  float s;
};

__device__ __forceinline__ void merge(Lse& a, float m_b, float s_b) {
  const float m = fmaxf(a.m, m_b);
  a.s = a.s * ex2((a.m - m) * kLog2e) + s_b * ex2((m_b - m) * kLog2e);
  a.m = m;
}

// The row's outputs from its off-diagonal (square) or full (probe) state;
// in square mode diag[at] was written by the thread that met the diagonal.
template <bool DIAG>
__device__ __forceinline__ void finish(Lse a, size_t at, const float* diag, float* full,
                                       float* off) {
  if (DIAG) {
    const float dg = diag[at];
    off[at] = a.s > 0.f ? a.m + logf(a.s) : kNegInf;
    const float m = fmaxf(a.m, dg);
    full[at] = m + logf(a.s * expf(a.m - m) + expf(dg - m));
  } else {
    full[at] = a.m + logf(a.s);
  }
}

// Offset inside a tile of a thread's i-th row (column), t its thread row (column).
__device__ __forceinline__ int micro_offset(int t, int i) {
  return (i / 4) * (kTile / 2) + t * 4 + i % 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* __restrict__ u, const T* __restrict__ mu, const T* __restrict__ lv,
             float* __restrict__ u_t, float* __restrict__ mu_t, float* __restrict__ s_t,
             float* __restrict__ h, int n, int m, int d, int dp, int np, int mp, int u_blocks) {
  __shared__ float a[kStageRows][kMaxDim + 1];   // u or mu, entry-major (odd stride)
  __shared__ float b[kStageRows][kMaxDim + 1];   // lv
  const int g = blockIdx.y;
  const bool is_u = blockIdx.x < static_cast<unsigned>(u_blocks);
  const int e0 = (is_u ? blockIdx.x : blockIdx.x - u_blocks) * kStageRows;
  const int count = is_u ? n : m;
  const T* src = is_u ? u + static_cast<size_t>(g) * n * d : mu + static_cast<size_t>(g) * m * d;
  const T* src_lv = lv + static_cast<size_t>(g) * m * d;
  for (int e = threadIdx.x; e < kStageRows * dp; e += kThreads) {
    const int j = e / dp;
    const int k = e % dp;
    const bool ok = e0 + j < count && k < d;
    const size_t at = static_cast<size_t>(e0 + j) * d + k;
    a[j][k] = ok ? to_float(src[at]) : 0.f;
    if (!is_u) b[j][k] = ok ? to_float(src_lv[at]) : 0.f;
  }
  __syncthreads();
  const int stride = is_u ? np : mp;
  float* dst = is_u ? u_t + static_cast<size_t>(g) * dp * np : mu_t + static_cast<size_t>(g) * dp * mp;
  float* dst_s = s_t + static_cast<size_t>(g) * dp * mp;
  for (int e = threadIdx.x; e < kStageRows * dp; e += kThreads) {
    const int k = e / kStageRows;
    const int j = e % kStageRows;
    const size_t at = static_cast<size_t>(k) * stride + e0 + j;
    dst[at] = a[j][k];
    if (!is_u) dst_s[at] = (e0 + j < m && k < d) ? expf(-0.5f * b[j][k]) : 0.f;
  }
  if (!is_u && threadIdx.x < kStageRows) {
    const int j = threadIdx.x;
    double sum = d * kLog2Pi;  // in double: h adds no rounding error of its own
    for (int k = 0; k < d; ++k) sum += b[j][k];
    h[static_cast<size_t>(g) * mp + e0 + j] = e0 + j < m ? static_cast<float>(-0.5 * sum) : -INFINITY;
  }
}

template <bool DIAG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
row_stats_kernel(const float* __restrict__ u_t, const float* __restrict__ mu_t,
                 const float* __restrict__ s_t, const float* __restrict__ h,
                 float* __restrict__ diag, float* __restrict__ full, float* __restrict__ off,
                 float* __restrict__ part_m, float* __restrict__ part_s, int n, int dp, int np,
                 int mp, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* s_u = smem;                   // [dp][kTile], resident
  float* s_ring = smem + dp * kTile;   // kStages x (mu [kChunk][kTile], s [kChunk][kTile], h [kTile])
  const int tid = threadIdx.x;
  const int tn = tid % kThreadCols;
  const int tm = tid / kThreadCols;
  const int rb = blockIdx.x;
  const int split = blockIdx.y;
  const int g = blockIdx.z;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, mp / kTile);
  const int chunks = dp / kChunk;
  const int steps = max(t_end - t_begin, 0) * chunks;
  const float* mu_g = mu_t + static_cast<size_t>(g) * dp * mp;
  const float* s_g = s_t + static_cast<size_t>(g) * dp * mp;
  const float* h_g = h + static_cast<size_t>(g) * mp;

  {  // the u tile joins the first step's copy group
    const float* u_g = u_t + static_cast<size_t>(g) * dp * np + rb * kTile;
    for (int e = tid; e < dp * (kTile / 4); e += kThreads) {
      const int k = e / (kTile / 4);
      const int c4 = e % (kTile / 4);
      cp_async16(s_u + k * kTile + c4 * 4, u_g + static_cast<size_t>(k) * np + c4 * 4);
    }
  }
  auto load_step = [&](int step) {
    if (step < steps) {
      const int t = t_begin + step / chunks;
      const int kc = step % chunks;
      float* st = s_ring + (step % kStages) * kStageFloats;
      for (int e = tid; e < kChunk * (kTile / 4); e += kThreads) {
        const int k = e / (kTile / 4);
        const int c4 = e % (kTile / 4);
        const size_t at = static_cast<size_t>(kc * kChunk + k) * mp + t * kTile + c4 * 4;
        cp_async16(st + k * kTile + c4 * 4, mu_g + at);
        cp_async16(st + (kChunk + k) * kTile + c4 * 4, s_g + at);
      }
      if (kc == chunks - 1 && tid < kTile / 4)
        cp_async16(st + 2 * kChunk * kTile + tid * 4, h_g + t * kTile + tid * 4);
    }
    cp_async_commit();  // an empty group past the end keeps the counting uniform
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_step(i);

  float q[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) q[r][c] = 0.f;
  Lse state[kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r) state[r] = Lse{kNegInf, 0.f};
  const size_t out_base = static_cast<size_t>(g) * n;
  const int row0 = rb * kTile;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step's copies visible to all; every thread done with step - 1
    load_step(step + kStages - 1);
    const float* st = s_ring + (step % kStages) * kStageFloats;
    const int kc = step % chunks;
    const float* uk = s_u + kc * kChunk * kTile;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 u0 = *reinterpret_cast<const float4*>(uk + kk * kTile + tm * 4);
      const float4 u1 = *reinterpret_cast<const float4*>(uk + kk * kTile + kTile / 2 + tm * 4);
      const float4 m0 = *reinterpret_cast<const float4*>(st + kk * kTile + tn * 4);
      const float4 m1 = *reinterpret_cast<const float4*>(st + kk * kTile + kTile / 2 + tn * 4);
      const float4 s0 = *reinterpret_cast<const float4*>(st + (kChunk + kk) * kTile + tn * 4);
      const float4 s1 =
          *reinterpret_cast<const float4*>(st + (kChunk + kk) * kTile + kTile / 2 + tn * 4);
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
    if (kc != chunks - 1) continue;

    // the tile's last chunk: fold the 8 x 8 values into the rows' states
    const int t = t_begin + step / chunks;
    const float4 h0 = *reinterpret_cast<const float4*>(st + 2 * kChunk * kTile + tn * 4);
    const float4 h1 =
        *reinterpret_cast<const float4*>(st + 2 * kChunk * kTile + kTile / 2 + tn * 4);
    const float hc[kMicro] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    // rows and columns are tiled alike (N == M), so the diagonal lies in
    // tile t == rb, at the threads with tm == tn, entries r == c
    const bool diag_threads = DIAG && t == rb && tm == tn;
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      float v[kMicro];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        v[c] = fmaf(q[r][c], -0.5f, hc[c]);
        q[r][c] = 0.f;
      }
      if (diag_threads) {
        const int row = row0 + micro_offset(tm, r);
        if (row < n) diag[out_base + row] = v[r];
        v[r] = -INFINITY;
      }
      float mx = state[r].m;
#pragma unroll
      for (int c = 0; c < kMicro; ++c) mx = fmaxf(mx, v[c]);
      float s = state[r].s * ex2((state[r].m - mx) * kLog2e);
#pragma unroll
      for (int c = 0; c < kMicro; ++c) s += ex2((v[c] - mx) * kLog2e);
      state[r] = Lse{mx, s};
    }
  }
  cp_async_wait<0>();  // an empty split never waited for its u tile

  // the 16 column threads of a row are one half-warp: merge by shuffles
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int lane_mask = kThreadCols / 2; lane_mask > 0; lane_mask >>= 1)
      merge(state[r], __shfl_xor_sync(0xffffffffu, state[r].m, lane_mask),
            __shfl_xor_sync(0xffffffffu, state[r].s, lane_mask));
  __syncthreads();  // the diagonal written above is visible to the whole block
  const bool whole = gridDim.y == 1;
  const size_t part_base = (static_cast<size_t>(split) * gridDim.z + g) * n;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int row = row0 + micro_offset(tm, r);
    if (tn != r || row >= n) continue;
    if (whole) {
      finish<DIAG>(state[r], out_base + row, diag, full, off);
    } else {
      part_m[part_base + row] = state[r].m;
      part_s[part_base + row] = state[r].s;
    }
  }
}

// Combines the splits' partial states of each of the G * N rows.
template <bool DIAG>
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
             float* __restrict__ diag, float* __restrict__ full, float* __restrict__ off,
             long long rows, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  Lse a{kNegInf, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    const size_t at = static_cast<size_t>(sp) * rows + i;
    merge(a, part_m[at], part_s[at]);
  }
  finish<DIAG>(a, i, diag, full, off);
}

struct Layout {
  int dp, np, mp, tiles;
  size_t u_t, mu_t, s_t, h, part_m, part_s, total;  // float offsets into the workspace
};

Layout layout(int g, int n, int m, int d, int splits) {
  Layout l;
  l.dp = round_up(d, kChunk);
  l.np = round_up(n, kTile);
  l.mp = round_up(m, kTile);
  l.tiles = l.mp / kTile;
  const size_t G = static_cast<size_t>(g);
  l.u_t = 0;
  l.mu_t = l.u_t + G * l.dp * l.np;
  l.s_t = l.mu_t + G * l.dp * l.mp;
  l.h = l.s_t + G * l.dp * l.mp;
  l.part_m = l.h + G * l.mp;
  const size_t parts = splits > 1 ? static_cast<size_t>(splits) * G * n : 0;
  l.part_s = l.part_m + parts;
  l.total = l.part_s + parts;
  return l;
}

template <typename T>
cudaError_t stage(const void* u, const void* mu, const void* lv, float* ws, const Layout& l,
                  int g, int n, int m, int d, cudaStream_t stream) {
  const int u_blocks = l.np / kStageRows;
  const dim3 grid(u_blocks + l.mp / kStageRows, g);
  stage_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(mu), static_cast<const T*>(lv),
      ws + l.u_t, ws + l.mu_t, ws + l.s_t, ws + l.h, n, m, d, l.dp, l.np, l.mp, u_blocks);
  return cudaGetLastError();
}

// Lets row_stats_kernel<DIAG> take the widest channel's shared memory, once
// per device (the attribute is the device context's; setting it costs host
// time on every call otherwise).
template <bool DIAG>
cudaError_t allow_smem(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      row_stats_kernel<DIAG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxDim));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <bool DIAG>
cudaError_t reduce(float* ws, const Layout& l, float* diag, float* full, float* off, int g,
                   int n, int splits, int device, cudaStream_t stream) {
  const int smem = smem_bytes(l.dp);
  cudaError_t err = allow_smem<DIAG>(device);
  if (err != cudaSuccess) return err;
  const int tiles_per_split = (l.tiles + splits - 1) / splits;
  const dim3 grid(l.np / kTile, splits, g);
  row_stats_kernel<DIAG><<<grid, kThreads, smem, stream>>>(
      ws + l.u_t, ws + l.mu_t, ws + l.s_t, ws + l.h, diag, full, off, ws + l.part_m,
      ws + l.part_s, n, l.dp, l.np, l.mp, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = static_cast<long long>(g) * n;
  const unsigned blocks = static_cast<unsigned>((rows + 255) / 256);
  merge_kernel<DIAG><<<blocks, 256, 0, stream>>>(ws + l.part_m, ws + l.part_s, diag, full, off,
                                                 rows, splits);
  return cudaGetLastError();
}

}  // namespace

// The geometry the host's split rule needs: rows per block and columns per
// tile, and the blocks of the main kernel that one SM holds.
extern "C" int mi_row_stats_tile() { return kTile; }
extern "C" int mi_row_stats_blocks_per_sm() { return kMinBlocks; }

// Floats of f32 workspace that mi_row_stats_launch needs for these sizes.
extern "C" long long mi_row_stats_workspace_floats(int g, int n, int m, int d, int splits) {
  return static_cast<long long>(layout(g, n, m, d, splits).total);
}

// u [g, n, d]; mu, lv [g, m, d], all contiguous and of one type
// (dtype 0: float32, 1: bfloat16). Outputs [g, n] float32; diag and off are
// unused (may be null) when diagonal == 0. `workspace` holds at least
// mi_row_stats_workspace_floats(g, n, m, d, splits) floats, 16-byte aligned;
// `splits` (1 .. the number of 128-column tiles) is the column split. Launches
// on `stream` and returns the first cudaError_t of the launches; does not
// synchronise.
extern "C" int mi_row_stats_launch(const void* u, const void* mu, const void* lv, float* diag,
                                   float* full, float* off, float* workspace,
                                   long long workspace_floats, int g, int n, int m, int d,
                                   int splits, int dtype, int diagonal, int device, void* stream) {
  if (g < 1 || g > 65535 || n < 1 || m < 1 || d < 1 || d > kMaxDim ||
      (dtype != 0 && dtype != 1) || workspace == nullptr ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0 ||
      (diagonal && (diag == nullptr || off == nullptr || n != m)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(g, n, m, d, splits);
  if (splits < 1 || splits > l.tiles || splits > 65535 ||
      workspace_floats < static_cast<long long>(l.total))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? stage<float>(u, mu, lv, workspace, l, g, n, m, d, s)
                   : stage<__nv_bfloat16>(u, mu, lv, workspace, l, g, n, m, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = diagonal ? reduce<true>(workspace, l, diag, full, off, g, n, splits, device, s)
                 : reduce<false>(workspace, l, diag, full, off, g, n, splits, device, s);
  return static_cast<int>(err);
}
