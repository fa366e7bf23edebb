// One-pass MI-sandwich row statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel dib_tpu/ops/pallas_density.py::_row_stats_kernel
// (called through mi_row_stats_pallas). For every row i of u and every group
// g (the feature axis) it computes, in f32 and in one pass over the columns:
//
//   diag[g, i] = log p(u_i | x_i)                       (square mode only)
//   full[g, i] = logsumexp_j      log p(u_i | x_j)
//   off[g, i]  = logsumexp_{j!=i} log p(u_i | x_j)      (square mode only)
//
//   log p(u_i | x_j) = -1/2 (sum_k z_k^2 + sum_k lv_jk + d log 2pi),
//   z_k = (u_ik - mu_jk) * exp(-lv_jk / 2)
//
// The [N, M] matrix never exists. z uses the direct difference, never the
// |u|^2 + |mu|^2 - 2 u.mu expansion: on the diagonal u ~= mu and the
// expansion cancels catastrophically. Masked entries use the large-finite
// -1e30 (never -inf), so a row with every entry masked (the off-diagonal
// reduction at N = 1) gives -1e30, as the TPU kernel does.
//
// What bounds it on an H100: operations. Each (row, column) pair costs about
// 4d f32 operations (difference, scale, square-accumulate) plus two exps,
// while the bytes are O((N + M) d) per group, so at the slice shape
// (G = 10, N = M = 1024, d = 32) the work sits far above the memory roofline
// and on the CUDA cores (tensor cores cannot form a direct difference).
//
// Design: the TPU grid carried the running max/sum in scratch across a
// sequential column axis; Hopper blocks run in no order, so one block owns 32
// rows of one group and walks every column itself. Each lane keeps its row of
// u in registers. A tile of 64 columns (mu, exp(-lv/2) and the sums of lv,
// reduced by warp shuffles as the tile loads) is staged in shared memory;
// each of the 8 warps takes 8 of its columns, so all
// lanes of a warp read the same shared address (a broadcast, no bank
// conflicts). Each warp keeps its own online max / rescaled sum per row for
// the full and the off-diagonal reductions plus the captured diagonal; at the
// end the 8 partial states of a row are merged through shared memory. No
// state crosses blocks, so no second pass or atomics. The feature dimension
// is a template bound (32 or 64) so u stays in registers and the inner loop
// unrolls; slots past d are zero on both sides and contribute nothing.
// Ragged rows and columns are bounds-checked, never padded in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                         // rows per block, one per lane
constexpr int kWarps = 8;                         // warps split each column tile
constexpr int kThreads = kRows * kWarps;
constexpr int kTileCols = 64;                     // columns staged per step
constexpr int kColsPerWarp = kTileCols / kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2Pi = 1.8378770664093453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Online logsumexp: running max m and the sum s of exp(v - m).
struct Lse {
  float m;
  float s;
};

__device__ __forceinline__ void merge(Lse& a, float m_b, float s_b) {
  const float m = fmaxf(a.m, m_b);
  a.s = a.s * expf(a.m - m) + s_b * expf(m_b - m);
  a.m = m;
}

// Folds the first `count` values of a warp's column chunk into `acc`.
__device__ __forceinline__ void accumulate(Lse& acc, const float (&v)[kColsPerWarp], int count) {
  float chunk_max = kNegInf;
#pragma unroll
  for (int t = 0; t < kColsPerWarp; ++t)
    if (t < count) chunk_max = fmaxf(chunk_max, v[t]);
  const float m = fmaxf(acc.m, chunk_max);
  float s = acc.s * expf(acc.m - m);
#pragma unroll
  for (int t = 0; t < kColsPerWarp; ++t)
    if (t < count) s += expf(v[t] - m);
  acc.m = m;
  acc.s = s;
}

template <typename T, int DP, bool DIAG>
__global__ void __launch_bounds__(kThreads)
mi_row_stats_kernel(const T* __restrict__ u, const T* __restrict__ mu, const T* __restrict__ lv,
                    float* __restrict__ diag_out, float* __restrict__ full_out,
                    float* __restrict__ off_out, int n, int m, int d) {
  // a warp's 32 consecutive tile entries lie in one column, and every lane
  // takes the same number of load steps (the shuffles below need all 32)
  static_assert(DP % 32 == 0, "DP must be a multiple of the warp width");
  static_assert(kTileCols * DP % kThreads == 0, "load steps must be uniform");
  constexpr int kParts = DP / 32;  // warps that load one column's lv
  __shared__ __align__(16) float s_mu[kTileCols][DP];
  __shared__ __align__(16) float s_inv_std[kTileCols][DP];
  __shared__ float s_lv_sum[kTileCols][kParts];
  __shared__ float s_part[kWarps][5][kRows];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.y;
  const int row = blockIdx.x * kRows + lane;
  const bool row_ok = row < n;
  const T* u_g = u + static_cast<size_t>(g) * n * d;
  const T* mu_g = mu + static_cast<size_t>(g) * m * d;
  const T* lv_g = lv + static_cast<size_t>(g) * m * d;

  float ur[DP];
#pragma unroll
  for (int k = 0; k < DP; ++k)
    ur[k] = (row_ok && k < d) ? to_float(u_g[static_cast<size_t>(row) * d + k]) : 0.f;

  Lse full{kNegInf, 0.f};
  Lse off{kNegInf, 0.f};
  float diag = kNegInf;

  for (int c0 = 0; c0 < m; c0 += kTileCols) {
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < kTileCols * DP; e += kThreads) {
      const int j = e / DP;
      const int k = e % DP;
      const int col = c0 + j;
      const bool ok = k < d && col < m;
      const size_t at = static_cast<size_t>(col) * d + k;
      const float lv_k = ok ? to_float(lv_g[at]) : 0.f;
      s_mu[j][k] = ok ? to_float(mu_g[at]) : 0.f;
      s_inv_std[j][k] = ok ? expf(-0.5f * lv_k) : 0.f;
      float lv_sum = lv_k;  // this warp's 32 entries of column j
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1)
        lv_sum += __shfl_xor_sync(0xffffffffu, lv_sum, offset);
      if (lane == 0) s_lv_sum[j][k / 32] = lv_sum;
    }
    __syncthreads();

    const int j0 = warp * kColsPerWarp;
    const int count = min(kColsPerWarp, m - (c0 + j0));  // uniform across the warp
    if (count <= 0) continue;
    float v[kColsPerWarp];
#pragma unroll
    for (int t = 0; t < kColsPerWarp; ++t) {
      v[t] = kNegInf;
      if (t < count) {
        const float4* mu4 = reinterpret_cast<const float4*>(s_mu[j0 + t]);
        const float4* is4 = reinterpret_cast<const float4*>(s_inv_std[j0 + t]);
        float q = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < DP / 4; ++k4) {
          const float4 a = mu4[k4];
          const float4 b = is4[k4];
          const float z0 = (ur[4 * k4 + 0] - a.x) * b.x;
          const float z1 = (ur[4 * k4 + 1] - a.y) * b.y;
          const float z2 = (ur[4 * k4 + 2] - a.z) * b.z;
          const float z3 = (ur[4 * k4 + 3] - a.w) * b.w;
          q = fmaf(z0, z0, q);
          q = fmaf(z1, z1, q);
          q = fmaf(z2, z2, q);
          q = fmaf(z3, z3, q);
        }
        float norm = d * kLog2Pi;
#pragma unroll
        for (int p = 0; p < kParts; ++p) norm += s_lv_sum[j0 + t][p];
        v[t] = -0.5f * (q + norm);
      }
    }
    accumulate(full, v, count);
    if (DIAG) {
#pragma unroll
      for (int t = 0; t < kColsPerWarp; ++t) {
        if (c0 + j0 + t == row) {
          diag = v[t];
          v[t] = kNegInf;
        }
      }
      accumulate(off, v, count);
    }
  }

  // merge the 8 warps' partial states of each row
  s_part[warp][0][lane] = full.m;
  s_part[warp][1][lane] = full.s;
  if (DIAG) {
    s_part[warp][2][lane] = off.m;
    s_part[warp][3][lane] = off.s;
    s_part[warp][4][lane] = diag;
  }
  __syncthreads();
  if (warp != 0 || !row_ok) return;
  const size_t out = static_cast<size_t>(g) * n + row;
  for (int w = 1; w < kWarps; ++w) merge(full, s_part[w][0][lane], s_part[w][1][lane]);
  full_out[out] = full.m + logf(full.s);
  if (DIAG) {
    for (int w = 1; w < kWarps; ++w) {
      merge(off, s_part[w][2][lane], s_part[w][3][lane]);
      diag = fmaxf(diag, s_part[w][4][lane]);
    }
    off_out[out] = off.m + logf(off.s);
    diag_out[out] = diag;
  }
}

template <typename T, int DP>
void launch(const void* u, const void* mu, const void* lv, float* diag, float* full, float* off,
            int g, int n, int m, int d, bool diagonal, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, g);
  const T* u_t = static_cast<const T*>(u);
  const T* mu_t = static_cast<const T*>(mu);
  const T* lv_t = static_cast<const T*>(lv);
  if (diagonal)
    mi_row_stats_kernel<T, DP, true><<<grid, kThreads, 0, stream>>>(u_t, mu_t, lv_t, diag, full,
                                                                     off, n, m, d);
  else
    mi_row_stats_kernel<T, DP, false><<<grid, kThreads, 0, stream>>>(u_t, mu_t, lv_t, diag, full,
                                                                      off, n, m, d);
}

template <typename T>
void launch_for_dim(const void* u, const void* mu, const void* lv, float* diag, float* full,
                    float* off, int g, int n, int m, int d, bool diagonal, cudaStream_t stream) {
  if (d <= 32)
    launch<T, 32>(u, mu, lv, diag, full, off, g, n, m, d, diagonal, stream);
  else
    launch<T, 64>(u, mu, lv, diag, full, off, g, n, m, d, diagonal, stream);
}

}  // namespace

// u [g, n, d]; mu, lv [g, m, d], all contiguous and of one type
// (dtype 0: float32, 1: bfloat16). Outputs [g, n] float32; diag and off are
// unused (may be null) when diagonal == 0. Launches on `stream` and returns
// the cudaError_t of the launch; does not synchronise.
extern "C" int mi_row_stats_launch(const void* u, const void* mu, const void* lv, float* diag,
                                   float* full, float* off, int g, int n, int m, int d,
                                   int dtype, int diagonal, int device, void* stream) {
  if (g < 1 || g > 65535 || n < 1 || m < 1 || d < 1 || d > 64 || (dtype != 0 && dtype != 1) ||
      (diagonal && (diag == nullptr || off == nullptr || n != m)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_for_dim<float>(u, mu, lv, diag, full, off, g, n, m, d, diagonal != 0, s);
  else
    launch_for_dim<__nv_bfloat16>(u, mu, lv, diag, full, off, g, n, m, d, diagonal != 0, s);
  return static_cast<int>(cudaGetLastError());
}
