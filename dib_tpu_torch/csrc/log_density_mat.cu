// The full Gaussian log-density matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel dib_tpu/ops/pallas_density.py::_density_kernel
// (called through gaussian_log_density_mat_pallas). For u [N, d] and the
// diagonal Gaussians (mu, lv) [M, d] it writes the [N, M] float32 matrix
//
//   out[i, j] = log p(u_i | x_j) = -1/2 (sum_k z_k^2 + sum_k lv_jk + d log 2pi),
//   z_k = (u_ik - mu_jk) * exp(-lv_jk / 2)
//
// z uses the direct difference, never the |u|^2 + |mu|^2 - 2 u.mu expansion:
// on the diagonal u ~= mu and the expansion cancels catastrophically.
//
// What bounds it on an H100: both sides are close. The output is the only
// large traffic (4 N M bytes, 67 MB at N = M = 4096), and each entry costs
// about 3d + 2 f32 operations on the CUDA cores (difference, scale,
// square-accumulate; tensor cores cannot form a direct difference), so at
// d = 32 the operations and the bytes take about the same time at the
// published peaks. The design therefore writes each output once, coalesced,
// and reuses every staged value many times.
//
// Design: the TPU grid gave each (row tile, column tile) step a [bm, bn, d]
// difference block in VMEM and zero-padded ragged inputs. Here one block of
// 256 threads owns a 64 x 64 output tile. The tile's u rows and its columns'
// mu, exp(-lv/2) and lv are staged in shared memory, d in chunks of 32 so any
// d works. Thread (tx, ty) owns column tx and 16 rows; it holds its column's
// chunk of mu and exp(-lv/2) in registers and reads each row of u as float4
// broadcasts (every lane of a warp reads the same address). Consecutive
// threads own consecutive columns, so each row of the tile is stored by a
// warp as 128 contiguous bytes. The column's sum of lv is taken once per
// tile. Ragged rows, columns and d are bounds-checked (staged as zeros, never
// stored), not padded in memory.

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kChunk = 32;                                // d staged per step
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kTileCols;          // 4
constexpr int kRowsPerThread = kTileRows / kRowGroups;    // 16
constexpr float kLog2Pi = 1.8378770664093453f;

__global__ void __launch_bounds__(kThreads)
log_density_mat_kernel(const float* __restrict__ u, const float* __restrict__ mu,
                       const float* __restrict__ lv, float* __restrict__ out, int n, int m,
                       int d) {
  static_assert(kChunk % 4 == 0, "u rows are read as float4");
  // row stride of s_u keeps each row 16-byte aligned; the +1 of the column
  // arrays puts lane tx's reads of column tx in bank tx
  __shared__ __align__(16) float s_u[kTileRows][kChunk + 4];
  __shared__ float s_mu[kTileCols][kChunk + 1];
  __shared__ float s_inv_std[kTileCols][kChunk + 1];
  __shared__ float s_lv[kTileCols][kChunk + 1];

  const int tx = threadIdx.x % kTileCols;
  const int ty = threadIdx.x / kTileCols;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
  float lv_sum = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = threadIdx.x; e < kTileRows * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int k = e % kChunk;
      const bool ok = row0 + r < n && k0 + k < d;
      s_u[r][k] = ok ? u[static_cast<size_t>(row0 + r) * d + k0 + k] : 0.f;
    }
    for (int e = threadIdx.x; e < kTileCols * kChunk; e += kThreads) {
      const int c = e / kChunk;
      const int k = e % kChunk;
      const bool ok = col0 + c < m && k0 + k < d;
      const size_t at = static_cast<size_t>(col0 + c) * d + k0 + k;
      const float lv_k = ok ? lv[at] : 0.f;
      s_mu[c][k] = ok ? mu[at] : 0.f;
      s_inv_std[c][k] = ok ? expf(-0.5f * lv_k) : 0.f;
      s_lv[c][k] = lv_k;
    }
    __syncthreads();

    float mu_r[kChunk];
    float inv_std_r[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      mu_r[k] = s_mu[tx][k];
      inv_std_r[k] = s_inv_std[tx][k];
      lv_sum += s_lv[tx][k];
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float4* u4 = reinterpret_cast<const float4*>(s_u[ty * kRowsPerThread + r]);
      float q = acc[r];
#pragma unroll
      for (int k4 = 0; k4 < kChunk / 4; ++k4) {
        const float4 a = u4[k4];
        const float z0 = (a.x - mu_r[4 * k4 + 0]) * inv_std_r[4 * k4 + 0];
        const float z1 = (a.y - mu_r[4 * k4 + 1]) * inv_std_r[4 * k4 + 1];
        const float z2 = (a.z - mu_r[4 * k4 + 2]) * inv_std_r[4 * k4 + 2];
        const float z3 = (a.w - mu_r[4 * k4 + 3]) * inv_std_r[4 * k4 + 3];
        q = fmaf(z0, z0, q);
        q = fmaf(z1, z1, q);
        q = fmaf(z2, z2, q);
        q = fmaf(z3, z3, q);
      }
      acc[r] = q;
    }
  }

  const int col = col0 + tx;
  if (col >= m) return;
  const float norm = lv_sum + d * kLog2Pi;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + ty * kRowsPerThread + r;
    if (row < n) out[static_cast<size_t>(row) * m + col] = -0.5f * (acc[r] + norm);
  }
}

}  // namespace

// u [n, d]; mu, lv [m, d]; out [n, m]; all float32 and contiguous. Launches
// on `stream` and returns the cudaError_t of the launch; does not
// synchronise.
extern "C" int log_density_mat_launch(const float* u, const float* mu, const float* lv,
                                      float* out, int n, int m, int d, int device,
                                      void* stream) {
  const int row_tiles = (n + kTileRows - 1) / kTileRows;
  if (n < 1 || m < 1 || d < 1 || row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTileCols - 1) / kTileCols, row_tiles);
  log_density_mat_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, mu, lv, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}
