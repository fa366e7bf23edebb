// Blockwise (flash) self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dib_tpu/ops/pallas_attention.py::_flash_kernel
// (called through flash_self_attention). For q, k, v of shape [B, S, H, D]
// it computes, per (batch, head) and in f32,
//
//   out[b, i, h] = sum_j softmax_j(scale * q_i . k_j) v_j,  scale = 1/sqrt(D)
//
// without ever forming the [S, S] score matrix: an online softmax (running
// max m, normaliser l, rescaled accumulator) over tiles of keys. As in the
// TPU kernel the score is scaled after the q.k product, keys past S are
// masked with the large-finite -1e30 (never -inf), the unnormalised
// probabilities are rounded to the input type before the p.v product, and
// the output is f32. Inputs are f32 or bf16 of one type; every sum is f32.
//
// What bounds it on an H100: at the flagship shape (B = 32, S = 50, H = 12,
// D = 128) bytes. The three inputs and the output are about 9.8 MB each
// against 4 B H S^2 D = 0.49 GFLOP per call: ~12 us at 3.35 TB/s against
// ~7 us at the f32 peak of 67 TFLOP/s. From a few hundred keys on it is
// operations: at S = 1024 the same call is 25.8 GFLOP against 50 MB.
//
// Design: the TPU grid carried m, l and the accumulator in scratch across a
// sequential key-block axis. Hopper blocks run in no order, so one block
// owns one (batch*head, tile of 64 query rows) and walks every key tile
// itself; no state crosses blocks. q, k and v are read in their [B, S, H, D]
// layout through strides (the JAX wrapper's moveaxis + pad copy is not
// needed), the ragged last tiles are bounds-checked, never padded in memory.
// The 64 x D query tile and each 64 x D key and value tile are staged in
// shared memory as f32; the tile of probabilities reuses the key tile's
// space once the scores are formed. That is 97 KB at D = 128: above the
// 48 KB static limit, so the launch raises the dynamic limit, and small
// enough for two blocks on one SM (227 KB). 256 threads form a 16 x 16
// grid: each thread holds a 4 x 4 block of the tile's scores and a 4 x D/16
// block of the accumulator in registers and reads shared memory as float4
// (row padding keeps the key reads free of bank conflicts). The 16 threads
// that share a query row are 16 lanes of one warp, so the row max and row
// sum of the online softmax are warp shuffles. The products run on the CUDA
// cores in f32; mma.sync/wgmma, TMA and a pipelined load of the next tile
// are later work. One width of tile (DP = 128) serves every D <= 128: the
// columns past D are zero-filled in shared memory and never written out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;                        // query rows per block
constexpr int kBlockK = 64;                        // keys per tile
constexpr int kLanes = 16;                         // threads sharing a query row
constexpr int kRows = kBlockQ / (kThreads / kLanes);   // query rows per thread (4)
constexpr int kCols = kBlockK / kLanes;            // keys per thread and tile (4)
constexpr int kPad = 4;                            // floats of row padding
constexpr int kPStride = kBlockK + kPad;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The TPU kernel casts p to the input type before the p.v product.
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int DP>
constexpr int kKStride = DP + kPad;                // padded: key rows are read across lanes

// q tile [kBlockQ][DP], k tile [kBlockK][DP + kPad] (later the p tile
// [kBlockQ][kPStride]), v tile [kBlockK][DP]
template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ) * DP + kBlockK * kKStride<DP> + kBlockK * DP);
}

// Stages rows [row0, row0 + 64) of one (batch, head) slice as f32, zeros past
// `seq` rows and `d` columns. Consecutive threads read consecutive columns.
template <typename T, int DP, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride, int row0,
                                          int seq, int d) {
  for (int e = threadIdx.x; e < kBlockK * DP; e += kThreads) {
    const int r = e / DP;
    const int c = e % DP;
    const int row = row0 + r;
    dst[r * STRIDE + c] =
        (row < seq && c < d) ? to_float(src[static_cast<long long>(row) * row_stride + c]) : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       float* __restrict__ out, int seq, int heads, int d, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                       float scale) {
  static_assert(DP % 64 == 0, "each lane owns float4 groups of 64-column strips");
  static_assert(kBlockQ * kPStride <= kBlockK * kKStride<DP>, "the p tile fits the k tile");
  constexpr int KS = kKStride<DP>;
  constexpr int kStrips = DP / 64;                 // float4 groups per lane and row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                // [kBlockQ][DP]
  float* ks = qs + kBlockQ * DP;                   // [kBlockK][KS]
  float* vs = ks + kBlockK * KS;                   // [kBlockK][DP]
  float* ps = ks;                                  // [kBlockQ][kPStride], after the scores

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tx = threadIdx.x % kLanes;             // key / column group
  const int ty = threadIdx.x / kLanes;             // query row group
  const T* k_bh = k + b * k_sb + h * k_sh;
  const T* v_bh = v + b * v_sb + h * v_sh;

  load_tile<T, DP, DP>(qs, q + b * q_sb + h * q_sh, q_ss, q0, seq, d);

  float m[kRows], l[kRows], acc[kRows][4 * kStrips];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kStrips; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ps and vs are consumed
    load_tile<T, DP, KS>(ks, k_bh, k_ss, k0, seq, d);
    load_tile<T, DP, DP>(vs, v_bh, v_ss, k0, seq, d);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * DP + c);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * KS + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    __syncthreads();  // every score is formed: ps may overwrite ks

    // online softmax; the 16 lanes of a row reduce with xor shuffles
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = (k0 + tx + 16 * j < seq) ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int offset = kLanes / 2; offset > 0; offset >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, offset));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = round_like(p, q);
      }
#pragma unroll
      for (int offset = kLanes / 2; offset > 0; offset >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, offset);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kStrips; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc[rows ty + 16 i][columns 64 strip + 4 tx + e] += p . v over the tile's keys
    const int keys = min(kBlockK, seq - k0);
    for (int j = 0; j < keys; j += 4) {
      float pa[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPStride + j);
        pa[i][0] = p4.x;
        pa[i][1] = p4.y;
        pa[i][2] = p4.z;
        pa[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int strip = 0; strip < kStrips; ++strip) {
          const float4 vb =
              *reinterpret_cast<const float4*>(vs + (j + jj) * DP + 64 * strip + 4 * tx);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i][4 * strip + 0] = fmaf(pa[i][jj], vb.x, acc[i][4 * strip + 0]);
            acc[i][4 * strip + 1] = fmaf(pa[i][jj], vb.y, acc[i][4 * strip + 1]);
            acc[i][4 * strip + 2] = fmaf(pa[i][jj], vb.z, acc[i][4 * strip + 2]);
            acc[i][4 * strip + 3] = fmaf(pa[i][jj], vb.w, acc[i][4 * strip + 3]);
          }
        }
    }
  }

  // out [B, S, H, D] contiguous f32
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    float* o = out + ((static_cast<long long>(b) * seq + row) * heads + h) * d;
#pragma unroll
    for (int strip = 0; strip < kStrips; ++strip)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * strip + 4 * tx + e;
        if (col < d) o[col] = acc[i][4 * strip + e] / l[i];
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, int batch, int seq,
                   int heads, int d, const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  const auto kernel = flash_attention_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, seq,
      heads, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v [batch, seq, heads, d] of one type (dtype 0: float32, 1: bfloat16),
// addressed through their element strides over (batch, seq, heads) with a
// unit stride along d; out [batch, seq, heads, d] contiguous float32.
// Launches on `stream` and returns the cudaError_t of the launch; does not
// synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, float* out,
                                      int batch, int seq, int heads, int d, long long q_sb,
                                      long long q_ss, long long q_sh, long long k_sb,
                                      long long k_ss, long long k_sh, long long v_sb,
                                      long long v_ss, long long v_sh, float scale, int dtype,
                                      int device, void* stream) {
  const long long blocks = static_cast<long long>(batch) * heads;
  if (batch < 1 || heads < 1 || seq < 1 || d < 1 || d > 128 || blocks > 2147483647LL ||
      (seq + kBlockQ - 1) / kBlockQ > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float, 128>(q, k, v, out, batch, seq, heads, d, st, scale, s);
  else
    err = launch<__nv_bfloat16, 128>(q, k, v, out, batch, seq, heads, d, st, scale, s);
  return static_cast<int>(err);
}
