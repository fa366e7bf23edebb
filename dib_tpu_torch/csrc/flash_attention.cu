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
// probabilities are rounded to the input type before the p.v product
// while l sums them unrounded, and the output is f32 (acc / l). Inputs are
// f32 or bf16 of one type; every sum is f32. Two kernels, one per type, and
// both read q, k and v in their [B, S, H, D] layout through strides (the
// JAX wrapper's moveaxis + pad copy is not needed), bounds-check the ragged
// last tiles instead of padding them in memory, and serve every D <= 128
// with one tile width (columns past D are zero in shared memory and never
// written out). Each grid is one-dimensional with the query tile fastest,
// so the blocks that read one head's k and v run together and find them in
// L2.
//
// flash_attention_kernel<ASYNC> (f32 inputs, on the CUDA cores).
// What bounds it on an H100: at the flagship shape (B = 32, S = 50, H = 12,
// D = 128) bytes. The three inputs and the output are about 9.8 MB each
// against 4 B H S^2 D = 0.49 GFLOP per call: ~12 us at 3.35 TB/s against
// ~7 us at the f32 peak of 67 TFLOP/s. From a few hundred keys on it is
// operations: at S = 1024 the same call is 25.8 GFLOP against 50 MB. The
// products stay exact f32 FMAs (no TF32, no mma: the SASS holds no HMMA),
// and each score sums its channels in order, one FMA chain from channel 0
// to 127, as the plain version's matrix product does: at scores near 1e4
// (q and k scaled by 100) a sum taken in another order (tried: four
// channel quarters added by shuffles) moves the output far past the 1e-4
// that the check of that case allows.
// Design: the TPU grid carried m, l and the accumulator in scratch across a
// sequential key-block axis. Here one block of 4 warps owns one
// (batch*head, tile of 64 query rows) and walks every key tile itself; each
// warp owns 16 of the rows and carries their m, l and accumulator, so the
// softmax needs warp shuffles and __syncwarp only, and a warp whose rows
// all lie past S skips the arithmetic. The q tile and 2 stages of 32-key k
// and v tiles are staged in shared memory by 16-byte cp.async copies, q
// with the first key tile in one commit group and the second in the next,
// so that every byte a block needs at S <= 64 is in flight at once; past
// that, one __syncthreads per tile publishes tile t and frees the stage of
// tile t - 1, which then takes tile t + 1 while tile t computes. Each warp
// multiplies from shared memory in register-blocked micro-tiles:
//   q.k: lane (rq, kq) = (lane / 8, lane % 8) forms the 4 x 4 scores of
//   rows rq + 4i and keys kq + 8j; each step of 4 channels reads 4 q and
//   4 k float4 for 64 FMAs (q and k rows are padded by 4 floats, so the 4
//   rows and the 8 keys that one load touches start on distinct banks).
//   p.v: lane (rp, cp) = (lane / 16, lane % 16) accumulates the 8 x 8
//   outputs of rows rp + 2i and columns 4 cp + e, 64 + 4 cp + e; each step
//   of 4 keys reads 8 float4 of p (broadcasts) and 8 of v for 256 FMAs.
// A larger q.k micro-tile needs a larger warp tile: more keys per stage
// (shared memory then holds one block per SM) or more rows per warp (the
// accumulator then outgrows the registers). The probabilities pass from
// the first layout to the second through a per-warp [16][40] tile in
// shared memory (row stride 40: the scalar writes of the first layout hit
// 32 distinct banks), whose column 32 carries each row's rescale factor
// and column 33, at the end, its normaliser. The exponentials are
// ex2.approx of (s - m) log2 e, the difference taken first in f32: folding
// m into an FMA would round the argument away at large |s|, and exp2f in
// its accurate form adds a range fix-up to every score. (-1e30) - (-1e30)
// is 0, never NaN. Shared memory is 110,592 bytes, so two blocks share an
// SM. 64 query rows per block measured fastest at every shape the port
// runs: tiles of 32 rows (2 warps, so one warp per scheduler) and of 128
// rows (8 warps, one block per SM) were slower or no faster. Inputs whose
// base pointers are not 16-byte aligned, whose (b, s, h) strides are not
// multiples of 4, or whose D is not a multiple of 4 take the same kernel
// with ASYNC = false: the tiles are staged by a synchronous per-element
// loop (zeros past S and D) and the rest is unchanged.
//
// flash_attention_bf16_kernel<ASYNC> (bf16 inputs, on the tensor cores).
// What bounds it: operations from a few dozen keys on. At B = 4, S = 1024,
// H = 12, D = 128 the call is 25.8 GFLOP, 26 us at the dense bf16 peak of
// 989 TFLOP/s, against 63 MB of bf16 inputs and f32 output (19 us at
// 3.35 TB/s); at the flagship's S = 50 it is bytes (24.6 MB, 7.3 us).
// Design: FlashAttention-2's layout on mma.sync.m16n8k16 (bf16 in, f32
// accumulate). 4 warps per block, one block per (batch*head, 128-query
// tile); each warp owns 32 query rows as two m16 tiles, so every k and v
// fragment that ldmatrix brings into registers feeds two products. That
// halves the shared-memory reads per product against 16 rows per warp,
// which measured slower on the card at every S >= 1024 shape tried: with
// mma.sync, whose operands pass through registers, ldmatrix bandwidth and
// not the tensor cores is the first limit. With the head fastest in the
// grid instead, k and v are re-read from device memory once per query tile
// as soon as B H S D outgrows L2. The query tile is staged in shared memory
// once; its A fragments are re-read by ldmatrix.x4 at each of the 8
// k-steps of 16 over DP = 128 (held in registers for 32 rows they would
// not fit beside the 128 accumulator registers). Key and value tiles of
// 32 x 128 go through a 3-stage cp.async ring (16-byte copies, one commit
// group per tile, wait_group 1): tiles t + 1 and t + 2 are in flight while
// tile t computes, and one __syncthreads per tile both publishes tile t
// and frees the stage of tile t - 1 for the next copy. Shared memory:
// 34,816 bytes of q plus 3 x 17,408 of k and v = 87,040 bytes, two blocks
// per SM. Every shared row is padded by 16 bytes (272-byte stride), so the
// 8 row addresses of each ldmatrix phase fall on distinct banks. S = Q K^T
// takes K's B fragments by ldmatrix from its row-major rows; O += P V
// takes V's by ldmatrix.trans. The scores of a row sit in the 4 lanes of a
// quad, so the row max is two __shfl_xor_sync (offsets 1, 2); each lane
// keeps a partial l that is summed over the quad once, at the end. The
// exponential is ex2.approx.ftz (the SFU's 2^x) with log2 e folded into
// the scale: the max m is taken over the f32 products q . k, and p =
// 2^((q . k - m) scale2) with scale2 = scale * log2 e, which is
// exp(scale q . k - scale m) up to f32 rounding of the argument, with p
// below 2^-126 flushed to zero (exp2f in its accurate form adds a range
// fix-up to every one, which measured slower). The difference comes first,
// as in the f32 kernel: folding m into an FMA rounded the argument by units
// at the untrained flagship's block-0 scores (|scale q . k| ~ 1e8), whose
// bf16 training then turned non-finite after one update. p never leaves registers:
// two adjacent n8 C fragments, rounded by __floats2bfloat162_rn
// (round-to-nearest-even, as JAX's astype), are the A fragment of the p.v
// product. 255 registers (the most a thread can have; two blocks of 128
// threads fit one SM's 65,536) with 16 bytes spilled (-Xptxas -v). Inputs
// whose base pointers are not 16-byte aligned, whose (b, s, h) strides are
// not multiples of 8, or whose D is not a multiple of 8 take the same
// kernel with ASYNC = false: the tiles are staged by a synchronous
// per-element loop (zeros past S and D) and the rest is unchanged. At
// B = 4, S = 1024, H = 12 the 384 blocks fill 1.45 waves of the card's
// 2 x 132 block slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kHeadPad = 128;                      // DP: one tile width for every D <= 128
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

template <bool ASYNC>
__device__ __forceinline__ void commit_stage() {
  if constexpr (ASYNC) asm volatile("cp.async.commit_group;\n" ::);
}

// Every committed stage but the newest `PENDING` has landed (for this thread).
template <bool ASYNC, int PENDING>
__device__ __forceinline__ void wait_stages() {
  if constexpr (ASYNC) asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// 2^x on the special-function unit; results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Lets `kernel` take `bytes` of dynamic shared memory on `device`. The
// attribute belongs to the device's context and setting it costs host time,
// so it is set once per kernel and device; `done` is the caller's record.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device,
                       std::atomic<unsigned long long>& done) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// The f32 kernel on the CUDA cores (see the note at the top).

constexpr int kWarps = 4;                          // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 16;                      // query rows per warp
constexpr int kBlockQ = kWarps * kWarpRows;        // query rows per block (64)
constexpr int kTileKeys = 32;                      // keys per k/v tile
constexpr int kQkStride = kHeadPad + 4;            // q and k rows, read across lanes: padded
constexpr int kVStride = kHeadPad;                 // v rows, read along the row
constexpr int kPStride = kTileKeys + 8;            // per-warp p rows, then corr and l
constexpr int kCorrCol = kTileKeys;                // the row's rescale factor of this tile
constexpr int kSumCol = kTileKeys + 1;             // the row's normaliser, at the end
constexpr int kKvFloats = kTileKeys * (kQkStride + kVStride);   // one stage: a k and a v tile

// the q tile [kBlockQ][kQkStride], 2 stages of (k [kTileKeys][kQkStride],
// v [kTileKeys][kVStride]), then each warp's p tile [kWarpRows][kPStride]
constexpr size_t kF32SmemBytes =
    sizeof(float) * (kBlockQ * kQkStride + 2 * kKvFloats + kBlockQ * kPStride);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stages rows [row0, row0 + ROWS) of one (batch, head) slice into a shared
// tile of row stride STRIDE, zeros past `seq` rows and `d` columns. ASYNC:
// 16-byte cp.async chunks, consecutive threads on consecutive chunks of a
// row (needs d % 4 == 0, a 16-byte-aligned slice and a row stride that is
// a multiple of 4); otherwise one element at a time, synchronously.
template <bool ASYNC, int ROWS, int STRIDE>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long row_stride,
                                          int row0, int seq, int d) {
  if constexpr (ASYNC) {
    constexpr int kChunks = kHeadPad / 4;          // 16-byte chunks per row
    static_assert(ROWS * kChunks % kThreads == 0, "every thread copies as many chunks");
#pragma unroll
    for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
      const int chunk = threadIdx.x + i * kThreads;
      const int r = chunk / kChunks;
      const int c = chunk % kChunks * 4;
      const int row = row0 + r;
      const bool inside = row < seq && c < d;
      cp_async_16(dst + r * STRIDE + c, inside ? src + row * row_stride + c : src,
                  inside ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kHeadPad; e += kThreads) {
      const int r = e / kHeadPad;
      const int c = e % kHeadPad;
      const int row = row0 + r;
      dst[r * STRIDE + c] = (row < seq && c < d) ? src[row * row_stride + c] : 0.f;
    }
  }
}

template <bool ASYNC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int seq, int heads,
                       int d, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kv = qs + kBlockQ * kQkStride;
  float* ps = kv + 2 * kKvFloats;

  // the query tiles of one (batch, head) are neighbours in the grid
  const int q_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const int b = blockIdx.x / q_tiles / heads;
  const int h = blockIdx.x / q_tiles % heads;
  const int q0 = blockIdx.x % q_tiles * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rq = lane / 8;                         // q.k: rows rq + 4 i
  const int kq = lane % 8;                         //      keys kq + 8 j of the tile
  const int rp = lane / 16;                        // p.v: rows rp + 2 i
  const int cp = lane % 16;                        //      columns 4 cp + e, 64 + 4 cp + e
  const bool active = q0 + warp * kWarpRows < seq;
  const float* qw = qs + warp * kWarpRows * kQkStride;
  float* pw = ps + warp * kWarpRows * kPStride;
  const float* k_bh = k + b * k_sb + h * k_sh;
  const float* v_bh = v + b * v_sb + h * v_sh;
  const int num_tiles = (seq + kTileKeys - 1) / kTileKeys;

  auto stage_kv = [&](int t) {
    if (t < num_tiles) {
      float* st = kv + t % 2 * kKvFloats;
      stage_f32<ASYNC, kTileKeys, kQkStride>(st, k_bh, k_ss, t * kTileKeys, seq, d);
      stage_f32<ASYNC, kTileKeys, kVStride>(st + kTileKeys * kQkStride, v_bh, v_ss,
                                            t * kTileKeys, seq, d);
    }
    commit_stage<ASYNC>();                         // possibly empty: keeps the count uniform
  };
  // prologue: q with key tile 0 in one commit group, tile 1 in the next,
  // so that at S <= 64 every byte the block needs is in flight at once
  stage_f32<ASYNC, kBlockQ, kQkStride>(qs, q + b * q_sb + h * q_sh, q_ss, q0, seq, d);
  stage_kv(0);
  stage_kv(1);

  float m[4], l[4], acc[8][8];                     // m, l: q.k rows; acc: p.v rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;                                    // this lane's share of the row's sum
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < num_tiles; ++t) {
    // tile t has landed (tile 1, copied with tile 0, may not have); the
    // barrier makes it visible and shows every warp done with tile t - 1,
    // whose stage then takes tile t + 1
    if (t == 0) {
      wait_stages<ASYNC, 1>();
    } else {
      wait_stages<ASYNC, 0>();
    }
    __syncthreads();
    if (t > 0) stage_kv(t + 1);
    const float* kt = kv + t % 2 * kKvFloats;
    const float* vt = kt + kTileKeys * kQkStride;
    const int k0 = t * kTileKeys;
    if (active) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < kHeadPad; c += 4) {
        float4 qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = ld4(qw + (rq + 4 * i) * kQkStride + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) kb[j] = ld4(kt + (kq + 8 * j) * kQkStride + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
          }
      }

      // online softmax over the 8 lanes of each row (xor 1, 2, 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = k0 + kq + 8 * j < seq ? s[i][j] * scale : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int offset = 1; offset < 8; offset <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, offset));
        const float corr = exp2_approx((m[i] - mx) * kLog2e);
        m[i] = mx;
        l[i] *= corr;
        float* p_row = pw + (rq + 4 * i) * kPStride;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2_approx((s[i][j] - mx) * kLog2e);
          l[i] += p;                               // the unrounded p
          p_row[kq + 8 * j] = p;                   // f32: rounding to the input type is a no-op
        }
        if (kq == 0) p_row[kCorrCol] = corr;
      }
      __syncwarp();

      // acc = acc * corr + p . v over the tile's keys (p is 0 past S, and
      // so are the staged v rows)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = pw[(rp + 2 * i) * kPStride + kCorrCol];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
      }
      const int keys = min(kTileKeys, seq - k0);
#pragma unroll 2
      for (int j = 0; j < keys; j += 4) {
        float4 pa[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pa[i] = ld4(pw + (rp + 2 * i) * kPStride + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 v0 = ld4(vt + (j + jj) * kVStride + 4 * cp);
          const float4 v1 = ld4(vt + (j + jj) * kVStride + 64 + 4 * cp);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
            acc[i][0] = fmaf(p, v0.x, acc[i][0]);
            acc[i][1] = fmaf(p, v0.y, acc[i][1]);
            acc[i][2] = fmaf(p, v0.z, acc[i][2]);
            acc[i][3] = fmaf(p, v0.w, acc[i][3]);
            acc[i][4] = fmaf(p, v1.x, acc[i][4]);
            acc[i][5] = fmaf(p, v1.y, acc[i][5]);
            acc[i][6] = fmaf(p, v1.z, acc[i][6]);
            acc[i][7] = fmaf(p, v1.w, acc[i][7]);
          }
        }
      }
    }
  }
  if (!active) return;

  // out [B, S, H, D] contiguous f32: acc / l for rows < S and columns < D
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int offset = 1; offset < 8; offset <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], offset);
    if (kq == 0) pw[(rq + 4 * i) * kPStride + kSumCol] = l[i];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * kWarpRows + rp + 2 * i;
    if (row >= seq) continue;
    const float inv = 1.f / pw[(rp + 2 * i) * kPStride + kSumCol];
    float* o_row = out + ((static_cast<long long>(b) * seq + row) * heads + h) * d;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 64 * half + 4 * cp;
      const float4 x = make_float4(acc[i][4 * half] * inv, acc[i][4 * half + 1] * inv,
                                   acc[i][4 * half + 2] * inv, acc[i][4 * half + 3] * inv);
      if (col + 4 <= d && d % 4 == 0) {
        *reinterpret_cast<float4*>(o_row + col) = x;
      } else {
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) o_row[col + e] = xs[e];
      }
    }
  }
}

// ASYNC = aligned: the cp.async staging needs every 16-byte chunk of a row aligned.
cudaError_t launch_f32(bool aligned, const void* q, const void* k, const void* v, float* out,
                       int blocks, int seq, int heads, int d, const long long* st, float scale,
                       int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set[2];
  const auto kernel = aligned ? flash_attention_kernel<true> : flash_attention_kernel<false>;
  const cudaError_t err = allow_smem(kernel, kF32SmemBytes, device, smem_set[aligned]);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, kF32SmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      out, seq, heads, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 kernel on the tensor cores (see the note at the top).

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMTiles = 2;                         // m16 tiles per warp: 32 query rows
constexpr int kBlockRows = 16 * kMTiles * kMmaWarps;   // query rows per block (128)
constexpr int kKeys = 32;                          // keys per tile
constexpr int kStages = 3;                         // key/value tiles in flight
constexpr int kRowElems = kHeadPad + 8;            // bf16 per shared row: 16 bytes of padding
constexpr int kStageElems = 2 * kKeys * kRowElems; // one k tile and one v tile
constexpr size_t kMmaSmemBytes =
    sizeof(uint16_t) * (kBlockRows * kRowElems + kStages * kStageElems);

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16 x 8, f32] += a[16 x 16, bf16, row-major] . b[16 x 8, bf16, column-major]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stages rows [row0, row0 + ROWS) of one (batch, head) slice into a padded
// shared tile of bf16 bit patterns, zeros past `seq` rows and `d` columns.
// ASYNC: 16-byte cp.async chunks, consecutive threads on consecutive chunks
// of a row (needs d % 8 == 0, a 16-byte-aligned slice and a row stride that
// is a multiple of 8); otherwise one element at a time, synchronously.
template <bool ASYNC, int ROWS>
__device__ __forceinline__ void stage_tile(uint16_t* dst, const uint16_t* src,
                                           long long row_stride, int row0, int seq, int d) {
  if constexpr (ASYNC) {
    constexpr int kChunks = kHeadPad / 8;          // 16-byte chunks per row
#pragma unroll
    for (int i = 0; i < ROWS * kChunks / kMmaThreads; ++i) {
      const int chunk = threadIdx.x + i * kMmaThreads;
      const int r = chunk / kChunks;
      const int c = (chunk % kChunks) * 8;
      const int row = row0 + r;
      const bool inside = row < seq && c < d;
      cp_async_16(dst + r * kRowElems + c, inside ? src + row * row_stride + c : src,
                  inside ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kHeadPad; e += kMmaThreads) {
      const int r = e / kHeadPad;
      const int c = e % kHeadPad;
      const int row = row0 + r;
      dst[r * kRowElems + c] = (row < seq && c < d) ? src[row * row_stride + c] : uint16_t{0};
    }
  }
}

template <bool ASYNC>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_attention_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v, float* __restrict__ out, int seq,
                            int heads, int d, long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                            long long v_ss, long long v_sh, float scale) {
  // the q tile [kBlockRows][kRowElems], then kStages stages, each a k tile
  // [kKeys][kRowElems] and the v tile of the same keys
  extern __shared__ __align__(16) uint16_t tiles[];
  uint16_t* qs = tiles;
  uint16_t* kv = tiles + kBlockRows * kRowElems;

  // the query tiles of one (batch, head) are neighbours in the grid, so the
  // blocks that read the same k and v run together and share them in L2
  const int q_tiles = (seq + kBlockRows - 1) / kBlockRows;
  const int b = blockIdx.x / q_tiles / heads;
  const int h = blockIdx.x / q_tiles % heads;
  const int q0 = blockIdx.x % q_tiles * kBlockRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = lane / 4;                      // fragment row (and row + 8)
  const int quad = lane % 4;                       // fragment column pair
  const uint16_t* k_bh = k + b * k_sb + h * k_sh;
  const uint16_t* v_bh = v + b * v_sb + h * v_sh;
  const int num_tiles = (seq + kKeys - 1) / kKeys;
  const float scale2 = scale * kLog2e;

  // prologue: q with key tile 0, then tiles 1 .. kStages - 2; one commit
  // group per tile
  stage_tile<ASYNC, kBlockRows>(qs, q + b * q_sb + h * q_sh, q_ss, q0, seq, d);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < num_tiles) {
      stage_tile<ASYNC, kKeys>(kv + j * kStageElems, k_bh, k_ss, j * kKeys, seq, d);
      stage_tile<ASYNC, kKeys>(kv + j * kStageElems + kKeys * kRowElems, v_bh, v_ss, j * kKeys,
                               seq, d);
    }
    commit_stage<ASYNC>();                         // possibly empty: keeps the count uniform
  }

  float o[kMTiles][kHeadPad / 8][4];               // C fragments of the output, 32 x 128
  float m[kMTiles][2];                             // unscaled running max of rows group, group + 8
  float l[kMTiles][2];                             // this lane's share of each row's sum
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < kHeadPad / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }

  for (int t = 0; t < num_tiles; ++t) {
    wait_stages<ASYNC, kStages - 2>();             // tile t has landed, later ones may not have
    // every thread's copies of tile t are visible, and every warp is done
    // with tile t - 1, whose stage the prefetch below overwrites
    __syncthreads();
    if (t + kStages - 1 < num_tiles) {
      uint16_t* next = kv + (t + kStages - 1) % kStages * kStageElems;
      stage_tile<ASYNC, kKeys>(next, k_bh, k_ss, (t + kStages - 1) * kKeys, seq, d);
      stage_tile<ASYNC, kKeys>(next + kKeys * kRowElems, v_bh, v_ss, (t + kStages - 1) * kKeys,
                               seq, d);
    }
    commit_stage<ASYNC>();
    const uint16_t* kt = kv + t % kStages * kStageElems;
    const uint16_t* vt = kt + kKeys * kRowElems;

    // S = Q K^T for the warp's 32 rows x the tile's 32 keys; each k and q
    // fragment feeds two products
    float s[kMTiles][kKeys / 8][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadPad / 16; ++kk) {
      uint32_t qa[kMTiles][4];                     // A fragments: rows of m tile mt, k-step kk
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
        ldmatrix_x4(qa[mt], qs + ((warp * kMTiles + mt) * 16 + lane % 16) * kRowElems +
                                kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        // matrices: keys +0..7 / +8..15 of the pair, columns +0..7 / +8..15 of the k-step
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * kRowElems + kk * 16 +
                            ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    // online softmax; element e of s[mt][n] is row 16 mt + group + 8 (e / 2)
    // of the warp, key t * kKeys + 8 n + 2 quad + e % 2. The max is taken
    // over the unscaled products (the scale is positive), and p =
    // 2^((s - m) scale2) = e^(s scale - m scale), the difference taken
    // first: at |s scale2| near 1e8 an FMA with -m scale2 rounds the
    // exponent by units (p off by 2^4 at the max), and near 1e10 to
    // infinity.
    const bool ragged = (t + 1) * kKeys > seq;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t * kKeys + n * 8 + 2 * quad + (e & 1);
          if (ragged && key >= seq) s[mt][n][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float corr = exp2_approx((m[mt][r] - mx[r]) * scale2);
        m[mt][r] = mx[r];
        l[mt][r] *= corr;
#pragma unroll
        for (int n = 0; n < kHeadPad / 8; ++n) {
          o[mt][n][2 * r] *= corr;
          o[mt][n][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = exp2_approx((s[mt][n][e] - mx[e >> 1]) * scale2);
          l[mt][e >> 1] += s[mt][n][e];            // the unrounded p
        }
    }

    // O += P V: the C fragments of n8 tiles 2 kk and 2 kk + 1, rounded to
    // bf16, are the A fragment of k-step kk (keys 16 kk .. 16 kk + 15)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t pa[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kHeadPad / 16; ++dp) {
        // matrices: keys +0..7 / +8..15 of the k-step, columns +0..7 / +8..15 of the pair
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * kRowElems +
                                  dp * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          mma_bf16(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  // out [B, S, H, D] contiguous f32: acc / l for rows < S and columns < D
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float row_sum = l[mt][r];
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      const int row = q0 + (warp * kMTiles + mt) * 16 + group + 8 * r;
      if (row >= seq) continue;
      float* o_row = out + ((static_cast<long long>(b) * seq + row) * heads + h) * d;
#pragma unroll
      for (int n = 0; n < kHeadPad / 8; ++n) {
        const int col = n * 8 + 2 * quad;
        if (col >= d) continue;
        const float x0 = o[mt][n][2 * r] / row_sum;
        const float x1 = o[mt][n][2 * r + 1] / row_sum;
        if (d % 2 == 0) {
          *reinterpret_cast<float2*>(o_row + col) = make_float2(x0, x1);
        } else {
          o_row[col] = x0;
          if (col + 1 < d) o_row[col + 1] = x1;
        }
      }
    }
}

cudaError_t launch_bf16(bool aligned, const void* q, const void* k, const void* v, float* out,
                        int blocks, int seq, int heads, int d, const long long* st, float scale,
                        int device, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set[2];
  const auto kernel =
      aligned ? flash_attention_bf16_kernel<true> : flash_attention_bf16_kernel<false>;
  const cudaError_t err = allow_smem(kernel, kMmaSmemBytes, device, smem_set[aligned]);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kMmaThreads, kMmaSmemBytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), out, seq, heads, d, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale);
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
  if (batch < 1 || heads < 1 || seq < 1 || d < 1 || d > kHeadPad || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // one-dimensional grids: (batch * heads) x query tiles blocks
  const int block_q = dtype == 0 ? kBlockQ : kBlockRows;
  const long long blocks =
      static_cast<long long>(batch) * heads * ((seq + block_q - 1) / block_q);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  // the cp.async paths need every 16-byte chunk of a row aligned: 4 floats
  // or 8 bfloat16 elements
  const int chunk = dtype == 0 ? 4 : 8;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  bool aligned = d % chunk == 0 && bases % 16 == 0;
  for (long long stride : st) aligned = aligned && stride % chunk == 0;
  const auto launch = dtype == 0 ? launch_f32 : launch_bf16;
  err = launch(aligned, q, k, v, out, static_cast<int>(blocks), seq, heads, d, st, scale, device,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of each kernel (dtype 0: float32,
// 1: bfloat16), in bytes.
extern "C" int flash_attention_smem_bytes(int dtype) {
  return static_cast<int>(dtype == 0 ? kF32SmemBytes : kMmaSmemBytes);
}
