// Tensor-core tiles of the encoder kernels (csrc/vit_encoder.cu, variant
// "mma": bf16, head dim 32 / 64 / 128, and above 128 a multiple of 64 in
// panels) for NVIDIA Hopper, sm_90a, built from the swizzled shared-memory
// tiles, copies and wgmma primitives of attention_mma.cuh.  The products
// come in two forms (the plan's Plan.ln, from the width alone), the
// attention in one (attention_panels_kernel, the attention at a head dim
// above 128, is described where it stands):
//
// product_kernel<BN, EPI, LN> (the resident form: every residual width up
//   to 768, the flagship's D 192 among them):
//   C[M, N] = epilogue(LN?(A)[M, K] . W[K, N] + b).  A CTA is one warpgroup
//   and owns 64 rows (wgmma's M) by BN = 32 or 64 columns.  A (the
//   activations, (M, K) row-major: K-major as they lie) and W (the weight,
//   (K, N) row-major: N-major as it lies, the transpose bit of the
//   descriptor) arrive by 16-byte cp.async in 64-deep chunks.
//   * LN (qkv, mlp1; K = the residual width W, D rounded up to a multiple
//     of 64): every chunk of the 64 rows is resident before the first
//     product; each row's mean, then the mean of (x - mu)^2, are taken in
//     f32 from the bf16 x over its D true columns (ln_dim; the W - D padded
//     ones are zeros and enter neither sum), the row is normalised, scaled
//     and shifted in f32 with no contraction (the twin's separate
//     roundings), rounded to bf16 once, and written back into the A tile.
//     Its shared memory grows with K: 1024 + K / 64 . 64 . (64 + BN) . 2
//     bytes, which the H100's 232,448 a block hold up to K = 1152 at BN 32
//     and K = 896 at BN 64.
//   * no LN (proj, mlp2; K = D or the MLP width): K walks a ring of kRing
//     chunks, the next chunks' copies in flight while one is multiplied.
//
// ln_rows_kernel and ring_product_kernel<NWG, BN, EPI> (the prenormed form:
//   every residual width above 768, ViT-L's D 1024 and ViT-H's 1280): the
//   LN rows are written once into a scratch (M, W) by ln_rows_kernel
//   (row_stats and layer_norm8 of the resident form, in its order: the same
//   bits), and all four products of a block read plain bf16 A through
//   ring_product_kernel: TMA copies on a ring of 6 or 8 stages fed by a
//   producer warpgroup, consumed by one or two warpgroups of 64 rows that
//   share each W chunk, persistent CTAs, N tiles of 32, 64 or 128 (two
//   64-column chains a warpgroup).  What bounds them on the H100 (989
//   TFLOP/s bf16, 3.35 TB/s): at batch 1 (ViT-L, (1, 320, 1024) x 24) the
//   weights from device memory, 605.93 MB in 180.87 us, and the operations,
//   203.34 GFLOP in 205.60 us, about equally; at batch 16 (one block at
//   (16, 320, 1024)) the operations, 135.56 GFLOP in 137.07 us.  Neither is
//   what held the streamed products before them back: they paid each
//   chunk's copy, LayerNorm and wgmma latencies one after another.  This
//   design keeps the copies in flight (the ring) and the tensor cores fed
//   while the f32 units add (several commit groups in flight), and what
//   then binds it is the rate at which chunks reach an SM's shared memory
//   from L2 (measured with the products cut out, profile_encoder.py cut:
//   PERF.md), then the f32 adds: so the CTA's tile is as large as
//   the fresh accumulators' registers allow (128 x 128 at batch 16: 32 KB
//   a 64-deep chunk for 2.1 MFLOP), the CTAs persist across tiles (no
//   waves, each epilogue under the next tile's copies), and the LN rows are
//   not redone by every column CTA.
//
// Both forms: every 16-deep step of a product goes to a fresh accumulator,
//   and the steps are added in f32 in order: the tensor cores round the sum
//   they accumulate toward zero, and a chain of such steps moved the
//   tracker's free-running trajectory off the plain twin's (PERF.md).  The
//   epilogue works on the accumulator registers at the twin's rounding
//   points: bias added in f32, rounded to bf16; then either the tanh GELU
//   in f32 of the rounded value, rounded again, or the residual x +
//   round(.) in place on x, each element read and written by one thread.
//
// attention_kernel<DH>: softmax(q k^T dh^-1/2) v of one (batch, head) for 64
//   query rows, q, k and v read from the qkv product's buffer where they lie
//   (strides batch S.3D, head dh, row 3D).  The twin's arithmetic up to the
//   order of its sums: f32 scores of exact bf16 products (each 16-deep step
//   in a fresh accumulator, added in f32), multiplied by dh^-1/2 in f32; the
//   row maximum m over all keys first (pass 1 over the key blocks: scores
//   only), then p = expf(s - m) of that same f32 argument
//   (pass 2: scores again, bit for bit the same), the row sum l of the f32 p,
//   and P.V with p carried as three bf16 terms hi + mid + lo that add up to
//   the f32 p exactly, each key block's P.V in a fresh accumulator added to
//   the sum in f32; one division o / l, one rounding to bf16.  Both
//   passes walk blocks of 64 keys through a ring of kAttStages stages, so no
//   sequence length needs more shared memory than the ring.

#pragma once

#include "attention_mma.cuh"
#include "panel_ring.cuh"

#include <cuda.h>

#include <cstddef>

namespace encoder_mma {

using bf16 = __nv_bfloat16;
using mma::kThreads;
using mma::kTileRows;

constexpr int kAlign = 1024;      // of the tiles; slack for the base
constexpr int kChunk = 64;        // K a chunk: one 128-byte panel of the A tile
constexpr int kRing = 3;          // chunks in flight in proj and mlp2
constexpr int kKeyBlock = 64;     // keys a block of the attention
constexpr int kAttStages = 2;     // key blocks in flight in the attention
constexpr float kLnEps = 1e-6f;

enum Epilogue { kEpiRound = 0, kEpiGelu = 1, kEpiResidual = 2 };
// The LayerNorm of a product's A: none, over the resident rows, or
// ("tf32x3", encoder_tf32.cuh) chunk by chunk on statistics taken by
// row_stats_kernel.
enum LnForm { kLnNone = 0, kLnResident = 1, kLnStreamed = 2 };

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - mma::smem_addr(raw) % kAlign) % kAlign);
}

#define F4(d, i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define F16(d, i) F4(d, i), F4(d, (i) + 4), F4(d, (i) + 8), F4(d, (i) + 12)

// D[64 x 64] = (acc ? D : 0) + A[64 x 16] (shared, K-major) . B[16 x 64]
// (shared, N-major: the transpose bit), as a row-major (K, N) weight lies.
__device__ __forceinline__ void wgmma_ss_t_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 32] = (acc ? D : 0) + A[64 x 16] (shared, K-major) . B[16 x 32]
// (shared, N-major).
__device__ __forceinline__ void wgmma_ss_t_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : F16(d, 0)
      : "l"(a), "l"(b), "r"(acc));
}

#undef F16
#undef F4

// jax.nn.gelu's default (approximate=True) written as PyTorch's
// gelu(approximate="tanh") writes it, tanhf in f32, each operation rounded
// on its own as the twin's CPU kernel rounds it (no contraction).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;   // sqrt(2) . 2 / sqrt(pi) . 0.5
  const float k_kappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(k_beta, __fadd_rn(x, __fmul_rn(k_kappa, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// 1 / sqrt(v), both operations correctly rounded.
__device__ __forceinline__ float rsqrt_rn(float v) {
  return __fdiv_rn(1.0f, __fsqrt_rn(v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_float(float v) { return v; }

// The LayerNorm statistics (mean, rstd) of one row of T over its first d
// columns, as models/vit.py::layer_norm computes them: mean = sum(x) / d,
// var = sum((x - mean)^2) / d (a sum divided, as torch's mean is on the
// CPU), rstd = 1 / sqrt(var + eps), every operation rounded on its own (no
// contraction).  Eight lanes a row: lane c holds 16-byte chunk c of each of
// the row's `segs` 128-byte segments (chunk(p) returns segment p's) and sums
// its elements in order, segment by segment; the eight lanes' sums are then
// added by group8_sum.  A column at or past d adds nothing to either sum (a
// zero pad's (0 - mean)^2 would: it is masked).  The one order of the
// resident forms (layer_norm_tile, encoder_tf32.cuh's layer_norm_rows), of
// the prenormed form's ln_rows_kernel and of the float32 streamed form's
// row_stats_kernel, so their statistics are the same bits.  Every lane of
// the warp calls it (the shuffles).
template <typename T, typename Chunk>
__device__ __forceinline__ float2 row_stats(Chunk chunk, int segs, int c, int d) {
  constexpr int kE = 16 / sizeof(T);        // elements a chunk
  const float k = (float)d;
  float sum = 0.f;
  for (int p = 0; p < segs; ++p) {
    const uint4 v = chunk(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if ((p * 8 + c) * kE + i < d) sum = __fadd_rn(sum, as_float(e[i]));
  }
  const float mu = __fdiv_rn(group8_sum(sum), k);
  float var = 0.f;
  for (int p = 0; p < segs; ++p) {
    const uint4 v = chunk(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      if ((p * 8 + c) * kE + i >= d) continue;
      const float t = __fsub_rn(as_float(e[i]), mu);
      var = __fadd_rn(var, __fmul_rn(t, t));
    }
  }
  return make_float2(mu, rsqrt_rn(__fadd_rn(__fdiv_rn(group8_sum(var), k), kLnEps)));
}

// The float32 streamed form's statistics (encoder_tf32.cuh): row_stats of
// each of the M rows of x ((M, W) row-major, W . sizeof(T) a multiple of
// 128) over its first d columns
// into stats[row] = (mean, rstd).  Eight lanes a row, 16 rows a CTA of 128
// threads; a lane past M reads row 0 (the shuffles need every lane) and
// stores nothing.  x is read once, from L2 where the previous launch left
// it: at (320, 1024) bf16 640 KB.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, int M, int W, int d) {
  constexpr int kE = 16 / sizeof(T);
  const int c = threadIdx.x & 7, row = blockIdx.x * (kThreads / 8) + (threadIdx.x >> 3);
  const T* xr = x + (size_t)(row < M ? row : 0) * W + c * kE;
  const float2 st = row_stats<T>(
      [&](int p) { return *reinterpret_cast<const uint4*>(xr + p * 8 * kE); },
      W / (8 * kE), c, d);
  if (row < M && c == 0) stats[row] = st;
}

// Eight bf16 of x (a 16-byte chunk) LayerNormed with the row's (mu, rstd)
// and the columns' scale s and bias b: y = (x - mu) . rstd, then y . s + b,
// every operation rounded on its own, one rounding to bf16.
__device__ __forceinline__ uint4 layer_norm8(uint4 v, float mu, float rstd, uint4 sv, uint4 bv) {
  const bf16 *e = reinterpret_cast<const bf16*>(&v), *se = reinterpret_cast<const bf16*>(&sv),
             *be = reinterpret_cast<const bf16*>(&bv);
  uint4 y;
  bf16* ye = reinterpret_cast<bf16*>(&y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t = __fmul_rn(__fsub_rn(__bfloat162float(e[i]), mu), rstd);
    ye[i] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(t, __bfloat162float(se[i])), __bfloat162float(be[i])));
  }
  return y;
}

// x LayerNormed with its row's (mu, rstd) and its column's scale s and bias
// b: (x - mu) . rstd . s + b, every operation rounded on its own (the float32
// form of layer_norm8's arithmetic).
__device__ __forceinline__ float layer_norm1(float x, float mu, float rstd, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), s), b);
}

// Four floats of x (a 16-byte chunk) LayerNormed as layer_norm8 normalises
// eight bf16: layer_norm1 on each.
__device__ __forceinline__ uint4 layer_norm4(uint4 v, float mu, float rstd, uint4 sv, uint4 bv) {
  const float *e = reinterpret_cast<const float*>(&v), *se = reinterpret_cast<const float*>(&sv),
              *be = reinterpret_cast<const float*>(&bv);
  uint4 y;
  float* ye = reinterpret_cast<float*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) ye[i] = layer_norm1(e[i], mu, rstd, se[i], be[i]);
  return y;
}

__device__ __forceinline__ uint4 layer_norm_chunk(bf16, uint4 v, float mu, float rstd, uint4 sv,
                                                  uint4 bv) {
  return layer_norm8(v, mu, rstd, sv, bv);
}
__device__ __forceinline__ uint4 layer_norm_chunk(float, uint4 v, float mu, float rstd, uint4 sv,
                                                  uint4 bv) {
  return layer_norm4(v, mu, rstd, sv, bv);
}

// ---------------------------------------------------------------------------
// The products.
// ---------------------------------------------------------------------------

// Dynamic shared memory of one product CTA: `chunks` slots, each an A chunk
// (64 rows x 64) and a W chunk (64 x bn), from a 1024-byte boundary.
inline size_t product_smem_bytes(int bn, int chunks) {
  return (size_t)kAlign + (size_t)chunks * kChunk * (kTileRows + bn) * sizeof(bf16);
}

// The resident A tile (64 rows x K, K / 64 panels) LayerNormed in place over
// the d true columns (d <= K; the K - d past them are the zero padding of
// the residual stream): row_stats, then layer_norm8 on each chunk.  A padded
// column's scale and bias are zeros, so it comes out 0; with d = K the
// arithmetic is the unpadded one's.  Eight lanes a row, four rows a warp at
// a time; lane c holds 16-byte chunk c of every panel.  Rows past M are
// zeros and come out as the LN bias: the epilogue drops them.
__device__ __forceinline__ void layer_norm_tile(unsigned char* tile, const bf16* __restrict__ s,
                                                const bf16* __restrict__ b, int K, int d) {
  using TA = mma::Tile<64>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 7, panels = K / kChunk;
  constexpr int kPanelBytes = TA::bytes(kTileRows);
  for (int r = warp * 16 + (lane >> 3); r < warp * 16 + 16; r += 4) {
    unsigned char* row = tile + TA::offset(r, c);
    const float2 st = row_stats<bf16>(
        [&](int p) { return *reinterpret_cast<const uint4*>(row + p * kPanelBytes); }, panels, c,
        d);
    for (int p = 0; p < panels; ++p) {
      uint4* at = reinterpret_cast<uint4*>(row + p * kPanelBytes);
      *at = layer_norm8(*at, st.x, st.y, *reinterpret_cast<const uint4*>(s + p * kChunk + c * 8),
                        *reinterpret_cast<const uint4*>(b + p * kChunk + c * 8));
    }
  }
}

// A: (M, K) row-major; W: (K, N) row-major; C: (M, N), which may alias the
// residual (EPI == kEpiResidual reads C before writing it, element by element
// in the same thread).  K is a multiple of 64, N of BN.  LN == kLnResident:
// K / 64 slots, every chunk resident, the LayerNorm over the first ln_dim
// columns of A (layer_norm_tile); kLnNone: kRing slots, ln_dim, ln_s and
// ln_b unread.
template <int BN, int EPI, int LN>
__global__ void __launch_bounds__(kThreads)
product_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
               const bf16* __restrict__ bias, const bf16* __restrict__ ln_s,
               const bf16* __restrict__ ln_b, bf16* C, int M, int N, int K, int ln_dim) {
  using TA = mma::Tile<64>;
  using TB = mma::Tile<BN>;
  constexpr int kRegs = TB::kPanelCols / 2;   // accumulators a thread holds a panel
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* a_ptr = aligned_smem(raw);
  const int chunks = K / kChunk;
  const int slots = LN == kLnResident ? chunks : kRing;
  const uint32_t a_ring = mma::smem_addr(a_ptr);
  const uint32_t b_ring = a_ring + slots * TA::bytes(kTileRows);
  const int m0 = blockIdx.y * kTileRows, n0 = blockIdx.x * BN;

  const auto load = [&](int c) {              // K chunk c into slot c % slots
    const int slot = c % slots;
    TA::template fill<kTileRows, kThreads>(a_ring + slot * TA::bytes(kTileRows), A + c * kChunk,
                                           K, m0, M);
    TB::template fill<kChunk, kThreads>(b_ring + slot * TB::bytes(kChunk), W + n0, N,
                                        c * kChunk, K);
  };
  float acc[TB::kPanels][kRegs];
#pragma unroll
  for (int p = 0; p < TB::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[p][i] = 0.f;
  // acc += A chunk c . W chunk c: each 16-deep step into a fresh
  // accumulator, the four added in f32 in order, then added to acc.
  constexpr int kSteps = kChunk / 16;
  const auto product = [&](int c) {
    const int slot = c % slots;
    const uint32_t a = a_ring + slot * TA::bytes(kTileRows);
    const uint32_t b = b_ring + slot * TB::bytes(kChunk);
    float part[kSteps][TB::kPanels][kRegs];
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint64_t da = TA::descriptor(a + kk * 32, 16);
#pragma unroll
      for (int p = 0; p < TB::kPanels; ++p) {
        const uint64_t db = TB::descriptor(
            b + p * kChunk * TB::kRowBytes + kk * 16 * TB::kRowBytes, kChunk * TB::kRowBytes);
        if constexpr (TB::kPanelCols == 64) wgmma_ss_t_n64(part[kk][p], da, db, 0);
        else wgmma_ss_t_n32(part[kk][p], da, db, 0);
      }
    }
    mma::wgmma_commit();
    mma::wgmma_wait();
#pragma unroll
    for (int p = 0; p < TB::kPanels; ++p) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) mma::fence_registers(part[kk][p]);
#pragma unroll
      for (int i = 0; i < kRegs; ++i) {
        float t = part[0][p][i];
#pragma unroll
        for (int kk = 1; kk < kSteps; ++kk) t += part[kk][p][i];
        acc[p][i] += t;
      }
    }
  };

  if constexpr (LN == kLnResident) {
    for (int c = 0; c < chunks; ++c) load(c);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    layer_norm_tile(a_ptr, ln_s, ln_b, K, ln_dim);
    mma::fence_async_proxy();                 // generic writes -> the tensor cores' reads
    __syncthreads();
    for (int c = 0; c < chunks; ++c) product(c);
  } else {
    for (int c = 0; c < kRing - 1; ++c) {     // a group a chunk, empty past the end
      if (c < chunks) load(c);
      mma::cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      mma::cp_async_wait<kRing - 2>();        // chunk c has landed
      mma::fence_async_proxy();
      __syncthreads();                        // ... for all; slot of chunk c - 1 is free
      if (c + kRing - 1 < chunks) load(c + kRing - 1);
      mma::cp_async_commit();
      product(c);
    }
  }

  // Epilogue from the accumulators: thread (warp, lane) holds rows warp.16 +
  // lane / 4 (+ 8) and, a panel, column pairs 8j + 2(lane % 4).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + warp * 16 + g + 8 * h;
    if (row >= M) continue;
    bf16* c_row = C + (size_t)row * N + n0;
#pragma unroll
    for (int p = 0; p < TB::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < kRegs / 4; ++j) {
        const int col = p * TB::kPanelCols + 8 * j + 2 * t;
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n0 + col));
        float v0 = round_bf16(acc[p][4 * j + 2 * h] + bb.x);
        float v1 = round_bf16(acc[p][4 * j + 2 * h + 1] + bb.y);
        if constexpr (EPI == kEpiGelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(c_row + col);
        if constexpr (EPI == kEpiResidual) {
          const float2 xr = __bfloat1622float2(*out);
          v0 = xr.x + v0;
          v1 = xr.y + v1;
        }
        *out = __floats2bfloat162_rn(v0, v1);
      }
  }
}

// ---------------------------------------------------------------------------
// The prenormed form: the LN rows written once, then every product of a
// wide block fed by TMA through a deep ring.
// ---------------------------------------------------------------------------

constexpr int kLnRowsThreads = 128;  // four warps a CTA

// Dynamic shared memory of one ln_rows_kernel<T, RPW> CTA: its 4 . RPW
// rows of x, then the scale and the bias; `elem` bytes an element.
inline size_t ln_rows_smem_bytes(int rpw, int W, size_t elem = sizeof(bf16)) {
  return (size_t)(kLnRowsThreads / 32 * rpw + 2) * W * elem;
}

// y = LayerNorm(x) of M rows ((M, W) row-major, W . sizeof(T) a multiple of
// 128: W a multiple of 64 in bf16, of 32 in float32) over their first d
// columns, with the columns' scale s and bias b (zero past d): row_stats in
// its order, then every 16-byte chunk normalised (bf16: layer_norm8,
// rounded to bf16 once; float32: layer_norm1 on each element), so y is what
// the resident form writes into its A tile (bf16) or what the float32
// streamed form's load_a_ln computes for each element as it lands
// (encoder_tf32.cuh), bit for bit.  RPW rows a warp, 32 / RPW lanes a row:
// every copy is issued at once (cp.async: the row's chunks by its lanes, the
// scale and bias by the CTA's), then read from shared memory; the
// statistics' f32 sums are row_stats's eight-lane order (lane c of each
// eight takes the row's chunks c, c + 8, ...; at RPW 1 the warp's four
// eights compute the same sums), and the row's lanes then normalise its
// chunks between them.  RPW 1 (a warp a row) where the rows are few and the
// grid is the latency (batch 1); RPW 4 where there are rows to fill the
// card.  Each 16-byte chunk of x is read from device memory once.  A row
// past M copies and stores nothing (the shuffles need every lane).
template <typename T, int RPW>
__global__ void __launch_bounds__(kLnRowsThreads)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ s, const T* __restrict__ b,
               T* __restrict__ y, int M, int W, int d) {
  extern __shared__ __align__(16) unsigned char raw[];
  constexpr int kRows = kLnRowsThreads / 32 * RPW, kLanes = 32 / RPW;
  constexpr int kE = 16 / sizeof(T);          // elements a chunk
  const int lane = threadIdx.x & 31, r = (threadIdx.x >> 5) * RPW + lane / kLanes;
  const int row = blockIdx.x * kRows + r, row_chunks = W / kE, l = lane % kLanes;
  uint4* tile = reinterpret_cast<uint4*>(raw);
  const uint4* mine = tile + (size_t)r * row_chunks;
  const uint4* sb = tile + (size_t)kRows * row_chunks;   // scale, then bias
  if (row < M) {
    const T* xr = x + (size_t)row * W;
    for (int i = l; i < row_chunks; i += kLanes)
      mma::cp_async16(mma::smem_addr(mine + i), xr + i * kE);
  }
  for (int i = threadIdx.x; i < 2 * row_chunks; i += kLnRowsThreads)
    mma::cp_async16(mma::smem_addr(sb + i),
                    i < row_chunks ? s + i * kE : b + (i - row_chunks) * kE);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  const int c = lane & 7;
  const float2 st =
      row_stats<T>([&](int p) { return mine[p * 8 + c]; }, row_chunks / 8, c, d);
  if (row >= M) return;
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * W);
  for (int i = l; i < row_chunks; i += kLanes)
    yr[i] = layer_norm_chunk(T(), mine[i], st.x, st.y, sb[i], sb[row_chunks + i]);
}

// Hopper's transaction barriers and the tensor memory accelerator (TMA):
// csrc/panel_ring.cuh's.
using panel::mbar_arrive;
using panel::mbar_expect_tx;
using panel::mbar_init;
using panel::mbar_wait;
using panel::tma_load;

template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// wgmma_wait_pending<n> for a count the caller's unrolled code makes constant.
__device__ __forceinline__ void wait_pending(int n) {
  if (n <= 0) wgmma_wait_pending<0>();
  else if (n == 1) wgmma_wait_pending<1>();
  else if (n == 2) wgmma_wait_pending<2>();
  else wgmma_wait_pending<3>();
}

// Geometry of ring_product_kernel<NWG, BN>: NWG consumer warpgroups of 64
// rows each and a producer warpgroup.  A stage holds the CTA's A chunk (NWG
// . 64 rows x 64, K-major as A lies, 128-byte swizzle) and one W chunk (64 x
// BN, N-major as W lies: at BN 32 64-byte rows with the 64-byte swizzle,
// else BN / 64 panels of 64 columns with the 128-byte one), the ring
// kStages of them (8, or 6 where 96 KB leaves room for two CTAs an SM or
// where 32 KB stages must fit), then a full and an empty barrier a stage.
// Registers: the producer gives its warpgroup's up (setmaxnreg) to the
// consumers, whose fresh accumulators need them.
template <int NWG, int BN>
struct Ring {
  static constexpr int kABytes = NWG * kTileRows * kChunk * 2;
  static constexpr int kBBytes = kChunk * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kStageBytes == 16384 || kStageBytes == 32768 ? 6 : 8;
  static constexpr int kThreads = (NWG + 1) * mma::kThreads;
  static constexpr int kCtasPerSm = NWG == 1 && BN <= 64 ? 2 : 1;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = kCtasPerSm == 2 ? 216 : 232;
  static constexpr size_t smem_bytes() {
    return (size_t)kAlign + (size_t)kStages * kStageBytes + 2 * kStages * 8;
  }
};

// One 16-deep step of a ring product into the fresh accumulator d (scale-d
// 0): the warpgroup's 64 rows of the A chunk at a, panel p (64 columns; at
// BN 32 the whole chunk) of the W chunk at b, step kk of the chunk's four;
// its own commit group.
template <int BN>
__device__ __forceinline__ void ring_step(float (&d)[BN == 32 ? 16 : 32], uint32_t a, uint32_t b,
                                          int p, int kk) {
  using TA = mma::Tile<64>;
  using TB = mma::Tile<BN == 32 ? 32 : 64>;
  mma::wgmma_fence();
  const uint64_t da = TA::descriptor(a + kk * 32, 16);
  const uint64_t db = TB::descriptor(b + p * kChunk * TB::kRowBytes + kk * 16 * TB::kRowBytes,
                                     kChunk * TB::kRowBytes);
  if constexpr (BN == 32) wgmma_ss_t_n32(d, da, db, 0);
  else wgmma_ss_t_n64(d, da, db, 0);
  mma::wgmma_commit();
}

template <int N>
__device__ __forceinline__ void add_into(float (&to)[N], float (&from)[N]) {
  mma::fence_registers(from);
#pragma unroll
  for (int i = 0; i < N; ++i) to[i] += from[i];
}

// C[M, N] = epilogue(A[M, K] . W[K, N] + bias) of the prenormed form, every
// product of a wide block (qkv, proj + residual, mlp1 + GELU, mlp2 +
// residual; A the LN rows of ln_rows_kernel, the attention's output or the
// MLP's hidden rows, plain bf16), in product_kernel's arithmetic: each
// 16-deep step into a fresh accumulator, a chunk's four steps added in f32
// in order into t, the chunks' t added to acc in order; the same epilogue.
// A is a_map's (M, K) rows; W is layer `layer` of w_map's (depth, K, N).
// The CTAs are persistent: CTA i takes output tiles i, i + gridDim.x, ...
// (N / BN of them a row of tiles, columns fastest, so the CTAs at work
// share A rows), and its ring runs on from one tile into the next, so a
// tile's epilogue overlaps the next tile's copies and no tile waits for a
// wave.  A tile is NWG warpgroups that share each W chunk, rows m0 + 64 w
// of warpgroup w, columns n0 to n0 + BN; a producer warpgroup's one
// thread keeps TMA copies of the next chunks in flight through the ring of
// kStages: it waits for a stage's empty barrier (one arrival from every
// consumer warp once the chunk's last step has completed), then counts the
// stage's bytes on its full barrier and issues the A box and the W panels.
// Rows past M arrive as zeros.  A consumer waits only for the full barrier
// of the chunk it is about to multiply.  Its wgmmas run ahead of their
// sums, and every group is retired before the loop's back-edge (ptxas
// serialises wgmma whose accumulators stay in flight across a back-edge
// or a branch):
//  * BN 32 / 64, two chunks at a time: a chunk's four steps are issued at
//    once (step 0 into the chunk's t, steps 1-3 into p1-p3, each its own
//    commit group), and as each completes it is added and its registers
//    take a step of the next chunk, so three or four groups are in flight
//    while the FP32 units add;
//  * BN 128, a chunk at a time as two chains of 64 columns (one a W
//    panel), each with its own t, p and acc, their steps interleaved: while
//    one chain's step is added, the other's is in flight.
template <int NWG, int BN, int EPI>
__global__ void __launch_bounds__(Ring<NWG, BN>::kThreads, Ring<NWG, BN>::kCtasPerSm)
ring_product_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap w_map, int layer,
                    const bf16* __restrict__ bias, bf16* C, int M, int N, int K) {
  using R = Ring<NWG, BN>;
  constexpr int kChains = BN == 128 ? 2 : 1;  // 64-column chains a warpgroup
  constexpr int kRegs = BN == 32 ? 16 : 32;   // accumulators a thread holds a chain
  constexpr int kPanel = kChunk * 64 * 2;     // bytes of a 64-column W panel
  constexpr int S = R::kStages;
  extern __shared__ __align__(16) unsigned char raw[];
  const uint32_t ring = mma::smem_addr(aligned_smem(raw));
  const uint32_t bars = ring + S * R::kStageBytes;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (S + s); };
  const auto stage_a = [&](int s) { return ring + s * R::kStageBytes; };
  const auto stage_b = [&](int s) { return ring + s * R::kStageBytes + R::kABytes; };
  const int chunks = K / kChunk, tiles_n = N / BN;
  const int tiles = tiles_n * ((M + NWG * kTileRows - 1) / (NWG * kTileRows));
  const int wg = threadIdx.x / mma::kThreads;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {                            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R::kProducerRegs));
    if (threadIdx.x == NWG * mma::kThreads) {
      int g = 0;                              // chunks issued, every tile's
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * NWG * kTileRows, n0 = t % tiles_n * BN;
        for (int c = 0; c < chunks; ++c, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(empty(s), (g / S - 1) & 1);
          mbar_expect_tx(full(s), R::kStageBytes);
          tma_load(stage_a(s), &a_map, full(s), c * kChunk, m0);
#pragma unroll
          for (int p = 0; p < BN / 64 || p == 0; ++p)
            tma_load(stage_b(s) + p * kPanel, &w_map, full(s), n0 + 64 * p, c * kChunk,
                     layer);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R::kConsumerRegs));
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const uint32_t a_rows = wg * kTileRows * kChunk * 2;   // this warpgroup's rows
    // Chunk c's slot is free as far as this warp goes.
    const auto release = [&](int c) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(c % S));
    };
    const auto a_of = [&](int c) { return stage_a(c % S) + a_rows; };
    const auto b_of = [&](int c) { return stage_b(c % S); };
    // Chunk indices below count every tile's chunks (the ring's).
    for (int t = blockIdx.x, g = 0; t < tiles; t += gridDim.x, g += chunks) {
      const int m0 = t / tiles_n * NWG * kTileRows, n0 = t % tiles_n * BN;
      float acc[kChains][kRegs];
#pragma unroll
      for (int h = 0; h < kChains; ++h)
#pragma unroll
        for (int i = 0; i < kRegs; ++i) acc[h][i] = 0.f;

      if constexpr (kChains == 1) {
        float t0[kRegs], t1[kRegs], p1[kRegs], p2[kRegs], p3[kRegs];
        // Chunks c and c + 1 once both have landed, straight-line from the
        // first wgmma to the last wait: c's steps into t0, p1-p3; as each
        // completes it is added to t0, and the registers it frees take a
        // step of c + 1 (t1, p1-p3); then c + 1's sums; then both slots are
        // released.
        const auto pair = [&](int c) {
          mbar_wait(full(c % S), (c / S) & 1);
          mbar_wait(full((c + 1) % S), ((c + 1) / S) & 1);
          ring_step<BN>(t0, a_of(c), b_of(c), 0, 0);
          ring_step<BN>(p1, a_of(c), b_of(c), 0, 1);
          ring_step<BN>(p2, a_of(c), b_of(c), 0, 2);
          ring_step<BN>(p3, a_of(c), b_of(c), 0, 3);
          wgmma_wait_pending<2>();
          mma::fence_registers(t0);
          add_into(t0, p1);
          ring_step<BN>(t1, a_of(c + 1), b_of(c + 1), 0, 0);
          ring_step<BN>(p1, a_of(c + 1), b_of(c + 1), 0, 1);
          wgmma_wait_pending<3>();
          add_into(t0, p2);
          ring_step<BN>(p2, a_of(c + 1), b_of(c + 1), 0, 2);
          wgmma_wait_pending<3>();
          add_into(t0, p3);
          add_into(acc[0], t0);
          ring_step<BN>(p3, a_of(c + 1), b_of(c + 1), 0, 3);
          wgmma_wait_pending<2>();
          mma::fence_registers(t1);
          add_into(t1, p1);
          wgmma_wait_pending<1>();
          add_into(t1, p2);
          wgmma_wait_pending<0>();
          add_into(t1, p3);
          add_into(acc[0], t1);
          release(c);
          release(c + 1);
        };
        int c = g;
        for (; c + 1 < g + chunks; c += 2) pair(c);
        if (c < g + chunks) {                   // an odd last chunk alone
          mbar_wait(full(c % S), (c / S) & 1);
          ring_step<BN>(t0, a_of(c), b_of(c), 0, 0);
          ring_step<BN>(p1, a_of(c), b_of(c), 0, 1);
          ring_step<BN>(p2, a_of(c), b_of(c), 0, 2);
          ring_step<BN>(p3, a_of(c), b_of(c), 0, 3);
          wgmma_wait_pending<2>();
          mma::fence_registers(t0);
          add_into(t0, p1);
          wgmma_wait_pending<1>();
          add_into(t0, p2);
          wgmma_wait_pending<0>();
          add_into(t0, p3);
          add_into(acc[0], t0);
          release(c);
        }
      } else {
        // Two chains (W panels 0 and 1), straight-line a chunk: steps k of
        // chains 0 and 1 land in ta / tb (k = 0) or pa / pb, and each chain's
        // step is added while the other chain's is in flight.
        float ta[kRegs], tb[kRegs], pa[kRegs], pb[kRegs];
        for (int c = g; c < g + chunks; ++c) {
          mbar_wait(full(c % S), (c / S) & 1);
          const uint32_t a = a_of(c), b = b_of(c);
          ring_step<BN>(ta, a, b, 0, 0);
          ring_step<BN>(tb, a, b, 1, 0);
          ring_step<BN>(pa, a, b, 0, 1);
          ring_step<BN>(pb, a, b, 1, 1);
          wgmma_wait_pending<1>();
          mma::fence_registers(ta);
          mma::fence_registers(tb);
          add_into(ta, pa);
          ring_step<BN>(pa, a, b, 0, 2);
          wgmma_wait_pending<1>();
          add_into(tb, pb);
          ring_step<BN>(pb, a, b, 1, 2);
          wgmma_wait_pending<1>();
          add_into(ta, pa);
          ring_step<BN>(pa, a, b, 0, 3);
          wgmma_wait_pending<1>();
          add_into(tb, pb);
          ring_step<BN>(pb, a, b, 1, 3);
          wgmma_wait_pending<1>();
          add_into(ta, pa);
          add_into(acc[0], ta);
          wgmma_wait_pending<0>();
          add_into(tb, pb);
          add_into(acc[1], tb);
          release(c);
        }
      }

      // Epilogue from the accumulators, as product_kernel's: thread (warp,
      // lane) of warpgroup wg holds rows m0 + 64 wg + 16 warp + lane / 4
      // (+ 8) and, a chain, column pairs 8j + 2(lane % 4).
      const int quad = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wg * kTileRows + warp * 16 + quad + 8 * h;
        if (row >= M) continue;
        bf16* c_row = C + (size_t)row * N + n0;
#pragma unroll
        for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
          for (int j = 0; j < kRegs / 4; ++j) {
            const int col = ch * 64 + 8 * j + 2 * tq;
            const float2 bb =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n0 + col));
            float v0 = round_bf16(acc[ch][4 * j + 2 * h] + bb.x);
            float v1 = round_bf16(acc[ch][4 * j + 2 * h + 1] + bb.y);
            if constexpr (EPI == kEpiGelu) {
              v0 = gelu_tanh(v0);
              v1 = gelu_tanh(v1);
            }
            __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(c_row + col);
            if constexpr (EPI == kEpiResidual) {
              const float2 xr = __bfloat1622float2(*out);
              v0 = xr.x + v0;
              v1 = xr.y + v1;
            }
            *out = __floats2bfloat162_rn(v0, v1);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The attention.
// ---------------------------------------------------------------------------

// Pass 2 of a key block: p = expf(s - m) of its scores (pair r holds scores
// 2r and 2r + 1 of row half r & 1), the row sums l += p, and p as three
// bf16 terms hi + mid + lo that add up to the f32 p exactly, pairwise: the
// A fragments of P.V.
template <int N>
__device__ __forceinline__ void p_terms(const float (&s)[2 * N], const float (&m)[2],
                                        float (&l)[2], uint32_t (&hi)[N], uint32_t (&mid)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float e0 = expf(s[2 * r] - m[r & 1]);
    const float e1 = expf(s[2 * r + 1] - m[r & 1]);
    l[r & 1] += e0 + e1;
    const __nv_bfloat162 ph = __floats2bfloat162_rn(e0, e1);
    const float r0 = e0 - __low2float(ph), r1 = e1 - __high2float(ph);
    const __nv_bfloat162 pm = __floats2bfloat162_rn(r0, r1);
    const __nv_bfloat162 pl = __floats2bfloat162_rn(r0 - __low2float(pm),
                                                    r1 - __high2float(pm));
    hi[r] = *reinterpret_cast<const uint32_t*>(&ph);
    mid[r] = *reinterpret_cast<const uint32_t*>(&pm);
    lo[r] = *reinterpret_cast<const uint32_t*>(&pl);
  }
}

// o / l rounded to bf16 once, through the warp's own 16 rows of the tile
// at tile_ptr (Tile T's panels of 64 rows; no product reads it any more)
// and out (row 0 of this (batch, head, panel), rows row_stride apart, the
// tile's DH columns) as 16-byte vectors; rows >= S are dropped.
template <typename T, int DH, int REGS>
__device__ __forceinline__ void store_rows(unsigned char* tile_ptr,
                                           const float (&o)[T::kPanels][REGS],
                                           const float (&l)[2], bf16* out, long long row_stride,
                                           int q0, int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = mma::quad_sum(l[hh]);
    const int r = warp * 16 + g + 8 * hh;
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < REGS / 4; ++j)
        *reinterpret_cast<uint32_t*>(tile_ptr + p * kTileRows * T::kRowBytes + T::offset(r, j)
                                     + 4 * tq) =
            mma::pack_bf16(o[p][4 * j + 2 * hh] / sum, o[p][4 * j + 2 * hh + 1] / sum);
  }
  __syncwarp();
  constexpr int kRowChunks = DH / 8;
  for (int i = lane; i < 16 * kRowChunks; i += 32) {
    const int r = warp * 16 + i / kRowChunks, c = i % kRowChunks;
    const int p = c / T::kChunks, cc = c - p * T::kChunks;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(out + (long long)(q0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile_ptr + p * kTileRows * T::kRowBytes
                                          + T::offset(r, cc));
  }
}

// Dynamic shared memory of one attention CTA: the Q tile and kAttStages
// slots of a K and a V block, from a 1024-byte boundary.
inline size_t attention_smem_bytes(int dh) {
  return (size_t)kAlign + (size_t)(kTileRows + 2 * kAttStages * kKeyBlock) * dh * sizeof(bf16);
}

// CTA = one warpgroup = (64 query rows, batch, head); blockIdx.x runs over
// tiles x B x H.  A thread holds, for rows lane / 4 and lane / 4 + 8 of its
// warp's 16 rows, the maximum m, its share of the sum l and its columns of
// o (per panel: column 8j + 2(lane % 4) + e of row half h is o[4j + 2h + e]).
// Step t of the 2 . ceil(S / 64) steps is key block t (pass 1, K alone) or
// t - blocks (pass 2, K and V) in ring slot t % kAttStages.
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int S, int heads,
                 int tiles, float scale) {
  using T = mma::Tile<DH>;
  constexpr int KB = kKeyBlock;
  constexpr int kScoreRegs = KB / 2;
  constexpr int kGroup = 2;                   // score steps in flight at a time
  constexpr int kOutRegs = T::kPanelCols / 2;
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* q_ptr = aligned_smem(raw);
  const uint32_t q_tile = mma::smem_addr(q_ptr);
  const uint32_t k_tiles = q_tile + T::bytes(kTileRows);
  const uint32_t v_tiles = k_tiles + kAttStages * T::bytes(KB);

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kTileRows;
  const int b = bh / heads, h = bh - b * heads;
  const int D = heads * DH;
  const long long ld = 3LL * D;
  const bf16* q = qkv + (long long)b * S * ld + h * DH;
  const bf16* k = q + D;
  const bf16* v = q + 2 * D;
  const int blocks = (S + KB - 1) / KB, steps = 2 * blocks;
  const auto fill = [&](int t) {
    const int slot = t % kAttStages, j = t < blocks ? t : t - blocks;
    T::template fill<KB, kThreads>(k_tiles + slot * T::bytes(KB), k, ld, j * KB, S);
    if (t >= blocks)
      T::template fill<KB, kThreads>(v_tiles + slot * T::bytes(KB), v, ld, j * KB, S);
  };
  T::template fill<kTileRows, kThreads>(q_tile, q, ld, q0, S);
#pragma unroll
  for (int t = 0; t < kAttStages - 1; ++t) {  // a group a step, empty past the end
    if (t < steps) fill(t);
    mma::cp_async_commit();
  }

  const int tq = threadIdx.x & 3;
  float o[T::kPanels][kOutRegs];
#pragma unroll
  for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kOutRegs; ++i) o[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < steps; ++t) {
    mma::cp_async_wait<kAttStages - 2>();    // step t (and Q) has landed
    mma::fence_async_proxy();
    __syncthreads();                          // ... for all; slot of step t - 1 is free
    if (t + kAttStages - 1 < steps) fill(t + kAttStages - 1);
    mma::cp_async_commit();
    const int slot = t % kAttStages, k0 = (t < blocks ? t : t - blocks) * KB;

    // Scores: each 16-deep step of q.k into a fresh accumulator, kGroup at a
    // time, added to s in f32 in order.
    float s[kScoreRegs];
#pragma unroll
    for (int g0 = 0; g0 < DH / 16; g0 += kGroup) {
      float part[kGroup][kScoreRegs];
      mma::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int ks = g0 + j;
        const int p = ks / (T::kPanelCols / 16), kk = ks % (T::kPanelCols / 16);
        const uint64_t da = T::descriptor(q_tile + p * kTileRows * T::kRowBytes + kk * 32, 16);
        const uint64_t db =
            T::descriptor(k_tiles + slot * T::bytes(KB) + p * KB * T::kRowBytes + kk * 32, 16);
        mma::wgmma_ss_n64(part[j], da, db, 0);
      }
      mma::wgmma_commit();
      mma::wgmma_wait();
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        mma::fence_registers(part[j]);
#pragma unroll
        for (int i = 0; i < kScoreRegs; ++i) s[i] = g0 + j == 0 ? part[0][i] : s[i] + part[j][i];
      }
    }
#pragma unroll
    for (int i = 0; i < kScoreRegs; ++i)
      s[i] = k0 + 8 * (i / 4) + 2 * tq + (i & 1) < S ? s[i] * scale : -INFINITY;

    if (t < blocks) {                         // pass 1: the row maximum
#pragma unroll
      for (int i = 0; i < kScoreRegs; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
      if (t == blocks - 1) {
        m[0] = mma::quad_max(m[0]);
        m[1] = mma::quad_max(m[1]);
      }
      continue;
    }

    // Pass 2: p = expf(s - m), its row sum, and P.V with p = hi + mid + lo.
    uint32_t hi[kScoreRegs / 2], mid[kScoreRegs / 2], lo[kScoreRegs / 2];
    p_terms(s, m, l, hi, mid, lo);
    // This block's P.V goes to a fresh accumulator, added to o in f32: the
    // tensor cores' own sums (which truncate) then run over one block's
    // keys, not over all of S.
    float pv[T::kPanels][kOutRegs];
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < kOutRegs; ++i) pv[p][i] = 0.f;
      mma::fence_registers(pv[p]);
    }
    mma::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
      const int j = 4 * ks;
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p) {
        const uint64_t db = T::descriptor(
            v_tiles + slot * T::bytes(KB) + p * KB * T::kRowBytes + ks * 16 * T::kRowBytes,
            KB * T::kRowBytes);
        if constexpr (T::kPanelCols == 64) {
          mma::wgmma_rs_n64(pv[p], hi[j], hi[j + 1], hi[j + 2], hi[j + 3], db);
          mma::wgmma_rs_n64(pv[p], mid[j], mid[j + 1], mid[j + 2], mid[j + 3], db);
          mma::wgmma_rs_n64(pv[p], lo[j], lo[j + 1], lo[j + 2], lo[j + 3], db);
        } else {
          mma::wgmma_rs_n32(pv[p], hi[j], hi[j + 1], hi[j + 2], hi[j + 3], db);
          mma::wgmma_rs_n32(pv[p], mid[j], mid[j + 1], mid[j + 2], mid[j + 3], db);
          mma::wgmma_rs_n32(pv[p], lo[j], lo[j + 1], lo[j + 2], lo[j + 3], db);
        }
      }
    }
    mma::wgmma_commit();
    mma::wgmma_wait();
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      mma::fence_registers(pv[p]);
#pragma unroll
      for (int i = 0; i < kOutRegs; ++i) o[p][i] += pv[p][i];
    }
  }

  // o / l rounded to bf16 once, through the warp's own 16 rows of the Q
  // tile (no product reads it any more).
  store_rows<T, DH>(q_ptr, o, l, out + (long long)b * S * D + h * DH, D, q0, S);
}

// Head dims above 128 (a multiple of 64: the plan zero-pads each head's qkv
// columns to one): attention_kernel's arithmetic with the head dim in panels
// of 64 columns, in csrc/panel_ring.cuh's CTA of two warpgroups = (64 query
// rows, batch, head, G panels op0 .. op0 + G - 1 of o); blockIdx.x runs over
// tiles x B x H x P / G groups, the groups fastest.  The producer's TMA
// copies come from one map of the qkv buffer ((B, S, 3E) rows, E = H . dh):
// the CTA's q (P = dh / 64 panels) once, resident for both passes; then pass
// 1's walk, every key block's k panels; then pass 2's, every key block's k
// panels and the CTA's G v panels, each through the ring.  A block's scores
// are taken once a CTA in each pass: its dh / 16 16-deep steps, a panel pair
// of q and k at a time, each step into a fresh accumulator, kGroup at a
// time, added in f32 in attention_kernel's order (so s, m, p and l are what
// attention_kernel's would be at this dh); pass 2 adds P.V of each of the
// CTA's v panels, p = hi + mid + lo, into a fresh accumulator added to that
// panel of o in f32, a panel at a time.  The design before this one (a CTA
// a panel of o) took every score 2 P times in its two passes and copied q
// from L2 at every step; this one takes them 2 P / G times.  G is the
// plan's: the fresh accumulators cap it at 3 (o, the scores and two steps
// in flight must fit 216 registers a thread), and at batch 1, where the
// grid is smaller than the card, it is 1 (ops/vit_block.py::panel_group).
//
// PC: the panels of the head dim as a constant (4: dh 256, built for G 1
// and 2), or 0 (any, `panels` at run time).  With a constant, a block's 4 PC steps are
// started once its k panels have all landed, each into a fresh accumulator
// with up to kFresh of them in flight while the earlier ones are added (in
// the same order), and pass 2 takes the next v panel's P.V while this one's
// is added; at run time, a panel's four steps two at a time.
template <int G, int PC>
__global__ void __launch_bounds__(panel::kThreads, panel::kCtasPerSm)
attention_panels_kernel(const __grid_constant__ CUtensorMap qkv_map, bf16* __restrict__ out,
                        int S, int heads, int tiles, int dh, int stages, float scale) {
  using T = mma::Tile<64 * G>;                // the CTA's panels of o
  using P64 = mma::Tile<64>;
  constexpr int KB = kKeyBlock, kScoreRegs = KB / 2, kOutRegs = 32, kGroup = 2;
  // Fresh score accumulators in flight, and P.V buffers: what fits 216
  // registers a thread beside o (32 G) and the scores.
  constexpr int kFresh = G == 1 ? 4 : 2, kPvBufs = G <= 2 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* base = aligned_smem(raw);
  const int panels = PC > 0 ? PC : dh / 64;
  const panel::Ring ring = panel::Ring::setup(base, panels, stages);
  const int groups = panels / G;
  const int op0 = blockIdx.x % groups * G, rest = blockIdx.x / groups;
  const int bh = rest / tiles, q0 = (rest - bh * tiles) * kTileRows;
  const int b = bh / heads, h = bh - b * heads;
  const int D = heads * dh;
  const int blocks = (S + KB - 1) / KB, pass1 = blocks * panels, per_block = panels + G;

  if (threadIdx.x >= kThreads) {              // the producer warpgroup
    panel::producer_registers();
    if (threadIdx.x == kThreads) {
      const int qc = h * dh, kc = D + h * dh, vc = 2 * D + h * dh + op0 * 64;
      ring.load_q(panels, [&](uint32_t dst, uint32_t bar, int p) {
        tma_load(dst, &qkv_map, bar, qc + p * 64, q0, b);
      });
      for (int g = 0; g < pass1 + blocks * per_block; ++g) {
        int j, i;                              // key block j, its load i
        if (g < pass1) {
          j = g / panels;
          i = g - j * panels;
        } else {
          j = (g - pass1) / per_block;
          i = g - pass1 - j * per_block;
        }
        const int col = i < panels ? kc + i * 64 : vc + (i - panels) * 64;
        ring.load(g, [&](uint32_t dst, uint32_t bar) { tma_load(dst, &qkv_map, bar, col, j * KB, b); });
      }
    }
    return;
  }

  panel::consumer_registers();
  ring.wait_q();
  const int tq = threadIdx.x & 3;
  float o[G][kOutRegs];                       // the CTA's panels of o
#pragma unroll
  for (int p = 0; p < G; ++p)
#pragma unroll
    for (int i = 0; i < kOutRegs; ++i) o[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kScoreRegs];

  for (int pass = 0, g = 0; pass < 2; ++pass) {
    for (int j = 0; j < blocks; ++j) {
      // The block's scores: its 16-deep steps of q.k, each into a fresh
      // accumulator, added to s in f32 in order; each k panel's stage freed
      // once its steps are read.
      if constexpr (PC == 0) {
        for (int p = 0; p < panels; ++p, ++g) {
          const uint32_t qa = ring.q_panel(p), ka = ring.take(g);
#pragma unroll
          for (int g0 = 0; g0 < 64 / 16; g0 += kGroup) {
            float part[kGroup][kScoreRegs];
            mma::wgmma_fence();
#pragma unroll
            for (int jj = 0; jj < kGroup; ++jj) {
              const int kk = g0 + jj;
              mma::wgmma_ss_n64(part[jj], P64::descriptor(qa + kk * 32, 16),
                                P64::descriptor(ka + kk * 32, 16), 0);
            }
            mma::wgmma_commit();
            mma::wgmma_wait();
#pragma unroll
            for (int jj = 0; jj < kGroup; ++jj) {
              mma::fence_registers(part[jj]);
#pragma unroll
              for (int i = 0; i < kScoreRegs; ++i)
                s[i] = p == 0 && g0 + jj == 0 ? part[0][i] : s[i] + part[jj][i];
            }
          }
          ring.give(g);
        }
      } else {
        uint32_t ka[PC];
#pragma unroll
        for (int p = 0; p < PC; ++p) ka[p] = ring.take(g + p);
        // Step n (panel n / 4, 16-deep slice n % 4) into acc, its own group.
        const auto step = [&](float (&acc)[kScoreRegs], int n) {
          mma::wgmma_fence();
          mma::wgmma_ss_n64(acc, P64::descriptor(ring.q_panel(n / 4) + n % 4 * 32, 16),
                            P64::descriptor(ka[n / 4] + n % 4 * 32, 16), 0);
          mma::wgmma_commit();
        };
        constexpr int kSteps = 4 * PC;
        float part[kFresh][kScoreRegs];
        step(s, 0);
#pragma unroll
        for (int n = 1; n <= kFresh; ++n) step(part[n - 1], n);
#pragma unroll
        for (int n = 1; n < kSteps; ++n) {
          // Steps 0 .. n complete of the min(kFresh + n, kSteps) started.
          const int started = kFresh + n < kSteps ? kFresh + n : kSteps;
          wait_pending(started - n - 1);
          if (n == 1) mma::fence_registers(s);
          float (&got)[kScoreRegs] = part[(n - 1) % kFresh];
          mma::fence_registers(got);
#pragma unroll
          for (int i = 0; i < kScoreRegs; ++i) s[i] += got[i];
          if (n + kFresh < kSteps) step(got, n + kFresh);
        }
#pragma unroll
        for (int p = 0; p < PC; ++p) ring.give(g + p);
        g += PC;
      }
      const int k0 = j * KB;
#pragma unroll
      for (int i = 0; i < kScoreRegs; ++i)
        s[i] = k0 + 8 * (i / 4) + 2 * tq + (i & 1) < S ? s[i] * scale : -INFINITY;

      if (pass == 0) {                        // pass 1: the row maximum
#pragma unroll
        for (int i = 0; i < kScoreRegs; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
        if (j == blocks - 1) {
          m[0] = mma::quad_max(m[0]);
          m[1] = mma::quad_max(m[1]);
        }
        continue;
      }

      // Pass 2: p = expf(s - m), its row sum, and P.V with p = hi + mid +
      // lo, each v panel's P.V in a fresh accumulator added to its panel of
      // o in f32.
      uint32_t hi[kScoreRegs / 2], mid[kScoreRegs / 2], lo[kScoreRegs / 2];
      p_terms(s, m, l, hi, mid, lo);
      // v panel op's P.V into pv, its own group.
      const auto pv_of = [&](float (&pv)[kOutRegs], uint32_t va) {
#pragma unroll
        for (int i = 0; i < kOutRegs; ++i) pv[i] = 0.f;
        mma::fence_registers(pv);
        mma::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KB / 16; ++ks) {
          const int jj = 4 * ks;
          const uint64_t db = P64::descriptor(va + ks * 16 * 128, KB * 128);
          mma::wgmma_rs_n64(pv, hi[jj], hi[jj + 1], hi[jj + 2], hi[jj + 3], db);
          mma::wgmma_rs_n64(pv, mid[jj], mid[jj + 1], mid[jj + 2], mid[jj + 3], db);
          mma::wgmma_rs_n64(pv, lo[jj], lo[jj + 1], lo[jj + 2], lo[jj + 3], db);
        }
        mma::wgmma_commit();
      };
      if constexpr (PC == 0 || kPvBufs == 1) {
#pragma unroll
        for (int op = 0; op < G; ++op, ++g) {
          float pv[kOutRegs];
          pv_of(pv, ring.take(g));
          mma::wgmma_wait();
          mma::fence_registers(pv);
#pragma unroll
          for (int i = 0; i < kOutRegs; ++i) o[op][i] += pv[i];
          ring.give(g);
        }
      } else {
        uint32_t va[G];
#pragma unroll
        for (int op = 0; op < G; ++op) va[op] = ring.take(g + op);
        float pv[kPvBufs][kOutRegs];
        pv_of(pv[0], va[0]);
#pragma unroll
        for (int op = 0; op < G; ++op) {
          if (op + 1 < G) pv_of(pv[(op + 1) % kPvBufs], va[op + 1]);
          wait_pending(op + 1 < G ? 1 : 0);
          mma::fence_registers(pv[op % kPvBufs]);
#pragma unroll
          for (int i = 0; i < kOutRegs; ++i) o[op][i] += pv[op % kPvBufs][i];
        }
#pragma unroll
        for (int op = 0; op < G; ++op) ring.give(g + op);
        g += G;
      }
    }
  }

  // o / l rounded to bf16 once, through the warp's own 16 rows of the q
  // panels (no product reads them any more, no copy is in flight).
  store_rows<T, 64 * G>(base, o, l, out + (long long)b * S * D + h * dh + op0 * 64, D, q0, S);
}

}  // namespace encoder_mma
