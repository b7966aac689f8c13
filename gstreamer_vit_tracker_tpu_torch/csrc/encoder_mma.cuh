// Tensor-core tiles of the encoder kernels (csrc/vit_encoder.cu, variant
// "mma": bf16, head dim 32 / 64 / 128) for NVIDIA Hopper, sm_90a, built from
// the swizzled shared-memory tiles, copies and wgmma primitives of
// attention_mma.cuh.  Two kernels:
//
// product_kernel<BN, EPI, LN>: C[M, N] = epilogue(LN?(A)[M, K] . W[K, N] + b).
//   A CTA is one warpgroup and owns 64 rows (wgmma's M) by BN = 32 or 64
//   columns.  A (the activations, (M, K) row-major: K-major as they lie) and
//   W (the weight, (K, N) row-major: N-major as it lies, the transpose bit of
//   the descriptor) arrive by 16-byte cp.async in 64-deep chunks.
//   * LN (qkv, mlp1; K = the residual width W, D rounded up to a multiple
//     of 64): every chunk of the 64 rows is resident before the first
//     product; each row's mean, then the mean of (x - mu)^2, are taken in
//     f32 from the bf16 x over its D true columns (ln_dim; the W - D padded
//     ones are zeros and enter neither sum), the row is normalised, scaled
//     and shifted in f32 with no contraction (the twin's separate roundings),
//     rounded to bf16 once, and written back into the A tile.
//   * no LN (proj, mlp2; K = D or the MLP width): K walks a ring of kRing
//     chunks, the next chunks' copies in flight while one is multiplied.
//   Every 16-deep step of a product goes to a fresh accumulator, and the
//   steps are added in f32 in order: the tensor cores round the sum they
//   accumulate toward zero, and a chain of such steps moved the tracker's
//   free-running trajectory off the plain twin's (PERF.md).  The epilogue
//   works on the accumulator registers at the twin's rounding points: bias
//   added in f32, rounded to bf16; then either
//   the tanh GELU in f32 of the rounded value, rounded again, or the residual
//   x + round(.) in place on x, each element read and written by one thread.
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

// ---------------------------------------------------------------------------
// The products.
// ---------------------------------------------------------------------------

// Dynamic shared memory of one product CTA: `chunks` slots, each an A chunk
// (64 rows x 64) and a W chunk (64 x bn), from a 1024-byte boundary.
inline size_t product_smem_bytes(int bn, int chunks) {
  return (size_t)kAlign + (size_t)chunks * kChunk * (kTileRows + bn) * sizeof(bf16);
}

// The resident A tile (64 rows x K, K / 64 panels) LayerNormed in place, as
// models/vit.py::layer_norm computes it over the d true columns (d <= K; the
// K - d past them are the zero padding of the residual stream): mean =
// sum(x) / d, var = sum((x - mean)^2) / d (a sum divided, as torch's mean is
// on the CPU), y = (x - mean) . (1 / sqrt(var + eps)), then y . scale +
// bias, every operation rounded on its own (no contraction), and one
// rounding to bf16.  A padded column adds nothing to either sum (its
// (0 - mean)^2 would: it is masked), and its scale and bias are zeros, so
// it comes out 0.  With d = K the mask is always true and the arithmetic is
// the unpadded one's.  Eight lanes a row, four rows a warp at a time; lane
// c holds 16-byte chunk c of every panel.  Rows past M are zeros and come
// out as the LN bias: the epilogue drops them.
__device__ __forceinline__ void layer_norm_tile(unsigned char* tile, const bf16* __restrict__ s,
                                                const bf16* __restrict__ b, int K, int d) {
  using TA = mma::Tile<64>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 7, panels = K / kChunk;
  constexpr int kPanelBytes = TA::bytes(kTileRows);
  const float k = (float)d;
  for (int r = warp * 16 + (lane >> 3); r < warp * 16 + 16; r += 4) {
    unsigned char* row = tile + TA::offset(r, c);
    float sum = 0.f;
    for (int p = 0; p < panels; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + p * kPanelBytes);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (p * kChunk + c * 8 + i < d) sum = __fadd_rn(sum, __bfloat162float(e[i]));
    }
    const float mu = __fdiv_rn(group8_sum(sum), k);
    float var = 0.f;
    for (int p = 0; p < panels; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + p * kPanelBytes);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (p * kChunk + c * 8 + i >= d) continue;
        const float t = __fsub_rn(__bfloat162float(e[i]), mu);
        var = __fadd_rn(var, __fmul_rn(t, t));
      }
    }
    const float rstd = rsqrt_rn(__fadd_rn(__fdiv_rn(group8_sum(var), k), kLnEps));
    for (int p = 0; p < panels; ++p) {
      uint4* at = reinterpret_cast<uint4*>(row + p * kPanelBytes);
      const uint4 v = *at;
      const uint4 sv = *reinterpret_cast<const uint4*>(s + p * kChunk + c * 8);
      const uint4 bv = *reinterpret_cast<const uint4*>(b + p * kChunk + c * 8);
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
      *at = y;
    }
  }
}

// A: (M, K) row-major; W: (K, N) row-major; C: (M, N), which may alias the
// residual (EPI == kEpiResidual reads C before writing it, element by element
// in the same thread).  K is a multiple of 64, N of BN.  LN: K / 64 slots,
// every chunk resident, the LayerNorm over the first ln_dim columns of A
// (layer_norm_tile); else kRing slots, ln_dim unread.
template <int BN, int EPI, bool LN>
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
  const int slots = LN ? chunks : kRing;
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

  if constexpr (LN) {
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
// The attention.
// ---------------------------------------------------------------------------

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
#pragma unroll
    for (int r = 0; r < kScoreRegs / 2; ++r) {   // pair r holds scores 2r, 2r + 1
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

  // o / l rounded to bf16 once, through the warp's own 16 rows of the Q tile
  // (no product reads it any more) and out as 16-byte vectors; rows >= S are
  // dropped.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = mma::quad_sum(l[hh]);
    const int r = warp * 16 + g + 8 * hh;
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < kOutRegs / 4; ++j)
        *reinterpret_cast<uint32_t*>(q_ptr + p * kTileRows * T::kRowBytes + T::offset(r, j)
                                     + 4 * tq) =
            mma::pack_bf16(o[p][4 * j + 2 * hh] / sum, o[p][4 * j + 2 * hh + 1] / sum);
  }
  __syncwarp();
  constexpr int kRowChunks = DH / 8;
  bf16* o_base = out + (long long)b * S * D + h * DH;
  for (int i = lane; i < 16 * kRowChunks; i += 32) {
    const int r = warp * 16 + i / kRowChunks, c = i % kRowChunks;
    const int p = c / T::kChunks, cc = c - p * T::kChunks;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(o_base + (long long)(q0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(q_ptr + p * kTileRows * T::kRowBytes
                                          + T::offset(r, cc));
  }
}

}  // namespace encoder_mma
