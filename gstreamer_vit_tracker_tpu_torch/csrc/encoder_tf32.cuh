// Tensor-core tiles of the encoder kernels (csrc/vit_encoder.cu, variant
// "tf32x3": float32, head dims that are multiples of 8, above 128 in panels)
// for NVIDIA Hopper, sm_90a, built on the split-TF32 primitives of
// attention_tf32.cuh (to_tf32, split, FragA / FragB, mma3, load_a / load_b,
// Softmax).  Two kernels, the five launches a block of the "mma" variant,
// and attention_panels_kernel for head dims above 128 (described where it
// stands):
//
// product_kernel<BN, EPI, LN, NWG>: C[M, N] = epilogue(LN?(A)[M, K] . W[K,
//   N] + b) on mma.sync m16n8k8 in split TF32: every operand as hi = tf32(x)
//   and lo = tf32(x - hi), the three products lo.hi, hi.lo, hi.hi into an
//   f32 accumulator (float32's accuracy, attention_tf32.cuh's header).  The
//   weight comes split: W is two planes, hi then lo, each (K, N) row-major,
//   made once per parameter set by the operand cache (ops/vit_block.py), so
//   the warps that read a weight tile do not each split it again; the
//   kernel splits only the activations, each element once (a warp owns its
//   rows).  A CTA owns 64 rows (16 a warp) by BN = 16, 32 or 64 columns; K
//   arrives in 32-deep chunks by 16-byte cp.async through a ring of ring(BN)
//   slots (the A chunk, and the W chunk's two planes), the next chunks'
//   copies in flight while one is multiplied.  A chunk's four 8-deep steps
//   go to two fresh accumulators, the even steps' and the odd steps', added
//   to each other and then to the sum in f32: the tensor cores round the
//   sum they accumulate toward zero, and one accumulator over all of K
//   drifted (a chain of 288 truncated sums at K = 768; 1.7e-3 from the twin
//   at the flagship on the card, PERF.md).
//   * NWG warpgroups: at batch 1 a CTA of one warpgroup is alone on its SM
//     and every latency of its chain (the copy, the fragment loads, the
//     split, the products) is exposed; there the CTA is two warpgroups
//     that take the chunks in turn, each with its own ring and barrier,
//     and the second's sums are added to the first's before the epilogue
//     (the flagship's float32 encode on an H100 at 700 W: 602 us against
//     763 with one warpgroup, attention included; profile_encoder.py).
//   * LN resident (qkv, mlp1; K = the residual width W, D rounded up to a
//     multiple of 32): the CTA's 64 rows of A are resident, copied with the
//     LN scale and bias and the first W chunk, and LayerNormed in place
//     before the first product: eight lanes a row, the mean as the f32 sum
//     over the D true columns divided by D, then the mean of (x - mu)^2 the
//     same way (encoder_mma.cuh's row_stats), 1 / sqrt correctly rounded,
//     (x - mu) . rstd . scale + bias with every operation rounded on its own
//     (the twin's roundings: models/vit.py::layer_norm, eps 1e-6).  Its
//     shared memory grows with K, 64 . (K + 4) . 4 bytes of rows alone: the
//     H100's 232,448 a block hold it up to K = 544 at N 32 and two
//     warpgroups.
//   * LN streamed (the same products where the resident form does not fit):
//     a launch of row_stats_kernel<float> before the product takes each
//     row's mean and rstd with the resident form's arithmetic in its order;
//     the A chunk walks the ring as without LN, with the chunk's 32 columns
//     of the scale and bias beside it, and each A element is LayerNormed as
//     its fragment is loaded (load_a_ln), with the resident form's
//     roundings, before the split.  Its shared memory is the ring's, for
//     any K, and its LN output equals the resident form's bit for bit.
//   * no LN (proj, mlp2; K = the inner width E or the MLP width): the A chunk
//     walks the ring with the W chunk.  E is a multiple of 8 and may not be
//     one of 32: a chunk past K reads zeros, which add exactly.
//   The epilogue works on the accumulator registers: bias added in f32,
//   then the tanh GELU in f32, or the residual x + v in place on x (each
//   element read and written by one thread).  N is a multiple of 8 and may
//   not be one of BN (3E): columns past N are zeros in the tile and dropped.
//   Shared-memory rows are padded (A by 4 floats, W by 8), so the fragment
//   loads (A: row g, column t; B: row t, column g) are free of bank
//   conflicts.
//
// attention_kernel<DH, NWG>: softmax(q k^T dh^-1/2) v of one (batch, head)
//   for 64 query rows, q, k and v read from the qkv product's buffer where
//   they lie (row stride 3E, head h at column h . DH, k at +E, v at +2E),
//   out (B . S, E).  It is attention_tf32.cuh's tile code as attention.cu's
//   flash kernel runs it: 64-key blocks through a ring of two stages, the
//   online softmax in the score fragment, P.V with p split in registers;
//   c = log2(e) over the square root of the true head dim (a padded head is
//   scaled as the unpadded one).  One step differs (Softmax::step below): a
//   block's P.V goes to a fresh accumulator, and o = o . alpha + pv in f32,
//   where attention_tf32.cuh accumulates every block's P.V into o itself:
//   over the 12 blocks' residual stream of the flagship that chain of
//   truncated sums was the larger part of the distance to the twin (CPU
//   emulation, tests/test_torch_encoder_tf32.py).  At batch 1 (NWG = 2) two
//   warpgroups share the query tile and take its key blocks in turn, and
//   the first merges the second's (m, l, o).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attention_tf32.cuh"
#include "encoder_mma.cuh"
#include "panel_tf32.cuh"

namespace encoder_tf32 {

namespace tf = tf32x3;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kRows = 64;       // rows a product CTA: 4 warps of 16
constexpr int kChunk = 32;      // K a chunk
constexpr int kALd = kChunk + 4;   // floats of an A row of a ring slot
constexpr int kSbSlot = 2 * kChunk;   // floats of a streamed slot's scale and bias

using encoder_mma::kLnNone;
using encoder_mma::kLnResident;
using encoder_mma::kLnStreamed;

// Floats of a W tile row (BN + 8: row t, column g of a fragment falls in
// bank 8t + g), of one plane of a W chunk, and of an LN product's resident
// A row (K + 4).
__host__ __device__ constexpr int w_ld(int bn) { return bn + 8; }
__host__ __device__ constexpr int w_plane(int bn) { return kChunk * w_ld(bn); }
__host__ __device__ constexpr int ln_ld(int k) { return k + 4; }

// Slots of a warpgroup's ring (chunks in flight, one being multiplied):
// four, and three at N 64 so that two LN CTAs share an SM at D 192.
__host__ __device__ constexpr int ring(int bn) { return bn == 64 ? 3 : 4; }

// Dynamic shared memory of one product CTA of `nwg` warpgroups: the A tile
// (LN resident: 64 rows of K, and the LN scale and bias; else a chunk a slot
// of each warpgroup's ring), a W chunk of two planes a slot, and for LN
// streamed the chunk's scale and bias a slot.
inline size_t product_smem_bytes(int bn, int ln, int k, int nwg) {
  const size_t slots = (size_t)nwg * ring(bn);
  const size_t a = ln == kLnResident ? (size_t)kRows * ln_ld(k) + 2 * k
                                     : slots * kRows * kALd;
  const size_t sb = ln == kLnStreamed ? slots * kSbSlot : 0;
  return (a + slots * 2 * w_plane(bn) + sb) * sizeof(float);
}

// Barrier of warpgroup `wg` alone (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(wg + 1), "r"(kThreads) : "memory");
}

// A 16 x 8 A fragment at p (row g, column t), rows ld floats apart, split.
__device__ __forceinline__ tf::FragA load_a(const float* p, int ld) {
  tf::FragA a;
  tf::split(p[0], a.hi[0], a.lo[0]);
  tf::split(p[8 * ld], a.hi[1], a.lo[1]);
  tf::split(p[4], a.hi[2], a.lo[2]);
  tf::split(p[8 * ld + 4], a.hi[3], a.lo[3]);
  return a;
}

// x LayerNormed with its row's (mu, rstd) and its column's scale s and bias
// b: (x - mu) . rstd . s + b, every operation rounded on its own.
__device__ __forceinline__ float layer_norm1(float x, float mu, float rstd, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), s), b);
}

// load_a of the streamed form: each element LayerNormed (layer_norm1) before
// the split, rows g and g + 8 with st[0] and st[1], columns t and t + 4
// with the scale at sb[0] and sb[4] and the bias kChunk floats after it.
__device__ __forceinline__ tf::FragA load_a_ln(const float* p, int ld, const float2 (&st)[2],
                                               const float* sb) {
  tf::FragA a;
  tf::split(layer_norm1(p[0], st[0].x, st[0].y, sb[0], sb[kChunk]), a.hi[0], a.lo[0]);
  tf::split(layer_norm1(p[8 * ld], st[1].x, st[1].y, sb[0], sb[kChunk]), a.hi[1], a.lo[1]);
  tf::split(layer_norm1(p[4], st[0].x, st[0].y, sb[4], sb[kChunk + 4]), a.hi[2], a.lo[2]);
  tf::split(layer_norm1(p[8 * ld + 4], st[1].x, st[1].y, sb[4], sb[kChunk + 4]), a.hi[3],
            a.lo[3]);
  return a;
}

// Rows [m0, m0 + 64) and columns [k0, k0 + cols) of A ((M, K) row-major)
// into the tile at shared address `dst` (rows ld floats apart) by `threads`
// threads, `tid` this one; rows >= M and columns >= K are zeros.  cols and
// K are multiples of 4 (16 bytes).
__device__ __forceinline__ void fill_a(int tid, int threads, uint32_t dst, const float* A,
                                       int M, int K, int m0, int k0, int cols, int ld) {
  const int per_row = cols / 4;
  for (int i = tid; i < kRows * per_row; i += threads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    const bool valid = m0 + r < M && k0 + c < K;
    mma::cp_async16(dst + (uint32_t)(r * ld + c) * 4u,
                    valid ? A + (size_t)(m0 + r) * K + k0 + c : A, valid);
  }
}

// Rows [k0, k0 + 32) and columns [n0, n0 + BN) of both planes of W (each
// (K, N) row-major, lo K . N floats after hi) into the chunk at `dst` by the
// 128 threads of one warpgroup, `tid` this one's index in it; rows >= K and
// columns >= N are zeros.
template <int BN>
__device__ __forceinline__ void fill_w(int tid, uint32_t dst, const float* W, int K, int N,
                                       int k0, int n0) {
  constexpr int kPerRow = BN / 4, kPerPlane = kChunk * kPerRow;
  for (int i = tid; i < 2 * kPerPlane; i += kThreads) {
    const int plane = i / kPerPlane, j = i - plane * kPerPlane;
    const int r = j / kPerRow, c = (j - r * kPerRow) * 4;
    const bool valid = k0 + r < K && n0 + c < N;
    const float* src = W + (size_t)plane * K * N + (size_t)(k0 + r) * N + n0 + c;
    mma::cp_async16(dst + (uint32_t)(plane * w_plane(BN) + r * w_ld(BN) + c) * 4u,
                    valid ? src : W, valid);
  }
}

// The resident tile's 64 rows (ld floats apart, K wide, K a multiple of 32)
// LayerNormed in place over their d true columns (d <= K; the K - d past
// them are the zero padding of the residual stream) with the scale s and
// bias b (shared memory, K each, zero past d), as models/vit.py::layer_norm
// rounds it: encoder_mma.cuh's row_stats (the f32 sums over the d columns
// divided by d, 1 / sqrt correctly rounded), then layer_norm1.  With d = K
// the arithmetic is the unpadded one's.  Eight lanes a row, four rows a
// warp at a time, the CTA's `warps` warps taking 64 / warps rows each; lane
// c holds the 16-byte chunks c, c + 8, ... of its row.  Rows past M are
// zeros and come out as the LN bias: the epilogue drops them.
__device__ __forceinline__ void layer_norm_rows(float* tile, int ld, const float* s,
                                                const float* b, int K, int d, int warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = 4 * (lane & 7), rows = kRows / warps;
  for (int r = warp * rows + (lane >> 3); r < warp * rows + rows; r += 4) {
    float* row = tile + r * ld;
    const float2 st = encoder_mma::row_stats<float>(
        [&](int p) { return *reinterpret_cast<const uint4*>(row + 32 * p + c); }, K / 32,
        lane & 7, d);
    for (int i = c; i < K; i += 32) {
      float4 v = *reinterpret_cast<const float4*>(row + i);
      const float4 sv = *reinterpret_cast<const float4*>(s + i);
      const float4 bv = *reinterpret_cast<const float4*>(b + i);
      v.x = layer_norm1(v.x, st.x, st.y, sv.x, bv.x);
      v.y = layer_norm1(v.y, st.x, st.y, sv.y, bv.y);
      v.z = layer_norm1(v.z, st.x, st.y, sv.z, bv.z);
      v.w = layer_norm1(v.w, st.x, st.y, sv.w, bv.w);
      *reinterpret_cast<float4*>(row + i) = v;
    }
  }
}

// A: (M, K) row-major; W: two planes (hi, lo) of (K, N) row-major; C: (M,
// N), which may alias the residual (EPI == kEpiResidual reads C before
// writing it, element by element in the same thread).  LN (kLnResident,
// kLnStreamed): K = W, a multiple of 32, the LayerNorm over the first ln_dim
// columns of A (streamed: the rows' (mean, rstd) read from stats,
// row_stats_kernel's over the same columns); kLnNone: K a multiple of 8,
// ln_dim, ln_s, ln_b and stats unread.  N a multiple of 8.  NWG warpgroups:
// warpgroup w takes chunks w, w + NWG, ... through a ring of its own
// (synchronised by its own barrier) and the sums are added at the end.
template <int BN, int EPI, int LN, int NWG>
__global__ void __launch_bounds__(kThreads * NWG)
product_kernel(const float* __restrict__ A, const float* __restrict__ W,
               const float* __restrict__ bias, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, const float2* __restrict__ stats, float* C,
               int M, int N, int K, int ln_dim) {
  constexpr int kTiles = BN / 8;               // n tiles a warp
  constexpr int kRing = ring(BN);
  constexpr bool kResident = LN == kLnResident, kStreamed = LN == kLnStreamed;
  extern __shared__ __align__(16) float smem[];
  const int a_ld = kResident ? ln_ld(K) : kALd;
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  float* a_tile = smem;                        // resident; else [NWG][kRing] chunks
  float* ln_sb = smem + kRows * a_ld;          // resident: scale, then bias
  float* w_ring = smem + (kResident ? kRows * a_ld + 2 * K : NWG * kRing * kRows * kALd);
  float* sb_ring = w_ring + NWG * kRing * 2 * w_plane(BN);   // streamed: [NWG][kRing] s, b
  float* a_mine = a_tile + wg * kRing * kRows * kALd;
  float* w_mine = w_ring + wg * kRing * 2 * w_plane(BN);
  float* sb_mine = sb_ring + wg * kRing * kSbSlot;
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * BN;
  const int chunks = (K + kChunk - 1) / kChunk;
  const int mine = (chunks - wg + NWG - 1) / NWG;   // chunks wg, wg + NWG, ...

  const auto load = [&](int i) {               // my i-th chunk into slot i % kRing
    const int slot = i % kRing, k0 = (i * NWG + wg) * kChunk;
    if constexpr (!kResident)
      fill_a(tid, kThreads, mma::smem_addr(a_mine + slot * kRows * kALd), A, M, K, m0, k0,
             kChunk, kALd);
    if constexpr (kStreamed) {                 // the chunk's scale, then its bias
      if (tid < kSbSlot / 4) {
        const float* src = tid < kChunk / 4 ? ln_s + k0 + 4 * tid : ln_b + k0 + 4 * tid - kChunk;
        mma::cp_async16(mma::smem_addr(sb_mine + slot * kSbSlot + 4 * tid), src);
      }
    }
    fill_w<BN>(tid, mma::smem_addr(w_mine + slot * 2 * w_plane(BN)), W, K, N, k0, n0);
  };
  if constexpr (kResident) {
    fill_a(threadIdx.x, kThreads * NWG, mma::smem_addr(a_tile), A, M, K, m0, 0, K, a_ld);
    for (int i = threadIdx.x; i < K / 2; i += kThreads * NWG) {   // 16-byte pieces of s, b
      const float* src = i < K / 4 ? ln_s + 4 * i : ln_b + 4 * i - K;
      mma::cp_async16(mma::smem_addr(ln_sb + 4 * i), src);
    }
  }
  for (int i = 0; i < kRing - 1; ++i) {        // a group a chunk, empty past the end
    if (i < mine) load(i);
    mma::cp_async_commit();
  }
  if constexpr (kResident) {
    mma::cp_async_wait<kRing - 2>();           // A, s, b and my first chunk have landed
    __syncthreads();
    layer_norm_rows(a_tile, a_ld, ln_sb, ln_sb + K, K, ln_dim, 4 * NWG);
    __syncthreads();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float2 st[2];                                // streamed: rows g and g + 8's (mean, rstd)
  if constexpr (kStreamed) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + g + 8 * h;
      st[h] = row < M ? stats[row] : make_float2(0.f, 0.f);
    }
  }
  float acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int i = 0; i < mine; ++i) {
    mma::cp_async_wait<kRing - 2>();           // my chunk i has landed
    warpgroup_sync(wg);                        // ... for my warpgroup; slot i - 1 is free
    if (i + kRing - 1 < mine) load(i + kRing - 1);
    mma::cp_async_commit();
    const int slot = i % kRing, c = i * NWG + wg;
    const float* a = kResident ? a_tile + (warp * 16 + g) * a_ld + c * kChunk + t
                               : a_mine + slot * kRows * kALd + (warp * 16 + g) * kALd + t;
    const float* sb = sb_mine + slot * kSbSlot + t;
    const float* w_hi = w_mine + slot * 2 * w_plane(BN) + t * w_ld(BN) + g;
    const float* w_lo = w_hi + w_plane(BN);
    float part[2][kTiles][4];                  // this chunk's even and odd steps
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[e][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 8) {
      tf::FragA fa;
      if constexpr (kStreamed) fa = load_a_ln(a + kk, a_ld, st, sb + kk);
      else fa = load_a(a + kk, a_ld);
      tf::FragB fb[kTiles];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {       // b0 (k = t, n = g), b1 (k = t + 4)
        const int o = kk * w_ld(BN) + 8 * j;
        fb[j].hi[0] = __float_as_uint(w_hi[o]);
        fb[j].hi[1] = __float_as_uint(w_hi[o + 4 * w_ld(BN)]);
        fb[j].lo[0] = __float_as_uint(w_lo[o]);
        fb[j].lo[1] = __float_as_uint(w_lo[o + 4 * w_ld(BN)]);
      }
      tf::mma3<0>(part[(kk / 8) & 1], fa, fb);
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[0][j][q] + part[1][j][q];
  }
  if constexpr (NWG > 1) {                     // the second warpgroup's sums to the first
    mma::cp_async_wait<0>();
    __syncthreads();                           // every ring is read out
    float* spill = w_ring + tid;
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) spill[(4 * j + q) * kThreads] = acc[j][q];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += spill[(4 * j + q) * kThreads];
  }

  // Epilogue: a lane holds rows g and g + 8 of its warp's 16 and, a tile j,
  // columns 8j + 2t and 8j + 2t + 1.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + warp * 16 + g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) continue;
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
      float v0 = acc[j][2 * h] + bb.x, v1 = acc[j][2 * h + 1] + bb.y;
      if constexpr (EPI == encoder_mma::kEpiGelu) {
        v0 = encoder_mma::gelu_tanh(v0);
        v1 = encoder_mma::gelu_tanh(v1);
      }
      float2* out = reinterpret_cast<float2*>(C + (size_t)row * N + col);
      if constexpr (EPI == encoder_mma::kEpiResidual) {
        const float2 xr = *out;
        v0 = xr.x + v0;
        v1 = xr.y + v1;
      }
      *out = make_float2(v0, v1);
    }
  }
}

// attention_tf32.cuh's per-warp state with one step of its own: the block's
// P.V into a fresh accumulator, then o = o . alpha + pv (one fma).  The
// scores and the online softmax are the base's.
template <int DH>
struct Softmax : tf::Softmax<DH> {
  using Base = tf::Softmax<DH>;
  using Base::kChunks;
  using Base::kKeyTiles;
  using Base::kQInRegisters;
  using Base::l;
  using Base::m;
  using Base::o;

  __device__ __forceinline__ void step(const float* qw, const float* kb, const float* vb,
                                       int k0, int S, float c) {
    float s[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    this->template add_scores<kQInRegisters>(s, qw, kb);
    update(s, vb, k0, S, c);
  }

  // The rest of a block on its scores s: the base's softmax, then PV = P.V
  // in a fresh accumulator and o = o . alpha + PV.
  __device__ __forceinline__ void update(float (&s)[kKeyTiles][4], const float* vb, int k0,
                                         int S, float c) {
    float alpha[2];
    this->softmax(s, k0, S, c, alpha);
    float fresh[kChunks][4];
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) fresh[j][i] = 0.f;
    this->pv(fresh, s, vb);
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] = fmaf(o[j][i], alpha[i >> 1], fresh[j][i]);
  }

  // What a warpgroup that walked other key blocks of the same rows hands
  // over at shared address p (this thread's slot of 128, stride 128): m, l
  // and o as this thread holds them.
  __device__ __forceinline__ void spill(float* p) const {
    p[0] = m[0];
    p[tf::kThreads] = m[1];
    p[2 * tf::kThreads] = l[0];
    p[3 * tf::kThreads] = l[1];
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[(4 + 4 * j + i) * tf::kThreads] = o[j][i];
  }

  // This state merged with a spilled one of the same rows: the larger
  // maximum, each side's sums and output scaled by exp2((m_side - m) . c),
  // added with one rounding (an fma).  A side that saw no key (m = -inf)
  // adds zeros.
  __device__ __forceinline__ void merge(const float* p, float c) {
    float a0[2], a1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = p[h * tf::kThreads], l1 = p[(2 + h) * tf::kThreads];
      const float mm = fmaxf(m[h], m1);
      a0[h] = m[h] == -INFINITY ? 0.f : mma::exp2_approx((m[h] - mm) * c);
      a1[h] = m1 == -INFINITY ? 0.f : mma::exp2_approx((m1 - mm) * c);
      m[h] = mm;
      l[h] = fmaf(l[h], a0[h], l1 * a1[h]);
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[j][i] = fmaf(o[j][i], a0[i >> 1],
                       p[(4 + 4 * j + i) * tf::kThreads] * a1[i >> 1]);
  }
};

// Rows [row0, row0 + rows) of a float32 matrix of head dim DH whose row 0 is
// `g` (rows row_stride floats apart) into the tile at shared address `tile`
// by the 128 threads of one warpgroup, `tid` this thread's index in it;
// rows >= limit are zeros.  attention_tf32.cuh's fill, for a CTA of more
// than one warpgroup.
template <int DH>
__device__ __forceinline__ void fill_rows(int tid, uint32_t tile, const float* g,
                                          long long row_stride, int row0, int rows, int limit) {
  constexpr int kChunks = DH / 4, kPass = tf::kThreads / kChunks, kLd = tf::row_floats(DH);
  const int row = tid / kChunks, col = tid % kChunks;
  if (row >= kPass) return;
  const float* src = g + (long long)(row0 + row) * row_stride + 4 * col;
  uint32_t dst = tile + (uint32_t)(row * kLd + 4 * col) * 4u;
  for (int r = row; r < rows; r += kPass, src += kPass * row_stride, dst += kPass * kLd * 4) {
    const bool valid = row0 + r < limit;
    mma::cp_async16(dst, valid ? src : g, valid);
  }
}

// Largest head dim built with two warpgroups (the presets' 16, 48 and 64 and
// the padded rule's multiples of 8 below; their rings, (64 + 2 . 2 . 2 . 64)
// rows of DH + 4 floats, fit up to 96).
constexpr int kSplitMaxDh = 64;

// Dynamic shared memory of one attention CTA of `nwg` warpgroups: the Q
// tile and two stages of a K and a V block for each warpgroup, rows of DH +
// 4 floats.
inline size_t attention_smem_bytes(int dh, int nwg) {
  return tf::tile_bytes(tf::kRows + 4 * nwg * tf::kKeys, dh);
}

// CTA = NWG warpgroups on one query tile (64 rows, batch, head); blockIdx.x
// runs over tiles x B x H.  qkv (B . S, 3E), out (B . S, E), E = heads . DH.
// The key blocks are dealt to the warpgroups in turn (block j . NWG + w to
// warpgroup w at step j), each warpgroup's warp w keeping the state of the
// tile's rows 16w ... 16w + 15 over its own blocks; a ring of two stages of
// one K and one V block a warpgroup: the copies of step j + 1 are in flight
// while step j is computed, one barrier a step.  With two warpgroups (a grid
// smaller than the card: batch 1) the second spills its state into the
// ring at the end and the first merges it.
template <int DH, int NWG>
__global__ void __launch_bounds__(tf::kThreads * NWG)
attention_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S, int heads,
                 int tiles, float c) {
  constexpr int kLd = tf::row_floats(DH), kSlot = tf::kKeys * kLd;
  static_assert(NWG == 1 || (NWG == 2 && DH <= kSplitMaxDh), "warpgroups built");
  extern __shared__ __align__(16) float tile_mem[];
  float* q_tile = tile_mem;                              // [64][kLd]
  float* k_tiles = q_tile + tf::kRows * kLd;             // [2][NWG][64][kLd]
  float* v_tiles = k_tiles + 2 * NWG * kSlot;            // [2][NWG][64][kLd]
  const int blocks = (S + tf::kKeys - 1) / tf::kKeys;
  const int steps = (blocks + NWG - 1) / NWG;
  const int wg = threadIdx.x / tf::kThreads, tid = threadIdx.x % tf::kThreads;

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * tf::kRows;
  const int b = bh / heads, h = bh - b * heads;
  const int E = heads * DH;
  const long long ld = 3LL * E;
  const float* q = qkv + (long long)b * S * ld + h * DH;
  const float* k = q + E;
  const float* v = q + 2 * E;
  const auto slot = [&](int j) { return ((j & 1) * NWG + wg) * kSlot; };
  const auto fill_step = [&](int j) {          // this warpgroup's block of step j
    const int blk = j * NWG + wg;
    if (blk >= blocks) return;                 // uniform over the warpgroup
    fill_rows<DH>(tid, mma::smem_addr(k_tiles + slot(j)), k, ld, blk * tf::kKeys, tf::kKeys, S);
    fill_rows<DH>(tid, mma::smem_addr(v_tiles + slot(j)), v, ld, blk * tf::kKeys, tf::kKeys, S);
  };
  if (wg == 0) fill_rows<DH>(tid, mma::smem_addr(q_tile), q, ld, q0, tf::kRows, S);
  fill_step(0);
  mma::cp_async_commit();

  const int row0 = q0 + 16 * (tid >> 5);
  const bool has_rows = row0 < S;              // uniform over the warp
  const float* qw = q_tile + (row0 - q0) * kLd;
  Softmax<DH> sm;
  sm.init();
  for (int j = 0; j < steps; ++j) {
    mma::cp_async_wait<0>();                   // step j (and Q) has landed
    __syncthreads();
    if (j + 1 < steps) fill_step(j + 1);
    mma::cp_async_commit();
    const int blk = j * NWG + wg;
    if (!has_rows || blk >= blocks) continue;
    if (j == 0) sm.load_q(qw);
    sm.step(qw, k_tiles + slot(j), v_tiles + slot(j), blk * tf::kKeys, S, c);
  }
  if constexpr (NWG > 1) {
    float* scratch = k_tiles + tid;            // the ring is free once all are here
    __syncthreads();
    if (wg == 1) sm.spill(scratch);
    __syncthreads();
    if (wg == 1) return;
    sm.merge(scratch, c);
  }
  if (has_rows) sm.store(out + (long long)b * S * E + h * DH, E, row0, S);
}


// Head dims above 128 (a multiple of 8): attention_kernel's arithmetic at
// one warpgroup (64-key blocks, the online softmax, a block's P.V into a
// fresh accumulator) with the head dim in panels of 64 columns, on
// csrc/panel_tf32.cuh's CTA (q resident, G = group panels of o, each key
// block's scores once a CTA, K and V split once a CTA by producer
// warpgroups through a ring of `stages`).  CTA = (64 query rows, batch,
// head, panels op0 .. op0 + G - 1 of o); blockIdx.x runs over tiles x B x H
// x P / G, the groups fastest; q, k and v read from the qkv buffer where
// they lie.
template <int G>
__global__ void __launch_bounds__(tf32_panels::threads(G, true), 1)
attention_panels_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S, int heads,
                        int tiles, int dh, int stages, float c) {
  extern __shared__ __align__(16) float smem[];
  const int groups = (dh + tf32_panels::kCols - 1) / tf32_panels::kCols / G;
  const int op0 = blockIdx.x % groups * G, rest = blockIdx.x / groups;
  const int bh = rest / tiles, q0 = (rest - bh * tiles) * tf32_panels::kRows;
  const int b = bh / heads, h = bh - b * heads;
  const int E = heads * dh;
  const long long ld = 3LL * E;
  const float* q = qkv + (long long)b * S * ld + h * dh;
  tf32_panels::walk<G, true>(reinterpret_cast<unsigned char*>(smem), q, ld, q + E, ld,
                             q + 2 * E, ld, out + (long long)b * S * E + h * dh, E, S, q0, dh,
                             op0, stages, c);
}

}  // namespace encoder_tf32
