// Tensor-core tile code of the float32 attention kernels (csrc/attention.cu,
// variant "tf32x3") for NVIDIA Hopper, sm_90a: split-TF32 products on
// mma.sync, the online softmax on the accumulator fragment, and the output.
//
// Split TF32.  A TF32 operand keeps 11 of float32's 24 significant bits, so a
// single TF32 product is off by about 1e-3 in a score (1e-5 is the bound the
// kernels are held to).  Each operand x is written as hi + lo with hi =
// tf32(x) and lo = tf32(x - hi), both rounded to nearest, ties away (what
// cvt.rna.tf32.f32 gives, done here as an integer add and mask: on sm_90a
// ptxas expands the cvt into a longer sequence, which measured slower); the
// three products lo.hi, hi.lo, then hi.hi go into one f32 accumulator, and
// what is dropped (lo.lo and the rounding of lo) is about 2^-22 of a
// product: float32's accuracy at three TF32 products a product (CUTLASS's
// "3xTF32").
//
// One warpgroup (4 warps, 128 threads) owns 64 query rows of one (batch,
// head), 16 rows a warp, and walks blocks of 64 keys.  The head dim is a
// template argument (every multiple of 8 up to 128 is built): with it known,
// every loop over the head dim unrolls whole, with no branch around the
// products (a class of head dims with the dim given at run time, branches
// around the products, measured slower).  For one block a warp
//   1. takes its 16 x 64 scores with m16n8k8 products: A = its Q rows, B =
//      the K block, both read from shared memory where they lie as float32
//      ((rows, dh), dh contiguous) and split as the fragment is loaded; Q's
//      fragments are split once per CTA and kept in registers where the head
//      dim is at most 64 (dh registers of Q: at 128 they would not fit, so
//      above 64 they are loaded and split again for each block);
//   2. keeps the scores in its accumulator fragment, where a row lives in the
//      four lanes of a quad: masks keys >= the sequence length to -inf,
//      updates the running row maximum m and sum l (the maximum and the sum
//      reduced over the quad with __shfl_xor_sync) and turns S into p =
//      exp2(S.c - m.c) with c = dh^-1/2.log2(e), one multiply of the f32
//      scores;
//   3. adds P.V with p taken from the score accumulator as it is: the
//      accumulator gives a lane columns 2t and 2t + 1 (t = lane % 4) of each
//      8-key block, the A fragment wants k = t and t + 4, so A's k = t is
//      key 2t and k = t + 4 key 2t + 1, and V's B fragment is loaded in the
//      same order (b0 = V[2t][g], b1 = V[2t + 1][g]).  p is split in
//      registers and never touches shared memory.
//
// Shared-memory tiles: rows of dh floats padded by 4 (dh + 4 is 4 modulo 8
// for every dh that is a multiple of 8), so the eight rows of a fragment
// load fall into eight different groups of four banks: A and QK^T's B
// fragments (row g, column t) and P.V's B fragments (row 2t, column g) are
// free of bank conflicts.  Copies are 16-byte cp.async; rows past S are
// zero-filled.
//
// Why mma.sync and not wgmma: wgmma with TF32 takes both shared-memory
// operands K-major only (no transpose bit for 32-bit types), which V is not
// for P.V ((keys, dh) with dh contiguous is N-major there), so V would have
// to be transposed while it is staged, and the split operands would have to
// be staged as hi and lo tiles in the descriptor's swizzled layout.  That is
// left for later; mma.sync reads V as it lies.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attention_mma.cuh"

namespace tf32x3 {

constexpr int kRows = 64;       // query rows a CTA: 4 warps of 16
constexpr int kThreads = 128;   // one warpgroup
constexpr int kKeys = 64;       // keys a block
constexpr int kPad = 4;         // floats a shared-memory row is padded by

// Floats of one shared-memory row, and bytes of a tile of `rows` rows.
__host__ __device__ constexpr int row_floats(int dh) { return dh + kPad; }
__host__ __device__ inline size_t tile_bytes(int rows, int dh) {
  return (size_t)rows * row_floats(dh) * sizeof(float);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (about 2^-22 x): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A 16 x 8 A fragment and an 8 x 8 B fragment, each split.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[D0 + i] += a.b[i] for the N tiles i with D0 + i < M, to float32's
// accuracy: lo.hi, hi.lo, then hi.hi into each accumulator (the small
// products first), each of the three for every tile before the next, so
// that products into different accumulators follow each other and none
// waits on the one before it.
template <int D0, int N, int M>
__device__ __forceinline__ void mma3(float (&d)[M][4], const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N && D0 + i < M; ++i) mma(d[D0 + i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N && D0 + i < M; ++i) mma(d[D0 + i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N && D0 + i < M; ++i) mma(d[D0 + i], a.hi, b[i].hi);
}

// The A fragment of 16 rows x 8 columns at `p` (row g, column t of the
// fragment; rows LD floats apart): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4).
template <int LD>
__device__ __forceinline__ FragA load_a(const float* p) {
  FragA a;
  split(p[0], a.hi[0], a.lo[0]);
  split(p[8 * LD], a.hi[1], a.lo[1]);
  split(p[4], a.hi[2], a.lo[2]);
  split(p[8 * LD + 4], a.hi[3], a.lo[3]);
  return a;
}

// A B fragment from two elements: b0 (k = t) and b1 (k = t + 4).
__device__ __forceinline__ FragB load_b(float x0, float x1) {
  FragB b;
  split(x0, b.hi[0], b.lo[0]);
  split(x1, b.hi[1], b.lo[1]);
  return b;
}

// Rows [row0, row0 + rows) of a float32 matrix of head dim DH whose row 0 is
// `g` and whose rows are row_stride floats apart, into the tile at shared
// address `tile` (rows row_floats(DH) apart) by the CTA's 128 threads; rows
// >= limit are zeros.  A thread keeps its 16-byte chunk column and moves
// down the rows a pass at a time (a pass: as many whole rows as 128 threads
// cover; threads past them copy nothing), so a copy costs one address add.
template <int DH>
__device__ __forceinline__ void fill(uint32_t tile, const float* g, long long row_stride,
                                     int row0, int rows, int limit) {
  constexpr int kChunks = DH / 4, kPass = kThreads / kChunks, kLd = row_floats(DH);
  const int row = threadIdx.x / kChunks, col = threadIdx.x % kChunks;
  if (row >= kPass) return;
  const float* src = g + (long long)(row0 + row) * row_stride + 4 * col;
  uint32_t dst = tile + (uint32_t)(row * kLd + 4 * col) * 4u;
  for (int r = row; r < rows; r += kPass, src += kPass * row_stride, dst += kPass * kLd * 4) {
    const bool valid = row0 + r < limit;
    mma::cp_async16(dst, valid ? src : g, valid);
  }
}

// A head dim above 128 runs in panels of kPanel columns (the kernels'
// register and shared-memory footprint is one panel's, whatever the head
// dim): fill<kPanel> of panel columns [0, cols) of the matrix at g, the
// columns from cols on (cols a multiple of 4; below kPanel only in a ragged
// last panel) zeros.  `tid` is this thread's index in the 128 that copy.
constexpr int kPanel = 64;

__device__ __forceinline__ void fill_panel(int tid, uint32_t tile, const float* g,
                                           long long row_stride, int row0, int rows, int limit,
                                           int cols) {
  constexpr int kChunks = kPanel / 4, kPass = kThreads / kChunks, kLd = row_floats(kPanel);
  const int row = tid / kChunks, col = tid % kChunks;
  const float* src = g + (long long)(row0 + row) * row_stride + 4 * col;
  uint32_t dst = tile + (uint32_t)(row * kLd + 4 * col) * 4u;
  for (int r = row; r < rows; r += kPass, src += kPass * row_stride, dst += kPass * kLd * 4) {
    const bool valid = row0 + r < limit && 4 * col < cols;
    mma::cp_async16(dst, valid ? src : g, valid);
  }
}

// The columns of panel p of a head dim dh (a multiple of 8) that are real.
__host__ __device__ inline int panel_cols(int dh, int p) {
  return dh - p * kPanel < kPanel ? dh - p * kPanel : kPanel;
}

// The state of one warp's 16 query rows of head dim DH over the key blocks:
// a lane holds, for rows g = lane / 4 and g + 8 of the warp, the running
// maximum m, its share of the running sum l, and columns 8j + 2t + e of the
// output accumulator (o[j][2h + e], row g + 8h).
template <int DH>
struct Softmax {
  static_assert(DH % 8 == 0 && DH >= 8 && DH <= 128, "head dims built");
  static constexpr int kLd = row_floats(DH);
  static constexpr int kChunks = DH / 8;
  static constexpr bool kQInRegisters = DH <= 64;
  static constexpr int kKeyTiles = kKeys / 8;
  static constexpr int kGroup = kChunks < 8 ? kChunks : 8;   // B fragments live at once

  float o[kChunks][4];
  float m[2], l[2];
  FragA q[kQInRegisters ? kChunks : 1];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // The warp's Q rows at `qw` (shared, row 0 of the warp), split once.
  __device__ __forceinline__ void load_q(const float* qw) {
    if constexpr (kQInRegisters) {
      const int lane = threadIdx.x & 31;
      const float* p = qw + (lane >> 2) * kLd + (lane & 3);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) q[j] = load_a<kLd>(p + 8 * j);
    }
  }

  // One block of 64 keys starting at key k0: qw (the warp's 16 rows), kb and
  // vb (64 rows each, zeros past key S) in shared memory; c = dh^-1/2 .
  // log2(e).  The first block of a row always holds a real key, so m is
  // finite after it.
  __device__ __forceinline__ void step(const float* qw, const float* kb, const float* vb,
                                       int k0, int S, float c) {
    float s[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    add_scores<kQInRegisters>(s, qw, kb);
    update(s, vb, k0, S, c);
  }

  // The rest of a block on its scores s (add_scores'): the online softmax,
  // o scaled by alpha, then o += P.V with the V block at vb.
  __device__ __forceinline__ void update(float (&s)[kKeyTiles][4], const float* vb, int k0,
                                         int S, float c) {
    float alpha[2];
    softmax(s, k0, S, c, alpha);
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] *= alpha[i >> 1];
    pv(o, s, vb);
  }

  // s += Q.K^T of the warp's 16 rows over the DH columns of qw and kb, Q's
  // fragments from the registers load_q filled (kFromRegisters) or loaded
  // and split from qw.  B[k = d][n = key] = K[key][d], b0 (d = t), b1 (d =
  // t + 4).
  template <bool kFromRegisters>
  __device__ __forceinline__ void add_scores(float (&s)[kKeyTiles][4], const float* qw,
                                             const float* kb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* kp = kb + g * kLd + t;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      FragA a;
      if constexpr (kFromRegisters) a = q[j];
      else a = load_a<kLd>(qw + g * kLd + t + 8 * j);
      FragB b[kKeyTiles];
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n) {
        const float* p = kp + 8 * n * kLd + 8 * j;
        b[n] = load_b(p[0], p[4]);
      }
      mma3<0>(s, a, b);
    }
  }

  // The block's scores s into p = exp2(s.c - m.c) in place: keys >= S
  // masked, the running maximum m and sum l updated; alpha = exp2((m_old -
  // m).c) for each row half, what o is to be scaled by.
  __device__ __forceinline__ void softmax(float (&s)[kKeyTiles][4], int k0, int S, float c,
                                          float (&alpha)[2]) {
    const int t = threadIdx.x & 3;
    if (k0 + kKeys > S) {                      // the ragged last block
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * n + 2 * t + (i & 1) >= S) s[n][i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
    float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], mma::quad_max(mx[h]));
      alpha[h] = mma::exp2_approx((m[h] - m_new) * c);   // 0 on the first block
      m[h] = m_new;
      mc[h] = m_new * c;
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = mma::exp2_approx(fmaf(s[n][i], c, -mc[i >> 1]));
        sum[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
  }

  // d += P.V, p from softmax's s: A's k = t is key 2t (s[n][0], row g;
  // s[n][2], row g + 8), k = t + 4 key 2t + 1 (s[n][1], s[n][3]); B[k][n =
  // d] = V[key][d].
  __device__ __forceinline__ void pv(float (&d)[kChunks][4], const float (&s)[kKeyTiles][4],
                                     const float* vb) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* vp = vb + 2 * t * kLd + g;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      FragA a;
      split(s[n][0], a.hi[0], a.lo[0]);
      split(s[n][2], a.hi[1], a.lo[1]);
      split(s[n][1], a.hi[2], a.lo[2]);
      split(s[n][3], a.hi[3], a.lo[3]);
      const float* p = vp + 8 * n * kLd;
      pv_group<0>(d, a, p);
      if constexpr (kChunks > 8) pv_group<8>(d, a, p);
    }
  }

  // The output tiles j = J0 ... J0 + 7 (below kChunks) of one 8-key block
  // into d.
  template <int J0>
  __device__ __forceinline__ void pv_group(float (&d)[kChunks][4], const FragA& a,
                                           const float* p) const {
    FragB b[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup && J0 + i < kChunks; ++i)
      b[i] = load_b(p[8 * (J0 + i)], p[kLd + 8 * (J0 + i)]);
    mma3<J0>(d, a, b);
  }

  // o / l (one division, one rounding) into rows row0 + g, row0 + g + 8 of
  // `out` (row_stride floats apart) as float pairs; rows >= S are dropped,
  // and the columns from `cols` on (a multiple of 8: a ragged last panel).
  __device__ __forceinline__ void store(float* out, long long row_stride, int row0, int S,
                                        int cols = DH) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float sum[2] = {mma::quad_sum(l[0]), mma::quad_sum(l[1])};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      if (r >= S) continue;
      float* p = out + (long long)r * row_stride + 2 * t;
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
        if (8 * j < cols)
          *reinterpret_cast<float2*>(p + 8 * j) =
              make_float2(o[j][2 * h] / sum[h], o[j][2 * h + 1] / sum[h]);
    }
  }
};

// The panel kernels' CTA (a head dim above 128: csrc/attention.cu's panel
// kernels say why), for csrc/attention.cu (SM = Softmax<kPanel>) and the
// encoder (encoder_tf32.cuh's Softmax, a block's P.V into a fresh
// accumulator): 64 query rows from q0 of one (batch, head) and the 64
// columns of o panel `op`.  q, k, v and out point at row 0 of the (batch,
// head), rows qrs, krs, vrs and ors floats apart; dh a multiple of 8, the
// ragged last panel zero-filled.  Step t = j . panels + p (key block j,
// panel p) sums the scores of panel p of q and k into the block's; on the
// block's last panel SM::update takes the softmax and the V panel's P.V.
// SINGLE: every q panel, every key block's k panels and the V panel of
// each resident at once, one wait; else a ring of two stages of a q, a k
// and a V panel.
template <typename SM, bool SINGLE>
__device__ __forceinline__ void panel_cta(float* tile_mem, const float* q, long long qrs,
                                          const float* k, long long krs, const float* v,
                                          long long vrs, float* out, long long ors, int S,
                                          int q0, int dh, int op, float c) {
  constexpr int kLd = row_floats(kPanel), kTile = kKeys * kLd;
  const int panels = (dh + kPanel - 1) / kPanel;
  const int blocks = (S + kKeys - 1) / kKeys, steps = blocks * panels;
  const auto tiles_of = [&](int t, float*& qt, float*& kt, float*& vt) {
    const int j = t / panels, p = t - j * panels;
    if constexpr (SINGLE) {
      qt = tile_mem + p * kTile;
      kt = tile_mem + (panels + t) * kTile;
      vt = tile_mem + (panels + steps + j) * kTile;
    } else {
      qt = tile_mem + (t & 1) * 3 * kTile;
      kt = qt + kTile;
      vt = kt + kTile;
    }
  };
  const auto fill = [&](int t) {
    const int j = t / panels, p = t - j * panels;
    float *qt, *kt, *vt;
    tiles_of(t, qt, kt, vt);
    const int cols = panel_cols(dh, p);
    if (!SINGLE || j == 0)
      fill_panel(threadIdx.x, mma::smem_addr(qt), q + p * kPanel, qrs, q0, kRows, S, cols);
    fill_panel(threadIdx.x, mma::smem_addr(kt), k + p * kPanel, krs, j * kKeys, kKeys, S, cols);
    if (p == panels - 1)
      fill_panel(threadIdx.x, mma::smem_addr(vt), v + op * kPanel, vrs, j * kKeys, kKeys, S,
                 panel_cols(dh, op));
  };
  if constexpr (SINGLE) {
    for (int t = 0; t < steps; ++t) fill(t);
  } else {
    fill(0);
  }
  mma::cp_async_commit();

  const int row0 = q0 + 16 * (threadIdx.x >> 5);
  const bool has_rows = row0 < S;              // uniform over the warp
  SM sm;
  sm.init();
  float s[kKeys / 8][4];
  for (int t = 0; t < steps; ++t) {
    if (!SINGLE || t == 0) {
      mma::cp_async_wait<0>();                 // step t (SINGLE: every step) has landed
      __syncthreads();                         // ... for all; the other stage is free
    }
    if constexpr (!SINGLE) {
      if (t + 1 < steps) fill(t + 1);
      mma::cp_async_commit();
    }
    if (!has_rows) continue;
    const int j = t / panels, p = t - j * panels;
    float *qt, *kt, *vt;
    tiles_of(t, qt, kt, vt);
    if (p == 0) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    }
    sm.template add_scores<false>(s, qt + (row0 - q0) * kLd, kt);
    if (p == panels - 1) sm.update(s, vt, j * kKeys, S, c);
  }
  if (has_rows) sm.store(out + op * kPanel, ors, row0, S, panel_cols(dh, op));
}

}  // namespace tf32x3
