// Tensor-core tile code of the bf16 attention kernels (csrc/attention.cu) for
// NVIDIA Hopper, sm_90a: asynchronous copies into the swizzled shared-memory
// layout that a wgmma descriptor names, the wgmma products themselves, the
// online-softmax step on the accumulator fragment, and the output tile.
//
// One warpgroup (4 warps, 128 threads) owns a tile of 64 query rows and walks
// blocks of KB keys.  For one block it
//   1. takes S = Q.K^T with wgmma, A = the Q tile and B = the K block, both in
//      shared memory as they lie in device memory ((rows, dh), dh contiguous:
//      the K-major operand layout, no transpose);
//   2. keeps S in its f32 accumulator fragment, where a row lives in the four
//      lanes of a quad: masks keys >= the sequence length to -inf, updates the
//      running row maximum m and sum l, and turns S into p = exp2(S.c - m.c)
//      with c = dh^-1/2.log2(e) (the scale is applied to the f32 scores, not
//      to q);
//   3. rounds p to bf16 pairwise, which is the A fragment of the next product,
//      rescales the output accumulator by exp2((m_old - m).c) and adds P.V
//      with wgmma, A from registers and B = the V block as it lies ((keys, dh)
//      is the N-major layout of this product: the transpose bit).
// The f32 scores never touch shared memory.
//
// Shared-memory tiles.  A tile of R rows by DH columns is stored as DH / PW
// panels of PW = min(DH, 64) columns; a panel row is ROWB = 2.PW bytes (128 or
// 64) and rows follow each other without gaps.  Inside every 8-row group the
// 16-byte chunks of a row are XORed with the row index (the 128-byte or
// 64-byte swizzle of the descriptor: byte-offset bits [4, 4+b) ^= bits
// [7, 7+b)), so eight threads that fill one row, and the eight rows that one
// wgmma core matrix reads, each touch every bank once.  Tiles start at
// multiples of 1024 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;   // query rows of a warpgroup: the M of wgmma
constexpr int kThreads = 128;   // of one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory without passing registers;
// with `valid`, zeros instead when it is false (src must still be an address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Orders this thread's completed shared-memory writes before later reads by
// the tensor cores (the asynchronous proxy).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving a use of an accumulator across the wait
// that completes it.
template <int N>
__device__ __forceinline__ void fence_registers(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define F4(d, i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define F16(d, i) F4(d, i), F4(d, (i) + 4), F4(d, (i) + 8), F4(d, (i) + 12)

// D[64 x 64] = (acc ? D : 0) + A[64 x 16] (shared, K-major) . B[64 x 16]^T (shared,
// K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 128] = (acc ? D : 0) + A[64 x 16] (shared, K-major) . B[128 x 16]^T (shared,
// K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 32] += A[64 x 16] (registers) . B[16 x 32] (shared, N-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(d, 0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (shared, N-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef F16
#undef F4

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Geometry of the tiles of head dim DH (32, 64 or 128).
template <int DH>
struct Tile {
  static_assert(DH == 32 || DH == 64 || DH == 128, "head dims the tiles take");
  static constexpr int kPanelCols = DH < 64 ? DH : 64;
  static constexpr int kPanels = DH / kPanelCols;
  static constexpr int kRowBytes = kPanelCols * 2;            // 64 or 128
  static constexpr int kChunks = kRowBytes / 16;              // chunks a panel row
  static constexpr int kGroupBytes = 8 * kRowBytes;           // one 8-row group
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;   // swizzle mode

  __host__ __device__ static constexpr int bytes(int rows) { return rows * DH * 2; }

  // Byte offset of chunk `c` of row `r` inside a panel.
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t o = r * kRowBytes + c * 16;
    return o ^ (((o >> 7) & (kChunks - 1)) << 4);
  }

  // Descriptor of an operand that starts at shared address `addr`: 8-row
  // groups kGroupBytes apart; the leading offset is `lead` (read only when an
  // N-major operand spans panels).
  __device__ static __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead) {
    return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lead >> 4) << 16)
           | ((uint64_t)(kGroupBytes >> 4) << 32) | (kLayout << 62);
  }

  // Rows [row0, row0 + ROWS) of a matrix whose row 0 is `g` and whose rows are
  // row_stride elements apart, into the ROWS-row tile at `tile`, by the CTA's
  // NT threads; rows >= limit are zeros.  A thread keeps its chunk column and
  // moves down the rows a pass at a time: a pass is a multiple of 8 rows, so
  // the swizzle of its chunk never changes and a copy costs one address add.
  template <int ROWS, int NT>
  __device__ static __forceinline__ void fill(uint32_t tile, const bf16* g,
                                              long long row_stride, int row0, int limit) {
    constexpr int kRowChunks = DH / 8;
    constexpr int kPass = NT / kRowChunks;      // rows a pass
    static_assert(NT % kRowChunks == 0 && kPass % 8 == 0 && ROWS % kPass == 0,
                  "a pass is whole 8-row groups and a tile whole passes");
    const int r = threadIdx.x / kRowChunks, c = threadIdx.x % kRowChunks;
    const int p = c / kChunks, cc = c % kChunks;
    const uint32_t dst = tile + p * ROWS * kRowBytes + offset(r, cc);
    const bf16* src = g + (long long)(row0 + r) * row_stride + c * 8;
    if (row0 + ROWS <= limit) {                 // uniform over the CTA
#pragma unroll
      for (int i = 0; i < ROWS / kPass; ++i) {
        cp_async16(dst + i * kPass * kRowBytes, src);
        src += kPass * row_stride;
      }
    } else {
      const int left = limit - row0 - r;        // this thread's rows in range
#pragma unroll
      for (int i = 0; i < ROWS / kPass; ++i) {
        const bool valid = i * kPass < left;
        cp_async16(dst + i * kPass * kRowBytes, valid ? src : g, valid);
        src += kPass * row_stride;
      }
    }
  }
};

// The state of one warpgroup's 64 query rows over the key blocks: a thread
// holds, for rows lane / 4 and lane / 4 + 8 of its warp's 16 rows, the running
// maximum m, its share of the running sum l, and its columns of the output
// accumulator o (per panel: column 8j + 2(lane % 4) + e of row half h is
// o[4j + 2h + e]).
template <int DH, int KB>
struct Softmax {
  static_assert(KB == 64 || KB == 128, "key blocks the tiles take");
  using T = Tile<DH>;
  static constexpr int kScoreRegs = KB / 2;
  static constexpr int kOutRegs = T::kPanelCols / 2;

  float o[T::kPanels][kOutRegs];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < kOutRegs; ++i) o[p][i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // One block of KB keys starting at key k0: q_tile (64 rows), k_tile and
  // v_tile (KB rows, zeros past key S) are shared addresses of filled tiles;
  // c = dh^-1/2 . log2(e).  The first block of a row always holds a real key,
  // so m is finite after it.
  __device__ __forceinline__ void step(uint32_t q_tile, uint32_t k_tile, uint32_t v_tile,
                                       int k0, int S, float c) {
    float s[kScoreRegs];
    scores(s, q_tile, k_tile, 0);
    update(s, v_tile, k0, S, c);
  }

  // s = (acc ? s : 0) + Q.K^T over the DH columns of q_tile and k_tile, in
  // one chain of wgmma (a head dim in panels adds its panels' scores so).
  __device__ __forceinline__ void scores(float (&s)[kScoreRegs], uint32_t q_tile,
                                         uint32_t k_tile, int acc) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int p = ks / (T::kPanelCols / 16), kk = ks % (T::kPanelCols / 16);
      const uint64_t a = T::descriptor(q_tile + p * kTileRows * T::kRowBytes + kk * 32, 16);
      const uint64_t b = T::descriptor(k_tile + p * KB * T::kRowBytes + kk * 32, 16);
      if constexpr (KB == 128) wgmma_ss_n128(s, a, b, acc | (ks != 0));
      else wgmma_ss_n64(s, a, b, acc | (ks != 0));
    }
    wgmma_commit();
    wgmma_wait();
    fence_registers(s);
  }

  // The rest of a block on its scores s: the mask, m, l, p, o rescaled and
  // o += P.V with the V block at v_tile.
  __device__ __forceinline__ void update(float (&s)[kScoreRegs], uint32_t v_tile, int k0, int S,
                                         float c) {
    const int t = threadIdx.x & 3;
    if (k0 + KB > S) {                         // the ragged last block
#pragma unroll
      for (int i = 0; i < kScoreRegs; ++i)
        if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kScoreRegs; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = exp2_approx((m[h] - m_new) * c);      // 0 on the first block
      m[h] = m_new;
      mc[h] = m_new * c;
    }
    uint32_t pa[kScoreRegs / 2];               // p as bf16 pairs: the A fragments
#pragma unroll
    for (int r = 0; r < kScoreRegs / 2; ++r) {
      const float e0 = exp2_approx(fmaf(s[2 * r], c, -mc[r & 1]));
      const float e1 = exp2_approx(fmaf(s[2 * r + 1], c, -mc[r & 1]));
      sum[r & 1] += e0 + e1;
      pa[r] = pack_bf16(e0, e1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < kOutRegs; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      fence_registers(o[p]);
    }

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p) {
        const uint64_t b = T::descriptor(
            v_tile + p * KB * T::kRowBytes + ks * 16 * T::kRowBytes, KB * T::kRowBytes);
        const uint32_t a0 = pa[4 * ks], a1 = pa[4 * ks + 1], a2 = pa[4 * ks + 2],
                       a3 = pa[4 * ks + 3];
        if constexpr (T::kPanelCols == 64) wgmma_rs_n64(o[p], a0, a1, a2, a3, b);
        else wgmma_rs_n32(o[p], a0, a1, a2, a3, b);
      }
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) fence_registers(o[p]);
  }

  // Two warpgroups that took different keys of the same 64 rows: one leaves
  // its state in `scratch` (kStateFloats x 128 floats, thread-minor), the
  // other folds it in.  A warpgroup that saw no key (m = -inf, l = 0) adds
  // nothing; the one that merges has seen a real key.
  static constexpr int kStateFloats = T::kPanels * kOutRegs + 4;

  __device__ __forceinline__ void spill(float* scratch) const {
    float* at = scratch + (threadIdx.x & (kThreads - 1));
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < kOutRegs; ++i) at[(p * kOutRegs + i) * kThreads] = o[p][i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      at[(T::kPanels * kOutRegs + h) * kThreads] = m[h];
      at[(T::kPanels * kOutRegs + 2 + h) * kThreads] = l[h];
    }
  }

  __device__ __forceinline__ void merge(const float* scratch, float c) {
    const float* at = scratch + (threadIdx.x & (kThreads - 1));
    float mine[2], theirs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m2 = at[(T::kPanels * kOutRegs + h) * kThreads];
      const float l2 = at[(T::kPanels * kOutRegs + 2 + h) * kThreads];
      const float m_new = fmaxf(m[h], m2);
      mine[h] = exp2_approx((m[h] - m_new) * c);
      theirs[h] = exp2_approx((m2 - m_new) * c);
      m[h] = m_new;
      l[h] = l[h] * mine[h] + l2 * theirs[h];
    }
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < kOutRegs; ++i)
        o[p][i] = o[p][i] * mine[(i >> 1) & 1]
                  + at[(p * kOutRegs + i) * kThreads] * theirs[(i >> 1) & 1];
  }

  // o / l, rounded to bf16 once, through the warp's own 16 rows of the tile at
  // `tile` (generic pointer `tile_ptr`, the Q tile: no product reads it any
  // more) and out as 16-byte vectors; rows >= S are dropped.  `out` is row 0
  // of this (batch, head); q0 the tile's first row.
  __device__ __forceinline__ void store(unsigned char* tile_ptr, bf16* out,
                                        long long row_stride, int q0, int S) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / quad_sum(l[h]);
      const int r = warp * 16 + g + 8 * h;
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
        for (int j = 0; j < kOutRegs / 4; ++j)
          *reinterpret_cast<uint32_t*>(tile_ptr + p * kTileRows * T::kRowBytes
                                       + T::offset(r, j) + 4 * t) =
              pack_bf16(o[p][4 * j + 2 * h] * inv, o[p][4 * j + 2 * h + 1] * inv);
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
};

}  // namespace mma
