// The float32 products of kernels 1 and 2 at the residual widths past the
// resident form ("tf32x3", Plan.ln "prenormed": ViT-L's D 1024, ViT-H's
// 1280, Model A) for NVIDIA Hopper, sm_90a: csrc/vit_encoder.cu launches
// encoder_mma.cuh's ln_rows_kernel<float, RPW> (the LN rows written once,
// float32) before qkv and before mlp1, then every product of the block here,
// ring_product_kernel<NC, BN, KSPLIT>.  It replaces, for those widths, the
// streamed form of encoder_tf32.cuh (a statistics launch, then every column
// CTA normalising and splitting its 64 rows again, on mma.sync, each chunk
// copied by the threads that multiply it), which ran at 12-18 % of its
// split-TF32 bound on an H100 (PERF.md).
//
// C[M, N] = epilogue(A[M, K] . W[K, N] + bias): A the LN rows, the
// attention's output or the MLP's hidden rows (plain float32), W one block's
// kernel as two TF32 planes, hi then lo, each stored transposed ((N, K),
// K-major: wgmma takes TF32 operands K-major only), split once a parameter
// set by the operand cache (ops/vit_block.py).  A CTA is a producer
// warpgroup and NC consumer warpgroups; it persists over the output tiles i,
// i + gridDim.x, ... (columns fastest).  The producer's one thread keeps TMA
// copies of the next 32-deep chunks in flight through a ring of kStages
// stages, each the chunk of A (a 128-byte row of floats a row, the 128-byte
// swizzle) and the chunk of both W planes (BN rows of 128 bytes each), with
// a full barrier (the copy's bytes) and an empty one (one arrival from each
// consumer warp that read it).  A consumer owns 64 rows by BN columns: it
// loads its A fragments from the stage, splits each element into TF32 hi
// and lo in registers (tf32x3::split, once a CTA: the tile's columns share
// them), and runs the products on wgmma m64nNk8 with A from registers and B
// (a W plane) from shared memory.  Rows past M and columns past K or N
// arrive as zeros (TMA's out-of-bound fill), which add exactly.
//
// Every output is the streamed form's bit for bit (encoder_tf32.cuh's
// product_kernel, the same sums in the same order): each 8-deep step is
// three TF32 products, lo.hi, hi.lo, then hi.hi, into the chunk's even or
// odd fresh accumulator (a wgmma k-step is an mma.sync k-step's sum, bit for
// bit: panel_tf32.cuh), and after each chunk acc = acc + (even + odd) in
// f32; with KSPLIT (the plan's two warpgroups at an N tile of 16 or 32:
// batch 1, where such a product has few tiles and a long K) both consumers
// hold the same 64 rows, consumer w takes the chunks w, w + 2, ... and the
// second's sums are added to the first's at the end; the epilogue is the
// streamed form's (bias in f32, then the tanh GELU, or the residual in
// place).  A fresh
// accumulator's first product overwrites it (scale-d 0) where mma.sync added
// to zeros: the two differ only in the sign of a zero sum, which the chunk's
// and the tile's sums (from +0) give up.
//
// The shapes (Plan.tiles, Plan.warpgroups):
//   NC 2, BN 128 (tile 128): CTAs of 128 rows by 128 columns, the two
//     consumers sharing each W chunk, one CTA an SM (batch 16: 48 KB a
//     stage for 3.1 MFLOP, where the 64 x 64 tiles of the streamed form
//     moved twice the bytes a FLOP); a consumer's 128 columns are two
//     64-column chains that take the A fragments in turn.
//   NC 1, BN 16 / 32 / 64: CTAs of 64 rows, two an SM (batch 1: the grid
//     fills the card only with small tiles).
//   NC 2 with KSPLIT, BN 16 / 32: 64 rows, K dealt to the two consumers,
//     two CTAs an SM.
// What bounds them on the H100 (495 TFLOP/s TF32, three products a product;
// 3.35 TB/s): the operations at batch 16 (406.7 GFLOP a block at (16, 320,
// 1024): 821.6 us), the operations again at batch 1 (48.8 us a ViT-L
// block; its 100.7 MB of weight planes take 30 us from device memory).
// What holds them is what reaches each SM's shared memory from L2 (about 6
// GB a block at batch 16; at batch 1 every 64-row tile reads the whole
// weight again): with the products cut out of the build most of the time
// remains (profile_encoder.py cut, PERF.md).  A wider stage a FLOP did not
// pay: A read as two planes (the split gone) gained 3 % at batch 16 and lost
// 3 % at batch 1, 128-row CTAs at batch 1 leave most SMs idle, and each W
// chunk multicast to a cluster of row tiles ran slower than without.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "attention_tf32.cuh"
#include "encoder_mma.cuh"
#include "panel_ring.cuh"

namespace tf32_ring {

namespace tf = tf32x3;

constexpr int kChunk = 32;        // K a chunk: one 128-byte row of floats
constexpr int kRows = 64;         // rows a consumer warpgroup
constexpr int kWarpgroup = 128;
constexpr int kTwoCtaBytes = 115712;   // panel::kTwoCtaBytes: each of two CTAs an SM
constexpr int kOneCtaBytes = 232448;   // the H100's opt-in bytes a block
constexpr int kMaxStages = 16;

// Geometry of ring_product_kernel<NC, BN, KSPLIT> (ops/vit_block.py mirrors
// it in ln_smem_bytes): a stage is the A chunk (the tile's rows x 128
// bytes) and the two W planes' chunk (BN rows x 128 bytes each), 1024-byte
// aligned; as many stages as the CTA's share of an SM holds, then a full and
// an empty barrier a stage and (KSPLIT) the second consumer's sums.
template <int NC, int BN, bool KSPLIT>
struct Ring {
  static_assert((NC == 1 && !KSPLIT && (BN == 16 || BN == 32 || BN == 64))
                    || (NC == 2 && KSPLIT && (BN == 16 || BN == 32))
                    || (NC == 2 && !KSPLIT && BN == 128),
                "the ring's builds");
  static constexpr int kTileRows = KSPLIT ? kRows : NC * kRows;
  static constexpr int kABytes = kTileRows * kChunk * 4;
  static constexpr int kPlaneBytes = BN * kChunk * 4;
  static constexpr int kStageBytes = kABytes + 2 * kPlaneBytes;
  static constexpr int kCtasPerSm = NC == 1 || KSPLIT ? 2 : 1;
  static constexpr int kThreads = (NC + 1) * kWarpgroup;
  static constexpr int kScratchBytes = KSPLIT ? kRows * BN * 4 : 0;
  static constexpr int kFit = ((kCtasPerSm == 2 ? kTwoCtaBytes : kOneCtaBytes)
                               - encoder_mma::kAlign - kScratchBytes) / (kStageBytes + 16);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // setmaxnreg: the producer's registers to the consumers (the launch gives
  // 168 a thread at one CTA of three warpgroups an SM, 128 at two of two,
  // 80 at two of three).
  static constexpr int kProducerRegs = kThreads == 384 && kCtasPerSm == 2 ? 24 : 40;
  static constexpr int kConsumerRegs =
      kCtasPerSm == 1 ? 232 : kThreads == 256 ? 216 : 104;
  static constexpr size_t smem_bytes() {
    return (size_t)encoder_mma::kAlign + (size_t)kStages * kStageBytes + 16 * kStages
           + kScratchBytes;
  }
};

#define RT_F4(d, j) "+f"(d[4 * (j)]), "+f"(d[4 * (j) + 1]), "+f"(d[4 * (j) + 2]), \
                    "+f"(d[4 * (j) + 3])

// D[64 x N] (scale_d ? D : 0) += A[64 x 8] (registers: a warp's 16 rows,
// lane (g, t): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4))
// . B[N x 8]^T (shared, K-major, the 128-byte swizzle); D as mma.sync's
// accumulators, d[4j + i] columns 8j .. 8j + 7.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : RT_F4(d, 0), RT_F4(d, 1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : RT_F4(d, 0), RT_F4(d, 1), RT_F4(d, 2), RT_F4(d, 3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : RT_F4(d, 0), RT_F4(d, 1), RT_F4(d, 2), RT_F4(d, 3), RT_F4(d, 4), RT_F4(d, 5),
        RT_F4(d, 6), RT_F4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef RT_F4

// Descriptor of a K-major operand at shared address `addr`: rows of 128
// bytes with the 128-byte swizzle, 8-row groups 1024 bytes apart
// (panel_tf32.cuh's, mma::Tile<64>'s geometry).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return mma::Tile<64>::descriptor(addr, 16);
}

// x as its TF32 parts hi + lo (tf32x3::split): an A fragment's element.
__device__ __forceinline__ void split_a(float x, uint32_t& hi, uint32_t& lo) {
  tf::split(x, hi, lo);
}

// One 8-deep step of the split product into d: lo.hi, hi.lo, then hi.hi,
// the B operand's hi plane at shared address b and its lo plane `plane`
// bytes on; scale_d 0: the step's first product overwrites d (a fresh
// accumulator's first step).
template <int N>
__device__ __forceinline__ void step3(float (&d)[N / 2], const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], uint32_t b, uint32_t plane,
                                      int scale_d) {
  wgmma_tf32<N>(d, lo, descriptor(b), scale_d);
  wgmma_tf32<N>(d, hi, descriptor(b + plane), 1);
  wgmma_tf32<N>(d, hi, descriptor(b), 1);
}

// Named barriers of the two consumers of a KSPLIT CTA (0 is __syncthreads).
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(2 * kWarpgroup) : "memory");
}
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(2 * kWarpgroup) : "memory");
}

// A: a_map's (M, K) rows in boxes of 32 columns by the tile's rows; W: layer
// `layer` of w_map's (depth, 2, N, K) planes in boxes of 32 x BN x 2; C: (M,
// N), which may alias the residual (epi == kEpiResidual reads C before
// writing it, element by element in the same thread).  K and N multiples of
// 8; epi one of encoder_mma's Epilogue.
template <int NC, int BN, bool KSPLIT>
__global__ void __launch_bounds__(Ring<NC, BN, KSPLIT>::kThreads, Ring<NC, BN, KSPLIT>::kCtasPerSm)
ring_product_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap w_map, int layer,
                    const float* __restrict__ bias, float* C, int M, int N, int K, int epi) {
  using R = Ring<NC, BN, KSPLIT>;
  constexpr int S = R::kStages;
  constexpr int kChainCols = BN < 64 ? BN : 64;   // a wgmma's N
  constexpr int kChains = BN / kChainCols;
  constexpr int kRegs = kChainCols / 2;           // accumulators a thread a chain
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* base = encoder_mma::aligned_smem(raw);
  const uint32_t ring = mma::smem_addr(base);
  const uint32_t bars = ring + S * R::kStageBytes;
  float* scratch = reinterpret_cast<float*>(base + S * R::kStageBytes + 16 * S);
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (S + s); };
  const int chunks = (K + kChunk - 1) / kChunk, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + R::kTileRows - 1) / R::kTileRows);
  const int wg = threadIdx.x / kWarpgroup;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      panel::mbar_init(full(s), 1);
      panel::mbar_init(empty(s), KSPLIT ? 4 : NC * 4);   // each consumer warp that reads it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {                             // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R::kProducerRegs));
    if (threadIdx.x == NC * kWarpgroup) {
      for (int t = blockIdx.x, g = 0; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * R::kTileRows, n0 = t % tiles_n * BN;
        for (int c = 0; c < chunks; ++c, ++g) {
          const int s = g % S;
          if (g >= S) panel::mbar_wait(empty(s), (g / S - 1) & 1);
          panel::mbar_expect_tx(full(s), R::kStageBytes);
          const uint32_t stage = ring + s * R::kStageBytes;
          panel::tma_load(stage, &a_map, full(s), c * kChunk, m0);
          panel::tma_load(stage + R::kABytes, &w_map, full(s), c * kChunk, n0, 0, layer);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R::kConsumerRegs));
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row_base = KSPLIT ? 0 : wg * kRows;   // this consumer's rows in the tile
  // Byte of this thread's element (row 16 warp + g, column t) in a stage's A
  // chunk, before the swizzle of its 16-byte quad.
  const int a_off = (row_base + 16 * warp + g8) * 128 + 4 * t4;
  for (int t = blockIdx.x, gbase = 0, done = 0; t < tiles;
       t += gridDim.x, gbase += chunks, ++done) {
    float acc[kChains][kRegs];
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
      for (int i = 0; i < kRegs; ++i) acc[ch][i] = 0.f;

    for (int c = KSPLIT ? wg : 0; c < chunks; c += KSPLIT ? 2 : 1) {
      const int g = gbase + c, s = g % S;
      panel::mbar_wait(full(s), (g / S) & 1);
      // The A fragments of the chunk's four 8-deep steps, split: step kk's
      // columns 8kk + t (quad 2kk) and 8kk + t + 4 (quad 2kk + 1) of rows g
      // and g + 8, each quad at its swizzled place in its 128-byte row.
      const unsigned char* a = base + s * R::kStageBytes + a_off;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sw = (((2 * kk + h) ^ g8) & 7) << 4;
          split_a(*reinterpret_cast<const float*>(a + sw), hi[kk][2 * h], lo[kk][2 * h]);
          split_a(*reinterpret_cast<const float*>(a + 8 * 128 + sw), hi[kk][2 * h + 1],
                  lo[kk][2 * h + 1]);
        }
      const uint32_t w = ring + s * R::kStageBytes + R::kABytes;
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) {
        // The chunk's even and odd steps into fresh accumulators (steps 0
        // and 1 overwrite them), each step lo.hi, hi.lo, hi.hi.
        float part[2][kRegs];
        mma::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          step3<kChainCols>(part[kk & 1], hi[kk], lo[kk], w + ch * kChainCols * 128 + kk * 32,
                            R::kPlaneBytes, kk >= 2);
        mma::wgmma_commit();
        mma::wgmma_wait();
        mma::fence_registers(part[0]);
        mma::fence_registers(part[1]);
        if (ch == kChains - 1) {              // the stage is read out, as far as this warp goes
          __syncwarp();
          if (lane == 0) panel::mbar_arrive(empty(s));
        }
#pragma unroll
        for (int i = 0; i < kRegs; ++i) acc[ch][i] += part[0][i] + part[1][i];
      }
    }

    if constexpr (KSPLIT) {                   // the second consumer's sums to the first
      float* spill = scratch + (threadIdx.x & (kWarpgroup - 1));
      if (wg == 1) {
        if (done > 0) consumers_sync(2);      // the first has read the last tile's
#pragma unroll
        for (int i = 0; i < kRegs; ++i) spill[i * kWarpgroup] = acc[0][i];
        consumers_arrive(1);
        continue;
      }
      consumers_sync(1);
#pragma unroll
      for (int i = 0; i < kRegs; ++i) acc[0][i] += spill[i * kWarpgroup];
      if (t + (int)gridDim.x < tiles) consumers_arrive(2);
    }

    // Epilogue: rows g and g + 8 of the warp's 16 and, a chain, columns 8j +
    // 2t and 8j + 2t + 1 (product_kernel's, encoder_tf32.cuh).
    const int m0 = t / tiles_n * R::kTileRows + row_base, n0 = t % tiles_n * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + g8 + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
        for (int j = 0; j < kRegs / 4; ++j) {
          const int col = n0 + ch * kChainCols + 8 * j + 2 * t4;
          if (col >= N) continue;
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
          float v0 = acc[ch][4 * j + 2 * h] + bb.x, v1 = acc[ch][4 * j + 2 * h + 1] + bb.y;
          if (epi == encoder_mma::kEpiGelu) {
            v0 = encoder_mma::gelu_tanh(v0);
            v1 = encoder_mma::gelu_tanh(v1);
          }
          float2* out = reinterpret_cast<float2*>(C + (size_t)row * N + col);
          if (epi == encoder_mma::kEpiResidual) {
            const float2 xr = *out;
            v0 = xr.x + v0;
            v1 = xr.y + v1;
          }
          *out = make_float2(v0, v1);
        }
    }
  }
}

}  // namespace tf32_ring
