// The float32 panel attention above a head dim of 128 ("tf32x3" in panels)
// for NVIDIA Hopper, sm_90a: attention.cu's attention_panels_tf32_kernel<G>
// (kernels 3 and 4) and encoder_tf32.cuh's attention_panels_kernel<G> (the
// attention stage of kernels 1 and 2) run one CTA routine, walk<G, FRESH>.
//
// A CTA is a consumer warpgroup and one or two producer warpgroups.  The
// consumer (warpgroup 0) owns 64 query rows (16 a warp) and G 64-column
// panels of o in its registers.  The producers (warpgroup 1, and 2 where
// the consumer's registers leave room: the loads in turn) copy, each load a
// 64 x 64 panel read with plain 16-byte loads from device memory, split and
// stored: first the CTA's q, all P = ceil(dh / 64) panels of its 64 rows,
// which stay resident for the whole key walk (up to kMaxResidentPanels;
// above that each q panel comes through the ring before its k panel, block
// by block); then,
// in the order the consumer takes them, the panels of every key block (its
// P k panels: the scores need the whole head dim; its G v panels: the
// CTA's own) through a ring of R stages of one panel each, each producer's
// reads of its next load in flight while it stores the current one.  Each
// block's scores are thus taken once a CTA, dh / (64 G) times in all, where
// the design before this one (a CTA a panel of o) took them P times and
// copied and split q again at every step.
//
// Both products run on wgmma with TF32 operands, three a product (split
// TF32, attention_tf32.cuh's header): lo.hi, hi.lo, then hi.hi into one
// float32 accumulator, A from registers, B from shared memory.  The
// producers split each k and v element into its TF32 hi and lo parts once
// a CTA as they store it (not once a warp), into two planes in the K-major
// layout wgmma reads: rows of 32 floats (128 bytes) with the 128-byte
// swizzle, a 64-column panel two such sub-panels of 64 rows
// (mma::Tile<64>'s bf16 geometry: the same bytes a row).
//   k panel: row = key, K = the panel's 64 head-dim columns;
//   v panel: stored transposed, row = head-dim column d (the N of P.V), K
//     = the block's 64 keys, each 8-key group in the order 0, 2, 4, 6, 1,
//     3, 5, 7: the scores' accumulator gives a lane keys 2t and 2t + 1 of
//     each group, which as P.V's A fragment are its k = t and t + 4, so p
//     goes from the accumulator into the product as it lies (the order
//     attention_tf32.cuh's mma.sync P.V used).
//   q panel, as float32 (the consumer splits its A fragments as it loads
//     them): warp w, 8-column chunk j, lane (g, t): [Q[16w + g][8j + t],
//     Q[16w + g + 8][8j + t], Q[16w + g][8j + t + 4], Q[16w + g + 8][8j +
//     t + 4]] at ((w . 8 + j) . 32 + lane) . 16 bytes: one 16-byte load a
//     lane gives the A fragment of a k-step.
// A stage is a k or v panel's two planes, 32 KB; a q panel 16 KB; rows past
// S and columns past dh arrive as zeros.
//
// Each stage has a full barrier (one arrival from each thread of the
// producer that filled it, after its stores and a proxy fence: the tensor
// cores read what plain stores wrote) and an empty one (one arrival from
// each consumer warp once
// the products that read the stage are complete); the consumer waits only
// for the stage it is about to read, so no step stops the CTA.  One CTA an
// SM (two need more shared memory than an SM has once q is resident), so
// the ring takes what q leaves of the card's opt-in bytes, up to two key
// blocks' loads; the single kernel's form is a ring of every load of the
// walk.
//
// Each thread's sums are those of attention_tf32.cuh's mma.sync tiles in
// their order: a block's scores summed over the panels 0 .. P - 1 and each
// panel's 8-column k-steps in order; the online softmax of
// tf32x3::Softmax; P.V over the block's 8-key groups in order into o (the
// attention: o scaled by alpha first) or into a fresh accumulator a block
// (FRESH, the encoder: o = o . alpha + PV, one fma).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attention_tf32.cuh"
#include "panel_ring.cuh"

namespace tf32_panels {

namespace tf = tf32x3;

constexpr int kRows = 64;                              // query rows a CTA
constexpr int kKeys = 64;                              // keys a block
constexpr int kCols = 64;                              // columns a panel
constexpr int kConsumer = 128;                         // warpgroup 0
constexpr int kProducer = 128;                         // each producer warpgroup

// Producer warpgroups of a CTA at G panels of o (FRESH: the encoder's fresh
// P.V sum): two where the consumer needs at most kConsumerRegs registers
// (o, the scores and a k-step batch's A fragments), so that the loads keep
// up with it (one producer measured the bound: the products cut out of the
// build, the time stayed; its stores cut out, it fell), else one and the
// consumer takes every register the launch gives (255).
__host__ __device__ constexpr int producers(int group, bool fresh) {
  return group + (fresh ? 1 : 0) <= 2 ? 2 : 1;
}
__host__ __device__ constexpr int threads(int group, bool fresh) {
  return kConsumer + producers(group, fresh) * kProducer;
}
// With two producers, registers a thread after setmaxnreg (168 at the
// launch of 384 threads): the producers' 144 leave the consumer 208.
constexpr int kProducerRegs = 144, kConsumerRegs = 208;
constexpr int kMaxGroup = 4;                           // panels of o a CTA
constexpr int kMaxResidentPanels = 8;                  // q resident up to dh 512
constexpr int kAlign = 1024;                           // of the stages; slack for the base
constexpr uint32_t kStageBytes = 32768;                // a k or v panel's hi and lo planes
constexpr uint32_t kPlaneBytes = 16384;                // one plane: two 64 x 128-byte sub-panels
constexpr uint32_t kQPanelBytes = 16384;               // a q panel: 64 x 64 x 4
static_assert(kStageBytes == 2 * kPlaneBytes && kPlaneBytes == kKeys * kCols * 4
              && kQPanelBytes == kRows * kCols * 4, "panels");

__host__ __device__ constexpr bool q_resident(int panels) {
  return panels <= kMaxResidentPanels;
}

// The ring's loads of one key block: its P k panels (each after its q
// panel where q is not resident), then the G v panels.
__host__ __device__ constexpr int block_loads(int panels, int group) {
  return (q_resident(panels) ? panels : 2 * panels) + group;
}

// Dynamic shared memory of a CTA with a ring of `stages`: slack to a
// 1024-byte boundary, the resident q panels, the stages, then q's barrier
// and a full and an empty barrier a stage.
__host__ __device__ constexpr size_t smem_bytes(int panels, int stages) {
  return kAlign + (q_resident(panels) ? (size_t)panels * kQPanelBytes : 0)
         + (size_t)stages * kStageBytes + 8 * (1 + 2 * (size_t)stages);
}

// The flash ring at `panels` and G = `group`: as many stages as `optin`
// bytes hold beside q, up to two key blocks' loads; 0 if fewer than two fit
// (the consumer holds a q and a k panel at once where q is not resident).
__host__ __device__ inline int ring_stages(int panels, int group, size_t optin) {
  const size_t fixed = smem_bytes(panels, 0), per = kStageBytes + 16;
  if (fixed + 2 * per > optin) return 0;
  const int fit = (int)((optin - fixed) / per), want = 2 * block_loads(panels, group);
  return fit < want ? fit : want;
}

// ---------------------------------------------------------------------------
// A producer: one panel's 64 rows x 64 columns as eight float4 a thread of
// its warpgroup (`tid` its index there), read from device memory (fetch_*),
// then split and stored (store_*).  g: the panel's column 0 of row 0 of the
// (batch, head); rows rs floats apart; rows row0 .. row0 + 63; rows >= S
// and columns >= cols (a multiple of 8) zeros.
// ---------------------------------------------------------------------------

constexpr int kFetch = kRows * kCols / 4 / 128;        // float4 a thread: 8

__device__ __forceinline__ float4 load4(const float* p, bool valid) {
  return valid ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Row i / 16, column quad i % 16 (q and k: a warp reads two whole rows).
__device__ __forceinline__ void fetch_rows(int tid, float4 (&x)[kFetch], const float* g,
                                           long long rs, int row0, int S, int cols) {
#pragma unroll
  for (int it = 0; it < kFetch; ++it) {
    const int i = tid + 128 * it, r = i >> 4, k = i & 15;
    x[it] = load4(g + (long long)(row0 + r) * rs + 4 * k, row0 + r < S && 4 * k < cols);
  }
}

// Key i % 64, column quad i / 64 (v: a warp's lanes are 32 keys of one
// column quad, so each of its transposed stores is one 128-byte row).
__device__ __forceinline__ void fetch_keys(int tid, float4 (&x)[kFetch], const float* g,
                                           long long rs, int row0, int S, int cols) {
#pragma unroll
  for (int it = 0; it < kFetch; ++it) {
    const int i = tid + 128 * it, r = i & 63, c = i >> 6;
    x[it] = load4(g + (long long)(row0 + r) * rs + 4 * c, row0 + r < S && 4 * c < cols);
  }
}

// Byte offset of float `col` (0 .. 31) of row `row` in a 64-row sub-panel of
// 128-byte rows with the 128-byte swizzle (mma::Tile<64>::offset's).
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// q in fragment order, as float32 (fetch_rows' items).
__device__ __forceinline__ void store_q(int tid, const float4 (&x)[kFetch], float* dst) {
#pragma unroll
  for (int it = 0; it < kFetch; ++it) {
    const int i = tid + 128 * it, r = i >> 4, k = i & 15;
    // Row r = 16w + g + 8h, columns 8j + 4e + t (t = 0 .. 3): lane 4g + t,
    // fragment register h + 2e.
    float* p = dst + ((((r >> 4) * 8 + (k >> 1)) * 32 + 4 * (r & 7)) * 4 + ((r >> 3) & 1)
                      + 2 * (k & 1));
    p[0] = x[it].x;
    p[4] = x[it].y;
    p[8] = x[it].z;
    p[12] = x[it].w;
  }
}

// x = hi + lo: tf32x3::split, as floats.
__device__ __forceinline__ float4 split4(const float4& x, float4& lo) {
  uint32_t h[4], l[4];
  tf::split(x.x, h[0], l[0]);
  tf::split(x.y, h[1], l[1]);
  tf::split(x.z, h[2], l[2]);
  tf::split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

// A k panel's hi and lo planes (fetch_rows' items): row = key.
__device__ __forceinline__ void store_k(int tid, const float4 (&x)[kFetch], unsigned char* dst) {
#pragma unroll
  for (int it = 0; it < kFetch; ++it) {
    const int i = tid + 128 * it, r = i >> 4, k = i & 15;
    const uint32_t at = (k >> 3) * (kPlaneBytes / 2) + swizzled(r, 4 * (k & 7));
    float4 lo;
    const float4 hi = split4(x[it], lo);
    *reinterpret_cast<float4*>(dst + at) = hi;
    *reinterpret_cast<float4*>(dst + kPlaneBytes + at) = lo;
  }
}

// A v panel's hi and lo planes, transposed (fetch_keys' items): row = head-
// dim column d, K = key r at position (r & 24) | 4 (r & 1) | (r & 7) / 2 of
// its sub-panel r / 32.
__device__ __forceinline__ void store_v(int tid, const float4 (&x)[kFetch], unsigned char* dst) {
#pragma unroll
  for (int it = 0; it < kFetch; ++it) {
    const int i = tid + 128 * it, r = i & 63, c = i >> 6;
    const int col = (r & 24) | ((r & 1) << 2) | ((r & 7) >> 1);
    const uint32_t sub = (r >> 5) * (kPlaneBytes / 2);
    float4 lo;
    const float4 hi = split4(x[it], lo);
    const float h4[4] = {hi.x, hi.y, hi.z, hi.w}, l4[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t at = sub + swizzled(4 * c + e, col);
      *reinterpret_cast<float*>(dst + at) = h4[e];
      *reinterpret_cast<float*>(dst + kPlaneBytes + at) = l4[e];
    }
  }
}

// ---------------------------------------------------------------------------
// The consumer: wgmma m64n64k8 with TF32 operands, A from registers.
// ---------------------------------------------------------------------------

// Descriptor of a K-major operand at shared address `addr` in a sub-panel of
// 128-byte swizzled rows (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return mma::Tile<64>::descriptor(addr, 16);
}

#define PT_F4(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// D[64 x 64] += A[64 x 8] (registers: a warp's 16 rows, lane (g, t): a0 (g,
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) . B[64 x 8]^T
// (shared, K-major); D as attention_tf32.cuh's accumulators, d[j] the
// columns 8j .. 8j + 7.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : PT_F4(d, 0), PT_F4(d, 1), PT_F4(d, 2), PT_F4(d, 3), PT_F4(d, 4), PT_F4(d, 5),
        PT_F4(d, 6), PT_F4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef PT_F4

// Keeps the compiler from moving a use of an accumulator across the wait
// that completes it.
__device__ __forceinline__ void fence_registers(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i]) :: "memory");
}

// The three products of N k-steps from k-step k0 (lo.hi, hi.lo, hi.hi into
// d, each step's before the next's), then their completion.  b: the B
// operand's hi plane (its lo plane kPlaneBytes on); step k reads its 32
// bytes of each row at sub-panel k / 4, byte 32 (k % 4).
template <int N>
__device__ __forceinline__ void products(float (&d)[8][4], const uint32_t (&hi)[N][4],
                                         const uint32_t (&lo)[N][4], uint32_t b, int k0) {
  mma::wgmma_fence();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int k = k0 + i;
    const uint32_t at = b + (k >> 2) * (kPlaneBytes / 2) + (k & 3) * 32;
    wgmma_tf32(d, lo[i], descriptor(at));
    wgmma_tf32(d, hi[i], descriptor(at + kPlaneBytes));
    wgmma_tf32(d, hi[i], descriptor(at));
  }
  mma::wgmma_commit();
  mma::wgmma_wait();
  fence_registers(d);
}

// s += the scores of k-steps k0 .. k0 + N - 1 of one panel pair: q panel qp
// (fragment order, split as loaded), k panel at shared address kb.
template <int N>
__device__ __forceinline__ void score_steps(float (&s)[8][4], const float* qp, uint32_t kb,
                                            int warp, int lane, int k0) {
  uint32_t hi[N][4], lo[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 x = reinterpret_cast<const float4*>(qp)[(warp * 8 + k0 + i) * 32 + lane];
    tf::split(x.x, hi[i][0], lo[i][0]);
    tf::split(x.y, hi[i][1], lo[i][1]);
    tf::split(x.z, hi[i][2], lo[i][2]);
    tf::split(x.w, hi[i][3], lo[i][3]);
  }
  products<N>(s, hi, lo, kb, k0);
}

// d += P.V of the 8-key groups k0 .. k0 + N - 1 of a block, p from the
// softmax's s (a lane's keys 2t and 2t + 1 of group n as its k = t and t +
// 4), v panel at shared address vb.
template <int N>
__device__ __forceinline__ void pv_steps(float (&d)[8][4], const float (&s)[8][4], uint32_t vb,
                                         int k0) {
  uint32_t hi[N][4], lo[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float* p = s[k0 + i];
    tf::split(p[0], hi[i][0], lo[i][0]);
    tf::split(p[2], hi[i][1], lo[i][1]);
    tf::split(p[1], hi[i][2], lo[i][2]);
    tf::split(p[3], hi[i][3], lo[i][3]);
  }
  products<N>(d, hi, lo, vb, k0);
}

// ---------------------------------------------------------------------------
// The CTA: 64 query rows from q0 of one (batch, head) and the G panels op0
// .. op0 + G - 1 of o.  q, k, v and out point at row 0, column 0 of the
// (batch, head), rows qrs, krs, vrs and ors floats apart; dh a multiple of 8
// (a ragged last panel is zero-filled and its columns past dh not stored);
// c = dh^-1/2 . log2(e); `stages` the ring's (every load of the walk for
// the single kernel).  Every thread of the CTA calls it.
// ---------------------------------------------------------------------------

template <int G, bool FRESH>
__device__ __forceinline__ void walk(unsigned char* raw, const float* q, long long qrs,
                                     const float* k, long long krs, const float* v,
                                     long long vrs, float* out, long long ors, int S, int q0,
                                     int dh, int op0, int stages, float c) {
  constexpr int kProducers = producers(G, FRESH);
  const int panels = (dh + kCols - 1) / kCols;
  const bool resident = q_resident(panels);
  unsigned char* base = raw + (kAlign - mma::smem_addr(raw) % kAlign) % kAlign;
  float* q_mem = reinterpret_cast<float*>(base);
  unsigned char* ring = base + (resident ? panels * kQPanelBytes : 0);
  const uint32_t q_bar = mma::smem_addr(ring + (size_t)stages * kStageBytes);
  const auto full = [&](int l) { return q_bar + 8 + 8 * (l % stages); };
  const auto empty = [&](int l) { return q_bar + 8 + 8 * (stages + l % stages); };
  const auto stage = [&](int l) { return ring + (size_t)(l % stages) * kStageBytes; };
  if (threadIdx.x == 0) {
    panel::mbar_init(q_bar, kProducers * kProducer);   // every producer thread
    for (int i = 0; i < stages; ++i) {
      panel::mbar_init(full(i), kProducer);              // the producer of the stage
      panel::mbar_init(empty(i), kConsumer / 32);         // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int blocks = (S + kKeys - 1) / kKeys, per = block_loads(panels, G);
  const int scores = per - G;                          // a block's q and k loads

  if (threadIdx.x >= kConsumer) {                      // the producer warpgroups
    if constexpr (kProducers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const int tid = threadIdx.x % kProducer, pw = (threadIdx.x - kConsumer) / kProducer;
    float4 cur[kFetch], nxt[kFetch];
    if (resident) {
      for (int p = pw; p < panels; p += kProducers) {
        fetch_rows(tid, cur, q + p * kCols, qrs, q0, S, tf::panel_cols(dh, p));
        store_q(tid, cur, q_mem + p * (kQPanelBytes / 4));
      }
      panel::mbar_arrive(q_bar);
    }
    // Load l: key block l / per, its i-th load: a v panel, a k panel or
    // (q streamed) the q panel before it; producer pw takes the loads l =
    // pw, pw + kProducers, ...
    const auto fetch = [&](int l, float4 (&x)[kFetch]) {
      const int j = l / per, i = l - j * per;
      if (i >= scores) {
        const int p = op0 + i - scores;
        fetch_keys(tid, x, v + p * kCols, vrs, j * kKeys, S, tf::panel_cols(dh, p));
      } else if (resident || (i & 1)) {
        const int p = resident ? i : i >> 1;
        fetch_rows(tid, x, k + p * kCols, krs, j * kKeys, S, tf::panel_cols(dh, p));
      } else {
        fetch_rows(tid, x, q + (i >> 1) * kCols, qrs, q0, S, tf::panel_cols(dh, i >> 1));
      }
    };
    const int loads = blocks * per;
    if (pw < loads) fetch(pw, cur);
    for (int l = pw; l < loads; l += kProducers) {
      if (l + kProducers < loads) fetch(l + kProducers, nxt);   // in flight while l is stored
      if (l >= stages) panel::mbar_wait(empty(l), (l / stages - 1) & 1);
      const int i = l % per;
      if (i >= scores) store_v(tid, cur, stage(l));
      else if (resident || (i & 1)) store_k(tid, cur, stage(l));
      else store_q(tid, cur, reinterpret_cast<float*>(stage(l)));
      mma::fence_async_proxy();                        // the stores, before the tensor cores read
      panel::mbar_arrive(full(l));
#pragma unroll
      for (int it = 0; it < kFetch; ++it) cur[it] = nxt[it];
    }
    return;
  }

  // The consumer warpgroup.  k-steps a batch of products: half a panel's
  // where o (and the encoder's fresh sum) leave too few registers for all
  // eight steps' A fragments.
  constexpr int kSteps = G + (FRESH ? 1 : 0) >= 3 ? 4 : 8;
  if constexpr (kProducers == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const auto take = [&](int l) {
    panel::mbar_wait(full(l), (l / stages) & 1);
    return stage(l);
  };
  const auto give = [&](int l) {
    __syncwarp();
    if (lane == 0) panel::mbar_arrive(empty(l));
  };
  tf::Softmax<kCols> sm;                               // m, l and the online softmax
  sm.m[0] = sm.m[1] = -INFINITY;
  sm.l[0] = sm.l[1] = 0.f;
  float o[G][kCols / 8][4];
#pragma unroll
  for (int p = 0; p < G; ++p)
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[p][j][i] = 0.f;
  if (resident) panel::mbar_wait(q_bar, 0);

  for (int j = 0, l = 0; j < blocks; ++j) {
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    for (int p = 0; p < panels; ++p) {
      const float* qp = resident ? q_mem + p * (kQPanelBytes / 4)
                                 : reinterpret_cast<const float*>(take(l++));
      const uint32_t kb = mma::smem_addr(take(l));
#pragma unroll
      for (int k0 = 0; k0 < kCols / 8; k0 += kSteps)
        score_steps<kSteps>(s, qp, kb, warp, lane, k0);
      give(l++);
      if (!resident) give(l - 2);
    }
    float alpha[2];
    sm.softmax(s, j * kKeys, S, c, alpha);
#pragma unroll
    for (int p = 0; p < G; ++p, ++l) {
      const uint32_t vb = mma::smem_addr(take(l));
      if constexpr (FRESH) {
        float fresh[kCols / 8][4];
#pragma unroll
        for (int jj = 0; jj < kCols / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) fresh[jj][i] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < kKeys / 8; k0 += kSteps) pv_steps<kSteps>(fresh, s, vb, k0);
        give(l);
#pragma unroll
        for (int jj = 0; jj < kCols / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[p][jj][i] = fmaf(o[p][jj][i], alpha[i >> 1], fresh[jj][i]);
      } else {
#pragma unroll
        for (int jj = 0; jj < kCols / 8; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[p][jj][i] *= alpha[i >> 1];
#pragma unroll
        for (int k0 = 0; k0 < kKeys / 8; k0 += kSteps) pv_steps<kSteps>(o[p], s, vb, k0);
        give(l);
      }
    }
  }

  // o / l (one division, one rounding), rows >= S and columns >= dh dropped.
  const int g = lane >> 2, t = lane & 3;
  const float sum[2] = {mma::quad_sum(sm.l[0]), mma::quad_sum(sm.l[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int p = 0; p < G; ++p) {
      const int cols = tf::panel_cols(dh, op0 + p);
      float* row = out + (long long)r * ors + (op0 + p) * kCols + 2 * t;
#pragma unroll
      for (int jj = 0; jj < kCols / 8; ++jj)
        if (8 * jj < cols)
          *reinterpret_cast<float2*>(row + 8 * jj) =
              make_float2(o[p][jj][2 * h] / sum[h], o[p][jj][2 * h + 1] / sum[h]);
    }
  }
}

}  // namespace tf32_panels
