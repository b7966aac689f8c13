// Whole ViT encoder forward (every pre-LN block) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel gstreamer_vit_tracker_tpu/ops/vit_block.py::_encoder_kernel
// (the pallas_call in _encoder_forward, reached through vit_block.encoder from
// models/vit.py::encode at batch 1).  Per block it computes what _block_math
// computes, rounding where the port's twin (models/vit.py::_block) rounds:
//   LN (f32, eps 1e-6) -> qkv (f32 acc + bias, rounded to T) -> per-head softmax
//   attention in f32, one division o / l, heads rounded to T -> proj (f32 acc +
//   bias, rounded) + residual in T -> LN -> mlp1 (rounded) -> tanh GELU (f32,
//   rounded) -> mlp2 (rounded) + residual.
// T is __nv_bfloat16 (the flagship) or float (the f32 presets).
//
// Bound on the H100 SXM at the flagship shape (B=1, S=320, D=192, depth 12,
// 3 heads of 64, MLP 768): 4.34 GFLOP is ~4.4 us at 989 TFLOP/s bf16; the
// weights, 12 x 0.885 MB = 10.6 MB, are ~3.2 us at 3.35 TB/s.  At batch 1
// neither bounds this design: it is a host loop over depth issuing five
// launches a block, each a few microseconds of launch and latency on a
// fraction of the SMs.  The TPU kernel's carry of the activation in VMEM
// across a sequential depth grid has no counterpart on 132 SMs that run
// blocks in no order; the activation goes through device memory (and L2)
// between launches instead.  One persistent launch with TMA is later work.
//
// Three variants (ops/vit_block.py::plan names one and passes it in with the
// N tiles as ints; the entries launch what they are told or return an
// error; nothing falls back): "mma" for bf16, "tf32x3" for float32, and
// "simt" for float32 by name only, as the yardstick of the timings.  The
// head dim the kernels run at (head_dim) may exceed the true one, D / H: the
// plan zero-pads a head dim no variant takes
// (the qkv weight and bias get zero columns a head, the proj weight zero rows
// a head, so the inner width E = H . head_dim), and the scores are scaled by
// the true head dim's (D / H)^-1/2.  Zeros add exactly to an f32 sum, so a
// padded head computes what the unpadded one does.
//
// "mma" (bf16, head dim 32 / 64 / 128 or above 128 a multiple of 64, any D):
// the tiles of encoder_mma.cuh, in one of two forms (Config::ln, the plan's
// choice from the width alone; encoder_mma.cuh's header says what bounds
// each on the H100 and what the design does about it).
//   Resident (every residual width up to 768: the flagship, D 192): five
//   launches a block, 1. LN1 + qkv  2. attention  3. proj + residual
//   4. LN2 + mlp1 + GELU  5. mlp2 + residual, each product's N tile (32 or
//   64) as the plan says; the CTA's 64 rows of the residual stream sit in
//   shared memory whole, 1024 + W / 64 . 64 . (64 + N tile) . 2 bytes, and
//   are LayerNormed there.
//   Prenormed (every width above 768: ViT-L's 1024, ViT-H's 1280): seven
//   launches a block, 1. LN1 rows  2. qkv  3. attention  4. proj + residual
//   5. LN2 rows  6. mlp1 + GELU  7. mlp2 + residual.  ln_rows_kernel writes
//   the LayerNorm of the residual stream once into the scratch `normed` (M,
//   W) (the resident form's arithmetic and order: the same bits), and the
//   four products read plain bf16 rows through ring_product_kernel (TMA on
//   a deep ring, one or two warpgroups sharing each W chunk, persistent
//   CTAs; the maps of ring_maps, made once a call).  At ViT-L's (1, 320,
//   1024) x 24 the weights, 605.93 MB from device memory (180.87 us at 3.35
//   TB/s), and the operations, 203.34 GFLOP (205.60 us at 989 TFLOP/s),
//   bound it about equally; at batch 16 the operations.
// Its products take K in 64-deep chunks, so a D or an MLP width that is no
// multiple of 64 runs zero-padded to the next one (the `small` architecture
// in bf16: D 96 -> W 128).  The plan pads the weights once per parameter
// set: zero rows of the qkv and mlp1 kernels past D and past the MLP width
// of mlp2, zero columns of proj, mlp1 and mlp2 and of their biases, zero LN
// scale and bias past D.  The residual stream is carried at the padded width
// W in the scratch h: x is copied in with zero columns past D, and the first
// D columns are copied out after the last block.  The LN prologue takes its
// mean and variance over the D true columns alone (the padded columns' (0 -
// mean)^2 is masked), and its output is 0 past D (0 scale, 0 bias).  Every
// padded column then stays exactly 0 through a block: the qkv product reads
// it against zero rows; proj and mlp2 write acc 0 + bias 0 = 0 there and the
// residual adds 0 to 0; mlp1's padded columns are 0 + 0 and GELU(0) =
// 0.5 . 0 . (1 + tanh 0) = 0, read by mlp2 against zero rows.  Zeros add
// exactly to an f32 sum, so a padded block computes what an unpadded one
// would, and D already a multiple of 64 (the flagship) pads nothing.
//
// "tf32x3" (float32, head dims that are multiples of 8, any D and
// MLP width, each zero-padded to a multiple of 32 as "mma" pads to 64: the
// residual stream carried at the padded width W, the LN statistics over the
// true D, the hi / lo planes split after the pad): the same five launches
// a block while 64 rows of W fit (resident, W up to 544 at every N tile and
// warpgroups), seven past it.  Past it the form is prenormed, as "mma"'s:
// ln_rows_kernel<float> writes the LN rows once (the scratch `normed`, (M,
// W) float32), and the four products run ring_tf32.cuh's
// ring_product_kernel (split-TF32 wgmma, A split in registers, the weight's
// planes stored transposed, a TMA ring, persistent CTAs; its header says
// what bounds it), every output the bits of the streamed form it replaced
// (a row_stats_kernel launch, then each K chunk LayerNormed as it lands in a
// ring slot beside its scale and bias: run by name only, the yardstick of
// the timings).  Resident and streamed, the
// tiles of encoder_tf32.cuh: products on the tensor cores in split TF32
// (mma.sync m16n8k8, each operand as hi + lo TF32 parts, lo.hi + hi.lo +
// hi.hi into one f32 accumulator: float32's accuracy, not TF32's), the
// weights split once per parameter set by the caller (two planes a kernel),
// the activations split as their fragments are loaded; the LayerNorm in the
// qkv and mlp1 prologue and bias / GELU / residual in the epilogue, in f32
// with the twin's roundings; the attention of attention_tf32.cuh on the qkv
// buffer's head slices (64-key blocks, online softmax); at batch 1 two
// warpgroups a CTA, sharing a product's K or an attention tile's keys
// (Config::warpgroups).  Bound at the
// flagship (1, 320, 192) x 12 in float32: the 4.341 GFLOP as three TF32
// products are 26.3 us at 495 TFLOP/s (64.8 us as f32 FMA); the f32
// weights, x in and out, 21.8 MB, 6.5 us at 3.35 TB/s (the two planes
// double the weights' share: 13 us): bound by operations.  The resident
// and streamed products run mma.sync on (K, N) planes; wgmma in TF32 takes
// both operands K-major, which the prenormed ring's transposed planes are.
//
// "simt" (float32, head dims that are multiples of 16 up to 128; this
// file's first design, run by name only, the yardstick of "tf32x3"): seven
// launches a block on the FMA units, f32
// arithmetic (no TF32, so the f32 presets stay f32):
//   * layer_norm_kernel: one warp per row, the twin's roundings;
//   * gemm_bias_kernel: 64x64x32 tiles, 4 warps; tiles move as 16-byte
//     vectors, loaded into registers one k step ahead of the compute; the
//     epilogue adds the bias in f32, rounds to T, then optionally applies the
//     tanh GELU or adds the residual (in place: C may alias resid);
//   * attention_simt_kernel: one CTA per (16-query tile, head, batch), 8
//     warps of two query rows each, walking blocks of 32 keys (one a lane)
//     through shared memory twice, the twin's arithmetic in f32 (the row
//     maximum, then expf, the sum and P.V), so any sequence length fits the
//     same 41 KB.
//
// Above a head dim of 128, "mma" and "tf32x3" run the attention stage in
// panels of 64 columns (attention_panels_kernel of encoder_mma.cuh and
// encoder_tf32.cuh): q resident and G panels of o a CTA, K and V coming
// through a ring of panel stages, "mma" by TMA (csrc/panel_ring.cuh),
// "tf32x3" split into TF32 parts once a CTA by producer warpgroups
// (csrc/panel_tf32.cuh); the products do not see the head dim.
//
// Every launch goes to the caller's stream; the entry point returns the first
// CUDA error (cudaGetLastError after each launch), 0 on success.
//
// A second entry, vit_block_forward, runs ONE block with its own unstacked
// weights on any batch through the same device code: it replaces the TPU
// kernel _block_kernel of the same file (see the note at the entry).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#include "encoder_mma.cuh"
#include "encoder_tf32.cuh"
#include "ring_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using encoder_mma::kEpiGelu;
using encoder_mma::kEpiResidual;
using encoder_mma::kEpiRound;
using encoder_mma::kLnEps;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the point where the twin casts to x.dtype.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Variant "simt": LayerNorm, one warp per row.
// ---------------------------------------------------------------------------

constexpr int kLnThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ y, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                    // whole warp leaves together
  const T* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f32(xr[i]);
  const float mu = __fdiv_rn(warp_sum(s), (float)d);
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float t = __fsub_rn(to_f32(xr[i]), mu);
    v = __fadd_rn(v, __fmul_rn(t, t));
  }
  const float rstd = encoder_mma::rsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(v), (float)d), kLnEps));
  T* yr = y + (size_t)row * d;
  for (int i = lane; i < d; i += 32) {
    const float t = __fmul_rn(__fsub_rn(to_f32(xr[i]), mu), rstd);
    yr[i] = from_f32<T>(__fadd_rn(__fmul_rn(t, to_f32(scale[i])), to_f32(bias[i])));
  }
}

// ---------------------------------------------------------------------------
// Variant "simt": C[M, N] = epilogue(A[M, K] @ W[K, N] + bias[N]), row-major,
// f32 FMA.
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32, kGemmThreads = 128;
constexpr int kALd = kBK + 8;   // padded smem row strides, multiples of 16 bytes
constexpr int kBLd = kBN + 8;

// Each thread moves its share of the A (kBM x kBK) and W (kBK x kBN) tiles
// as 16-byte vectors: loaded into registers for the next k step while the
// current one computes, then stored to shared memory.  Needs K and N to be
// multiples of the vector width (the wrapper checks D % 16 == 0); rows past
// M and columns past N load zeros.
template <typename T>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kA = kBM * kBK / kVec / kGemmThreads;
  static constexpr int kB = kBK * kBN / kVec / kGemmThreads;
  uint4 a[kA];
  uint4 b[kB];

  __device__ __forceinline__ void load(const T* __restrict__ A, const T* __restrict__ W,
                                       int m0, int n0, int k0, int M, int N, int K) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const int r = v / (kBK / kVec), c = (v % (kBK / kVec)) * kVec;
      const int gm = m0 + r, gk = k0 + c;
      a[i] = (gm < M && gk < K) ? *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const int r = v / (kBN / kVec), c = (v % (kBN / kVec)) * kVec;
      const int gk = k0 + r, gn = n0 + c;
      b[i] = (gk < K && gn < N) ? *reinterpret_cast<const uint4*>(W + (size_t)gk * N + gn)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(T* As, T* Bs) const {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const int r = v / (kBK / kVec), c = (v % (kBK / kVec)) * kVec;
      *reinterpret_cast<uint4*>(As + r * kALd + c) = a[i];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const int r = v / (kBN / kVec), c = (v % (kBN / kVec)) * kVec;
      *reinterpret_cast<uint4*>(Bs + r * kBLd + c) = b[i];
    }
  }
};

template <typename T, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_kernel(const T* __restrict__ A, const T* __restrict__ W,
                 const T* __restrict__ bias, const T* resid, T* C,
                 int M, int N, int K) {
  __shared__ __align__(128) T As[kBM * kALd];
  __shared__ __align__(128) T Bs[kBK * kBLd];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;     // 16 x 8 threads, 8 x 4 outputs each
  TileRegs<T> regs;
  regs.load(A, W, m0, n0, 0, M, N, K);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    regs.store(As, Bs);
    __syncthreads();
    if (k0 + kBK < K) regs.load(A, W, m0, n0, k0 + kBK, M, N, K);
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = to_f32(As[(ty + 8 * i) * kALd + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f32(Bs[kk * kBLd + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 8 * i, gn = n0 + tx + 16 * j;
      if (gm >= M || gn >= N) continue;
      float v = round_to<T>(acc[i][j] + to_f32(bias[gn]));
      if constexpr (EPI == kEpiGelu) v = encoder_mma::gelu_tanh(v);
      if constexpr (EPI == kEpiResidual) v = to_f32(resid[(size_t)gm * N + gn]) + v;
      C[(size_t)gm * N + gn] = from_f32<T>(v);
    }
}

// ---------------------------------------------------------------------------
// Variant "simt": softmax attention over one head, CTA = (16-query tile,
// head, batch); qkv: (B*S, 3D) rows [q | k | v], heads contiguous inside
// each; out: (B*S, D), D here the inner width H . dh.  Keys arrive 32 at a
// time: K transposed (row stride 33 words, so the transposing stores and the
// reads are free of bank conflicts) and V, both widened to f32.  Each warp
// owns two query rows, lane j scores key j of a block.  As the twin computes
// it: pass 1 walks the key blocks for each row's maximum m of the f32 scores
// (scaled by the true head dim's ^-1/2), pass 2 walks them again for
// p = expf(s - m), the row sum l and P.V (p from lane j by a shuffle, each
// lane owning head dims lane, lane + 32, ...; dh <= 128); one division o / l.
// ---------------------------------------------------------------------------

// kAttMaxDh: the largest head dim "simt" takes, and of one tile in "mma"
// and "tf32x3" (above it they run the panel kernels).
constexpr int kAttQt = 16, kAttThreads = 256, kAttWarps = kAttThreads / 32, kAttKb = 32;
constexpr int kAttMaxDh = 128, kKtLd = kAttKb + 1;

template <typename T>
__global__ void __launch_bounds__(kAttThreads)
attention_simt_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S, int D,
                      int dh, float scale) {
  __shared__ float Kt[kAttMaxDh * kKtLd];     // [dh][kKtLd]
  __shared__ float Vs[kAttKb * kAttMaxDh];    // [kAttKb][dh]
  __shared__ float Qs[kAttQt * kAttMaxDh];    // [kAttQt][dh]
  constexpr int kRows = kAttQt / kAttWarps;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kAttQt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ld = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * S * ld;
  const int qoff = h * dh, koff = D + h * dh, voff = 2 * D + h * dh;

  for (int idx = tid; idx < kAttQt * dh; idx += kAttThreads) {
    const int i = idx / dh, d = idx - i * dh;
    Qs[idx] = q0 + i < S ? to_f32(base[(size_t)(q0 + i) * ld + qoff + d]) : 0.f;
  }
  float m[kRows], l[kRows], o[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) o[r][u] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < S; j0 += kAttKb) {
      __syncthreads();                        // the previous block is read out
      for (int idx = tid; idx < kAttKb * dh; idx += kAttThreads) {
        const int jj = idx / dh, d = idx - jj * dh;
        const bool in = j0 + jj < S;
        const T* row = base + (size_t)(j0 + jj) * ld;
        Kt[d * kKtLd + jj] = in ? to_f32(row[koff + d]) : 0.f;
        if (pass == 1) Vs[jj * dh + d] = in ? to_f32(row[voff + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = warp + kAttWarps * r;
        if (q0 + i >= S) break;               // uniform over the warp
        const float* q = Qs + i * dh;
        float s = 0.f;
        for (int d = 0; d < dh; ++d) s = fmaf(q[d], Kt[d * kKtLd + lane], s);
        s = j0 + lane < S ? s * scale : -INFINITY;
        if (pass == 0) {
          m[r] = fmaxf(m[r], warp_max(s));
          continue;
        }
        const float p = expf(s - m[r]);
        l[r] += warp_sum(p);
#pragma unroll 4
        for (int jj = 0; jj < kAttKb; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
          const float* vrow = Vs + jj * dh;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = lane + 32 * u;
            if (d < dh) o[r][u] = fmaf(pj, vrow[d], o[r][u]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp + kAttWarps * r;
    if (qi >= S) break;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = lane + 32 * u;
      if (d < dh) out[((size_t)b * S + qi) * D + h * dh + d] = from_f32<T>(o[r][u] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    const cudaError_t err_ = (expr);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

struct Weights {   // row-major; stacked over depth for the encoder entry
  const void *ln1_s, *ln1_b, *w_qkv, *b_qkv, *w_proj, *b_proj,
      *ln2_s, *ln2_b, *w_mlp1, *b_mlp1, *w_mlp2, *b_mlp2;
};

template <typename T>
const T* layer(const void* p, int l, size_t per_layer) {
  return static_cast<const T*>(p) + (size_t)l * per_layer;
}

enum Variant { kSimt = 0, kMma = 1, kTf32x3 = 2 };

// Block l's weights; W is the residual width (D, or "mma"'s padded one), E
// the inner width H . head_dim.  "tf32x3" takes each kernel as two planes
// (hi, lo), so a block's kernel is twice as long.
Weights layer_weights(const Weights& w, int l, int D, int E, int hidden, int dtype,
                      int variant) {
  const size_t e = dtype == 1 ? sizeof(bf16) : sizeof(float);
  const size_t planes = variant == kTf32x3 ? 2 : 1;
  const auto at = [&](const void* p, size_t n) {
    return static_cast<const void*>(static_cast<const char*>(p) + (size_t)l * n * e);
  };
  return Weights{at(w.ln1_s, D), at(w.ln1_b, D), at(w.w_qkv, planes * D * 3 * E),
                 at(w.b_qkv, 3 * E), at(w.w_proj, planes * E * D), at(w.b_proj, D),
                 at(w.ln2_s, D), at(w.ln2_b, D), at(w.w_mlp1, planes * D * hidden),
                 at(w.b_mlp1, hidden), at(w.w_mlp2, planes * hidden * D), at(w.b_mlp2, D)};
}

// What ops/vit_block.py::plan decided: the variant; for "mma" and "tf32x3"
// the N tile of the qkv, proj, mlp1 and mlp2 products ("mma" 32 or 64, and
// 128 prenormed; "tf32x3" 16, 32 or 64); the warpgroups a CTA, 1 or 2:
// "tf32x3"'s attention's share a query tile's key blocks (head dims up to
// 64), its products of N tile 16 or 32 their K (2 at batch 1; the prenormed
// ring's tile 128 is CTAs of 128 x 128), "mma"'s prenormed products' share
// each W chunk (2 at batch 16); the form of the LN products, 0 resident, 1
// streamed ("tf32x3", by name) or 2 prenormed.
// "simt" reads none of them, "mma" resident not the warpgroups.
struct Config {
  int variant;
  int bn[4];
  int warpgroups;
  int ln;
  int group;   // above a head dim of 128: panels of o an attention CTA
};

constexpr int kMaxDevices = 64;

// Opts `kernel` in to `smem` bytes of dynamic shared memory.  `allowed` is
// that kernel's own record by device: the attribute is set when a launch needs
// more than any before it (never during a CUDA-graph capture of a shape seen
// before).
template <typename K>
cudaError_t allow_smem(K kernel, int (&allowed)[kMaxDevices], size_t smem) {
  int device = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  if (device < kMaxDevices && (int)smem <= allowed[device]) return cudaSuccess;
  int optin = 0;
  RETURN_IF_ERROR(cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem));
  if (device < kMaxDevices) allowed[device] = (int)smem;
  return cudaSuccess;
}

using encoder_mma::kLnNone;
using encoder_mma::kLnResident;
using encoder_mma::kLnStreamed;

// The LN products' forms (Config::ln): "mma" takes kResident or
// kPrenormed, "tf32x3" kResident or kStreamed.
enum LnCode { kResident = 0, kStreamed = 1, kPrenormed = 2 };

// "tf32x3"'s streamed statistics of the M rows of A ((M, K)) over their
// first ln_dim columns into stats: one launch, 16 rows a CTA.
cudaError_t launch_row_stats(const float* A, float2* stats, int M, int K, int ln_dim,
                             cudaStream_t st) {
  constexpr int kRowsACta = mma::kThreads / 8;
  encoder_mma::row_stats_kernel<float>
      <<<(M + kRowsACta - 1) / kRowsACta, mma::kThreads, 0, st>>>(A, stats, M, K, ln_dim);
  return cudaGetLastError();
}

template <int BN, int EPI, int LN>
cudaError_t product_bn(const bf16* A, const bf16* W, const bf16* bias, const bf16* ln_s,
                       const bf16* ln_b, bf16* C, int M, int N, int K, int ln_dim,
                       cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_mma::product_kernel<BN, EPI, LN>;
  const size_t smem = encoder_mma::product_smem_bytes(
      BN, LN == kLnResident ? K / encoder_mma::kChunk : encoder_mma::kRing);
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  const dim3 grid(N / BN, (M + mma::kTileRows - 1) / mma::kTileRows);
  kernel<<<grid, mma::kThreads, smem, st>>>(A, W, bias, ln_s, ln_b, C, M, N, K, ln_dim);
  return cudaGetLastError();
}

// The resident form's products.  ln_dim: the true columns of A the
// LayerNorm runs over (LN products; K or fewer, the rest zero padding).
template <int EPI, int LN>
cudaError_t product(int bn, const bf16* A, const bf16* W, const bf16* bias, const bf16* ln_s,
                    const bf16* ln_b, bf16* C, int M, int N, int K, int ln_dim,
                    cudaStream_t st) {
  if (N % bn || K % encoder_mma::kChunk || (LN != kLnNone && (ln_dim < 1 || ln_dim > K)))
    return cudaErrorInvalidValue;
  if (bn == 32) return product_bn<32, EPI, LN>(A, W, bias, ln_s, ln_b, C, M, N, K, ln_dim, st);
  if (bn == 64) return product_bn<64, EPI, LN>(A, W, bias, ln_s, ln_b, C, M, N, K, ln_dim, st);
  return cudaErrorInvalidValue;
}

// The current device's SM count and opt-in shared memory a block, read
// once a device.
struct Limits {
  int sms, optin;
};

cudaError_t device_limits(Limits* limits) {
  static Limits read[kMaxDevices] = {};
  int device = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  if (device < kMaxDevices && read[device].sms) {
    *limits = read[device];
    return cudaSuccess;
  }
  RETURN_IF_ERROR(cudaDeviceGetAttribute(&limits->sms, cudaDevAttrMultiProcessorCount, device));
  RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&limits->optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  if (device < kMaxDevices) read[device] = *limits;
  return cudaSuccess;
}

template <typename T, int RPW>
cudaError_t ln_rows_rpw(const T* x, const T* s, const T* b, T* y, int M, int W, int d,
                        cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_mma::ln_rows_kernel<T, RPW>;
  const size_t smem = encoder_mma::ln_rows_smem_bytes(RPW, W, sizeof(T));
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  constexpr int kRows = encoder_mma::kLnRowsThreads / 32 * RPW;
  kernel<<<(M + kRows - 1) / kRows, encoder_mma::kLnRowsThreads, smem, st>>>(x, s, b, y, M, W,
                                                                           d);
  return cudaGetLastError();
}

// The prenormed form (bf16 and float32).  y = the LN rows of the M rows of
// x ((M, W), W . sizeof(T) a multiple of 128) over their first d columns:
// one launch, four rows a warp where that gives at least two CTAs an SM and
// their rows fit a block's shared memory, else a warp a row.
template <typename T>
cudaError_t ln_rows(const T* x, const T* s, const T* b, T* y, int M, int W, int d,
                    cudaStream_t st) {
  if (W * sizeof(T) % 128 || d < 1 || d > W) return cudaErrorInvalidValue;
  Limits card;
  RETURN_IF_ERROR(device_limits(&card));
  if (M / (encoder_mma::kLnRowsThreads / 32 * 4) >= 2 * card.sms
      && encoder_mma::ln_rows_smem_bytes(4, W, sizeof(T)) <= (size_t)card.optin)
    return ln_rows_rpw<T, 4>(x, s, b, y, M, W, d, st);
  return ln_rows_rpw<T, 1>(x, s, b, y, M, W, d, st);
}

// A row-major bf16 (or float32: T) tensor of `rank` dims (innermost first)
// as a TMA map with boxes of `box` elements; a box's rows are 128 or 64
// bytes, swizzled as mma::Tile's 64- and 32-column panels are (float32: rows
// of 32, the 128-byte swizzle).
template <typename T = bf16>
cudaError_t tile_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint32_t* box) {
  cuuint64_t strides[3] = {0, 0, 0};
  cuuint64_t stride = dims[0] * sizeof(T);
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = stride;
    stride *= dims[i + 1];
  }
  return panel::encode_map(map, base, rank, dims, strides, box,
                           std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// The TMA maps of a prenormed forward: the rows each product reads (the LN
// rows, the attention's output, the MLP's hidden rows) in boxes of one
// K chunk (bf16 64 columns, float32 32) by the CTA's rows, and the four
// weights stacked over depth: bf16 in boxes of 64 rows by the product's N
// tile or, above 64, by a 64-column panel of it; float32 ("tf32x3", the two
// planes of each kernel stored transposed, (depth, 2, N, K)) in boxes of 32
// columns of K by the N tile by both planes.
struct RingMaps {
  CUtensorMap normed, attn, hid, qkv, proj, mlp1, mlp2;
  CUtensorMap heads;   // the qkv buffer's rows for the "mma" panel attention
};

// Rows a CTA of the float32 ring takes (tf32_ring::Ring::kTileRows): 128 at
// N tile 128, else 64 (the plan gives every product tile 128 or none).
int tf32_ring_rows(const Config& c) { return c.bn[0] == 128 ? 128 : 64; }

template <typename T>
cudaError_t ring_maps(RingMaps* m, const Config& c, const Weights& w, int M, int W, int E,
                      int hidden, int depth, const void* normed, const void* attn,
                      const void* hid) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const auto rows = [&](CUtensorMap* map, const void* p, int k) {
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)M};
    const cuuint32_t box[2] = {
        (cuuint32_t)(kF32 ? tf32_ring::kChunk : encoder_mma::kChunk),
        (cuuint32_t)(kF32 ? tf32_ring_rows(c) : c.warpgroups * mma::kTileRows)};
    return tile_map<T>(map, p, 2, dims, box);
  };
  const auto weight = [&](CUtensorMap* map, const void* p, int k, int n, int bn) {
    if (kF32) {
      const cuuint64_t dims[4] = {(cuuint64_t)k, (cuuint64_t)n, 2, (cuuint64_t)depth};
      const cuuint32_t box[4] = {tf32_ring::kChunk, (cuuint32_t)bn, 2, 1};
      return tile_map<T>(map, p, 4, dims, box);
    }
    const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)k, (cuuint64_t)depth};
    const cuuint32_t box[3] = {(cuuint32_t)(bn < 64 ? bn : 64), encoder_mma::kChunk, 1};
    return tile_map<T>(map, p, 3, dims, box);
  };
  RETURN_IF_ERROR(rows(&m->normed, normed, W));
  RETURN_IF_ERROR(rows(&m->attn, attn, E));
  RETURN_IF_ERROR(rows(&m->hid, hid, hidden));
  RETURN_IF_ERROR(weight(&m->qkv, w.w_qkv, W, 3 * E, c.bn[0]));
  RETURN_IF_ERROR(weight(&m->proj, w.w_proj, E, W, c.bn[1]));
  RETURN_IF_ERROR(weight(&m->mlp1, w.w_mlp1, W, hidden, c.bn[2]));
  return weight(&m->mlp2, w.w_mlp2, hidden, W, c.bn[3]);
}

template <int NWG, int BN, int EPI>
cudaError_t ring_product_bn(const CUtensorMap& a, const CUtensorMap& w, int layer,
                            const bf16* bias, bf16* C, int M, int N, int K, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  using R = encoder_mma::Ring<NWG, BN>;
  const auto kernel = encoder_mma::ring_product_kernel<NWG, BN, EPI>;
  RETURN_IF_ERROR(allow_smem(kernel, allowed, R::smem_bytes()));
  Limits card;
  RETURN_IF_ERROR(device_limits(&card));
  const long long tiles =
      (long long)(N / BN) * ((M + NWG * mma::kTileRows - 1) / (NWG * mma::kTileRows));
  const int slots = card.sms * R::kCtasPerSm;
  const int grid = (int)(tiles < slots ? tiles : slots);
  kernel<<<grid, R::kThreads, R::smem_bytes(), st>>>(a, w, layer, bias, C, M, N, K);
  return cudaGetLastError();
}

// A product of the prenormed form: C = epilogue(A . W[layer] + bias), A and
// W as the maps a and w give them, CTAs of wgs warpgroups and N tile bn
// (32 or 64, and with two warpgroups 128).
template <int EPI>
cudaError_t ring_product(int wgs, int bn, const CUtensorMap& a, const CUtensorMap& w, int layer,
                         const bf16* bias, bf16* C, int M, int N, int K, cudaStream_t st) {
  if (N % bn || K % encoder_mma::kChunk) return cudaErrorInvalidValue;
#define RING_PRODUCT(NWG, BN)   \
  if (wgs == NWG && bn == BN) \
    return ring_product_bn<NWG, BN, EPI>(a, w, layer, bias, C, M, N, K, st);
  RING_PRODUCT(1, 32)
  RING_PRODUCT(1, 64)
  RING_PRODUCT(2, 32)
  RING_PRODUCT(2, 64)
  RING_PRODUCT(2, 128)
#undef RING_PRODUCT
  return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t attention_mma(const bf16* qkv, bf16* out, int B, int S, int H, float scale,
                          cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_mma::attention_kernel<DH>;
  const size_t smem = encoder_mma::attention_smem_bytes(DH);
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  const int tiles = (S + mma::kTileRows - 1) / mma::kTileRows;
  kernel<<<tiles * B * H, mma::kThreads, smem, st>>>(qkv, out, S, H, tiles, scale);
  return cudaGetLastError();
}

// "tf32x3" above kAttMaxDh: tiles x B x H x P / G CTAs of
// attention_panels_kernel<G> (P = ceil(dh / 64)), the ring
// tf32_panels::ring_stages gives.
template <int G>
cudaError_t attention_panels_tf32(const float* qkv, float* out, int B, int S, int H, int dh,
                                  float c, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_tf32::attention_panels_kernel<G>;
  const int panels = (dh + tf32_panels::kCols - 1) / tf32_panels::kCols;
  Limits card;
  RETURN_IF_ERROR(device_limits(&card));
  const int tiles = (S + tf32_panels::kRows - 1) / tf32_panels::kRows;
  const long long grid = (long long)tiles * B * H * (panels / G);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int stages = tf32_panels::ring_stages(panels, G, (size_t)card.optin);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = tf32_panels::smem_bytes(panels, stages);
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  kernel<<<(int)grid, tf32_panels::threads(G, true), smem, st>>>(qkv, out, S, H, tiles, dh,
                                                                   stages, c);
  return cudaGetLastError();
}

// The map of the qkv buffer ((B, S, 3E) bf16 rows) that the "mma" panel
// attention's TMA copies read, in boxes of one 64-key x 64-column panel.
cudaError_t heads_map(CUtensorMap* map, const void* qkv, int B, int S, int E) {
  const cuuint64_t dims[3] = {(cuuint64_t)3 * E, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint32_t box[3] = {64, (cuuint32_t)encoder_mma::kKeyBlock, 1};
  return tile_map<bf16>(map, qkv, 3, dims, box);
}

// "mma" above kAttMaxDh: tiles x B x H x P / G CTAs of
// attention_panels_kernel<G, PC>, the ring panel::ring_stages gives.
template <int G, int PC>
cudaError_t attention_panels_mma(const CUtensorMap& map, bf16* out, int B, int S, int H, int dh,
                                 float scale, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_mma::attention_panels_kernel<G, PC>;
  const int panels = dh / 64;
  Limits card;
  RETURN_IF_ERROR(device_limits(&card));
  const int tiles = (S + mma::kTileRows - 1) / mma::kTileRows;
  const long long grid = (long long)tiles * B * H * (panels / G);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int stages = panel::ring_stages(panels, G, (size_t)card.optin);
  if (stages < (PC > G ? PC : G + 1)) return cudaErrorInvalidValue;
  const size_t smem = panel::smem_bytes(panels, stages);
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  kernel<<<(int)grid, panel::kThreads, smem, st>>>(map, out, S, H, tiles, dh, stages, scale);
  return cudaGetLastError();
}

cudaError_t attention_mma_dh(int dh, int group, const CUtensorMap& map, const bf16* qkv,
                             bf16* out, int B, int S, int H, float scale, cudaStream_t st) {
  switch (dh) {
    case 32: return attention_mma<32>(qkv, out, B, S, H, scale, st);
    case 64: return attention_mma<64>(qkv, out, B, S, H, scale, st);
    case 128: return attention_mma<128>(qkv, out, B, S, H, scale, st);
    case 256:
      return group == 2 ? attention_panels_mma<2, 4>(map, out, B, S, H, dh, scale, st)
                        : attention_panels_mma<1, 4>(map, out, B, S, H, dh, scale, st);
    default:
      switch (group) {
        case 1: return attention_panels_mma<1, 0>(map, out, B, S, H, dh, scale, st);
        case 2: return attention_panels_mma<2, 0>(map, out, B, S, H, dh, scale, st);
        case 3: return attention_panels_mma<3, 0>(map, out, B, S, H, dh, scale, st);
        default: return cudaErrorInvalidValue;
      }
  }
}

template <int BN, int EPI, int LN, int NWG>
cudaError_t product_tf32_bn(const float* A, const float* W, const float* bias,
                            const float* ln_s, const float* ln_b, const float2* stats, float* C,
                            int M, int N, int K, int ln_dim, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_tf32::product_kernel<BN, EPI, LN, NWG>;
  const size_t smem = encoder_tf32::product_smem_bytes(BN, LN, K, NWG);
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  const dim3 grid((N + BN - 1) / BN, (M + encoder_tf32::kRows - 1) / encoder_tf32::kRows);
  kernel<<<grid, encoder_tf32::kThreads * NWG, smem, st>>>(A, W, bias, ln_s, ln_b, stats, C, M,
                                                           N, K, ln_dim);
  return cudaGetLastError();
}

// The N tiles built: 16 and 32, with K dealt to one or two warpgroups
// (wgs), and 64 with one.  LN kLnStreamed launches row_stats_kernel into stats
// first.
template <int EPI, int LN>
cudaError_t product_tf32(int bn, int wgs, const float* A, const float* W, const float* bias,
                         const float* ln_s, const float* ln_b, float2* stats, float* C, int M,
                         int N, int K, int ln_dim, cudaStream_t st) {
  if (N % 8 || K % 8 || (wgs != 1 && wgs != 2)
      || (LN != kLnNone && (K % encoder_tf32::kChunk || ln_dim < 1 || ln_dim > K)))
    return cudaErrorInvalidValue;
  if (LN == kLnStreamed) RETURN_IF_ERROR(launch_row_stats(A, stats, M, K, ln_dim, st));
#define PRODUCT_TF32(BN, NWG)                                                              \
  product_tf32_bn<BN, EPI, LN, NWG>(A, W, bias, ln_s, ln_b, stats, C, M, N, K, ln_dim, st)
  if (bn == 16) return wgs == 1 ? PRODUCT_TF32(16, 1) : PRODUCT_TF32(16, 2);
  if (bn == 32) return wgs == 1 ? PRODUCT_TF32(32, 1) : PRODUCT_TF32(32, 2);
  if (bn == 64) return PRODUCT_TF32(64, 1);
#undef PRODUCT_TF32
  return cudaErrorInvalidValue;
}

// An LN product of "tf32x3" in the form the plan named (Config::ln).
template <int EPI>
cudaError_t ln_product_tf32(int ln, int bn, int wgs, const float* A, const float* W,
                            const float* bias, const float* ln_s, const float* ln_b,
                            float2* stats, float* C, int M, int N, int K, int ln_dim,
                            cudaStream_t st) {
  if (ln == kStreamed)
    return product_tf32<EPI, kLnStreamed>(bn, wgs, A, W, bias, ln_s, ln_b, stats, C, M, N, K,
                                          ln_dim, st);
  return product_tf32<EPI, kLnResident>(bn, wgs, A, W, bias, ln_s, ln_b, stats, C, M, N, K,
                                        ln_dim, st);
}

template <int NC, int BN, bool KSPLIT>
cudaError_t ring_tf32_bn(const CUtensorMap& a, const CUtensorMap& w, int layer, const float* bias,
                         float* C, int M, int N, int K, int epi, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  using R = tf32_ring::Ring<NC, BN, KSPLIT>;
  const auto kernel = tf32_ring::ring_product_kernel<NC, BN, KSPLIT>;
  RETURN_IF_ERROR(allow_smem(kernel, allowed, R::smem_bytes()));
  Limits card;
  RETURN_IF_ERROR(device_limits(&card));
  const long long tiles =
      (long long)((N + BN - 1) / BN) * ((M + R::kTileRows - 1) / R::kTileRows);
  const int slots = card.sms * R::kCtasPerSm;
  const int grid = (int)(tiles < slots ? tiles : slots);
  kernel<<<grid, R::kThreads, R::smem_bytes(), st>>>(a, w, layer, bias, C, M, N, K, epi);
  return cudaGetLastError();
}

// A float32 product of the prenormed form ("tf32x3"): C = epilogue(A .
// W[layer] + bias), A and W as the maps a and w give them, at N tile bn
// with the plan's warpgroups wgs: tile 128 is CTAs of 128 rows by 128
// columns; 16 and 32 with two warpgroups deal K to two consumers of the
// same 64 rows (the streamed form's split, the same sums); else CTAs of 64
// rows.
cudaError_t ring_tf32(int epi, int bn, int wgs, const CUtensorMap& a, const CUtensorMap& w,
                      int layer, const float* bias, float* C, int M, int N, int K,
                      cudaStream_t st) {
  if (N % 8 || K % 8) return cudaErrorInvalidValue;
#define RING_TF32(NC, BN, KSPLIT) \
  ring_tf32_bn<NC, BN, KSPLIT>(a, w, layer, bias, C, M, N, K, epi, st)
  if (bn == 128) return RING_TF32(2, 128, false);
  if (wgs == 2 && bn == 16) return RING_TF32(2, 16, true);
  if (wgs == 2 && bn == 32) return RING_TF32(2, 32, true);
  if (bn == 16) return RING_TF32(1, 16, false);
  if (bn == 32) return RING_TF32(1, 32, false);
  if (bn == 64) return RING_TF32(1, 64, false);
#undef RING_TF32
  return cudaErrorInvalidValue;
}

template <int DH, int NWG>
cudaError_t attention_tf32(const float* qkv, float* out, int B, int S, int H, float c,
                           cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_tf32::attention_kernel<DH, NWG>;
  const size_t smem = encoder_tf32::attention_smem_bytes(DH, NWG);
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  const int tiles = (S + tf32x3::kRows - 1) / tf32x3::kRows;
  kernel<<<tiles * B * H, tf32x3::kThreads * NWG, smem, st>>>(qkv, out, S, H, tiles, c);
  return cudaGetLastError();
}

// Every head dim that is a multiple of 8 up to 128 is built with one
// warpgroup, and up to encoder_tf32::kSplitMaxDh with two (the padded rule
// of ops/vit_block.py::head_pad: another head dim runs at the next one);
// above 128, the panel kernel at G = group panels of o a CTA (a divisor of
// ceil(dh / 64) up to 4).
template <int DH = 8>
cudaError_t attention_tf32_dh(int dh, int wgs, int group, const float* qkv, float* out, int B,
                              int S, int H, float c, cudaStream_t st) {
  if constexpr (DH > kAttMaxDh) {
    if (dh <= kAttMaxDh || wgs != 1) return cudaErrorInvalidValue;
    switch (group) {
      case 1: return attention_panels_tf32<1>(qkv, out, B, S, H, dh, c, st);
      case 2: return attention_panels_tf32<2>(qkv, out, B, S, H, dh, c, st);
      case 3: return attention_panels_tf32<3>(qkv, out, B, S, H, dh, c, st);
      case 4: return attention_panels_tf32<4>(qkv, out, B, S, H, dh, c, st);
      default: return cudaErrorInvalidValue;
    }
  } else {
    if (dh != DH) return attention_tf32_dh<DH + 8>(dh, wgs, group, qkv, out, B, S, H, c, st);
    if (wgs == 1) return attention_tf32<DH, 1>(qkv, out, B, S, H, c, st);
    if constexpr (DH <= encoder_tf32::kSplitMaxDh) {
      if (wgs == 2) return attention_tf32<DH, 2>(qkv, out, B, S, H, c, st);
    }
    return cudaErrorInvalidValue;
  }
}

template <typename T, int EPI>
cudaError_t gemm(const T* A, const T* W, const T* bias, const T* resid, T* C,
                 int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bias_kernel<T, EPI><<<grid, kGemmThreads, 0, st>>>(A, W, bias, resid, C, M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t layer_norm(const T* x, const T* s, const T* b, T* y, int rows, int d,
                       cudaStream_t st) {
  const int warps = kLnThreads / 32;
  layer_norm_kernel<T><<<(rows + warps - 1) / warps, kLnThreads, 0, st>>>(x, s, b, y, rows, d);
  return cudaGetLastError();
}

// The float32 ring's N tiles: each 16, 32, 64 or 128, and 128 for every
// product or none (a CTA's rows, which the A maps' boxes share).
bool tf32_ring_tiles(const Config& c) {
  int wide = 0;
  for (int bn : c.bn) {
    if (bn != 16 && bn != 32 && bn != 64 && bn != 128) return false;
    wide += bn == 128;
  }
  return wide == 0 || wide == 4;
}

// Everything a call checks before its first launch: the shape against the
// variant, and the variant against the dtype; dh is the head dim the kernels
// run at, D / H or more; W the residual width, D or D zero-padded to the
// next multiple of 64 ("mma") or 32 ("tf32x3"); hidden the MLP width of the
// weights (padded); c the plan: the LN products' form the variant takes
// ("mma": resident or prenormed, the latter with one or two warpgroups a
// CTA; "tf32x3": resident or streamed; "simt": none).  A resident form
// whose rows do not fit the card's shared memory fails at its launch
// (allow_smem).
cudaError_t check(const Config& c, int dtype, int B, int S, int D, int W, int H, int dh,
                  int hidden) {
  if (B < 1 || S < 1 || H < 1 || D % H || dh < D / H || W < D
      || (long long)B * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bool ok = false;
  if ((c.group != 0) != (c.variant != kSimt && dh > kAttMaxDh)) return cudaErrorInvalidValue;
  if (c.variant == kMma)
    ok = dtype == 1
         && (dh == 32 || dh == 64 || dh == 128
             || (dh > kAttMaxDh && dh % 64 == 0 && c.group >= 1 && c.group <= 3
                 && dh / 64 % c.group == 0))
         && W % 64 == 0 && W - D < 64 && hidden % 64 == 0
         && (c.ln == kResident
             || (c.ln == kPrenormed && (c.warpgroups == 1 || c.warpgroups == 2)));
  else if (c.variant == kTf32x3)
    ok = dtype == 0 && dh % 8 == 0 && W % 32 == 0 && W - D < 32 && hidden % 32 == 0
         && (c.ln == kResident || c.ln == kStreamed
             || (c.ln == kPrenormed && tf32_ring_tiles(c)))
         && (dh <= kAttMaxDh
             || (c.group >= 1 && c.group <= tf32_panels::kMaxGroup
                 && (dh + tf32_panels::kCols - 1) / tf32_panels::kCols % c.group == 0));
  else if (c.variant == kSimt)
    ok = dtype == 0 && W == D && dh % 16 == 0 && dh <= kAttMaxDh && hidden % 16 == 0
         && c.ln == kResident;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// One pre-LN block in place on x (B * S rows of W, the residual width):
// five launches (bf16: mma, resident; float32: tf32x3), seven where their
// LN products stream (tf32x3 by name: a statistics launch before each) or
// are prenormed (mma and tf32x3: the LN rows written before each), or seven
// (float32: simt).  w points at this block's weights, block `layer` of the stacks
// the maps name (prenormed); heads of dh (D / H, or a zero-padded one above
// it) in an inner width E = H . dh; h (B * S, D) is read by simt alone;
// ln_scratch holds the streamed form's statistics ((B * S, 2) float32) or
// the prenormed form's LN rows ((B * S, W) in T).  W = D but for a padded
// "mma" or "tf32x3" width, whose LN products normalise the first D of W
// columns.
template <typename T>
cudaError_t block_launches(T* x, const Weights& w, int B, int S, int D, int W, int H, int dh,
                           int hidden, const Config& c, T* hb, T* qkv, T* attn, T* hid,
                           void* ln_scratch, const RingMaps& maps, int layer,
                           cudaStream_t st) {
  const int M = B * S, E = H * dh;
  const float scale = (float)(1.0 / sqrt((double)(D / H)));   // the true head dim's
  const auto p = [](const void* q) { return static_cast<const T*>(q); };
  if constexpr (std::is_same<T, float>::value) {
    if (c.variant == kTf32x3 && c.ln == kPrenormed) {
      const float log2e_scale = (float)(1.4426950408889634 / sqrt((double)(D / H)));
      float* normed = static_cast<float*>(ln_scratch);
      const int g = c.warpgroups;
      RETURN_IF_ERROR(ln_rows<float>(x, p(w.ln1_s), p(w.ln1_b), normed, M, W, D, st));
      RETURN_IF_ERROR(ring_tf32(kEpiRound, c.bn[0], g, maps.normed, maps.qkv, layer,
                                p(w.b_qkv), qkv, M, 3 * E, W, st));
      RETURN_IF_ERROR(attention_tf32_dh(dh, g, c.group, qkv, attn, B, S, H, log2e_scale, st));
      RETURN_IF_ERROR(ring_tf32(kEpiResidual, c.bn[1], g, maps.attn, maps.proj, layer,
                                p(w.b_proj), x, M, W, E, st));
      RETURN_IF_ERROR(ln_rows<float>(x, p(w.ln2_s), p(w.ln2_b), normed, M, W, D, st));
      RETURN_IF_ERROR(ring_tf32(kEpiGelu, c.bn[2], g, maps.normed, maps.mlp1, layer,
                                p(w.b_mlp1), hid, M, hidden, W, st));
      return ring_tf32(kEpiResidual, c.bn[3], g, maps.hid, maps.mlp2, layer, p(w.b_mlp2), x, M,
                       W, hidden, st);
    }
    if (c.variant == kTf32x3) {
      const float log2e_scale = (float)(1.4426950408889634 / sqrt((double)(D / H)));
      // Two warpgroups, where the plan says so, in the attention and in the
      // products of N tile 16 and 32 (N 64 is built with one).
      const auto ks = [&](int bn) { return bn == 64 ? 1 : c.warpgroups; };
      float2* stats = static_cast<float2*>(ln_scratch);
      RETURN_IF_ERROR(ln_product_tf32<kEpiRound>(c.ln, c.bn[0], ks(c.bn[0]), x, p(w.w_qkv),
                                                 p(w.b_qkv), p(w.ln1_s), p(w.ln1_b), stats,
                                                 qkv, M, 3 * E, W, D, st));
      RETURN_IF_ERROR(attention_tf32_dh(dh, c.warpgroups, c.group, qkv, attn, B, S, H,
                                        log2e_scale, st));
      RETURN_IF_ERROR((product_tf32<kEpiResidual, kLnNone>(c.bn[1], ks(c.bn[1]), attn,
                                                           p(w.w_proj), p(w.b_proj), nullptr,
                                                           nullptr, nullptr, x, M, W, E, 0,
                                                           st)));
      RETURN_IF_ERROR(ln_product_tf32<kEpiGelu>(c.ln, c.bn[2], ks(c.bn[2]), x, p(w.w_mlp1),
                                                p(w.b_mlp1), p(w.ln2_s), p(w.ln2_b), stats,
                                                hid, M, hidden, W, D, st));
      return product_tf32<kEpiResidual, kLnNone>(c.bn[3], ks(c.bn[3]), hid, p(w.w_mlp2),
                                                 p(w.b_mlp2), nullptr, nullptr, nullptr, x, M,
                                                 W, hidden, 0, st);
    }
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (c.ln == kPrenormed) {
      bf16* normed = static_cast<bf16*>(ln_scratch);
      const int g = c.warpgroups;
      RETURN_IF_ERROR(ln_rows<bf16>(x, p(w.ln1_s), p(w.ln1_b), normed, M, W, D, st));
      RETURN_IF_ERROR(ring_product<kEpiRound>(g, c.bn[0], maps.normed, maps.qkv, layer,
                                              p(w.b_qkv), qkv, M, 3 * E, W, st));
      RETURN_IF_ERROR(attention_mma_dh(dh, c.group, maps.heads, qkv, attn, B, S, H, scale, st));
      RETURN_IF_ERROR(ring_product<kEpiResidual>(g, c.bn[1], maps.attn, maps.proj, layer,
                                                 p(w.b_proj), x, M, W, E, st));
      RETURN_IF_ERROR(ln_rows<bf16>(x, p(w.ln2_s), p(w.ln2_b), normed, M, W, D, st));
      RETURN_IF_ERROR(ring_product<kEpiGelu>(g, c.bn[2], maps.normed, maps.mlp1, layer,
                                             p(w.b_mlp1), hid, M, hidden, W, st));
      return ring_product<kEpiResidual>(g, c.bn[3], maps.hid, maps.mlp2, layer, p(w.b_mlp2), x,
                                        M, W, hidden, st);
    }
    RETURN_IF_ERROR((product<kEpiRound, kLnResident>(c.bn[0], x, p(w.w_qkv), p(w.b_qkv),
                                                     p(w.ln1_s), p(w.ln1_b), qkv, M, 3 * E, W,
                                                     D, st)));
    RETURN_IF_ERROR(attention_mma_dh(dh, c.group, maps.heads, qkv, attn, B, S, H, scale, st));
    RETURN_IF_ERROR((product<kEpiResidual, kLnNone>(c.bn[1], attn, p(w.w_proj), p(w.b_proj),
                                                    nullptr, nullptr, x, M, W, E, 0, st)));
    RETURN_IF_ERROR((product<kEpiGelu, kLnResident>(c.bn[2], x, p(w.w_mlp1), p(w.b_mlp1),
                                                    p(w.ln2_s), p(w.ln2_b), hid, M, hidden, W,
                                                    D, st)));
    return product<kEpiResidual, kLnNone>(c.bn[3], hid, p(w.w_mlp2), p(w.b_mlp2), nullptr,
                                          nullptr, x, M, W, hidden, 0, st);
  } else {
    RETURN_IF_ERROR(layer_norm<T>(x, p(w.ln1_s), p(w.ln1_b), hb, M, D, st));
    RETURN_IF_ERROR((gemm<T, kEpiRound>(hb, p(w.w_qkv), p(w.b_qkv), nullptr, qkv, M, 3 * E, D,
                                        st)));
    attention_simt_kernel<T><<<dim3((S + kAttQt - 1) / kAttQt, H, B), kAttThreads, 0, st>>>(
        qkv, attn, S, E, dh, scale);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR((gemm<T, kEpiResidual>(attn, p(w.w_proj), p(w.b_proj), x, x, M, D, E, st)));
    RETURN_IF_ERROR(layer_norm<T>(x, p(w.ln2_s), p(w.ln2_b), hb, M, D, st));
    RETURN_IF_ERROR((gemm<T, kEpiGelu>(hb, p(w.w_mlp1), p(w.b_mlp1), nullptr, hid, M, hidden, D,
                                       st)));
    return gemm<T, kEpiResidual>(hid, p(w.w_mlp2), p(w.b_mlp2), x, x, M, D, hidden, st);
  }
}

// `depth` blocks in place on x_out, a copy of x_in; w stacked over depth
// (depth 1: one block's own weights).  With W > D (a padded width) the
// blocks run on h_buf (B . S, W) instead: x_in copied into its first D
// columns, the rest set to 0, and the first D columns copied to x_out at
// the end.
template <typename T>
cudaError_t forward(const Config& c, int B, int S, int D, int W, int H, int dh, int hidden,
                    int depth, const void* x_in, void* x_out, const Weights& w, void* h_buf,
                    void* qkv_buf, void* attn_buf, void* hid_buf, void* ln_scratch,
                    cudaStream_t st) {
  const size_t rows = (size_t)B * S, e = sizeof(T);
  RingMaps maps;
  if (c.ln == kPrenormed)
    RETURN_IF_ERROR(ring_maps<T>(&maps, c, w, (int)rows, W, H * dh, hidden, depth, ln_scratch,
                                 attn_buf, hid_buf));
  if (std::is_same<T, bf16>::value && dh > kAttMaxDh)
    RETURN_IF_ERROR(heads_map(&maps.heads, qkv_buf, B, S, H * dh));
  T* x = static_cast<T*>(W == D ? x_out : h_buf);
  if (W == D) {
    RETURN_IF_ERROR(cudaMemcpyAsync(x, x_in, rows * D * e, cudaMemcpyDeviceToDevice, st));
  } else {
    RETURN_IF_ERROR(cudaMemset2DAsync(x + D, W * e, 0, (W - D) * e, rows, st));
    RETURN_IF_ERROR(cudaMemcpy2DAsync(x, W * e, x_in, D * e, D * e, rows,
                                      cudaMemcpyDeviceToDevice, st));
  }
  const int dtype = std::is_same<T, bf16>::value ? 1 : 0;
  for (int l = 0; l < depth; ++l)
    RETURN_IF_ERROR(block_launches<T>(x, layer_weights(w, l, W, H * dh, hidden, dtype,
                                                       c.variant), B, S,
                                      D, W, H, dh, hidden, c, static_cast<T*>(h_buf),
                                      static_cast<T*>(qkv_buf), static_cast<T*>(attn_buf),
                                      static_cast<T*>(hid_buf), ln_scratch, maps, l, st));
  if (W != D)
    RETURN_IF_ERROR(cudaMemcpy2DAsync(x_out, D * e, x, W * e, D * e, rows,
                                      cudaMemcpyDeviceToDevice, st));
  return cudaGetLastError();
}

cudaError_t run(const Config& c, int dtype, int B, int S, int D, int W, int H, int dh,
                int hidden, int depth, const void* x_in, void* x_out, const Weights& w, void* h,
                void* qkv, void* attn, void* hid, void* ln_scratch, cudaStream_t st) {
  RETURN_IF_ERROR(check(c, dtype, B, S, D, W, H, dh, hidden));
  if (depth < 1 || (c.ln != kResident && ln_scratch == nullptr)) return cudaErrorInvalidValue;
  if (dtype == 1)
    return forward<bf16>(c, B, S, D, W, H, dh, hidden, depth, x_in, x_out, w, h, qkv, attn,
                         hid, ln_scratch, st);
  return forward<float>(c, B, S, D, W, H, dh, hidden, depth, x_in, x_out, w, h, qkv, attn,
                        hid, ln_scratch, st);
}

}  // namespace

// variant: 0 = "simt" (float32), 1 = "mma" (bfloat16), 2 = "tf32x3"
// (float32); bn_*, warpgroups, ln, group: the N tiles, the warpgroups a CTA,
// the LN products' form (0 resident, 1 streamed, 2 prenormed) and, above a
// head dim of 128, the panels of o an attention CTA ("mma" 1 to 3, a
// divisor of head_dim / 64; "tf32x3" 1 to 4, a divisor of ceil(head_dim /
// 64); 0 elsewhere) of the plan (see Config above).  dtype: 0 = float32,
// 1 = bfloat16.  dim: D, the width of x and of the output; width: the residual width W the weights have, D or D
// zero-padded to the next multiple of 64 ("mma") or 32 ("tf32x3"; see the
// header).  head_dim: the head dim the kernels
// run at, dim / heads or the zero-padded one of the weights (E = heads .
// head_dim below; the scale stays (dim / heads)^-1/2).  hidden: the MLP
// width of the weights.  All tensors contiguous on the current device and
// 16-byte aligned: x (B, S, D); weights stacked over depth as (depth, ...)
// with kernels (in, out), LN scales and biases and the proj and mlp2 biases
// (W), the qkv kernel (W, 3E) and bias (3E), the proj kernel (E, W), mlp1
// (W, hidden), mlp2 (hidden, W) ("tf32x3": each of the four kernels as two
// planes, (depth, 2, in, out), hi = tf32(w) then lo = tf32(w - hi), rounded
// to nearest with ties away from zero; prenormed, each plane transposed,
// (depth, 2, out, in)); scratch h (B*S, D) read by "simt"
// alone, (B*S, W) the residual stream of a padded call, attn (B*S, E), qkv
// (B*S, 3E), mlp_hidden (B*S, hidden), ln_scratch: the streamed LN
// products' rows' (mean, rstd) ((B*S, 2) float32) or the prenormed form's
// LN rows ((B*S, W) in x's type), null where ln is 0.  x_out must not alias x_in.
// Returns a cudaError_t.
extern "C" int vit_encoder_forward(
    int variant, int bn_qkv, int bn_proj, int bn_mlp1, int bn_mlp2, int warpgroups, int ln,
    int group, int dtype, int batch, int seq, int dim, int width, int heads, int head_dim,
    int hidden, int depth,
    const void* x_in, void* x_out,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* ln2_s, const void* ln2_b,
    const void* w_mlp1, const void* b_mlp1, const void* w_mlp2, const void* b_mlp2,
    void* h, void* qkv, void* attn, void* mlp_hidden, void* ln_scratch, void* stream) {
  const Config c{variant, {bn_qkv, bn_proj, bn_mlp1, bn_mlp2}, warpgroups, ln, group};
  const Weights w{ln1_s, ln1_b, w_qkv, b_qkv, w_proj, b_proj,
                  ln2_s, ln2_b, w_mlp1, b_mlp1, w_mlp2, b_mlp2};
  return (int)run(c, dtype, batch, seq, dim, width, heads, head_dim, hidden, depth, x_in, x_out,
                  w, h, qkv, attn, mlp_hidden, ln_scratch, static_cast<cudaStream_t>(stream));
}

// One pre-LN block: replaces the TPU kernel
// gstreamer_vit_tracker_tpu/ops/vit_block.py::_block_kernel (the pallas_call in
// _fused_forward, reached through vit_block.block).  The TPU kernel's grid runs
// one program per batch element; here the batch folds into the rows of the
// four products and into the attention grid, so a call is the same launches at
// any B.  The weights are one block's own (not stacked): LN scales and biases
// (dim,), kernels (in, out), biases (out,).  Configuration, tensors and
// scratch as for vit_encoder_forward.  It shares the device code of the
// encoder's launches a block, so what bounds it is the same: launches and
// latency more than operations or bytes (at (16, 320, 192) bf16: 5.79 GFLOP,
// 5.9 us at 989 TFLOP/s).  Returns a cudaError_t.
extern "C" int vit_block_forward(
    int variant, int bn_qkv, int bn_proj, int bn_mlp1, int bn_mlp2, int warpgroups, int ln,
    int group, int dtype, int batch, int seq, int dim, int width, int heads, int head_dim,
    int hidden, const void* x_in, void* x_out,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* ln2_s, const void* ln2_b,
    const void* w_mlp1, const void* b_mlp1, const void* w_mlp2, const void* b_mlp2,
    void* h, void* qkv, void* attn, void* mlp_hidden, void* ln_scratch, void* stream) {
  const Config c{variant, {bn_qkv, bn_proj, bn_mlp1, bn_mlp2}, warpgroups, ln, group};
  const Weights w{ln1_s, ln1_b, w_qkv, b_qkv, w_proj, b_proj,
                  ln2_s, ln2_b, w_mlp1, b_mlp1, w_mlp2, b_mlp2};
  return (int)run(c, dtype, batch, seq, dim, width, heads, head_dim, hidden, 1, x_in, x_out, w,
                  h, qkv, attn, mlp_hidden, ln_scratch, static_cast<cudaStream_t>(stream));
}
