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
// five launches a block, the tiles of encoder_mma.cuh:
//   1. LN1 + qkv  2. attention  3. proj + residual  4. LN2 + mlp1 + GELU
//   5. mlp2 + residual; each product's N tile (32 or 64) as the plan says.
// The LN products come in two forms (Config::ln, the plan's choice from the
// shape alone).  Resident: the CTA's 64 rows of the residual stream sit in
// shared memory whole, 1024 + W / 64 . 64 . (64 + N tile) . 2 bytes, which
// the H100's 232,448 a block bound: W up to 1152 at N tile 32, 896 at 64
// (the flagship, D 192, and every width up to 768 at the plan's tiles).
// Streamed, past that: a row_stats_kernel launch before each LN product
// takes the rows' mean and rstd (the resident form's arithmetic and order,
// into the scratch `stats`), and the product walks K through its ring of
// three 64-deep chunks, each LayerNormed in place as it lands: 50 KB at N
// tile 64 for any W, seven launches a block, and the same LN output bit for
// bit.  What bounds either is the weights and the operations, as below.
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
// a block (seven where the LN products stream: resident while 64 rows of W
// fit, W up to 544 at N tile 32 and two warpgroups; streamed past it, a
// ring slot holding the chunk's LN scale and bias beside A), the
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
// double the weights' share: 13 us): bound by operations.  mma.sync and not
// wgmma: wgmma in TF32 takes both operands K-major from shared memory,
// which the (K, N) weights and V are not as they lie (attention_tf32.cuh's
// header); caching the weights transposed would allow it for the products,
// and is left for later.
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
// encoder_tf32.cuh): a CTA owns one panel of o and sums its scores over the
// panels of q and k, so its registers and shared memory are one panel's
// whatever the head dim; the products do not see the head dim.
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
// the N tile of the qkv, proj, mlp1 and mlp2 products ("mma" 32 or 64,
// "tf32x3" 16, 32 or 64); for "tf32x3" the warpgroups a CTA, 1 or 2 (2 at
// batch 1): the attention's share a query tile's key blocks (head dims up
// to 64), a product's of N tile 16 or 32 its K; for both the form of the LN
// products, 0 resident or 1 streamed.  "simt" reads none of them, "mma"
// not the warpgroups.
struct Config {
  int variant;
  int bn[4];
  int warpgroups;
  int ln;
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

// The streamed form's statistics of the M rows of A ((M, K), T) over their
// first ln_dim columns into stats: one launch, 16 rows a CTA.
template <typename T>
cudaError_t launch_row_stats(const T* A, float2* stats, int M, int K, int ln_dim,
                             cudaStream_t st) {
  constexpr int kRowsACta = mma::kThreads / 8;
  encoder_mma::row_stats_kernel<T>
      <<<(M + kRowsACta - 1) / kRowsACta, mma::kThreads, 0, st>>>(A, stats, M, K, ln_dim);
  return cudaGetLastError();
}

template <int BN, int EPI, int LN>
cudaError_t product_bn(const bf16* A, const bf16* W, const bf16* bias, const bf16* ln_s,
                       const bf16* ln_b, const float2* stats, bf16* C, int M, int N, int K,
                       int ln_dim, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = encoder_mma::product_kernel<BN, EPI, LN>;
  const size_t smem = encoder_mma::product_smem_bytes(
      BN, LN == kLnResident ? K / encoder_mma::kChunk : encoder_mma::kRing);
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  const dim3 grid(N / BN, (M + mma::kTileRows - 1) / mma::kTileRows);
  kernel<<<grid, mma::kThreads, smem, st>>>(A, W, bias, ln_s, ln_b, stats, C, M, N, K, ln_dim);
  return cudaGetLastError();
}

// ln_dim: the true columns of A the LayerNorm runs over (LN products; K or
// fewer, the rest zero padding).  LN kLnStreamed launches row_stats_kernel into
// stats first.
template <int EPI, int LN>
cudaError_t product(int bn, const bf16* A, const bf16* W, const bf16* bias, const bf16* ln_s,
                    const bf16* ln_b, float2* stats, bf16* C, int M, int N, int K, int ln_dim,
                    cudaStream_t st) {
  if (N % bn || K % encoder_mma::kChunk || (LN != kLnNone && (ln_dim < 1 || ln_dim > K)))
    return cudaErrorInvalidValue;
  if (LN == kLnStreamed) RETURN_IF_ERROR(launch_row_stats(A, stats, M, K, ln_dim, st));
  if (bn == 32)
    return product_bn<32, EPI, LN>(A, W, bias, ln_s, ln_b, stats, C, M, N, K, ln_dim, st);
  if (bn == 64)
    return product_bn<64, EPI, LN>(A, W, bias, ln_s, ln_b, stats, C, M, N, K, ln_dim, st);
  return cudaErrorInvalidValue;
}

// An LN product in the form the plan named (Config::ln).
template <int EPI>
cudaError_t ln_product(int ln, int bn, const bf16* A, const bf16* W, const bf16* bias,
                       const bf16* ln_s, const bf16* ln_b, float2* stats, bf16* C, int M, int N,
                       int K, int ln_dim, cudaStream_t st) {
  if (ln == 1)
    return product<EPI, kLnStreamed>(bn, A, W, bias, ln_s, ln_b, stats, C, M, N, K, ln_dim, st);
  return product<EPI, kLnResident>(bn, A, W, bias, ln_s, ln_b, stats, C, M, N, K, ln_dim, st);
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

// A head dim above kAttMaxDh (both tensor-core variants): the panel
// kernel, tiles x B x H x panels CTAs of one warpgroup.
template <typename T, typename K>
cudaError_t attention_panels(K kernel, size_t smem, const T* qkv, T* out, int B, int S, int H,
                             int dh, float scale, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  const int tiles = (S + mma::kTileRows - 1) / mma::kTileRows;
  const long long grid = (long long)tiles * B * H * ((dh + 63) / 64);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(int)grid, mma::kThreads, smem, st>>>(qkv, out, S, H, tiles, dh, scale);
  return cudaGetLastError();
}

cudaError_t attention_mma_dh(int dh, const bf16* qkv, bf16* out, int B, int S, int H,
                             float scale, cudaStream_t st) {
  switch (dh) {
    case 32: return attention_mma<32>(qkv, out, B, S, H, scale, st);
    case 64: return attention_mma<64>(qkv, out, B, S, H, scale, st);
    case 128: return attention_mma<128>(qkv, out, B, S, H, scale, st);
    default:
      if (dh <= kAttMaxDh || dh % 64) return cudaErrorInvalidValue;
      return attention_panels(encoder_mma::attention_panels_kernel<encoder_mma::kKeyBlock>,
                              encoder_mma::attention_panels_smem_bytes(), qkv, out, B, S, H, dh,
                              scale, st);
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
  if (ln == 1)
    return product_tf32<EPI, kLnStreamed>(bn, wgs, A, W, bias, ln_s, ln_b, stats, C, M, N, K,
                                          ln_dim, st);
  return product_tf32<EPI, kLnResident>(bn, wgs, A, W, bias, ln_s, ln_b, stats, C, M, N, K,
                                        ln_dim, st);
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
// above 128, the panel kernel with one.
template <int DH = 8>
cudaError_t attention_tf32_dh(int dh, int wgs, const float* qkv, float* out, int B, int S,
                              int H, float c, cudaStream_t st) {
  if constexpr (DH > kAttMaxDh) {
    if (dh <= kAttMaxDh || wgs != 1) return cudaErrorInvalidValue;
    return attention_panels(encoder_tf32::attention_panels_kernel<tf32x3::kKeys>,
                            encoder_tf32::attention_panels_smem_bytes(), qkv, out, B, S, H, dh,
                            c, st);
  } else {
    if (dh != DH) return attention_tf32_dh<DH + 8>(dh, wgs, qkv, out, B, S, H, c, st);
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

// Everything a call checks before its first launch: the shape against the
// variant, and the variant against the dtype; dh is the head dim the kernels
// run at, D / H or more; W the residual width, D or D zero-padded to the
// next multiple of 64 ("mma") or 32 ("tf32x3"); hidden the MLP width of the
// weights (padded); ln the LN products' form.  A resident form whose rows do
// not fit the card's shared memory fails at its launch (allow_smem).
cudaError_t check(int variant, int dtype, int B, int S, int D, int W, int H, int dh,
                  int hidden, int ln) {
  if (B < 1 || S < 1 || H < 1 || D % H || dh < D / H || W < D || (ln != 0 && ln != 1)
      || (long long)B * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  bool ok = false;
  if (variant == kMma)
    ok = dtype == 1 && (dh == 32 || dh == 64 || dh == 128 || (dh > kAttMaxDh && dh % 64 == 0))
         && W % 64 == 0 && W - D < 64 && hidden % 64 == 0;
  else if (variant == kTf32x3)
    ok = dtype == 0 && dh % 8 == 0 && W % 32 == 0 && W - D < 32 && hidden % 32 == 0;
  else if (variant == kSimt)
    ok = dtype == 0 && W == D && dh % 16 == 0 && dh <= kAttMaxDh && hidden % 16 == 0;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// One pre-LN block in place on x (B * S rows of W, the residual width):
// five launches (bf16: mma; float32: tf32x3), seven where their LN products
// stream (a statistics launch before each), or seven (float32: simt).  w
// points at this block's weights; heads of dh (D / H, or a zero-padded one
// above it) in an inner width E = H . dh; h (B * S, D) is read by simt
// alone, stats (B * S) by the streamed LN products.  W = D but for a padded
// "mma" or "tf32x3" width, whose LN products normalise the first D of W
// columns.
template <typename T>
cudaError_t block_launches(T* x, const Weights& w, int B, int S, int D, int W, int H, int dh,
                           int hidden, const Config& c, T* hb, T* qkv, T* attn, T* hid,
                           float2* stats, cudaStream_t st) {
  const int M = B * S, E = H * dh;
  const float scale = (float)(1.0 / sqrt((double)(D / H)));   // the true head dim's
  const auto p = [](const void* q) { return static_cast<const T*>(q); };
  if constexpr (std::is_same<T, float>::value) {
    if (c.variant == kTf32x3) {
      const float log2e_scale = (float)(1.4426950408889634 / sqrt((double)(D / H)));
      // Two warpgroups, where the plan says so, in the attention and in the
      // products of N tile 16 and 32 (N 64 is built with one).
      const auto ks = [&](int bn) { return bn == 64 ? 1 : c.warpgroups; };
      RETURN_IF_ERROR(ln_product_tf32<kEpiRound>(c.ln, c.bn[0], ks(c.bn[0]), x, p(w.w_qkv),
                                                 p(w.b_qkv), p(w.ln1_s), p(w.ln1_b), stats,
                                                 qkv, M, 3 * E, W, D, st));
      RETURN_IF_ERROR(attention_tf32_dh(dh, c.warpgroups, qkv, attn, B, S, H, log2e_scale,
                                        st));
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
    RETURN_IF_ERROR(ln_product<kEpiRound>(c.ln, c.bn[0], x, p(w.w_qkv), p(w.b_qkv),
                                          p(w.ln1_s), p(w.ln1_b), stats, qkv, M, 3 * E, W, D,
                                          st));
    RETURN_IF_ERROR(attention_mma_dh(dh, qkv, attn, B, S, H, scale, st));
    RETURN_IF_ERROR((product<kEpiResidual, kLnNone>(c.bn[1], attn, p(w.w_proj), p(w.b_proj),
                                                    nullptr, nullptr, nullptr, x, M, W, E, 0,
                                                    st)));
    RETURN_IF_ERROR(ln_product<kEpiGelu>(c.ln, c.bn[2], x, p(w.w_mlp1), p(w.b_mlp1),
                                         p(w.ln2_s), p(w.ln2_b), stats, hid, M, hidden, W, D,
                                         st));
    return product<kEpiResidual, kLnNone>(c.bn[3], hid, p(w.w_mlp2), p(w.b_mlp2), nullptr,
                                          nullptr, nullptr, x, M, W, hidden, 0, st);
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
                    void* qkv_buf, void* attn_buf, void* hid_buf, void* stats,
                    cudaStream_t st) {
  const size_t rows = (size_t)B * S, e = sizeof(T);
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
                                      static_cast<T*>(hid_buf), static_cast<float2*>(stats),
                                      st));
  if (W != D)
    RETURN_IF_ERROR(cudaMemcpy2DAsync(x_out, D * e, x, W * e, D * e, rows,
                                      cudaMemcpyDeviceToDevice, st));
  return cudaGetLastError();
}

cudaError_t run(const Config& c, int dtype, int B, int S, int D, int W, int H, int dh,
                int hidden, int depth, const void* x_in, void* x_out, const Weights& w, void* h,
                void* qkv, void* attn, void* hid, void* stats, cudaStream_t st) {
  RETURN_IF_ERROR(check(c.variant, dtype, B, S, D, W, H, dh, hidden, c.ln));
  if (depth < 1 || (c.variant != kSimt && c.ln == 1 && stats == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return forward<bf16>(c, B, S, D, W, H, dh, hidden, depth, x_in, x_out, w, h, qkv, attn,
                         hid, stats, st);
  return forward<float>(c, B, S, D, W, H, dh, hidden, depth, x_in, x_out, w, h, qkv, attn,
                        hid, stats, st);
}

}  // namespace

// variant: 0 = "simt" (float32), 1 = "mma" (bfloat16), 2 = "tf32x3"
// (float32); bn_*, warpgroups, ln: the N tiles, the warpgroups a CTA and the
// LN products' form (0 resident, 1 streamed) of the plan (see Config
// above).  dtype: 0 = float32, 1 = bfloat16.  dim: D, the width of x and of
// the output; width: the residual width W the weights have, D or D
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
// to nearest with ties away from zero); scratch h (B*S, D) read by "simt"
// alone, (B*S, W) the residual stream of a padded call, attn (B*S, E), qkv
// (B*S, 3E), mlp_hidden (B*S, hidden), stats (B*S, 2) float32 the streamed
// LN products' rows' (mean, rstd) (null where ln is 0).  x_out must not
// alias x_in.  Returns a cudaError_t.
extern "C" int vit_encoder_forward(
    int variant, int bn_qkv, int bn_proj, int bn_mlp1, int bn_mlp2, int warpgroups, int ln,
    int dtype, int batch, int seq, int dim, int width, int heads, int head_dim, int hidden,
    int depth,
    const void* x_in, void* x_out,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* ln2_s, const void* ln2_b,
    const void* w_mlp1, const void* b_mlp1, const void* w_mlp2, const void* b_mlp2,
    void* h, void* qkv, void* attn, void* mlp_hidden, void* stats, void* stream) {
  const Config c{variant, {bn_qkv, bn_proj, bn_mlp1, bn_mlp2}, warpgroups, ln};
  const Weights w{ln1_s, ln1_b, w_qkv, b_qkv, w_proj, b_proj,
                  ln2_s, ln2_b, w_mlp1, b_mlp1, w_mlp2, b_mlp2};
  return (int)run(c, dtype, batch, seq, dim, width, heads, head_dim, hidden, depth, x_in, x_out,
                  w, h, qkv, attn, mlp_hidden, stats, static_cast<cudaStream_t>(stream));
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
    int dtype, int batch, int seq, int dim, int width, int heads, int head_dim, int hidden,
    const void* x_in, void* x_out,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* ln2_s, const void* ln2_b,
    const void* w_mlp1, const void* b_mlp1, const void* w_mlp2, const void* b_mlp2,
    void* h, void* qkv, void* attn, void* mlp_hidden, void* stats, void* stream) {
  const Config c{variant, {bn_qkv, bn_proj, bn_mlp1, bn_mlp2}, warpgroups, ln};
  const Weights w{ln1_s, ln1_b, w_qkv, b_qkv, w_proj, b_proj,
                  ln2_s, ln2_b, w_mlp1, b_mlp1, w_mlp2, b_mlp2};
  return (int)run(c, dtype, batch, seq, dim, width, heads, head_dim, hidden, 1, x_in, x_out, w,
                  h, qkv, attn, mlp_hidden, stats, static_cast<cudaStream_t>(stream));
}
