// Whole ViT encoder forward (every pre-LN block) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel gstreamer_vit_tracker_tpu/ops/vit_block.py::_encoder_kernel
// (the pallas_call in _encoder_forward, reached through vit_block.encoder from
// models/vit.py::encode at batch 1).  Per block it computes what _block_math
// computes, rounding where it rounds:
//   LN (f32, eps 1e-6) -> qkv (f32 acc + bias, rounded to T) -> per-head softmax
//   attention in f32 with P.V taken before the division by the row sum ->
//   heads rounded to T -> proj (f32 acc + bias, rounded) + residual in T ->
//   LN -> mlp1 (rounded) -> tanh GELU (f32, rounded) -> mlp2 (rounded) + residual.
// T is __nv_bfloat16 (the flagship) or float (the f32 presets).
//
// Bound on the H100 SXM at the flagship shape (B=1, S=320, D=192, depth 12,
// 3 heads of 64, MLP 768): 4.42 GFLOP (utils/flops.py::encoder_flops in the
// JAX package) is ~4.5 us at 989 TFLOP/s bf16; the weights, 12 x 0.885 MB =
// 10.6 MB, are ~3.2 us at 3.35 TB/s.  At batch 1 neither bounds this design:
// it is a host loop over depth issuing 7 launches a block (LN, 4 GEMMs, LN,
// attention), each a few microseconds of launch and latency on a handful of
// SMs, so it is bound by launches and latency far above both figures.  The
// TPU kernel's carry of the activation in VMEM across a sequential depth grid
// has no counterpart on 132 SMs that run blocks in no order; the activation
// goes through device memory (and L2) between launches instead.  Making this
// one persistent launch with wgmma and TMA is later work.
//
// Design, simple first:
//   * layer_norm_kernel: one warp per row, f32 statistics.
//   * gemm_bias_kernel: 64x64x32 tiles, 4 warps; tiles move as 16-byte
//     vectors, loaded into registers one k step ahead of the compute.  bf16
//     runs on the tensor cores through WMMA 16x16x16 fragments with f32
//     accumulators; float runs on the FMA units in f32 (no TF32, so the f32
//     presets stay f32).  The epilogue adds the bias in f32, rounds to T, and
//     then optionally applies the tanh GELU or adds the residual (in place:
//     C may alias resid).
//   * attention_kernel: one CTA per (16-query tile, head, batch).  K (stored
//     transposed, row stride padded to an odd number of 32-bit words so both
//     the transposing stores and the reads are free of bank conflicts) and V
//     of all S keys sit in dynamic shared memory, loaded as 16-byte vectors;
//     8 warps, each taking one query row at a time, compute the scores
//     (eight keys a lane at a time), the f32 softmax, and P.V divided by the
//     row sum (up to four head dims a lane).
// Every launch goes to the caller's stream; the entry point returns the first
// CUDA error (cudaGetLastError after each launch), 0 on success.
//
// A second entry, vit_block_forward, runs ONE block with its own unstacked
// weights on any batch through the same device code: it replaces the TPU
// kernel _block_kernel of the same file (see the note at the entry).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the point where the TPU kernel casts to x.dtype.
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

// jax.nn.gelu's default (approximate=True), = torch's gelu(approximate="tanh").
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k_beta * (x + 0.044715f * x * x * x)));
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row.
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
  const float mu = warp_sum(s) / d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float t = to_f32(xr[i]) - mu;
    v += t * t;
  }
  const float rstd = rsqrtf(warp_sum(v) / d + kLnEps);
  T* yr = y + (size_t)row * d;
  for (int i = lane; i < d; i += 32) {
    const float t = (to_f32(xr[i]) - mu) * rstd;
    yr[i] = from_f32<T>(t * to_f32(scale[i]) + to_f32(bias[i]));
  }
}

// ---------------------------------------------------------------------------
// C[M, N] = epilogue(A[M, K] @ W[K, N] + bias[N]), row-major, f32 accumulate.
// ---------------------------------------------------------------------------

enum Epilogue { kEpiRound = 0, kEpiGelu = 1, kEpiResidual = 2 };

constexpr int kBM = 64, kBN = 64, kBK = 32, kGemmThreads = 128;
constexpr int kALd = kBK + 8;   // padded smem row strides; WMMA needs a
constexpr int kBLd = kBN + 8;   // multiple of 8 halves (16 bytes)
constexpr int kCLd = kBN + 4;   // and of 4 floats for the f32 store

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
  __shared__ __align__(128) float Cs[kBM * kCLd];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  TileRegs<T> regs;
  regs.load(A, W, m0, n0, 0, M, N, K);

  if constexpr (std::is_same<T, bf16>::value) {
    namespace wmma = nvcuda::wmma;
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;   // 2 x 2 warps
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      regs.store(As, Bs);
      __syncthreads();
      if (k0 + kBK < K) regs.load(A, W, m0, n0, k0 + kBK, M, N, K);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16,
                                acc[i][j], kCLd, wmma::mem_row_major);
  } else {
    const int tx = tid & 15, ty = tid >> 4;   // 16 x 8 threads, 8 x 4 outputs each
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
      for (int j = 0; j < 4; ++j) Cs[(ty + 8 * i) * kCLd + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  for (int idx = tid; idx < kBM * kBN; idx += kGemmThreads) {
    const int r = idx / kBN, c = idx % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float v = round_to<T>(Cs[r * kCLd + c] + to_f32(bias[gn]));
    if constexpr (EPI == kEpiGelu) v = gelu_tanh(v);
    if constexpr (EPI == kEpiResidual) v = to_f32(resid[(size_t)gm * N + gn]) + v;
    C[(size_t)gm * N + gn] = from_f32<T>(v);
  }
}

// ---------------------------------------------------------------------------
// Softmax attention over one head: CTA = (16-query tile, head, batch).
// qkv: (B*S, 3D) rows [q | k | v], heads contiguous inside each; out: (B*S, D).
// ---------------------------------------------------------------------------

constexpr int kAttQt = 16, kAttThreads = 256, kAttWarps = kAttThreads / 32;

// Row stride (elements) of the transposed K tile: at least S, and an odd
// number of 32-bit words, so lanes that store consecutive d rows, or read
// consecutive keys, fall on distinct banks.
int k_stride(int seq, int elem_bytes) {
  int words = (seq * elem_bytes + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 4 / elem_bytes;
}

size_t attention_smem_bytes(int seq, int head_dim, int elem_bytes) {
  return (size_t)head_dim * k_stride(seq, elem_bytes) * elem_bytes   // K^T
         + (size_t)seq * head_dim * elem_bytes                       // V
         + (size_t)kAttQt * head_dim * sizeof(float)                 // Q tile
         + (size_t)kAttQt * seq * sizeof(float);                     // scores
}

template <typename T>
__global__ void __launch_bounds__(kAttThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S, int D,
                 int dh, int kstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Kt = reinterpret_cast<T*>(smem);                          // [dh][kstride]
  T* Vs = Kt + (size_t)dh * kstride;                           // [S][dh]
  float* Qs = reinterpret_cast<float*>(Vs + (size_t)S * dh);   // [Qt][dh]
  float* Ps = Qs + kAttQt * dh;                                // [Qt][S]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kAttQt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ld = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * S * ld;
  const int qoff = h * dh, koff = D + h * dh, voff = 2 * D + h * dh;

  // K and V rows arrive as 16-byte vectors (dh is a multiple of 16, so
  // every vector is aligned); V is stored as is, K scattered transposed.
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = dh / kVec;                  // vectors per row
  for (int v = tid; v < S * vpr; v += kAttThreads) {
    const int j = v / vpr, c = (v - j * vpr) * kVec;
    const T* row = base + (size_t)j * ld;
    const uint4 kv = *reinterpret_cast<const uint4*>(row + koff + c);
    *reinterpret_cast<uint4*>(Vs + (size_t)j * dh + c) =
        *reinterpret_cast<const uint4*>(row + voff + c);
    const T* ke = reinterpret_cast<const T*>(&kv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) Kt[(size_t)(c + e) * kstride + j] = ke[e];
  }
  for (int idx = tid; idx < kAttQt * dh; idx += kAttThreads) {
    const int i = idx / dh, d = idx - i * dh;
    const int qi = q0 + i;
    Qs[idx] = qi < S ? to_f32(base[(size_t)qi * ld + qoff + d]) : 0.f;
  }
  __syncthreads();

  for (int i = warp; i < kAttQt; i += kAttWarps) {
    const int qi = q0 + i;
    if (qi >= S) break;                       // the ragged last tile
    const float* q = Qs + i * dh;
    float* p = Ps + (size_t)i * S;
    float mx = -INFINITY;
    // Scores: each lane takes keys lane, lane+32, ... eight at a time, with
    // eight independent accumulators (indices past S are clamped and their
    // sums dropped).
    for (int j0 = 0; j0 < S; j0 += 8 * 32) {
      int jj[8];
      float acc[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        jj[t] = min(j0 + lane + 32 * t, S - 1);
        acc[t] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        const float qd = q[d];
        const T* krow = Kt + (size_t)d * kstride;
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[t] = fmaf(qd, to_f32(krow[jj[t]]), acc[t]);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = j0 + lane + 32 * t;
        if (j < S) {
          const float s = acc[t] * scale;
          p[j] = s;
          mx = fmaxf(mx, s);
        }
      }
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    __syncwarp();                             // every lane's p[j] is visible
    // P.V: each lane owns head dims lane, lane+32, ... (dh <= 128).
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
      const T* vrow = Vs + (size_t)j * dh;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = lane + 32 * u;
        if (d < dh) o[u] = fmaf(pj, to_f32(vrow[d]), o[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = lane + 32 * u;
      if (d < dh) out[((size_t)b * S + qi) * D + h * dh + d] = from_f32<T>(o[u] / l);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Host loop over depth.
// ---------------------------------------------------------------------------

struct Weights {   // row-major; stacked over depth for the encoder entry
  const void *ln1_s, *ln1_b, *w_qkv, *b_qkv, *w_proj, *b_proj,
      *ln2_s, *ln2_b, *w_mlp1, *b_mlp1, *w_mlp2, *b_mlp2;
};

template <typename T>
const T* layer(const void* p, int l, size_t per_layer) {
  return static_cast<const T*>(p) + (size_t)l * per_layer;
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

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    const cudaError_t err_ = (expr);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

// What one call needs beside its tensors: the attention kernel's shared memory
// (checked against the card and opted in to) and launch shape.
struct AttentionPlan {
  int kstride;
  size_t smem;
  dim3 grid;
  float scale;
};

template <typename T>
cudaError_t plan_attention(int B, int S, int H, int dh, AttentionPlan* plan) {
  plan->kstride = k_stride(S, sizeof(T));
  plan->smem = attention_smem_bytes(S, dh, sizeof(T));
  int device = 0, smem_optin = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  RETURN_IF_ERROR(cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                         device));
  if (plan->smem > (size_t)smem_optin) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaFuncSetAttribute(attention_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)plan->smem));
  plan->grid = dim3((S + kAttQt - 1) / kAttQt, H, B);
  plan->scale = 1.0f / sqrtf((float)dh);
  return cudaSuccess;
}

// One pre-LN block in place on x (M = B * S rows): the seven launches.  w
// points at this block's weights.
template <typename T>
cudaError_t block_launches(T* x, const Weights& w, int M, int S, int D, int dh, int hidden,
                           const AttentionPlan& plan, T* hb, T* qkv, T* attn, T* hid,
                           cudaStream_t st) {
  const auto p = [](const void* q) { return static_cast<const T*>(q); };
  RETURN_IF_ERROR(layer_norm<T>(x, p(w.ln1_s), p(w.ln1_b), hb, M, D, st));
  RETURN_IF_ERROR((gemm<T, kEpiRound>(hb, p(w.w_qkv), p(w.b_qkv), nullptr, qkv, M, 3 * D, D,
                                      st)));
  attention_kernel<T><<<plan.grid, kAttThreads, plan.smem, st>>>(qkv, attn, S, D, dh,
                                                                 plan.kstride, plan.scale);
  RETURN_IF_ERROR(cudaGetLastError());
  RETURN_IF_ERROR((gemm<T, kEpiResidual>(attn, p(w.w_proj), p(w.b_proj), x, x, M, D, D, st)));
  RETURN_IF_ERROR(layer_norm<T>(x, p(w.ln2_s), p(w.ln2_b), hb, M, D, st));
  RETURN_IF_ERROR((gemm<T, kEpiGelu>(hb, p(w.w_mlp1), p(w.b_mlp1), nullptr, hid, M, hidden, D,
                                     st)));
  return gemm<T, kEpiResidual>(hid, p(w.w_mlp2), p(w.b_mlp2), x, x, M, D, hidden, st);
}

// Every block of weights stacked over depth: the host loop of kernel 1.
template <typename T>
cudaError_t encoder_forward(int B, int S, int D, int H, int hidden, int depth,
                            const void* x_in, void* x_out, const Weights& w,
                            void* h_buf, void* qkv_buf, void* attn_buf, void* hid_buf,
                            cudaStream_t st) {
  const int M = B * S;
  const int dh = D / H;
  AttentionPlan plan;
  RETURN_IF_ERROR(plan_attention<T>(B, S, H, dh, &plan));
  T* x = static_cast<T*>(x_out);
  RETURN_IF_ERROR(cudaMemcpyAsync(x, x_in, (size_t)M * D * sizeof(T),
                                  cudaMemcpyDeviceToDevice, st));
  for (int l = 0; l < depth; ++l) {
    const Weights wl{layer<T>(w.ln1_s, l, D),   layer<T>(w.ln1_b, l, D),
                     layer<T>(w.w_qkv, l, (size_t)D * 3 * D), layer<T>(w.b_qkv, l, 3 * D),
                     layer<T>(w.w_proj, l, (size_t)D * D),    layer<T>(w.b_proj, l, D),
                     layer<T>(w.ln2_s, l, D),   layer<T>(w.ln2_b, l, D),
                     layer<T>(w.w_mlp1, l, (size_t)D * hidden), layer<T>(w.b_mlp1, l, hidden),
                     layer<T>(w.w_mlp2, l, (size_t)hidden * D), layer<T>(w.b_mlp2, l, D)};
    RETURN_IF_ERROR(block_launches<T>(x, wl, M, S, D, dh, hidden, plan,
                                      static_cast<T*>(h_buf), static_cast<T*>(qkv_buf),
                                      static_cast<T*>(attn_buf), static_cast<T*>(hid_buf), st));
  }
  return cudaGetLastError();
}

// One block with its own, unstacked weights, on any batch: kernel 2.  The
// TPU kernel's grid runs one program per batch element; here the batch folds
// into the rows of the four products and into the attention grid, so a call is
// the same seven launches at any B.
template <typename T>
cudaError_t block_forward(int B, int S, int D, int H, int hidden,
                          const void* x_in, void* x_out, const Weights& w,
                          void* h_buf, void* qkv_buf, void* attn_buf, void* hid_buf,
                          cudaStream_t st) {
  const int M = B * S;
  AttentionPlan plan;
  RETURN_IF_ERROR(plan_attention<T>(B, S, H, D / H, &plan));
  T* x = static_cast<T*>(x_out);
  RETURN_IF_ERROR(cudaMemcpyAsync(x, x_in, (size_t)M * D * sizeof(T),
                                  cudaMemcpyDeviceToDevice, st));
  return block_launches<T>(x, w, M, S, D, D / H, hidden, plan, static_cast<T*>(h_buf),
                           static_cast<T*>(qkv_buf), static_cast<T*>(attn_buf),
                           static_cast<T*>(hid_buf), st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous on the current
// device: x (B, S, D); weights stacked over depth as (depth, ...) with kernels
// (in, out); scratch h and attn (B*S, D), qkv (B*S, 3D), mlp_hidden
// (B*S, hidden).  x_out must not alias x_in.  Returns a cudaError_t.
extern "C" int vit_encoder_forward(
    int dtype, int batch, int seq, int dim, int heads, int hidden, int depth,
    const void* x_in, void* x_out,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* ln2_s, const void* ln2_b,
    const void* w_mlp1, const void* b_mlp1, const void* w_mlp2, const void* b_mlp2,
    void* h, void* qkv, void* attn, void* mlp_hidden, void* stream) {
  const Weights w{ln1_s, ln1_b, w_qkv, b_qkv, w_proj, b_proj,
                  ln2_s, ln2_b, w_mlp1, b_mlp1, w_mlp2, b_mlp2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % heads != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)encoder_forward<bf16>(batch, seq, dim, heads, hidden, depth, x_in, x_out, w, h,
                                      qkv, attn, mlp_hidden, st);
  if (dtype == 0)
    return (int)encoder_forward<float>(batch, seq, dim, heads, hidden, depth, x_in, x_out, w, h,
                                       qkv, attn, mlp_hidden, st);
  return (int)cudaErrorInvalidValue;
}

// One pre-LN block: replaces the TPU kernel
// gstreamer_vit_tracker_tpu/ops/vit_block.py::_block_kernel (the pallas_call in
// _fused_forward, reached through vit_block.block).  The weights are one
// block's own (not stacked): LN scales and biases (dim,), kernels (in, out),
// biases (out,).  Tensors and scratch as for vit_encoder_forward, any batch.
// It shares the device code of the encoder's seven launches a block, so what
// bounds it is the same: launches and latency, not operations or bytes
// (at (16, 320, 192) bf16: 5.79 GFLOP, 5.9 us at 989 TFLOP/s).  Returns a
// cudaError_t.
extern "C" int vit_block_forward(
    int dtype, int batch, int seq, int dim, int heads, int hidden,
    const void* x_in, void* x_out,
    const void* ln1_s, const void* ln1_b, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* b_proj, const void* ln2_s, const void* ln2_b,
    const void* w_mlp1, const void* b_mlp1, const void* w_mlp2, const void* b_mlp2,
    void* h, void* qkv, void* attn, void* mlp_hidden, void* stream) {
  const Weights w{ln1_s, ln1_b, w_qkv, b_qkv, w_proj, b_proj,
                  ln2_s, ln2_b, w_mlp1, b_mlp1, w_mlp2, b_mlp2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % heads != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)block_forward<bf16>(batch, seq, dim, heads, hidden, x_in, x_out, w, h, qkv,
                                    attn, mlp_hidden, st);
  if (dtype == 0)
    return (int)block_forward<float>(batch, seq, dim, heads, hidden, x_in, x_out, w, h, qkv,
                                     attn, mlp_hidden, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) the attention kernel needs for this shape.
extern "C" long long vit_encoder_attention_smem(int seq, int head_dim, int elem_bytes) {
  return (long long)attention_smem_bytes(seq, head_dim, elem_bytes);
}
