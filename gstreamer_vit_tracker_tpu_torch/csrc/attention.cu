// Softmax attention over (batch*heads, S, dh) for NVIDIA Hopper, sm_90a: two
// kernels behind one entry (ops/attention.py::flash_attention).
//
// They replace the two TPU kernels of gstreamer_vit_tracker_tpu/ops/attention.py:
//   * attention_single_kernel  <- _single_block_kernel: the whole sequence of one
//     (batch*head) at once, plain softmax;
//   * attention_flash_kernel   <- _flash_kernel: blocked online softmax, running
//     row max m and normaliser l in f32 over key blocks, acc * exp(m - m_new)
//     rescaling, acc / l at the end.
// Both compute softmax(q k^T dh^-1/2) v as the TPU kernels do: q is widened to
// f32 and scaled before the product, scores, softmax and P.V are f32 (FMA
// units; no tensor cores, so f32 inputs run without TF32 and bf16 inputs are
// widened exactly), P.V is taken before the division by the row sum, and the
// result is rounded to the input type once.  The TPU kernels pad S to the
// 128-lane grid and mask keys >= seq_len to -inf; here nothing is padded: the
// kernels take any S >= 1 and a ragged last tile simply stops at its last key
// (a key that is never scored contributes exp(-inf) = 0, the same value).
//
// Bound on the H100 SXM at the serving shape (48, 320, 64) bf16: 4*S^2*dh per
// (batch*head) is 1.26 GFLOP, 1.3 us at the 989 TFLOP/s tensor-core peak, and
// q, k, v, out once are 7.9 MB, 2.3 us at 3.35 TB/s: bound by bytes.  This
// design is bound by neither: it is SIMT f32 (19 us at the 67 TFLOP/s f32
// peak), limited by shared-memory loads per FMA and by how many warps one SM
// holds beside K and V.  What it does about that: every K pair a lane loads
// (one 32-bit load in bf16) serves four query rows and every q value four
// keys, every V pair four rows; and the whole-sequence kernel runs 16 warps a
// CTA, because with K, V and the scores in shared memory only one CTA fits an
// SM.  Tensor-core products (wgmma) with an f32 softmax are later work.
//
// Layout of one CTA (both kernels): W warps, each carrying R query rows
// together.  K is held transposed in shared memory with a row stride of an
// odd number of 32-bit words, so the transposing stores and the per-key reads
// spread over the banks; V is held as is; q as scaled f32; the scores of the
// CTA's rows in f32.  The single kernel (16 warps x 4 rows) holds K and V of
// all S keys (the wrapper takes it only while that fits the card's opt-in
// shared memory); the flash kernel (8 warps x 4 rows) stages 128 keys at a
// time.  profile_attention.py times other shapes of the CTAs.
// Launches go to the caller's stream; the entry points return the CUDA error
// (cudaGetLastError after the launch), 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

// A CTA has W warps, each carrying R query rows together: W * R rows a CTA.
constexpr int kKeys = 4;         // keys a lane scores together: two pairs
constexpr int kKb = 128;         // keys per staged block of the flash kernel
constexpr int kMaxHeadDim = 128;
constexpr int kPairs = kMaxHeadDim / 64;   // head-dim pairs a lane owns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Two adjacent elements.  bf16 pairs are one 32-bit load (the caller keeps
// them 4-byte aligned); float pairs of the transposed K tile are not 8-byte
// aligned on odd rows, so they load as two scalars.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_k_pair(const float* p) {
  return make_float2(p[0], p[1]);
}
__device__ __forceinline__ float2 load_k_pair(const bf16* p) { return load_pair(p); }
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// Row stride (elements) of a transposed K tile of `keys` keys: more than
// `keys` rounded up to even (so the pair that holds the last key can be
// loaded whole), and an odd number of 32-bit words.
__host__ __device__ inline int k_stride(int keys, int elem_bytes) {
  int words = ((keys + 2) * elem_bytes + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 4 / elem_bytes;
}

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// Shared memory of a CTA of `rows` query rows that holds `keys` keys: K^T, V,
// the q tile, the scores.
size_t smem_bytes(int rows, int keys, int head_dim, int elem_bytes) {
  return (size_t)head_dim * k_stride(keys, elem_bytes) * elem_bytes
         + (size_t)keys * head_dim * elem_bytes
         + (size_t)rows * head_dim * sizeof(float)
         + (size_t)rows * round_up4(keys) * sizeof(float);
}

// n keys of K and V (rows of dh) into shared memory as 16-byte vectors; V as
// is, K scattered transposed.  dh is a multiple of 8, so every vector is
// aligned.
template <typename T>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k, const T* __restrict__ v,
                                         int n, int dh, int kstride, T* Kt, T* Vs) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = dh / kVec;                  // vectors per row
  for (int i = threadIdx.x; i < n * vpr; i += blockDim.x) {
    const int j = i / vpr, c = (i - j * vpr) * kVec;
    const uint4 kv = *reinterpret_cast<const uint4*>(k + (size_t)j * dh + c);
    *reinterpret_cast<uint4*>(Vs + (size_t)j * dh + c) =
        *reinterpret_cast<const uint4*>(v + (size_t)j * dh + c);
    const T* ke = reinterpret_cast<const T*>(&kv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) Kt[(size_t)(c + e) * kstride + j] = ke[e];
  }
}

// The CTA's `rows` query rows, widened to f32 and scaled (the TPU kernels
// scale q, not the scores); rows past S are zeros.
template <typename T>
__device__ __forceinline__ void stage_q(const T* __restrict__ q, int q0, int rows, int S,
                                        int dh, float scale, float* Qs) {
  for (int idx = threadIdx.x; idx < rows * dh; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    const int qi = q0 + i;
    Qs[idx] = qi < S ? to_f32(q[(size_t)qi * dh + d]) * scale : 0.f;
  }
}

// Scores of a warp's R query rows (Qw, f32, row stride dh) against the n
// keys of Kt, written to Pw (row stride ldp); mx[r] = the row's maximum, the
// same in every lane.  A lane scores the key pairs (2 * lane + 64 * m,
// + 1), two pairs at a time: every K pair it loads serves R rows, every q
// value four keys.  A pair past the last key is clamped and its sums are
// dropped (the element after key n - 1 is padding inside the tile).
template <typename T, int R>
__device__ __forceinline__ void score_rows(const float* Qw, const T* Kt, int kstride, int n,
                                           int dh, float* Pw, int ldp, float mx[R]) {
  const int lane = threadIdx.x & 31;
  const int last = (n - 1) & ~1;
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
  for (int j0 = 0; j0 < n; j0 += 32 * kKeys) {
    int jj[kKeys / 2];
    float acc[R][kKeys];
#pragma unroll
    for (int t = 0; t < kKeys / 2; ++t) jj[t] = min(j0 + 2 * lane + 64 * t, last);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < kKeys; ++t) acc[r][t] = 0.f;
    for (int d = 0; d < dh; d += 4) {
      float qv[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 t4 = *reinterpret_cast<const float4*>(Qw + r * dh + d);
        qv[r][0] = t4.x; qv[r][1] = t4.y; qv[r][2] = t4.z; qv[r][3] = t4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* krow = Kt + (size_t)(d + e) * kstride;
        float kv[kKeys];
#pragma unroll
        for (int t = 0; t < kKeys / 2; ++t) {
          const float2 k2 = load_k_pair(krow + jj[t]);
          kv[2 * t] = k2.x;
          kv[2 * t + 1] = k2.y;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int t = 0; t < kKeys; ++t) acc[r][t] = fmaf(qv[r][e], kv[t], acc[r][t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kKeys; ++t) {
      const int j = j0 + 2 * lane + 64 * (t / 2) + (t & 1);
      if (j < n) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          Pw[r * ldp + j] = acc[r][t];
          mx[r] = fmaxf(mx[r], acc[r][t]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = warp_max(mx[r]);
}

// Pw[r][j] <- exp(Pw[r][j] - m[r]) for the warp's rows; returns the row sums
// in sum[r] (the same in every lane).  A lane touches the keys it scored.
template <int R>
__device__ __forceinline__ void exp_rows(float* Pw, int ldp, int n, const float m[R],
                                         float sum[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
    for (int j = 2 * lane; j < n; j += 64) {
      const float e0 = expf(Pw[r * ldp + j] - m[r]);
      Pw[r * ldp + j] = e0;
      s += e0;
      if (j + 1 < n) {
        const float e1 = expf(Pw[r * ldp + j + 1] - m[r]);
        Pw[r * ldp + j + 1] = e1;
        s += e1;
      }
    }
    sum[r] = warp_sum(s);
  }
}

// o[r] += Pw[r][0:n] . Vs[0:n] for the warp's rows.  A lane owns head dims
// 2*lane, 2*lane + 1 (+ 64 for the second pair); ldp is a multiple of 4.
template <typename T, int R>
__device__ __forceinline__ void pv_rows(const float* Pw, int ldp, const T* Vs, int n, int dh,
                                        float o[R][kPairs][2]) {
  const int lane = threadIdx.x & 31;
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    float pv[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 t4 = *reinterpret_cast<const float4*>(Pw + r * ldp + j);
      pv[r][0] = t4.x; pv[r][1] = t4.y; pv[r][2] = t4.z; pv[r][3] = t4.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < dh) {
          const float2 vv = load_pair(Vs + (size_t)(j + e) * dh + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            o[r][u][0] = fmaf(pv[r][e], vv.x, o[r][u][0]);
            o[r][u][1] = fmaf(pv[r][e], vv.y, o[r][u][1]);
          }
        }
      }
    }
  }
  for (; j < n; ++j) {
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int d = 2 * lane + 64 * u;
      if (d < dh) {
        const float2 vv = load_pair(Vs + (size_t)j * dh + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = Pw[r * ldp + j];
          o[r][u][0] = fmaf(p, vv.x, o[r][u][0]);
          o[r][u][1] = fmaf(p, vv.y, o[r][u][1]);
        }
      }
    }
  }
}

// out rows of the warp: o / l, rounded to T once.  Rows past S are dropped.
template <typename T, int R>
__device__ __forceinline__ void write_rows(T* __restrict__ out, int row0, int S, int dh,
                                           float o[R][kPairs][2], const float l[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = row0 + r;
    if (qi >= S) continue;
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int d = 2 * lane + 64 * u;
      if (d < dh) store_pair(out + (size_t)qi * dh + d, o[r][u][0] / l[r], o[r][u][1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Whole sequence at once: CTA = (W * R query rows, batch*head), K and V of
// all S keys in shared memory, plain softmax.
// ---------------------------------------------------------------------------

template <typename T, int W, int R>
__global__ void __launch_bounds__(W * 32)
attention_single_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int S, int dh,
                        int tiles, int kstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQt = W * R;
  const int ldp = round_up4(S);
  T* Kt = reinterpret_cast<T*>(smem);                          // [dh][kstride]
  T* Vs = Kt + (size_t)dh * kstride;                           // [S][dh]
  float* Qs = reinterpret_cast<float*>(Vs + (size_t)S * dh);   // [kQt][dh]
  float* Ps = Qs + kQt * dh;                                   // [kQt][ldp]

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kQt;
  const size_t base = (size_t)bh * S * dh;
  stage_kv(k + base, v + base, S, dh, kstride, Kt, Vs);
  stage_q(q + base, q0, kQt, S, dh, scale, Qs);
  __syncthreads();

  const int i0 = (threadIdx.x >> 5) * R;
  if (q0 + i0 >= S) return;                   // a warp with no row (last tile)
  float* Pw = Ps + (size_t)i0 * ldp;
  float m[R], l[R];
  score_rows<T, R>(Qs + i0 * dh, Kt, kstride, S, dh, Pw, ldp, m);
  exp_rows<R>(Pw, ldp, S, m, l);
  __syncwarp();                               // every lane's p is visible
  float o[R][kPairs][2] = {};
  pv_rows<T, R>(Pw, ldp, Vs, S, dh, o);
  write_rows<T, R>(out + base, q0 + i0, S, dh, o, l);
}

// ---------------------------------------------------------------------------
// Blocked online softmax: CTA = (W * R query rows, batch*head), a loop over
// key blocks of kKb staged through shared memory.
// ---------------------------------------------------------------------------

template <typename T, int W, int R>
__global__ void __launch_bounds__(W * 32)
attention_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int dh,
                       int tiles, int kstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQt = W * R;
  T* Kt = reinterpret_cast<T*>(smem);                          // [dh][kstride]
  T* Vs = Kt + (size_t)dh * kstride;                           // [kKb][dh]
  float* Qs = reinterpret_cast<float*>(Vs + (size_t)kKb * dh); // [kQt][dh]
  float* Ps = Qs + kQt * dh;                                   // [kQt][kKb]

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kQt;
  const size_t base = (size_t)bh * S * dh;
  stage_q(q + base, q0, kQt, S, dh, scale, Qs);

  const int i0 = (threadIdx.x >> 5) * R;
  float* Pw = Ps + (size_t)i0 * kKb;
  float m[R], l[R];
  float o[R][kPairs][2] = {};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kKb) {
    const int n = min(kKb, S - k0);           // the last block stops at key S
    __syncthreads();                          // the previous block is read out
    stage_kv(k + base + (size_t)k0 * dh, v + base + (size_t)k0 * dh, n, dh, kstride, Kt, Vs);
    __syncthreads();
    float mb[R], sum[R];
    score_rows<T, R>(Qs + i0 * dh, Kt, kstride, n, dh, Pw, kKb, mb);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_new = fmaxf(m[r], mb[r]);
      const float alpha = expf(m[r] - m_new); // 0 on the first block (m = -inf)
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        o[r][u][0] *= alpha;
        o[r][u][1] *= alpha;
      }
    }
    exp_rows<R>(Pw, kKb, n, m, sum);
#pragma unroll
    for (int r = 0; r < R; ++r) l[r] += sum[r];
    __syncwarp();
    pv_rows<T, R>(Pw, kKb, Vs, n, dh, o);
  }
  write_rows<T, R>(out + base, q0 + i0, S, dh, o, l);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    const cudaError_t err_ = (expr);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

cudaError_t check_smem(size_t smem) {
  int device = 0, optin = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  RETURN_IF_ERROR(cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  return smem > (size_t)optin ? cudaErrorInvalidValue : cudaSuccess;
}

bool shape_ok(int bh, int seq, int dh) {
  return bh >= 1 && seq >= 1 && dh >= 8 && dh % 8 == 0 && dh <= kMaxHeadDim
         && (long long)seq * bh <= 0x7fffffffLL;
}

// Shape of the CTAs (warps, rows a warp): SINGLE_* for the whole-sequence
// kernel, FLASH_* for the blocked one.  A build may override them with -D to
// compare shapes.
#ifndef SINGLE_W
#define SINGLE_W 16
#define SINGLE_R 4
#endif
#ifndef FLASH_W
#define FLASH_W 8
#define FLASH_R 4
#endif
constexpr int kSingleW = SINGLE_W, kSingleR = SINGLE_R;
constexpr int kFlashW = FLASH_W, kFlashR = FLASH_R;

template <typename T, int W, int R>
cudaError_t launch_single(int bh, int S, int dh, const void* q, const void* k, const void* v,
                          void* out, cudaStream_t st) {
  const size_t smem = smem_bytes(W * R, S, dh, sizeof(T));
  RETURN_IF_ERROR(check_smem(smem));
  RETURN_IF_ERROR(cudaFuncSetAttribute(attention_single_kernel<T, W, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const int tiles = (S + W * R - 1) / (W * R);
  attention_single_kernel<T, W, R><<<tiles * bh, W * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, dh, tiles, k_stride(S, sizeof(T)), 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

template <typename T, int W, int R>
cudaError_t launch_flash(int bh, int S, int dh, const void* q, const void* k, const void* v,
                         void* out, cudaStream_t st) {
  const size_t smem = smem_bytes(W * R, kKb, dh, sizeof(T));
  RETURN_IF_ERROR(check_smem(smem));
  RETURN_IF_ERROR(cudaFuncSetAttribute(attention_flash_kernel<T, W, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const int tiles = (S + W * R - 1) / (W * R);
  attention_flash_kernel<T, W, R><<<tiles * bh, W * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, dh, tiles, k_stride(kKb, sizeof(T)), 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, out: contiguous (bh, seq, dh) on
// the current device, 16-byte aligned, out not aliasing an input; dh a multiple
// of 8 up to 128.  Return a cudaError_t.

extern "C" int attention_single_forward(int dtype, int bh, int seq, int dh, const void* q,
                                        const void* k, const void* v, void* out,
                                        void* stream) {
  if (!shape_ok(bh, seq, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_single<bf16, kSingleW, kSingleR>(bh, seq, dh, q, k, v, out, st);
  if (dtype == 0) return (int)launch_single<float, kSingleW, kSingleR>(bh, seq, dh, q, k, v, out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int attention_flash_forward(int dtype, int bh, int seq, int dh, const void* q,
                                       const void* k, const void* v, void* out,
                                       void* stream) {
  if (!shape_ok(bh, seq, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_flash<bf16, kFlashW, kFlashR>(bh, seq, dh, q, k, v, out, st);
  if (dtype == 0) return (int)launch_flash<float, kFlashW, kFlashR>(bh, seq, dh, q, k, v, out, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of one CTA: the single kernel at this sequence
// length, and the flash kernel (independent of the length).
extern "C" long long attention_single_smem(int seq, int head_dim, int elem_bytes) {
  return (long long)smem_bytes(kSingleW * kSingleR, seq, head_dim, elem_bytes);
}

extern "C" long long attention_flash_smem(int head_dim, int elem_bytes) {
  return (long long)smem_bytes(kFlashW * kFlashR, kKb, head_dim, elem_bytes);
}
