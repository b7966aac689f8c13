// Softmax attention softmax(q k^T dh^-1/2) v for NVIDIA Hopper, sm_90a: two
// kernels, each in three variants, behind one entry
// (ops/attention.py::multihead_attention and ::flash_attention).
//
// They replace the two TPU kernels of gstreamer_vit_tracker_tpu/ops/attention.py:
//   * attention_single  <- _single_block_kernel: K and V of all S keys of one
//     (batch, head) are loaded into shared memory once (one wait, no ring, no
//     block-wide barrier after it);
//   * attention_flash   <- _flash_kernel: key blocks walk through a ring of
//     shared-memory stages, the next block's copy in flight while this one
//     is computed.
// Both keep scores, row maximum and row sum in f32, take P.V before the
// division by the row sum and round to the input type once.  The TPU kernels
// pad S to the 128-lane grid and mask keys >= seq_len to -inf; here nothing is
// padded in device memory: the kernels take any S >= 1.
//
// q, k, v and out are read and written where they lie: every tensor comes
// with element strides for batch, head and row (dh is contiguous), so the
// three column blocks of a (B, S, 3D) qkv product go in as they are and out is
// (B, S, D); contiguous (batch*heads, S, dh) is the case heads = 1.
//
// Bound on the H100 SXM at the serving shape (48, 320, 64) bf16: 4*S^2*dh per
// (batch, head) is 1.26 GFLOP, 1.3 us at the 989 TFLOP/s tensor-core peak, and
// q, k, v, out once are 7.9 MB, 2.3 us at 3.35 TB/s: bound by bytes.
//
// Variant "mma" (bf16, head dim 32, 64 or 128, and above 128 a multiple of
// 64 in panels, below; tile code in attention_mma.cuh):
// one warpgroup a CTA owns 64 query rows.  Both products run on the tensor
// cores with wgmma; K and V sit in shared memory as they lie in device memory
// (16-byte cp.async into the swizzled layout the descriptors name, no
// transpose, rows past S zero-filled); the softmax is online over key blocks
// in both kernels and lives in the accumulator fragment, p goes to the second
// product from registers as bf16, and the f32 scores never touch shared
// memory.  dh^-1/2 is folded with log2(e) into one multiply of the f32
// scores, where the TPU kernels scale q first: q is a bf16 operand here.
// attention_flash splits a stage's keys over two warpgroups that share the
// query tile when the grid is smaller than the card, and merges their (m, l,
// o) at the end.  The copies are started by the computing threads, each
// keeping its chunk column so that a copy costs one address add: computing
// every chunk's address anew cost more than the arithmetic ((3, 1088, 64) on
// an H100 at 700 W: 19.1 us that way, 11.9 us this way, one warpgroup,
// profile_attention.py).  What is left of the distance to the bound: the
// exponentials (one ex2 a score on the SFU, as many cycles as the products),
// products and softmax running one after the other inside a warpgroup, and
// the launch.
//
// Variant "tf32x3" (float32, every head dim that is a multiple of 8, above
// 128 in panels; tile code in attention_tf32.cuh): the TPU kernels'
// function to float32's accuracy on the tensor cores.  Bound at the
// training shape (48, 320, 64) f32: the 1.258
// GFLOP take 18.8 us at the 67 TFLOP/s of f32 FMA, and 7.6 us as three TF32
// products a product (3.77 GFLOP at 495 TFLOP/s); q, k, v, out once are 15.7
// MB, 4.7 us at 3.35 TB/s: bound by the split products.  One TF32 product
// keeps 11 bits and misses the 1e-5 the kernels are held to, so every operand
// is split into hi + lo TF32 parts as its fragment is loaded and each product
// is lo.hi + hi.lo + hi.hi on mma.sync m16n8k8 into an f32 accumulator.  A
// CTA is one warpgroup of 64 query rows (the "mma" geometry); K and V come in
// as float32 by 16-byte cp.async into rows padded by 4 floats (no bank
// conflicts in the fragment loads), a ring of two 64-key blocks for flash,
// every block at once for single; the softmax is online over key blocks in
// the score accumulator (dh^-1/2 . log2(e) folded into one multiply of the
// f32 scores), and p goes into P.V from registers, split there: no score
// touches shared memory.  It replaced the SIMT design below for float32: at
// the training shape on an H100 at 700 W, 30.5 us against 102.4 for the SIMT
// design and 49.5 for scaled_dot_product_attention (chip_smoke.py, PERF.md).
// By instruction count about half of a warp's work is splitting the K and V
// blocks, which each of the four warps does again for its own rows.
//
// Variant "simt" (the design of bf16 head dims the tiles do not take, which
// ops/attention.py now pads to 32 / 64 / 128 for "mma", and of float32
// before "tf32x3"; taken only by name, the yardstick of the timings): f32 FMA products
// without TF32, q widened and scaled first as the TPU kernels do.  A CTA has
// W warps of R query rows each; K is held transposed in shared memory at an
// odd word stride, V as is, the f32 scores of the CTA's rows too (16 warps x 4
// rows for single, 8 x 4 and 128-key blocks for flash).
//
// Above a head dim of 128 both tensor-core variants run the panel kernels
// (their section below): a CTA owns one 64-column panel of o and sums its
// scores over the panels of q and k, so its registers and shared memory are
// one panel's whatever the head dim.
//
// Which (dtype, dh) takes which variant, and which lengths take which kernel,
// is decided by ops/attention.py::plan before the launch; the entries here
// launch what they are told or return an error.  Launches go to the caller's
// stream; the entries return the CUDA error (cudaGetLastError after the
// launch), 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A CTA has W warps, each carrying R query rows together: W * R rows a CTA.
constexpr int kKeys = 4;         // keys a lane scores together: two pairs
constexpr int kKb = 128;         // keys per staged block of the flash kernel
// Head dims up to it run in one tile (every variant; "simt" stops there),
// above it in panels of 64 columns ("mma", "tf32x3": the panel kernels).
constexpr int kMaxTileDh = 128;
constexpr int kPairs = kMaxTileDh / 64;   // head-dim pairs a lane owns

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

// Element strides of q, k, v and out: batch, head, row (dh is contiguous).
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// n keys of K and V (rows of dh, krs and vrs elements apart) into shared
// memory as 16-byte vectors; V as is, K scattered transposed.  dh and the
// strides are multiples of 16 bytes, so every vector is aligned.  (Row strides
// are below 2^31 elements: the host checks it, and 32-bit strides keep these
// kernels inside their registers.)
template <typename T>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k, const T* __restrict__ v,
                                         int krs, int vrs, int n, int dh, int kstride,
                                         T* Kt, T* Vs) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = dh / kVec;                  // vectors per row
  for (int i = threadIdx.x; i < n * vpr; i += blockDim.x) {
    const int j = i / vpr, c = (i - j * vpr) * kVec;
    const uint4 kv = *reinterpret_cast<const uint4*>(k + (size_t)j * krs + c);
    *reinterpret_cast<uint4*>(Vs + (size_t)j * dh + c) =
        *reinterpret_cast<const uint4*>(v + (size_t)j * vrs + c);
    const T* ke = reinterpret_cast<const T*>(&kv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) Kt[(size_t)(c + e) * kstride + j] = ke[e];
  }
}

// The CTA's `rows` query rows, widened to f32 and scaled (the TPU kernels
// scale q, not the scores); rows past S are zeros.
template <typename T>
__device__ __forceinline__ void stage_q(const T* __restrict__ q, int qrs, int q0,
                                        int rows, int S, int dh, float scale, float* Qs) {
  for (int idx = threadIdx.x; idx < rows * dh; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    const int qi = q0 + i;
    Qs[idx] = qi < S ? to_f32(q[(size_t)qi * qrs + d]) * scale : 0.f;
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
__device__ __forceinline__ void write_rows(T* __restrict__ out, int ors, int row0,
                                           int S, int dh, float o[R][kPairs][2],
                                           const float l[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = row0 + r;
    if (qi >= S) continue;
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int d = 2 * lane + 64 * u;
      if (d < dh) store_pair(out + (size_t)qi * ors + d, o[r][u][0] / l[r], o[r][u][1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Variant "simt".  Whole sequence at once: CTA = (W * R query rows, batch,
// head), K and V of all S keys in shared memory, plain softmax.
// ---------------------------------------------------------------------------

template <typename T, int W, int R>
__global__ void __launch_bounds__(W * 32)
attention_single_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, Strides st, int S,
                        int dh, int heads, int tiles, int kstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQt = W * R;
  const int ldp = round_up4(S);
  T* Kt = reinterpret_cast<T*>(smem);                          // [dh][kstride]
  T* Vs = Kt + (size_t)dh * kstride;                           // [S][dh]
  float* Qs = reinterpret_cast<float*>(Vs + (size_t)S * dh);   // [kQt][dh]
  float* Ps = Qs + kQt * dh;                                   // [kQt][ldp]

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kQt;
  const int b = bh / heads, h = bh - b * heads;
  stage_kv(k + b * st.k[0] + h * st.k[1], v + b * st.v[0] + h * st.v[1], (int)st.k[2],
           (int)st.v[2], S, dh, kstride, Kt, Vs);
  stage_q(q + b * st.q[0] + h * st.q[1], (int)st.q[2], q0, kQt, S, dh, scale, Qs);
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
  write_rows<T, R>(out + b * st.o[0] + h * st.o[1], (int)st.o[2], q0 + i0, S, dh, o, l);
}

// ---------------------------------------------------------------------------
// Variant "simt".  Blocked online softmax: CTA = (W * R query rows, batch,
// head), a loop over key blocks of kKb staged through shared memory.  The
// launch bound names three CTAs an SM (85 registers a thread at 8 warps):
// left to itself ptxas aims at four and spills the bf16 instantiation.
// ---------------------------------------------------------------------------

template <typename T, int W, int R>
__global__ void __launch_bounds__(W * 32, 3)
attention_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, Strides st, int S,
                       int dh, int heads, int tiles, int kstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQt = W * R;
  T* Kt = reinterpret_cast<T*>(smem);                          // [dh][kstride]
  T* Vs = Kt + (size_t)dh * kstride;                           // [kKb][dh]
  float* Qs = reinterpret_cast<float*>(Vs + (size_t)kKb * dh); // [kQt][dh]
  float* Ps = Qs + kQt * dh;                                   // [kQt][kKb]

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * kQt;
  const int b = bh / heads, h = bh - b * heads;
  k += b * st.k[0] + h * st.k[1];
  v += b * st.v[0] + h * st.v[1];
  out += b * st.o[0] + h * st.o[1];
  const int krs = (int)st.k[2], vrs = (int)st.v[2];
  stage_q(q + b * st.q[0] + h * st.q[1], (int)st.q[2], q0, kQt, S, dh, scale, Qs);

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
    stage_kv(k + (size_t)k0 * krs, v + (size_t)k0 * vrs, krs, vrs, n, dh, kstride, Kt, Vs);
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
  write_rows<T, R>(out, (int)st.o[2], q0 + i0, S, dh, o, l);
}

// ---------------------------------------------------------------------------
// Variant "mma" (bf16): CTA = one warpgroup = (64 query rows, batch, head).
// Shared memory, from a 1024-byte boundary: the Q tile, then K blocks, then
// V blocks, each block a tile of KB keys (attention_mma.cuh).
// ---------------------------------------------------------------------------

constexpr int kAlign = 1024;                  // of the tiles; slack for the base

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - mma::smem_addr(raw) % kAlign) % kAlign);
}

// All ceil(S / KB) key blocks at once: one group of copies, one wait, one
// barrier, then the warpgroup runs alone.
template <int DH, int KB>
__global__ void __launch_bounds__(mma::kThreads)
attention_single_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, Strides st,
                            int S, int heads, int tiles, float c) {
  using T = mma::Tile<DH>;
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* q_ptr = aligned_smem(raw);
  const int blocks = (S + KB - 1) / KB;
  const uint32_t q_tile = mma::smem_addr(q_ptr);
  const uint32_t k_tiles = q_tile + T::bytes(mma::kTileRows);
  const uint32_t v_tiles = k_tiles + blocks * T::bytes(KB);

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * mma::kTileRows;
  const int b = bh / heads, h = bh - b * heads;
  k += b * st.k[0] + h * st.k[1];
  v += b * st.v[0] + h * st.v[1];
  T::template fill<mma::kTileRows, mma::kThreads>(q_tile, q + b * st.q[0] + h * st.q[1], st.q[2],
                                                  q0, S);
  for (int j = 0; j < blocks; ++j) {
    T::template fill<KB, mma::kThreads>(k_tiles + j * T::bytes(KB), k, st.k[2], j * KB, S);
    T::template fill<KB, mma::kThreads>(v_tiles + j * T::bytes(KB), v, st.v[2], j * KB, S);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  mma::fence_async_proxy();
  __syncthreads();

  mma::Softmax<DH, KB> sm;
  sm.init();
  for (int j = 0; j < blocks; ++j)
    sm.step(q_tile, k_tiles + j * T::bytes(KB), v_tiles + j * T::bytes(KB), j * KB, S, c);
  sm.store(q_ptr, out + b * st.o[0] + h * st.o[1], st.o[2], q0, S);
}

// A ring of STAGES stages; a stage holds one K block and one V block for
// each of the CTA's NWG warpgroups, which share the 64 query rows and split
// the keys: warpgroup w takes block w of every stage, and the first folds the
// others' (m, l, o) in at the end.  The copies of stages j + 1 .. j + STAGES
// - 1 are in flight while stage j is computed.  One barrier a stage: it
// publishes stage j and frees the slot of stage j - 1.
template <int DH, int KB, int STAGES, int NWG>
__global__ void __launch_bounds__(NWG * mma::kThreads)
attention_flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, Strides st,
                           int S, int heads, int tiles, float c) {
  using T = mma::Tile<DH>;
  constexpr int kNT = NWG * mma::kThreads;
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* q_ptr = aligned_smem(raw);
  const int steps = (S + NWG * KB - 1) / (NWG * KB);
  const uint32_t q_tile = mma::smem_addr(q_ptr);
  const uint32_t k_tiles = q_tile + T::bytes(mma::kTileRows);
  const uint32_t v_tiles = k_tiles + STAGES * NWG * T::bytes(KB);

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * mma::kTileRows;
  const int b = bh / heads, h = bh - b * heads;
  k += b * st.k[0] + h * st.k[1];
  v += b * st.v[0] + h * st.v[1];
  const auto fill_stage = [&](int j) {        // stage j into its slot of the ring
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      const int tile = (j % STAGES) * NWG + w, key0 = (j * NWG + w) * KB;
      T::template fill<KB, kNT>(k_tiles + tile * T::bytes(KB), k, st.k[2], key0, S);
      T::template fill<KB, kNT>(v_tiles + tile * T::bytes(KB), v, st.v[2], key0, S);
    }
  };
  T::template fill<mma::kTileRows, kNT>(q_tile, q + b * st.q[0] + h * st.q[1], st.q[2], q0, S);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {      // a group a stage, empty past the end
    if (j < steps) fill_stage(j);
    mma::cp_async_commit();
  }

  const int wg = threadIdx.x / mma::kThreads;
  mma::Softmax<DH, KB> sm;
  sm.init();
  for (int j = 0; j < steps; ++j) {
    mma::cp_async_wait<STAGES - 2>();         // stage j (and Q) has landed
    mma::fence_async_proxy();
    __syncthreads();
    if (j + STAGES - 1 < steps) fill_stage(j + STAGES - 1);
    mma::cp_async_commit();
    const int tile = (j % STAGES) * NWG + wg, key0 = (j * NWG + wg) * KB;
    if (key0 < S)                             // uniform over the warpgroup
      sm.step(q_tile, k_tiles + tile * T::bytes(KB), v_tiles + tile * T::bytes(KB), key0, S, c);
  }
  if constexpr (NWG > 1) {
    float* scratch = reinterpret_cast<float*>(q_ptr + T::bytes(mma::kTileRows));
    constexpr int kState = mma::Softmax<DH, KB>::kStateFloats * mma::kThreads;
    __syncthreads();                          // the ring is read out: reuse it
    if (wg > 0) sm.spill(scratch + (wg - 1) * kState);
    __syncthreads();
    if (wg > 0) return;
#pragma unroll
    for (int w = 1; w < NWG; ++w) sm.merge(scratch + (w - 1) * kState, c);
  }
  sm.store(q_ptr, out + b * st.o[0] + h * st.o[1], st.o[2], q0, S);
}

// ---------------------------------------------------------------------------
// Variant "tf32x3" (float32): CTA = one warpgroup = (64 query rows, batch,
// head).  Shared memory: the Q tile, then K blocks, then V blocks, each a
// tile of 64 keys in rows of DH + 4 floats (attention_tf32.cuh).
// ---------------------------------------------------------------------------

// All ceil(S / 64) key blocks at once: one group of copies, one wait, one
// barrier, then each warp runs alone.
template <int DH>
__global__ void __launch_bounds__(tf32x3::kThreads)
attention_single_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, Strides st,
                             int S, int heads, int tiles, float c) {
  namespace tf = tf32x3;
  constexpr int kLd = tf::row_floats(DH);
  extern __shared__ __align__(16) float tile_mem[];
  const int blocks = (S + tf::kKeys - 1) / tf::kKeys;
  float* q_tile = tile_mem;                              // [64][kLd]
  float* k_tiles = q_tile + tf::kRows * kLd;             // [blocks * 64][kLd]
  float* v_tiles = k_tiles + blocks * tf::kKeys * kLd;   // [blocks * 64][kLd]

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * tf::kRows;
  const int b = bh / heads, h = bh - b * heads;
  tf::fill<DH>(mma::smem_addr(q_tile), q + b * st.q[0] + h * st.q[1], st.q[2], q0, tf::kRows, S);
  tf::fill<DH>(mma::smem_addr(k_tiles), k + b * st.k[0] + h * st.k[1], st.k[2], 0,
               blocks * tf::kKeys, S);
  tf::fill<DH>(mma::smem_addr(v_tiles), v + b * st.v[0] + h * st.v[1], st.v[2], 0,
               blocks * tf::kKeys, S);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  const int row0 = q0 + 16 * (threadIdx.x >> 5);
  if (row0 >= S) return;                       // a warp with no row (last tile)
  const float* qw = q_tile + (row0 - q0) * kLd;
  tf::Softmax<DH> sm;
  sm.init();
  sm.load_q(qw);
  for (int j = 0; j < blocks; ++j)
    sm.step(qw, k_tiles + j * tf::kKeys * kLd, v_tiles + j * tf::kKeys * kLd, j * tf::kKeys, S,
            c);
  sm.store(out + b * st.o[0] + h * st.o[1], st.o[2], row0, S);
}

// A ring of two stages of one K block and one V block: the copy of block
// j + 1 is in flight while block j is computed.  One barrier a block: it
// publishes block j and frees the slot of block j - 1.
template <int DH>
__global__ void __launch_bounds__(tf32x3::kThreads)
attention_flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, Strides st,
                            int S, int heads, int tiles, float c) {
  namespace tf = tf32x3;
  constexpr int kLd = tf::row_floats(DH), kSlot = tf::kKeys * kLd;
  extern __shared__ __align__(16) float tile_mem[];
  const int blocks = (S + tf::kKeys - 1) / tf::kKeys;
  float* q_tile = tile_mem;                              // [64][kLd]
  float* k_tiles = q_tile + tf::kRows * kLd;             // [2 * 64][kLd]
  float* v_tiles = k_tiles + 2 * kSlot;                  // [2 * 64][kLd]

  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * tf::kRows;
  const int b = bh / heads, h = bh - b * heads;
  k += b * st.k[0] + h * st.k[1];
  v += b * st.v[0] + h * st.v[1];
  const auto fill_block = [&](int j) {         // block j into slot j % 2
    const int slot = (j & 1) * kSlot;
    tf::fill<DH>(mma::smem_addr(k_tiles + slot), k, st.k[2], j * tf::kKeys, tf::kKeys, S);
    tf::fill<DH>(mma::smem_addr(v_tiles + slot), v, st.v[2], j * tf::kKeys, tf::kKeys, S);
  };
  tf::fill<DH>(mma::smem_addr(q_tile), q + b * st.q[0] + h * st.q[1], st.q[2], q0, tf::kRows, S);
  fill_block(0);
  mma::cp_async_commit();

  const int row0 = q0 + 16 * (threadIdx.x >> 5);
  const bool has_rows = row0 < S;              // uniform over the warp
  const float* qw = q_tile + (row0 - q0) * kLd;
  tf::Softmax<DH> sm;
  sm.init();
  for (int j = 0; j < blocks; ++j) {
    mma::cp_async_wait<0>();                   // block j (and Q) has landed
    __syncthreads();
    if (j + 1 < blocks) fill_block(j + 1);
    mma::cp_async_commit();
    if (!has_rows) continue;
    if (j == 0) sm.load_q(qw);
    const int slot = (j & 1) * kSlot;
    sm.step(qw, k_tiles + slot, v_tiles + slot, j * tf::kKeys, S, c);
  }
  if (has_rows) sm.store(out + b * st.o[0] + h * st.o[1], st.o[2], row0, S);
}

// ---------------------------------------------------------------------------
// Head dims above 128, both variants: the head dim in panels of 64 columns.
// CTA = one warpgroup = (64 query rows, batch, head, one 64-column panel of
// o); blockIdx.x runs over tiles x batch x heads x panels, the panels fastest
// (the CTAs that read the same q and k rows run side by side).  A key
// block's scores are summed over the panels of q and k, one panel pair at a
// time, into the score accumulator; once the last pair is in, the block
// takes the online softmax of a head dim of 64 (Softmax::update) and P.V
// adds the CTA's own V panel.  Every CTA takes every score its panel needs,
// so a head dim of P panels computes its scores P times over: the price of
// holding a CTA's registers and shared memory to one panel whatever the
// head dim (o of 64 rows x dh in f32 is dh / 2 registers a thread, 128 at
// dh 256, and ModelConfig(num_heads=1) at D 1024 has dh 1024).  Keeping o
// in shared memory instead grows with dh just the same.
//   SINGLE: every q panel, every key block's k panels and its V panel of
//   the CTA resident at once, one wait (the single kernels' design; the plan
//   takes it while two such CTAs fit an SM); else a ring of two stages, a
//   stage one q panel, one k panel and, on a key block's last panel, the V
//   panel, the next step's copies in flight while one is computed.
// "mma" takes dh a multiple of 64 (ops/attention.py zero-pads to one);
// "tf32x3" a multiple of 8, a ragged last panel zero-filled in shared memory
// and its columns past dh not stored.
// ---------------------------------------------------------------------------

constexpr int kPanelKeys = 64;   // keys a block of the panel kernels

template <bool SINGLE>
__global__ void __launch_bounds__(mma::kThreads)
attention_panels_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, Strides st,
                            int S, int heads, int tiles, int panels, float c) {
  using T = mma::Tile<64>;
  constexpr int KB = kPanelKeys;
  constexpr uint32_t kQBytes = T::bytes(mma::kTileRows), kKBytes = T::bytes(KB);
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* base = aligned_smem(raw);
  const uint32_t smem0 = mma::smem_addr(base);
  const int blocks = (S + KB - 1) / KB, steps = blocks * panels;
  const int op = blockIdx.x % panels, rest = blockIdx.x / panels;
  const int bh = rest / tiles, q0 = (rest - bh * tiles) * mma::kTileRows;
  const int b = bh / heads, h = bh - b * heads;
  q += b * st.q[0] + h * st.q[1];
  k += b * st.k[0] + h * st.k[1];
  v += b * st.v[0] + h * st.v[1];
  // The q, k and V tiles of step t = j . panels + p (key block j, panel p).
  const auto tiles_of = [&](int t, uint32_t& qa, uint32_t& ka, uint32_t& va) {
    const int j = t / panels, p = t - j * panels;
    if constexpr (SINGLE) {
      qa = smem0 + p * kQBytes;
      ka = smem0 + panels * kQBytes + t * kKBytes;
      va = smem0 + panels * kQBytes + (steps + j) * kKBytes;
    } else {
      qa = smem0 + (t & 1) * (kQBytes + 2 * kKBytes);
      ka = qa + kQBytes;
      va = ka + kKBytes;
    }
  };
  const auto fill = [&](int t) {
    const int j = t / panels, p = t - j * panels;
    uint32_t qa, ka, va;
    tiles_of(t, qa, ka, va);
    if (!SINGLE || j == 0)
      T::template fill<mma::kTileRows, mma::kThreads>(qa, q + p * 64, st.q[2], q0, S);
    T::template fill<KB, mma::kThreads>(ka, k + p * 64, st.k[2], j * KB, S);
    if (p == panels - 1) T::template fill<KB, mma::kThreads>(va, v + op * 64, st.v[2], j * KB, S);
  };
  if constexpr (SINGLE) {
    for (int t = 0; t < steps; ++t) fill(t);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    mma::fence_async_proxy();
    __syncthreads();
  } else {
    fill(0);
    mma::cp_async_commit();
  }

  mma::Softmax<64, KB> sm;
  sm.init();
  float s[KB / 2];
  for (int t = 0; t < steps; ++t) {
    if constexpr (!SINGLE) {
      mma::cp_async_wait<0>();                 // step t has landed
      mma::fence_async_proxy();
      __syncthreads();                         // ... for all; the other stage is free
      if (t + 1 < steps) fill(t + 1);
      mma::cp_async_commit();
    }
    const int j = t / panels, p = t - j * panels;
    uint32_t qa, ka, va;
    tiles_of(t, qa, ka, va);
    sm.scores(s, qa, ka, p != 0);
    if (p == panels - 1) sm.update(s, va, j * KB, S, c);
  }
  sm.store(base, out + b * st.o[0] + h * st.o[1] + op * 64, st.o[2], q0, S);
}

template <bool SINGLE>
__global__ void __launch_bounds__(tf32x3::kThreads)
attention_panels_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, Strides st,
                             int S, int heads, int tiles, int dh, float c) {
  extern __shared__ __align__(16) float tile_mem[];
  const int panels = (dh + tf32x3::kPanel - 1) / tf32x3::kPanel;
  const int op = blockIdx.x % panels, rest = blockIdx.x / panels;
  const int bh = rest / tiles, q0 = (rest - bh * tiles) * tf32x3::kRows;
  const int b = bh / heads, h = bh - b * heads;
  tf32x3::panel_cta<tf32x3::Softmax<tf32x3::kPanel>, SINGLE>(
      tile_mem, q + b * st.q[0] + h * st.q[1], st.q[2], k + b * st.k[0] + h * st.k[1],
      st.k[2], v + b * st.v[0] + h * st.v[1], st.v[2], out + b * st.o[0] + h * st.o[1],
      st.o[2], S, q0, dh, op, c);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    const cudaError_t err_ = (expr);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

// Shape of the "simt" CTAs (warps, rows a warp).
constexpr int kSingleW = 16, kSingleR = 4;
constexpr int kFlashW = 8, kFlashR = 4;

// Dynamic shared memory of one "mma" CTA that holds `keys` keys.
size_t mma_smem_bytes(int keys, int dh) {
  return (size_t)kAlign + (size_t)(mma::kTileRows + 2 * keys) * dh * sizeof(bf16);
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory.  `allowed` is
// that kernel's own record by device: the attribute is set when a launch needs
// more than any before it.
constexpr int kMaxDevices = 64;

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

struct Args {
  int batch, heads, S, dh;
  int scale_dh;       // head dim of the softmax scale: dh, or a padded dh's true one
  const void *q, *k, *v;
  void* out;
  Strides st;
  cudaStream_t stream;
};

template <typename T, int W, int R, bool kSingle>
auto simt_kernel() {
  if constexpr (kSingle) return attention_single_kernel<T, W, R>;
  else return attention_flash_kernel<T, W, R>;
}

template <typename T, int W, int R, bool kSingle>
cudaError_t launch_simt(const Args& a) {
  const int keys = kSingle ? a.S : kKb;
  const size_t smem = smem_bytes(W * R, keys, a.dh, sizeof(T));
  const int tiles = (a.S + W * R - 1) / (W * R);
  const auto kernel = simt_kernel<T, W, R, kSingle>();
  static int allowed[kMaxDevices] = {};
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  kernel<<<tiles * a.batch * a.heads, W * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.st, a.S, a.dh, a.heads, tiles, k_stride(keys, sizeof(T)),
      1.0f / sqrtf((float)a.scale_dh));
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_mma(K kernel, int (&allowed)[kMaxDevices], const Args& a, int keys,
                       int warpgroups) {
  const size_t smem = mma_smem_bytes(keys, a.dh);
  const int tiles = (a.S + mma::kTileRows - 1) / mma::kTileRows;
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  kernel<<<tiles * a.batch * a.heads, warpgroups * mma::kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.st, a.S, a.heads, tiles,
      1.4426950408889634f / sqrtf((float)a.scale_dh));
  return cudaGetLastError();
}

int round_up(int n, int to) { return (n + to - 1) / to * to; }

template <int DH, int KB>
cudaError_t launch_single_mma(const Args& a) {
  static int allowed[kMaxDevices] = {};
  return launch_mma(attention_single_mma_kernel<DH, KB>, allowed, a, round_up(a.S, KB), 1);
}

template <int DH, int KB, int STAGES, int NWG>
cudaError_t launch_flash_mma(const Args& a) {
  static int allowed[kMaxDevices] = {};
  return launch_mma(attention_flash_mma_kernel<DH, KB, STAGES, NWG>, allowed, a,
                    STAGES * NWG * KB, NWG);
}

// The configurations that are built: key blocks of 64 or 128; two stages
// with one or two warpgroups, three stages with one.
template <int DH, int KB>
cudaError_t launch_mma_kb(bool single, int stages, int warpgroups, const Args& a) {
  if (single) return warpgroups == 1 ? launch_single_mma<DH, KB>(a) : cudaErrorInvalidValue;
  if (stages == 2 && warpgroups == 1) return launch_flash_mma<DH, KB, 2, 1>(a);
  if (stages == 2 && warpgroups == 2) return launch_flash_mma<DH, KB, 2, 2>(a);
  if (stages == 3 && warpgroups == 1) return launch_flash_mma<DH, KB, 3, 1>(a);
  return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_mma_dh(bool single, int kb, int stages, int warpgroups, const Args& a) {
  if (kb == 64) return launch_mma_kb<DH, 64>(single, stages, warpgroups, a);
  if (kb == 128) return launch_mma_kb<DH, 128>(single, stages, warpgroups, a);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one "tf32x3" CTA that holds `keys` keys.
size_t tf32_smem_bytes(int keys, int dh) {
  return tf32x3::tile_bytes(tf32x3::kRows + 2 * keys, dh);
}

template <typename K>
cudaError_t launch_tf32(K kernel, int (&allowed)[kMaxDevices], const Args& a, int keys) {
  const size_t smem = tf32_smem_bytes(keys, a.dh);
  const int tiles = (a.S + tf32x3::kRows - 1) / tf32x3::kRows;
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  kernel<<<tiles * a.batch * a.heads, tf32x3::kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.st, a.S, a.heads, tiles,
      1.4426950408889634f / sqrtf((float)a.scale_dh));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_single_tf32(const Args& a) {
  static int allowed[kMaxDevices] = {};
  return launch_tf32(attention_single_tf32_kernel<DH>, allowed, a, round_up(a.S, tf32x3::kKeys));
}

template <int DH>
cudaError_t launch_flash_tf32(const Args& a) {
  static int allowed[kMaxDevices] = {};
  return launch_tf32(attention_flash_tf32_kernel<DH>, allowed, a, 2 * tf32x3::kKeys);
}

// Every head dim that is a multiple of 8 up to 128 is built.
template <int DH = 8>
cudaError_t launch_tf32_dh(bool single, const Args& a) {
  if constexpr (DH > kMaxTileDh) {
    return cudaErrorInvalidValue;
  } else {
    if (a.dh != DH) return launch_tf32_dh<DH + 8>(single, a);
    return single ? launch_single_tf32<DH>(a) : launch_flash_tf32<DH>(a);
  }
}

// Dynamic shared memory of one panel CTA at head dim dh ("mma": a multiple
// of 64) and length S: SINGLE every q panel, every key block's k panels and
// one V panel of each; else two stages of a q, a k and a V panel.
size_t mma_panels_smem_bytes(bool single, int S, int dh) {
  const size_t panels = dh / 64, keys = round_up(S, kPanelKeys);
  const size_t rows = single ? mma::kTileRows * panels + keys * panels + keys
                             : 2 * (mma::kTileRows + 2 * kPanelKeys);
  return (size_t)kAlign + rows * 64 * sizeof(bf16);
}

size_t tf32_panels_smem_bytes(bool single, int S, int dh) {
  const size_t panels = (dh + tf32x3::kPanel - 1) / tf32x3::kPanel;
  const size_t keys = round_up(S, tf32x3::kKeys);
  const size_t rows = single ? tf32x3::kRows * panels + keys * panels + keys
                             : 2 * (tf32x3::kRows + 2 * tf32x3::kKeys);
  return tf32x3::tile_bytes(rows, tf32x3::kPanel);
}

// One panel kernel: tiles x batch x heads x panels CTAs of one warpgroup.
template <typename E, typename K>
cudaError_t launch_panel_kernel(K kernel, int (&allowed)[kMaxDevices], const Args& a,
                                size_t smem, int last) {
  const int tiles = (a.S + mma::kTileRows - 1) / mma::kTileRows;
  const long long grid = (long long)tiles * a.batch * a.heads * ((a.dh + 63) / 64);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  kernel<<<(int)grid, mma::kThreads, smem, a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.k), static_cast<const E*>(a.v),
      static_cast<E*>(a.out), a.st, a.S, a.heads, tiles, last,
      1.4426950408889634f / sqrtf((float)a.scale_dh));
  return cudaGetLastError();
}

template <bool SINGLE>
cudaError_t launch_panels_mma(const Args& a) {
  static int allowed[kMaxDevices] = {};
  return launch_panel_kernel<bf16>(attention_panels_mma_kernel<SINGLE>, allowed, a,
                                   mma_panels_smem_bytes(SINGLE, a.S, a.dh), a.dh / 64);
}

template <bool SINGLE>
cudaError_t launch_panels_tf32(const Args& a) {
  static int allowed[kMaxDevices] = {};
  return launch_panel_kernel<float>(attention_panels_tf32_kernel<SINGLE>, allowed, a,
                                    tf32_panels_smem_bytes(SINGLE, a.S, a.dh), a.dh);
}

// A head dim above kMaxTileDh: 64-key blocks, one warpgroup, the single
// kernel (stages 0) or a ring of two (stages 2).
cudaError_t launch_panels(bool single, int variant, int kb, int stages, int warpgroups,
                          const Args& a) {
  if (kb != kPanelKeys || warpgroups != 1 || stages != (single ? 0 : 2))
    return cudaErrorInvalidValue;
  if (variant == 1) return single ? launch_panels_mma<true>(a) : launch_panels_mma<false>(a);
  return single ? launch_panels_tf32<true>(a) : launch_panels_tf32<false>(a);
}

cudaError_t launch(bool single, int variant, int kb, int stages, int warpgroups, int dtype,
                   const Args& a) {
  if (a.batch < 1 || a.heads < 1 || a.S < 1 || a.dh < 8 || a.dh % 8 || a.scale_dh < 1
      || a.scale_dh > a.dh || (long long)a.S * a.batch * a.heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (a.dh == 32) return launch_mma_dh<32>(single, kb, stages, warpgroups, a);
    if (a.dh == 64) return launch_mma_dh<64>(single, kb, stages, warpgroups, a);
    if (a.dh == 128) return launch_mma_dh<128>(single, kb, stages, warpgroups, a);
    if (a.dh > kMaxTileDh && a.dh % 64 == 0)
      return launch_panels(single, variant, kb, stages, warpgroups, a);
    return cudaErrorInvalidValue;
  }
  if (variant == 2) {
    if (dtype != 0 || kb != tf32x3::kKeys || stages != (single ? 0 : 2) || warpgroups != 1)
      return cudaErrorInvalidValue;
    if (a.dh > kMaxTileDh) return launch_panels(single, variant, kb, stages, warpgroups, a);
    return launch_tf32_dh(single, a);
  }
  if (variant != 0 || a.dh > kMaxTileDh) return cudaErrorInvalidValue;
  for (const long long row : {a.st.q[2], a.st.k[2], a.st.v[2], a.st.o[2]})
    if (row < 0 || row > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (dtype == 1)
    return single ? launch_simt<bf16, kSingleW, kSingleR, true>(a)
                  : launch_simt<bf16, kFlashW, kFlashR, false>(a);
  if (dtype == 0)
    return single ? launch_simt<float, kSingleW, kSingleR, true>(a)
                  : launch_simt<float, kFlashW, kFlashR, false>(a);
  return cudaErrorInvalidValue;
}

Args make_args(int batch, int heads, int seq, int dh, int scale_dh, const void* q,
               const void* k, const void* v, void* out, const long long* strides,
               void* stream) {
  Args a{batch, heads, seq, dh, scale_dh, q, k, v, out, {}, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
  }
  return a;
}

}  // namespace

// variant: 0 = "simt" (dh up to 128), 1 = "mma" (bf16, dh 32 / 64 / 128 or
// a multiple of 64 above 128, in panels; kb = keys a block, 64 or 128 (64 in
// panels); (stages, warpgroups) = (2, 1), (2, 2) or (3, 1) of the flash
// kernel's ring ((2, 1) in panels), (0, 1) for the single kernel), 2 =
// "tf32x3" (float32; kb 64, (stages, warpgroups) = (2, 1) for flash, (0, 1)
// for single; above 128 in panels).  dtype: 0 = float32, 1 = bfloat16.  q,
// k, v, out: (batch, heads, seq, dh) on the current device through `strides`
// = element strides (batch, head, row) of q, k, v, out, twelve values in
// host memory; dh contiguous and a multiple of 8, every base and stride a
// multiple of 16 bytes, out not aliasing an input.  The scores are scaled
// by scale_dh^-1/2 (1 <= scale_dh <= dh): dh itself, or the true head dim
// of operands zero-padded to dh.  Return a cudaError_t.

extern "C" int attention_single_forward(int variant, int kb, int stages, int warpgroups,
                                        int dtype, int batch, int heads, int seq, int dh,
                                        int scale_dh, const void* q, const void* k,
                                        const void* v, void* out, const long long* strides,
                                        void* stream) {
  return (int)launch(true, variant, kb, stages, warpgroups, dtype,
                     make_args(batch, heads, seq, dh, scale_dh, q, k, v, out, strides, stream));
}

extern "C" int attention_flash_forward(int variant, int kb, int stages, int warpgroups,
                                       int dtype, int batch, int heads, int seq, int dh,
                                       int scale_dh, const void* q, const void* k,
                                       const void* v, void* out, const long long* strides,
                                       void* stream) {
  return (int)launch(false, variant, kb, stages, warpgroups, dtype,
                     make_args(batch, heads, seq, dh, scale_dh, q, k, v, out, strides, stream));
}

// Dynamic shared memory (bytes) of one CTA, as ops/attention.py::smem_bytes
// computes it: single = 1 for the whole-sequence kernel at this length, 0 for
// the blocked one.
extern "C" long long attention_smem(int single, int variant, int kb, int stages, int warpgroups,
                                    int seq, int head_dim, int elem_bytes) {
  if ((variant == 1 || variant == 2) && head_dim > kMaxTileDh)
    return (long long)(variant == 1 ? mma_panels_smem_bytes(single, seq, head_dim)
                                    : tf32_panels_smem_bytes(single, seq, head_dim));
  if (variant == 1 || variant == 2) {
    const int keys = single ? round_up(seq, kb) : stages * warpgroups * kb;
    return (long long)(variant == 1 ? mma_smem_bytes(keys, head_dim)
                                    : tf32_smem_bytes(keys, head_dim));
  }
  return single ? (long long)smem_bytes(kSingleW * kSingleR, seq, head_dim, elem_bytes)
                : (long long)smem_bytes(kFlashW * kFlashR, kKb, head_dim, elem_bytes);
}
