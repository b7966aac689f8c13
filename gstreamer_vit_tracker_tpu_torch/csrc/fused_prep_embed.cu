// NV12 frame -> embedded search tokens in one launch, for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel gstreamer_vit_tracker_tpu/ops/fused_prep_embed.py::_kernel
// (the pallas_call in _run, reached through nv12_search_tokens from
// tracker/core.py::update(fused_prep=...)).  It computes the chain
//   (Y - 16, UV - 128) -> bilinear window resample (rows, then columns; chroma
//   through the pair-folded weights, U at even and V at odd byte columns) ->
//   BT.601 mix -> clip to [0, 255] -> /255, normalise -> patchify, k = (p, q, c)
//   -> patch-embed product -> + (pos_embed_x + bias)
// and rounds where the TPU kernel rounds, T being __nv_bfloat16 or float: the
// hat weights to T, the row-resampled intermediate to T once, the column
// product, the colour mix, the clip and the normalise in float32, the
// normalised pixel to T, the embed sum (float32) to T, then + (pos + bias) in
// float32 rounded to T.
//
// The TPU kernel multiplies dense (S, band) sampling matrices because a matrix
// unit is what it has.  A hat row max(0, 1 - |t - j|) has at most two non-zero
// weights (two half-resolution ones for the folded chroma) and adding an exact
// zero changes no float32 sum, so this kernel reads two taps a row and two a
// column: twelve bytes of the frame for one output pixel.  It takes the whole
// frame with the band's origin (row0, col0) in device memory and treats a tap
// outside the band as the zero the band slice would have left, so no band is
// gathered first and nothing is read back to the host.
//
// Bound on the H100 SXM at the flagship shape (search 256, patch 16, D 192,
// bf16): the embed product is 75.5 MFLOP (0.08 us at 989 TFLOP/s), the taps and
// the mix a few MFLOP in float32; the bytes are the embed weight (295 KB), pos +
// bias and the tokens (98 KB each) and the part of the band under the window
// (about 1.5 bytes a window pixel): well under a megabyte, 0.2-0.3 us at
// 3.35 TB/s.  Bytes bound it; in practice it is one launch of latency.
//
// Design: one CTA of 256 threads makes kTok = 2 neighbouring tokens (128 CTAs
// for the flagship's 256 tokens, one wave on 132 SMs).  Each thread first makes
// pixels of the CTA's patches (all three channels, the row and column weights
// regenerated from the three scalars, the twelve taps loaded without a branch
// between them) into shared memory, already in k order.  Then the embed
// product, split over k (see the note there): the weight comes from L2 as
// 16-byte vectors, the same rows for every CTA, and both tokens accumulate in
// float32.  It runs on the FMA units: at 2 x 768 x 192 products a CTA the
// tensor cores would not change what bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTok = 2;          // tokens a CTA makes
constexpr int kThreads = 256;
constexpr int kAhead = 4;        // embed-weight vectors a thread loads ahead

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Source coordinate of output index o: start + (o + 0.5) * scale - 0.5, each
// operation rounded on its own (no fused multiply-add), as the plain version
// computes it.
__device__ __forceinline__ float source_coord(float start, int o, float scale) {
  return __fsub_rn(__fadd_rn(start, __fmul_rn((float)o + 0.5f, scale)), 0.5f);
}

__device__ __forceinline__ float hat(float t, int j) {
  return fmaxf(0.0f, 1.0f - fabsf(t - (float)j));
}

// Full-resolution weight of source index j, rounded to T.
template <typename T> __device__ __forceinline__ float weight(float t, int j) {
  return round_to<T>(hat(t, j));
}

// Pair-folded weight of half-resolution index i, rounded to T.
template <typename T> __device__ __forceinline__ float weight_half(float t, int i) {
  return round_to<T>(__fadd_rn(hat(t, 2 * i), hat(t, 2 * i + 1)));
}

// Shared memory: the pixels [kTok][K] of T, then (16-byte aligned) the partial
// embed sums [kgroups][kTok][dim] of float.
template <typename T> __host__ __device__ inline size_t partial_offset(int patch) {
  return ((size_t)kTok * patch * patch * 3 * sizeof(T) + 15) / 16 * 16;
}

struct Geometry {
  const unsigned char* y;    // (frame_h, frame_w)
  const unsigned char* uv;   // (frame_h / 2, frame_w) raw interleaved U, V
  int frame_w;
  int row0, col0;            // band origin, even
  int bh, bw;                // band size
};

// Shifted luma at band position (j, x); zero outside the band.  The load is
// unconditional, from a position clamped into the band, and the result is
// selected afterwards: no branch stands between the twelve loads of a pixel,
// so they are all in flight together.
__device__ __forceinline__ float luma(const Geometry& g, int j, int x) {
  const bool inside = j >= 0 && j < g.bh && x >= 0 && x < g.bw;
  const int jc = min(max(j, 0), g.bh - 1), xc = min(max(x, 0), g.bw - 1);
  const float v = (float)g.y[(size_t)(g.row0 + jc) * g.frame_w + g.col0 + xc] - 16.0f;
  return inside ? v : 0.0f;
}

// Shifted chroma at half-resolution band position (i, c); ch 0 = U, 1 = V.
__device__ __forceinline__ float chroma(const Geometry& g, int i, int c, int ch) {
  const bool inside = i >= 0 && i < g.bh / 2 && c >= 0 && c < g.bw / 2;
  const int ic = min(max(i, 0), g.bh / 2 - 1), cc = min(max(c, 0), g.bw / 2 - 1);
  const float v =
      (float)g.uv[(size_t)(g.row0 / 2 + ic) * g.frame_w + g.col0 + 2 * cc + ch] - 128.0f;
  return inside ? v : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_prep_embed_kernel(const unsigned char* __restrict__ y_plane,
                        const unsigned char* __restrict__ uv_plane,
                        const float* __restrict__ scal,      // start_y, start_x, scale
                        const int* __restrict__ origin,      // row0, col0
                        const T* __restrict__ w_embed,       // (K, D)
                        const T* __restrict__ pos_bias,      // (N, D)
                        T* __restrict__ out,                 // (N, D)
                        int frame_w, int bh, int bw, int out_size, int patch, int dim,
                        float mean_r, float mean_g, float mean_b,
                        float std_r, float std_g, float std_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                  // [kTok][K]
  const int grid_side = out_size / patch;
  const int n_tok = grid_side * grid_side;
  const int pp = patch * patch;
  const int K = pp * 3;
  const int n0 = blockIdx.x * kTok;
  const float sy = scal[0], sx = scal[1], sc = scal[2];
  const Geometry g{y_plane, uv_plane, frame_w, origin[0], origin[1], bh, bw};
  const float mean[3] = {mean_r, mean_g, mean_b};
  const float stdv[3] = {std_r, std_g, std_b};

  // ---- pixels of this CTA's patches, in k = (p, q, c) order ----------------
  for (int idx = threadIdx.x; idx < kTok * pp; idx += kThreads) {
    const int tk = idx / pp, rem = idx - tk * pp;
    const int n = n0 + tk;
    if (n >= n_tok) break;
    const int pr = rem / patch, q = rem - pr * patch;
    const int o_row = (n / grid_side) * patch + pr;
    const int o_col = (n % grid_side) * patch + q;
    const float ty = source_coord(sy, o_row, sc);
    const float tx = source_coord(sx, o_col, sc);
    const int j0 = (int)floorf(ty), x0 = (int)floorf(tx);
    const int i0 = j0 >> 1, c0 = x0 >> 1;              // floor division

    // Luma: rows j0, j0 + 1 blended and rounded to T, then columns x0, x0 + 1.
    const float wr0 = weight<T>(ty, j0), wr1 = weight<T>(ty, j0 + 1);
    float yc = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float col = round_to<T>(
          fmaf(wr1, luma(g, j0 + 1, x0 + dx), wr0 * luma(g, j0, x0 + dx)));
      yc = fmaf(col, weight<T>(tx, x0 + dx), yc);
    }
    // Chroma: half-resolution rows i0, i0 + 1 and columns c0, c0 + 1.
    const float hr0 = weight_half<T>(ty, i0), hr1 = weight_half<T>(ty, i0 + 1);
    float uc = 0.0f, vc = 0.0f;
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      const float wc = weight_half<T>(tx, c0 + dc);
      const float u = round_to<T>(
          fmaf(hr1, chroma(g, i0 + 1, c0 + dc, 0), hr0 * chroma(g, i0, c0 + dc, 0)));
      const float v = round_to<T>(
          fmaf(hr1, chroma(g, i0 + 1, c0 + dc, 1), hr0 * chroma(g, i0, c0 + dc, 1)));
      uc = fmaf(u, wc, uc);
      vc = fmaf(v, wc, vc);
    }
    // BT.601 (the integer coefficients over 256, exact in float32), every
    // operation rounded on its own.
    const float yv = __fmul_rn(298.0f / 256.0f, yc);
    float rgb[3];
    rgb[0] = __fadd_rn(yv, __fmul_rn(409.0f / 256.0f, vc));
    rgb[1] = __fadd_rn(__fadd_rn(yv, __fmul_rn(-100.0f / 256.0f, uc)),
                       __fmul_rn(-208.0f / 256.0f, vc));
    rgb[2] = __fadd_rn(yv, __fmul_rn(516.0f / 256.0f, uc));
    T* px = xs + (size_t)tk * K + (size_t)rem * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v01 = __fdiv_rn(fminf(fmaxf(rgb[c], 0.0f), 255.0f), 255.0f);
      px[c] = from_f32<T>(__fdiv_rn(__fsub_rn(v01, mean[c]), stdv[c]));
    }
  }
  __syncthreads();

  // ---- patch embed, split over k ---------------------------------------------
  // A thread owns kVec neighbouring outputs (one 16-byte vector of a weight
  // row) and every kgroups-th row k; kAhead vectors are loaded before any is
  // used.  A warp then reads 512 contiguous bytes of the weight at a time, an
  // eighth of the requests of one 2-byte load a thread and row, which is what
  // held the first version at 0.14 ms: every CTA reads the same rows, so the
  // requests of all SMs queue at the same L2 lines.  The partial sums of the
  // k groups meet in shared memory and are added in a fixed order.
  constexpr int kVec = 16 / sizeof(T);
  const int dgroups = dim / kVec;
  const int kgroups = kThreads / dgroups;
  float* part = reinterpret_cast<float*>(smem + partial_offset<T>(patch));  // [kg][kTok][dim]
  const int dg = threadIdx.x % dgroups, kg = threadIdx.x / dgroups;
  if (kg < kgroups) {
    float acc[kTok][kVec];
#pragma unroll
    for (int t = 0; t < kTok; ++t)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[t][e] = 0.0f;
    const T* wcol = w_embed + (size_t)dg * kVec;
    for (int k = kg; k < K; k += kgroups * kAhead) {
      uint4 w[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int kk = k + i * kgroups;
        w[i] = kk < K ? *reinterpret_cast<const uint4*>(wcol + (size_t)kk * dim)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int kk = min(k + i * kgroups, K - 1);   // past K the weights are zero
        const T* we = reinterpret_cast<const T*>(&w[i]);
#pragma unroll
        for (int t = 0; t < kTok; ++t) {
          const float x = to_f32(xs[t * K + kk]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[t][e] = fmaf(x, to_f32(we[e]), acc[t][e]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTok; ++t)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        part[((size_t)kg * kTok + t) * dim + dg * kVec + e] = acc[t][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kTok * dim; idx += kThreads) {
    const int t = idx / dim, d = idx - t * dim;
    const int n = n0 + t;
    if (n >= n_tok) break;
    float sum = 0.0f;
    for (int g2 = 0; g2 < kgroups; ++g2) sum += part[((size_t)g2 * kTok + t) * dim + d];
    const size_t at = (size_t)n * dim + d;
    out[at] = from_f32<T>(__fadd_rn(round_to<T>(sum), to_f32(pos_bias[at])));
  }
}

template <typename T>
cudaError_t launch(const void* y_plane, const void* uv_plane, const void* scal,
                   const void* origin, const void* w_embed, const void* pos_bias, void* out,
                   int frame_w, int bh, int bw, int out_size, int patch, int dim,
                   const float* mean, const float* stdv, cudaStream_t st) {
  const int grid_side = out_size / patch;
  const int n_tok = grid_side * grid_side;
  constexpr int kVec = 16 / sizeof(T);
  if (dim % kVec || dim / kVec > kThreads) return cudaErrorInvalidValue;
  const int kgroups = kThreads / (dim / kVec);
  const size_t smem = partial_offset<T>(patch) + (size_t)kgroups * kTok * dim * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  fused_prep_embed_kernel<T><<<(n_tok + kTok - 1) / kTok, kThreads, smem, st>>>(
      static_cast<const unsigned char*>(y_plane), static_cast<const unsigned char*>(uv_plane),
      static_cast<const float*>(scal), static_cast<const int*>(origin),
      static_cast<const T*>(w_embed), static_cast<const T*>(pos_bias), static_cast<T*>(out),
      frame_w, bh, bw, out_size, patch, dim, mean[0], mean[1], mean[2], stdv[0], stdv[1],
      stdv[2]);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of w_embed, pos_bias and out).  All tensors
// contiguous on the current device: y (frame_h, frame_w) uint8; uv
// (frame_h / 2, frame_w / 2, 2) uint8; scal 3 float32 [start_y, start_x, scale]
// relative to the band; origin 2 int32 [row0, col0], both even; w_embed
// (patch * patch * 3, dim), 16-byte aligned; pos_bias and out
// ((out_size / patch)^2, dim).  frame_w, band_h and band_w even, out_size a
// multiple of patch, dim a multiple of 16 bytes of the dtype.  Returns a
// cudaError_t.
extern "C" int fused_prep_embed_forward(
    int dtype, int frame_w, int band_h, int band_w, int out_size, int patch, int dim,
    float mean_r, float mean_g, float mean_b, float std_r, float std_g, float std_b,
    const void* y_plane, const void* uv_plane, const void* scal, const void* origin,
    const void* w_embed, const void* pos_bias, void* out, void* stream) {
  if (patch < 1 || out_size % patch || dim < 1 || (frame_w | band_h | band_w) & 1)
    return (int)cudaErrorInvalidValue;
  const float mean[3] = {mean_r, mean_g, mean_b};
  const float stdv[3] = {std_r, std_g, std_b};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<bf16>(y_plane, uv_plane, scal, origin, w_embed, pos_bias, out, frame_w,
                             band_h, band_w, out_size, patch, dim, mean, stdv, st);
  if (dtype == 0)
    return (int)launch<float>(y_plane, uv_plane, scal, origin, w_embed, pos_bias, out, frame_w,
                              band_h, band_w, out_size, patch, dim, mean, stdv, st);
  return (int)cudaErrorInvalidValue;
}
