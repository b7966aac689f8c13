// NV12 frame -> embedded search tokens in one launch, for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel gstreamer_vit_tracker_tpu/ops/fused_prep_embed.py::_kernel
// (the pallas_call in _run, reached through nv12_search_tokens from
// tracker/core.py::update(fused_prep=...)).  It computes the chain
//   window geometry (band origin, start, scale) -> (Y - 16, UV - 128) ->
//   bilinear window resample (rows, then columns; chroma through the
//   pair-folded weights, U at even and V at odd byte columns) -> BT.601 mix ->
//   clip to [0, 255] -> /255, normalise -> patchify, k = (p, q, c) ->
//   patch-embed product -> + (pos_embed_x + bias)
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
// frame and the window's centre and size in device memory, works out the band
// (window_geometry below, the float32 arithmetic of the Python version) and
// treats a tap outside the band as the zero the band slice would have left:
// no band is gathered, no operand is made on the host, nothing is read back.
//
// Bound on the H100 SXM at the flagship shape (search 256, patch 16, D 192,
// bf16): the embed product is 75.5 MFLOP (0.08 us at 989 TFLOP/s), the taps and
// the mix a few MFLOP in float32; the bytes are the embed weight (295 KB), pos +
// bias and the tokens (98 KB each) and the part of the band under the window
// (about 1.5 bytes a window pixel): well under a megabyte, 0.2-0.3 us at
// 3.35 TB/s.  Bytes bound it on paper.  What bounds it in practice is the pixel
// phase: some 300 instructions and twelve dependent tap loads an output pixel,
// 65,536 pixels, issued by whatever few SMs make them.  The first design (128
// CTAs of two tokens, a float32 FMA product that every CTA fed with the whole
// weight from L2, 37.7 MB of L2 reads a call) took 36.8 us a launch, and its
// wrapper made the band geometry and the operands with ~20 small PyTorch ops a
// call (PERF.md, the kernel table).
//
// Three variants, chosen by ops/fused_prep_embed.py::plan before the launch.
// Every one reads its operands padded to a width W (a multiple of its column
// tile and of its clusters, W >= D): the weight and pos + bias zero in
// columns [D, W), made once per parameter set; it writes only the D true
// columns of the (N, D) output.
//
// "mma" (bf16): a CTA of 256 threads owns TM = 16 tokens (one mma tile of
// rows) by TN = 32 (or 64) embed columns.  First it starts the copies of the
// first weight k-chunk (64 rows x TN, 16-byte cp.async into a ring of kStages
// chunks).  The
// pixels go straight into the A tile in shared memory, (TM, K) row-major, each
// row skewed to an odd number of 16-byte units, the layout ldmatrix reads
// without bank conflicts.  A thread owns one output column of the tile (one
// division for its token's place in the grid, the column weights and byte
// offsets made once) and walks the patch rows below it, the twelve tap loads
// of a pixel issued with no branch between them.  The W / TN CTAs of one token
// tile need the same pixels, so they run as thread-block clusters (at most
// 8; above W = 256 a token tile has equal clusters of 64-column CTAs, each
// cluster making the tile's pixels again): each CTA makes every cluster-th
// patch row, stores it into its peers' A tiles as well (16-byte stores into
// their shared memory) and one cluster barrier publishes them all.  Without
// the cluster each CTA makes all 4,096
// pixels of its tile itself, and the pixel phase is 16.7-18.1 us of a
// 22.4 us launch on the H100; with it 3.6-3.8 of 11.0 (profile_prep.py,
// which also times 64 columns a CTA: 32 is the fastest at D 192).
// Then the product: each warp owns m16 x n8 tiles and walks K in 16-deep
// steps of mma.sync.m16n8k16, A by ldmatrix, B (the weight as it lies, (K, W)
// row-major) by ldmatrix.trans.  Every step goes to a fresh accumulator and
// the steps are added in float32 in order: the tensor cores' own float32
// accumulation is not an IEEE sum (csrc/encoder_mma.cuh).  The epilogue rounds the
// sum to bf16, adds pos + bias in float32 and rounds again.  The weight is
// read by the CTAs of one column tile only: each reads K x TN of it once.
//
// "tf32x3" (float32): the same token tiles, clusters (of at most 6) and pixel
// phase, TN = 8, 16, 24 or 32 columns a CTA (the narrowest whose tiles make
// one cluster: 32 at D 192, 16 at D 96 and 64), the A tile in float32 ((TM,
// K) row-major, rows round_up(K, 32) + 4 floats apart, so that the eight rows
// of a fragment load fall into eight groups of four banks), and the product
// on mma.sync.m16n8k8 in split TF32 (csrc/attention_tf32.cuh: x = hi + lo, hi
// = tf32(x), lo = tf32(x - hi); lo.hi, hi.lo, then hi.hi, the three products
// float32's accuracy).  The weight arrives split, two planes (hi, then lo),
// each (K, W) row-major, made once per parameter set; the kernel splits only
// A, each element once, as its fragment is loaded.  A CTA has at most four
// n8 tiles and eight warps, so the warps split K: warp w takes the 32-deep
// chunks w, w + 8, ..., its B fragments read straight from the planes into
// registers (each load of a warp four rows' 32-byte sectors; L2 holds the
// planes) through two buffers: the first two chunks, and the epilogue's pos
// + bias, in flight while the pixels are made (volatile loads, which the
// compiler does not sink past the pixel phase: 15.3 -> 13.9 us at the
// flagship), each buffer refilled with the chunk two ahead as soon as it is
// multiplied.  A chunk's even and odd 8-deep steps go to two fresh
// accumulators, added to each other and then to the warp's sum in float32
// (one accumulator over K = 768 drifted 1.7e-3 from the twin in
// csrc/encoder_tf32.cuh); the eight warps' sums meet in shared memory and are
// added in warp order, then pos + bias in float32.  At the flagship's shape
// the split-TF32 product is 3 x 75.5 MFLOP (0.46 us at 495 TFLOP/s) and the
// weight's two planes 1.18 MB, read from L2 by each of the 16 token tiles'
// CTAs: 18.9 MB of L2 reads a call.  On the H100 the product alone (pixels
// cut out) takes ~5 us of a ~13.7 us launch, the pixel phase ~4, the rest
// (launch, cluster barriers, the copy of the shares, the epilogue) ~5
// (profile_prep.py).  Reading the peers' pixels in place over distributed
// shared memory, instead of copying them, measured slower (17.4 against
// 13.7 us), as did clusters of 8 and a build for two CTAs an SM.
//
// "simt" (float32, by name only: the yardstick of "tf32x3"): a CTA makes two
// tokens' pixels (the same pixel code) and the product split over k on the
// FMA units, the weight as 16-byte vectors from L2, the partial sums meeting
// in shared memory in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>

#include "attention_mma.cuh"   // cp.async and shared-address primitives
#include "encoder_tf32.cuh"   // split TF32: to_tf32, split, FragA / FragB, mma3, load_a

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::smem_addr;

constexpr int kThreads = 256;
constexpr int kTileTokens = 16;  // tokens a CTA ("mma", "tf32x3"): one m16 tile of rows
constexpr int kMaxCluster = 8;   // CTAs of a cluster: the portable limit
constexpr int kWarps = kThreads / 32;
constexpr int kKChunk = 64;      // weight rows a stage ("mma")
constexpr int kTf32Chunk = 32;   // K a warp's chunk ("tf32x3"): four 8-deep steps
constexpr int kStages = 2;       // weight k-chunks in flight ("mma")
constexpr int kSimtTok = 2;      // tokens a CTA ("simt")
constexpr int kAhead = 4;        // embed-weight vectors a thread loads ahead ("simt")

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

// ---------------------------------------------------------------------------
// The window's geometry.
// ---------------------------------------------------------------------------

struct Window {
  float start_y, start_x;    // window start relative to the band
  float scale;               // window size / out_size
  int row0, col0;            // band origin, even
  int bh, bw;                // band size
};

// ops/preprocess.py::band_origin on one axis: round(centre - band / 2) half to
// even (torch.round; rintf, not roundf), clamped to [0, max(limit - band, 0)],
// floored to an even number.  The clamp is taken on the float, which for every
// value in int32's range is the clamp of torch's int32.
__device__ __forceinline__ int band_origin(float centre, int limit, int band) {
  const float r = rintf(__fsub_rn(centre, 0.5f * (float)band));
  const float hi = (float)max(limit - band, 0);
  return (int)fminf(fmaxf(r, 0.0f), hi) & ~1;
}

// ops/fused_prep_embed.py::_band and the scale of its plain version, in the
// same float32 operations: start = (centre - 0.5 * size) - origin, the band
// only where the frame is larger than it on some axis (band 0: none), scale =
// size / out_size correctly rounded.
__device__ __forceinline__ Window window_geometry(const float* cx, const float* cy,
                                                  const float* size, int frame_h,
                                                  int frame_w, int band, int out_size) {
  const float c_x = *cx, c_y = *cy, s = *size;
  const float half = __fmul_rn(0.5f, s);
  Window w{__fsub_rn(c_y, half), __fsub_rn(c_x, half), __fdiv_rn(s, (float)out_size),
           0, 0, frame_h, frame_w};
  if (band > 0 && (frame_h > band || frame_w > band)) {
    w.bh = min(band, frame_h);
    w.bw = min(band, frame_w);
    w.row0 = band_origin(c_y, frame_h, band);
    w.col0 = band_origin(c_x, frame_w, band);
    w.start_y = __fsub_rn(w.start_y, (float)w.row0);
    w.start_x = __fsub_rn(w.start_x, (float)w.col0);
  }
  return w;
}

// ---------------------------------------------------------------------------
// The pixels.
// ---------------------------------------------------------------------------

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

struct Frame {
  const unsigned char* y;    // (frame_h, frame_w)
  const unsigned char* uv;   // (frame_h / 2, frame_w) raw interleaved U, V
  int frame_w;
};

struct Norm {
  float mean[3], stdv[3];
};

// Two taps of one axis at positions p and p + 1 of a band axis of length n:
// the positions clamped into it (so every load is of a real byte) and whether
// each lies inside (else the tap reads as zero).
struct Taps {
  int at0, at1;
  bool in0, in1;
};

__device__ __forceinline__ Taps taps(int p, int n) {
  return Taps{min(max(p, 0), n - 1), min(max(p + 1, 0), n - 1), p >= 0 && p < n,
              p + 1 >= 0 && p + 1 < n};
}

// The pixels of tokens [n0, n0 + tokens) into A: row t is token n0 + t, column
// k = (p * patch + q) * 3 + c, row stride lda, rounded to T; rows past the last
// token are zeros.  Only the patch rows p = share (mod shares) are made (all of
// them for shares = 1).  A thread owns one output column of the tile (or
// several, or a part of one's rows when the tile has fewer columns than
// threads): its token's grid place, column weights and byte offsets are made
// once, then it walks the patch rows.  The twelve loads of a pixel are
// unconditional, from positions clamped into the band, their results selected
// afterwards, so no branch stands between them and they are all in flight
// together.
template <typename T>
__device__ __forceinline__ void make_pixels(const Frame& f, const Window& w, const Norm& nm,
                                            int n0, int tokens, int n_tok, int grid_side,
                                            int patch, int share, int shares, T* A, int lda) {
  const int ncols = tokens * patch;
  const int rgroups = max(1, kThreads / ncols);
  const int step = shares * rgroups;
  const int half_w = w.bw / 2, half_h = w.bh / 2;
  for (int item = threadIdx.x; item < ncols * rgroups; item += kThreads) {
    const int col = item % ncols, first = share + shares * (item / ncols);
    const int t = col / patch, q = col - t * patch;
    const int n = n0 + t;
    T* at = A + (size_t)t * lda + q * 3;
    if (n >= n_tok) {
      for (int pr = first; pr < patch; pr += step)
#pragma unroll
        for (int c = 0; c < 3; ++c) at[pr * patch * 3 + c] = from_f32<T>(0.0f);
      continue;
    }
    const int gh = n / grid_side, gw = n - gh * grid_side;
    const float tx = source_coord(w.start_x, gw * patch + q, w.scale);
    const int x0 = (int)floorf(tx), c0 = x0 >> 1;     // floor division
    const float wc[2] = {weight<T>(tx, x0), weight<T>(tx, x0 + 1)};
    const float hc[2] = {weight_half<T>(tx, c0), weight_half<T>(tx, c0 + 1)};
    const Taps lx = taps(x0, w.bw), cxt = taps(c0, half_w);
    const int lcol[2] = {w.col0 + lx.at0, w.col0 + lx.at1};
    const int ccol[2] = {w.col0 + 2 * cxt.at0, w.col0 + 2 * cxt.at1};
    const bool lin[2] = {lx.in0, lx.in1}, cin[2] = {cxt.in0, cxt.in1};

    for (int pr = first; pr < patch; pr += step) {
      const float ty = source_coord(w.start_y, gh * patch + pr, w.scale);
      const int j0 = (int)floorf(ty), i0 = j0 >> 1;
      const float wr0 = weight<T>(ty, j0), wr1 = weight<T>(ty, j0 + 1);
      const float hr0 = weight_half<T>(ty, i0), hr1 = weight_half<T>(ty, i0 + 1);
      const Taps ly = taps(j0, w.bh), cy = taps(i0, half_h);
      const unsigned char* yr0 = f.y + (size_t)(w.row0 + ly.at0) * f.frame_w;
      const unsigned char* yr1 = f.y + (size_t)(w.row0 + ly.at1) * f.frame_w;
      const unsigned char* ur0 = f.uv + (size_t)(w.row0 / 2 + cy.at0) * f.frame_w;
      const unsigned char* ur1 = f.uv + (size_t)(w.row0 / 2 + cy.at1) * f.frame_w;
      // The twelve taps: four luma bytes, four (U, V) byte pairs.
      unsigned char l0[2], l1[2];
      uchar2 u0[2], u1[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        l0[d] = yr0[lcol[d]];
        l1[d] = yr1[lcol[d]];
        u0[d] = *reinterpret_cast<const uchar2*>(ur0 + ccol[d]);
        u1[d] = *reinterpret_cast<const uchar2*>(ur1 + ccol[d]);
      }
      // Luma: rows j0, j0 + 1 blended and rounded to T, then columns x0, x0 + 1.
      float yc = 0.0f, uc = 0.0f, vc = 0.0f;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float a = ly.in0 && lin[d] ? (float)l0[d] - 16.0f : 0.0f;
        const float b = ly.in1 && lin[d] ? (float)l1[d] - 16.0f : 0.0f;
        yc = fmaf(round_to<T>(fmaf(wr1, b, wr0 * a)), wc[d], yc);
      }
      // Chroma: half-resolution rows i0, i0 + 1 and columns c0, c0 + 1.
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const bool a_in = cy.in0 && cin[d], b_in = cy.in1 && cin[d];
        const float ua = a_in ? (float)u0[d].x - 128.0f : 0.0f;
        const float va = a_in ? (float)u0[d].y - 128.0f : 0.0f;
        const float ub = b_in ? (float)u1[d].x - 128.0f : 0.0f;
        const float vb = b_in ? (float)u1[d].y - 128.0f : 0.0f;
        uc = fmaf(round_to<T>(fmaf(hr1, ub, hr0 * ua)), hc[d], uc);
        vc = fmaf(round_to<T>(fmaf(hr1, vb, hr0 * va)), hc[d], vc);
      }
      // BT.601 (the integer coefficients over 256, exact in float32), every
      // operation rounded on its own.
      const float yv = __fmul_rn(298.0f / 256.0f, yc);
      float rgb[3];
      rgb[0] = __fadd_rn(yv, __fmul_rn(409.0f / 256.0f, vc));
      rgb[1] = __fadd_rn(__fadd_rn(yv, __fmul_rn(-100.0f / 256.0f, uc)),
                         __fmul_rn(-208.0f / 256.0f, vc));
      rgb[2] = __fadd_rn(yv, __fmul_rn(516.0f / 256.0f, uc));
      T* px = at + pr * patch * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v01 = __fdiv_rn(fminf(fmaxf(rgb[c], 0.0f), 255.0f), 255.0f);
        px[c] = from_f32<T>(__fdiv_rn(__fsub_rn(v01, nm.mean[c]), nm.stdv[c]));
      }
    }
  }
}

struct Args {
  Frame frame;
  const float *cx, *cy, *size;
  int frame_h, band, out_size, patch;
  int dim;                   // D: the output's columns
  int width;                 // W: the operands' columns, D padded
  Norm norm;
  const void* w_embed;       // (K, W); "tf32x3": (2, K, W), hi then lo
  const void* pos_bias;      // (N, W)
  void* out;                 // (N, D)
};

// The pixels of every patch row made by the CTAs of this cluster (each CTA
// made the rows share, share + shares, ... of its tile into its own A, rows
// lda elements apart) copied into its peers' A tiles, 16 bytes at a time
// where a patch row of a token is whole 16-byte units, and published by one
// cluster barrier.  Every thread arrived at the cluster barrier before its
// pixels (a CTA may write a peer's shared memory only once the peer runs).
template <typename T>
__device__ __forceinline__ void share_pixels(cg::cluster_group& cluster, T* A, int lda,
                                             int tm, int patch, int share, int shares) {
  constexpr int kVec = 16 / sizeof(T);
  __syncthreads();                 // this CTA's share is made
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // the peers run
  const int seg = patch * 3;       // elements of one patch row of one token
  const int vec = seg % kVec == 0 ? kVec : 1;
  const int units = seg / vec;
  const int rows = (patch - share + shares - 1) / shares;      // patch rows of the share
  const int per_peer = tm * rows * units;
  for (int i = threadIdx.x; i < (shares - 1) * per_peer; i += kThreads) {
    const int peer = (share + 1 + i / per_peer) % shares, j = i % per_peer;
    const int u = j % units, tr = j / units;
    const size_t at = (size_t)(tr / rows) * lda + (share + shares * (tr % rows)) * seg
                      + u * vec;
    T* dst = cluster.map_shared_rank(A + at, peer);
    if (vec == kVec)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(A + at);
    else
      *dst = A[at];
  }
  cluster.sync();                  // every share is in every tile
}

// ---------------------------------------------------------------------------
// Variant "mma": bf16 on the tensor cores.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d = A[16 x 16] . B[16 x 8] into a fresh (zero) accumulator.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

__host__ __device__ inline int round_up(int n, int to) { return (n + to - 1) / to * to; }

// Row stride (bf16 elements) of a shared tile whose rows hold n: n rounded up
// to an odd number of 16-byte units, so that the eight rows one ldmatrix
// reads fall in eight different bank groups.
__host__ __device__ constexpr int skewed(int n) {
  return ((n + 7) / 8 % 2 ? (n + 7) / 8 : (n + 7) / 8 + 1) * 8;
}

// Shared memory of one "mma" CTA: the A tile (TM rows of round_up(K, 64),
// skewed), then the weight ring (kStages x 64 rows of TN, skewed).
inline size_t mma_smem_bytes(int tm, int tn, int k) {
  return ((size_t)tm * skewed(round_up(k, kKChunk))
          + (size_t)kStages * kKChunk * skewed(tn)) * sizeof(bf16);
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads) embed_mma_kernel(const Args a) {
  constexpr int kNt = TN / 8;                         // n8 tiles of a CTA
  constexpr int kTiles = (TM / 16) * kNt;
  constexpr int kPerWarp = (kTiles + kWarps - 1) / kWarps;
  constexpr int kLdb = skewed(TN);
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.patch * a.patch * 3;
  const int kp = round_up(K, kKChunk);
  const int lda = skewed(kp);
  bf16* A = reinterpret_cast<bf16*>(smem);            // [TM][lda]
  bf16* B = A + (size_t)TM * lda;                     // [kStages][kKChunk][kLdb]
  const int grid_side = a.out_size / a.patch;
  const int n_tok = grid_side * grid_side;
  const int n0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  const int chunks = kp / kKChunk;
  const bf16* w_embed = static_cast<const bf16*>(a.w_embed);

  // Weight rows [64 c, 64 c + 64) x columns [col0, col0 + TN) into stage c %
  // kStages; rows past K are zeros.
  const auto load_chunk = [&](int c) {
    bf16* dst = B + (size_t)(c % kStages) * kKChunk * kLdb;
    for (int i = threadIdx.x; i < kKChunk * kNt; i += kThreads) {
      const int r = i / kNt, v = i - r * kNt;
      const int k = c * kKChunk + r;
      cp_async16(smem_addr(dst + r * kLdb + v * 8),
                 w_embed + (size_t)min(k, K - 1) * a.width + col0 + v * 8, k < K);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load_chunk(s);
    cp_async_commit();
  }

  // The CTAs of one token tile (its column tiles) may run as one cluster:
  // each then makes every shares-th patch row of the tile's pixels and
  // stores them into the others' A tiles as well (16-byte stores into their
  // shared memory); one cluster barrier then publishes every share.
  cg::cluster_group cluster = cg::this_cluster();
  const int shares = (int)cluster.num_blocks(), share = (int)cluster.block_rank();
  // A CTA may write a peer's shared memory only once the peer runs: every
  // thread arrives here and waits before its first store to a peer.
  if (shares > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const Window w = window_geometry(a.cx, a.cy, a.size, a.frame_h, a.frame.frame_w, a.band,
                                   a.out_size);
  make_pixels<bf16>(a.frame, w, a.norm, n0, TM, n_tok, grid_side, a.patch, share, shares, A,
                    lda);
  if (shares > 1) share_pixels(cluster, A, lda, TM, a.patch, share, shares);
  for (int i = threadIdx.x; i < TM * (kp - K); i += kThreads)     // K's padding
    A[(size_t)(i / (kp - K)) * lda + K + i % (kp - K)] = __float2bfloat16_rn(0.0f);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kPerWarp][4];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    if (c + kStages - 1 < chunks) load_chunk(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();     // this thread's copies of chunk c are in
    __syncthreads();                 // everyone's are, and the pixels
    const bf16* Bs = B + (size_t)(c % kStages) * kKChunk * kLdb;
#pragma unroll
    for (int ks = 0; ks < kKChunk / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int tile = warp + i * kWarps;
        if (kTiles % kWarps != 0 && tile >= kTiles) break;   // uniform over the warp
        const int mt = tile / kNt, nt = tile - mt * kNt;
        uint32_t af[4], bfr[2];
        ldmatrix_x4(af, smem_addr(A + (size_t)(mt * 16 + (lane & 15)) * lda
                                  + c * kKChunk + ks * 16 + (lane >> 4) * 8));
        ldmatrix_x2_trans(bfr, smem_addr(Bs + (ks * 16 + (lane & 15)) * kLdb + nt * 8));
        float d[4];
        mma_16816(d, af, bfr);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = __fadd_rn(acc[i][e], d[e]);
      }
    }
    __syncthreads();                 // stage c % kStages is free again
  }

  // Epilogue on the accumulator registers: row lane / 4 (+ 8), columns
  // 2 (lane % 4) and + 1 of each n8 tile.
  const bf16* pos_bias = static_cast<const bf16*>(a.pos_bias);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int tile = warp + i * kWarps;
    if (kTiles % kWarps != 0 && tile >= kTiles) break;
    const int mt = tile / kNt, nt = tile - mt * kNt;
    const int col = col0 + nt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + mt * 16 + (lane >> 2) + 8 * h;
      if (n >= n_tok) continue;
      const __nv_bfloat162 pb =
          *reinterpret_cast<const __nv_bfloat162*>(pos_bias + (size_t)n * a.width + col);
      __nv_bfloat162 o;
      o.x = __float2bfloat16_rn(
          __fadd_rn(round_to<bf16>(acc[i][2 * h]), __bfloat162float(pb.x)));
      o.y = __float2bfloat16_rn(
          __fadd_rn(round_to<bf16>(acc[i][2 * h + 1]), __bfloat162float(pb.y)));
      bf16* dst = out + (size_t)n * a.dim + col;
      if (a.width == a.dim) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = o;
      } else {                       // the padded columns are dropped
        if (col < a.dim) dst[0] = o.x;
        if (col + 1 < a.dim) dst[1] = o.y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Variant "tf32x3": float32 on the tensor cores, split TF32.
// ---------------------------------------------------------------------------

// Floats of a row of the A tile: K rounded up to whole chunks, + 4 (4 modulo
// 32: the rows g of a fragment load fall into banks 4g + t).
__host__ __device__ inline int tf32_lda(int k) { return round_up(k, kTf32Chunk) + 4; }

// Shared memory of one "tf32x3" CTA: the A tile, then the eight warps' sums
// of the (TM, TN) output tile (rows TN + 1 floats apart).
inline size_t tf32_smem_bytes(int tn, int k) {
  return ((size_t)kTileTokens * tf32_lda(k) + (size_t)kWarps * kTileTokens * (tn + 1))
         * sizeof(float);
}

// A read-only load issued where it stands: volatile, so that the compiler
// keeps a chunk's loads ahead of the pixel phase (the cluster barrier's
// arrive is volatile too) instead of sinking them to their first use.
__device__ __forceinline__ uint32_t load_early(const float* p) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// A warp's B fragments of one 32-deep chunk at k0: for each 8-deep step s
// and n8 tile j, b0 (k = k0 + 8s + t) and b1 (k + 4) of column 8j + g of both
// planes.  Rows past K read row K - 1: A's columns past K are zeros, so
// those products add exact zeros.  wh: the hi plane at column col0 + g.
template <int NT>
__device__ __forceinline__ void load_b_chunk(tf32x3::FragB (&b)[4][NT], const float* wh,
                                             size_t plane, int width, int K, int k0, int t) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* row = wh + (size_t)min(k0 + 8 * s + t + 4 * e, K - 1) * width;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[s][j].hi[e] = load_early(row + 8 * j);
        b[s][j].lo[e] = load_early(row + 8 * j + plane);
      }
    }
  }
}

// One 32-deep chunk of a warp's product into acc, A's 16 rows at `a` (row g,
// column t of the chunk; rows lda floats apart), each fragment split as it
// is loaded, all four before the first product: the chunk's even and odd
// 8-deep steps in two fresh accumulators, added to each other and then to
// acc in float32.
template <int NT>
__device__ __forceinline__ void chunk_product(float (&acc)[NT][4], const float* a, int lda,
                                              const tf32x3::FragB (&b)[4][NT]) {
  tf32x3::FragA fa[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) fa[s] = encoder_tf32::load_a(a + 8 * s, lda);
  float part[2][NT][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[e][j][q] = 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) tf32x3::mma3<0>(part[s & 1], fa[s], b[s]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] += part[0][j][q] + part[1][j][q];
}

template <int TN>
__global__ void __launch_bounds__(kThreads) embed_tf32_kernel(const Args a) {
  namespace tf = tf32x3;
  constexpr int TM = kTileTokens;
  constexpr int kNt = TN / 8;                         // n8 tiles of a CTA
  static_assert(TM == 16, "one m16 tile of rows");
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.patch * a.patch * 3;
  const int kp = round_up(K, kTf32Chunk);
  const int lda = tf32_lda(K);
  float* A = reinterpret_cast<float*>(smem);          // [TM][lda]
  float* sums = A + (size_t)TM * lda;                 // [kWarps][TM][TN + 1]
  const int grid_side = a.out_size / a.patch;
  const int n_tok = grid_side * grid_side;
  const int n0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  const int chunks = kp / kTf32Chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* wh = static_cast<const float*>(a.w_embed) + col0 + g;
  const size_t plane = (size_t)K * a.width;

  // The warp's chunks c = warp, warp + 8, ... go through two register
  // buffers: its first two are in flight through the pixel phase, and each
  // buffer is refilled with the chunk two ahead as soon as it is multiplied.
  tf::FragB b0[4][kNt], b1[4][kNt];
  if (warp < chunks) load_b_chunk<kNt>(b0, wh, plane, a.width, K, warp * kTf32Chunk, t);
  if (warp + kWarps < chunks)
    load_b_chunk<kNt>(b1, wh, plane, a.width, K, (warp + kWarps) * kTf32Chunk, t);

  // This thread's elements of pos + bias for the epilogue, in flight too.
  constexpr int kOut = (TM * TN + kThreads - 1) / kThreads;
  const float* pos_bias = static_cast<const float*>(a.pos_bias);
  float pb[kOut];
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int i = min((int)threadIdx.x + u * kThreads, TM * TN - 1);
    pb[u] = __uint_as_float(load_early(
        pos_bias + (size_t)min(n0 + i / TN, n_tok - 1) * a.width + col0 + i % TN));
  }

  cg::cluster_group cluster = cg::this_cluster();
  const int shares = (int)cluster.num_blocks(), share = (int)cluster.block_rank();
  if (shares > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const Window w = window_geometry(a.cx, a.cy, a.size, a.frame_h, a.frame.frame_w, a.band,
                                   a.out_size);
  make_pixels<float>(a.frame, w, a.norm, n0, kTileTokens, n_tok, grid_side, a.patch, share,
                     shares, A, lda);
  if (shares > 1) share_pixels(cluster, A, lda, TM, a.patch, share, shares);
  for (int i = threadIdx.x; i < TM * (kp - K); i += kThreads)     // K's padding
    A[(size_t)(i / (kp - K)) * lda + K + i % (kp - K)] = 0.0f;
  __syncthreads();

  float acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
  const float* a_row = A + (size_t)g * lda + t;
  for (int c = warp; c < chunks; c += 2 * kWarps) {
    chunk_product<kNt>(acc, a_row + c * kTf32Chunk, lda, b0);
    if (c + 2 * kWarps < chunks)
      load_b_chunk<kNt>(b0, wh, plane, a.width, K, (c + 2 * kWarps) * kTf32Chunk, t);
    if (c + kWarps >= chunks) break;
    chunk_product<kNt>(acc, a_row + (c + kWarps) * kTf32Chunk, lda, b1);
    if (c + 3 * kWarps < chunks)
      load_b_chunk<kNt>(b1, wh, plane, a.width, K, (c + 3 * kWarps) * kTf32Chunk, t);
  }

  // The warps' sums into shared memory (a lane holds rows g and g + 8,
  // columns 8j + 2t and + 1), then added in warp order with pos + bias.
  float* mine = sums + (size_t)warp * TM * (TN + 1);
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mine[(g + 8 * (q >> 1)) * (TN + 1) + 8 * j + 2 * t + (q & 1)] = acc[j][q];
  __syncthreads();
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / TN, cc = i - r * TN;
    const int n = n0 + r, col = col0 + cc;
    if (i >= TM * TN || n >= n_tok || col >= a.dim) continue;
    float sum = sums[r * (TN + 1) + cc];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) sum += sums[((size_t)v * TM + r) * (TN + 1) + cc];
    out[(size_t)n * a.dim + col] = __fadd_rn(sum, pb[u]);
  }
}

// ---------------------------------------------------------------------------
// Variant "simt": float32 on the FMA units.
// ---------------------------------------------------------------------------

// Shared memory: the pixels [kSimtTok][K] of float, then the partial embed sums
// [kgroups][kSimtTok][width] of float.
inline size_t simt_smem_bytes(int k, int width) {
  const int kgroups = kThreads / (width / 4);
  return ((size_t)kSimtTok * k + (size_t)kgroups * kSimtTok * width) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) embed_simt_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);           // [kSimtTok][K]
  const int grid_side = a.out_size / a.patch;
  const int n_tok = grid_side * grid_side;
  const int K = a.patch * a.patch * 3, width = a.width;
  const int n0 = blockIdx.x * kSimtTok;
  const Window w = window_geometry(a.cx, a.cy, a.size, a.frame_h, a.frame.frame_w, a.band,
                                   a.out_size);
  make_pixels<float>(a.frame, w, a.norm, n0, kSimtTok, n_tok, grid_side, a.patch, 0, 1, xs,
                     K);
  __syncthreads();

  // A thread owns kVec neighbouring outputs (one 16-byte vector of a weight
  // row) and every kgroups-th row k; kAhead vectors are loaded before any is
  // used, so a warp reads 512 contiguous bytes of the weight at a time.  The
  // partial sums of the k groups meet in shared memory and are added in a
  // fixed order.
  constexpr int kVec = 4;
  const int dgroups = width / kVec;
  const int kgroups = kThreads / dgroups;
  float* part = xs + (size_t)kSimtTok * K;               // [kg][kSimtTok][width]
  const float* w_embed = static_cast<const float*>(a.w_embed);
  const int dg = threadIdx.x % dgroups, kg = threadIdx.x / dgroups;
  if (kg < kgroups) {
    float acc[kSimtTok][kVec];
#pragma unroll
    for (int t = 0; t < kSimtTok; ++t)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[t][e] = 0.0f;
    const float* wcol = w_embed + (size_t)dg * kVec;
    for (int k = kg; k < K; k += kgroups * kAhead) {
      float4 wv[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int kk = k + i * kgroups;
        wv[i] = kk < K ? *reinterpret_cast<const float4*>(wcol + (size_t)kk * width)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int kk = min(k + i * kgroups, K - 1);   // past K the weights are zero
        const float we[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
#pragma unroll
        for (int t = 0; t < kSimtTok; ++t) {
          const float x = xs[t * K + kk];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[t][e] = fmaf(x, we[e], acc[t][e]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kSimtTok; ++t)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        part[((size_t)kg * kSimtTok + t) * width + dg * kVec + e] = acc[t][e];
  }
  __syncthreads();

  const float* pos_bias = static_cast<const float*>(a.pos_bias);
  float* out = static_cast<float*>(a.out);
  for (int idx = threadIdx.x; idx < kSimtTok * a.dim; idx += kThreads) {
    const int t = idx / a.dim, d = idx - t * a.dim;
    const int n = n0 + t;
    if (n >= n_tok) break;
    float sum = 0.0f;
    for (int g2 = 0; g2 < kgroups; ++g2) sum += part[((size_t)g2 * kSimtTok + t) * width + d];
    out[(size_t)n * a.dim + d] = __fadd_rn(sum, pos_bias[(size_t)n * width + d]);
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

constexpr int kMaxDevices = 64;

// Opts `kernel` in to `smem` bytes of dynamic shared memory.  `allowed` is
// that kernel's own record by device: the attribute is set when a launch needs
// more than any before it (never during a CUDA-graph capture of a shape seen
// before).
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int (&allowed)[kMaxDevices], size_t smem) {
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

// The W / TN column tiles of a token tile run as W / (TN . cluster) clusters
// of `cluster` CTAs, each cluster sharing the tile's pixel phase.
template <typename Kern>
cudaError_t launch_tiled(Kern kernel, int (&allowed)[kMaxDevices], size_t smem, const Args& a,
                         int tn, int cluster, cudaStream_t st) {
  RETURN_IF_ERROR(allow_smem(kernel, allowed, smem));
  const int n_tok = (a.out_size / a.patch) * (a.out_size / a.patch);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n_tok + kTileTokens - 1) / kTileTokens, a.width / tn);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  RETURN_IF_ERROR(cudaLaunchKernelEx(&config, kernel, a));
  return cudaGetLastError();
}

cudaError_t launch_mma(const Args& a, int tn, int cluster, cudaStream_t st) {
  const int k = a.patch * a.patch * 3;
  if (tn == 32) {
    static int allowed[kMaxDevices] = {};
    return launch_tiled(embed_mma_kernel<kTileTokens, 32>, allowed,
                        mma_smem_bytes(kTileTokens, 32, k), a, tn, cluster, st);
  }
  if (tn == 64) {
    static int allowed[kMaxDevices] = {};
    return launch_tiled(embed_mma_kernel<kTileTokens, 64>, allowed,
                        mma_smem_bytes(kTileTokens, 64, k), a, tn, cluster, st);
  }
  return cudaErrorInvalidValue;
}

template <int TN>
cudaError_t launch_tf32_tiles(const Args& a, int cluster, cudaStream_t st) {
  static int allowed[kMaxDevices] = {};
  return launch_tiled(embed_tf32_kernel<TN>, allowed,
                      tf32_smem_bytes(TN, a.patch * a.patch * 3), a, TN, cluster, st);
}

cudaError_t launch_tf32(const Args& a, int tn, int cluster, cudaStream_t st) {
  switch (tn) {
    case 8: return launch_tf32_tiles<8>(a, cluster, st);
    case 16: return launch_tf32_tiles<16>(a, cluster, st);
    case 24: return launch_tf32_tiles<24>(a, cluster, st);
    case 32: return launch_tf32_tiles<32>(a, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_simt(const Args& a, cudaStream_t st) {
  if (a.width % 4 || a.width / 4 > kThreads) return cudaErrorInvalidValue;
  const size_t smem = simt_smem_bytes(a.patch * a.patch * 3, a.width);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int n_tok = (a.out_size / a.patch) * (a.out_size / a.patch);
  embed_simt_kernel<<<(n_tok + kSimtTok - 1) / kSimtTok, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = "simt" (float32: w_embed, pos_bias and out float), 1 = "mma"
// (bfloat16), 2 = "tf32x3" (float32; w_embed the two planes hi, lo).  cols:
// embed columns a CTA ("mma" 32 or 64, "tf32x3" 8, 16, 24 or 32; "simt" ignores it and
// the cluster); cluster: CTAs of a cluster, dividing width / cols, at most 8.
// All tensors on the current device: y (frame_h, frame_w) uint8; uv
// (frame_h / 2, frame_w / 2, 2) uint8; cx, cy, size one float32 each, the crop
// window (ops/preprocess.py::CropWindow); w_embed (patch * patch * 3, width),
// 16-byte aligned; pos_bias ((out_size / patch)^2, width) and out
// ((out_size / patch)^2, dim), contiguous.  frame_h and frame_w even; band 0
// for none, even where the frame is larger than it; out_size a multiple of
// patch; 1 <= dim <= width, width a multiple of cols (of 4 for "simt", at
// most 1024).  Returns a cudaError_t.
extern "C" int fused_prep_embed_forward(
    int variant, int cols, int cluster, int frame_h, int frame_w, int band,
    int out_size, int patch, int dim, int width, float mean_r, float mean_g, float mean_b,
    float std_r, float std_g, float std_b, const void* y_plane, const void* uv_plane,
    const void* cx, const void* cy, const void* size, const void* w_embed,
    const void* pos_bias, void* out, void* stream) {
  const bool banded = band > 0 && (frame_h > band || frame_w > band);
  if (patch < 1 || out_size < patch || out_size % patch || dim < 1 || width < dim
      || frame_h < 2 || frame_w < 2 || band < 0 || (frame_h | frame_w) & 1
      || (banded && band & 1))
    return (int)cudaErrorInvalidValue;
  if (variant != 0 && (cols < 1 || width % cols || cluster < 1 || cluster > kMaxCluster
                       || (width / cols) % cluster))
    return (int)cudaErrorInvalidValue;
  const Args a{Frame{static_cast<const unsigned char*>(y_plane),
                     static_cast<const unsigned char*>(uv_plane), frame_w},
               static_cast<const float*>(cx), static_cast<const float*>(cy),
               static_cast<const float*>(size), frame_h, band, out_size, patch, dim, width,
               Norm{{mean_r, mean_g, mean_b}, {std_r, std_g, std_b}}, w_embed, pos_bias, out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) return (int)launch_mma(a, cols, cluster, st);
  if (variant == 2) return (int)launch_tf32(a, cols, cluster, st);
  if (variant == 0) return (int)launch_simt(a, st);
  return (int)cudaErrorInvalidValue;
}
