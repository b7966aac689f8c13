// Hopper's transaction barriers and tensor memory accelerator (TMA), and the
// ring of 64 x 64 bf16 panels that the panel attentions walk above a head
// dim of 128: attention.cu's attention_panels_mma_kernel (kernels 3 and 4)
// and encoder_mma.cuh's attention_panels_kernel (the attention stage of
// kernels 1 and 2).  encoder_mma.cuh's ring products use the primitives too.
//
// A panel CTA is two warpgroups.  The consumer (warpgroup 0) owns 64 query
// rows and G 64-column panels of o in its registers.  The producer
// (warpgroup 1) gives its registers up (setmaxnreg) and one of its threads
// copies with TMA: first the CTA's q, all P = dh / 64 panels of its 64 rows,
// which stay resident for the whole key walk; then, in the order the
// consumer takes them, the panels of every key block (its P k panels: the
// scores need the whole head dim; its G v panels: the CTA's own) through a
// ring of R stages of one panel each.  A panel is 64 rows of 128 bytes with
// TMA's 128-byte swizzle, which is mma::Tile<64>'s layout, so the wgmma
// descriptors name q, k and v as they land; rows past S arrive as zeros.
// Each stage has a full barrier (the copy's bytes) and an empty one (one
// arrival from each consumer warp once its products have read the stage);
// the consumer waits only for the stage it is about to read.  With R at
// least the loads of a whole walk, nothing ever waits for a free stage (the
// single kernel's form: every key resident).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "attention_mma.cuh"

namespace panel {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// The box of `map` at coordinates (c0, c1), (c0, c1, c2) or (c0, c1, c2, c3)
// (innermost first) into shared memory at dst, its bytes counted on the
// barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
                  "r"(c2)
               : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
                  "r"(c2), "r"(c3)
               : "memory");
}

constexpr int kCols = 64;                              // a panel's columns
constexpr int kKeys = 64;                              // keys a block
constexpr uint32_t kPanelBytes = mma::kTileRows * kCols * 2;   // 64 rows (or keys) x 128 B
constexpr int kThreads = 2 * mma::kThreads;            // consumer + producer
// Two CTAs an SM: 65,536 registers, 128 a thread at the launch; the
// producer keeps 40, the consumer's accumulators get 216.
constexpr int kCtasPerSm = 2;
constexpr int kProducerRegs = 40, kConsumerRegs = 216;
constexpr int kAlign = 1024;                           // of the panels; slack for the base
// Dynamic shared memory of each of two CTAs an H100 SM holds: its 233,472
// bytes less 1 KB the system keeps a CTA, halved.
constexpr size_t kTwoCtaBytes = 115712;

// Dynamic shared memory of a CTA with `panels` q panels and a ring of
// `stages`: the panels from a 1024-byte boundary, then q's barrier and a full
// and an empty barrier a stage.
__host__ __device__ constexpr size_t smem_bytes(int panels, int stages) {
  return kAlign + (size_t)(panels + stages) * kPanelBytes + 8 * (1 + 2 * (size_t)stages);
}

// The ring of a blocked walk (attention_flash, the encoder's attention) at
// `panels` q panels and G = `group` o panels: as many stages as two key
// blocks' loads (2 . (panels + group)) while two CTAs fit an SM, fewer where
// they would not; where q alone leaves no room for group + 1 stages beside
// it within two CTAs' bytes, one CTA an SM up to `optin` bytes.  At least
// group + 1 (the consumer holds a block's G v panels at once); 0 if even
// that does not fit `optin`.
__host__ __device__ inline int ring_stages(int panels, int group, size_t optin) {
  const int want = 2 * (panels + group);
  const size_t fixed = smem_bytes(panels, 0), per = kPanelBytes + 16;
  const size_t budget = fixed + (group + 1) * per <= kTwoCtaBytes ? kTwoCtaBytes : optin;
  if (fixed + (group + 1) * per > budget) return 0;
  const int fit = (int)((budget - fixed) / per);
  return fit < want ? fit : want;
}

// A CTA's view of its q panels, ring and barriers.
struct Ring {
  uint32_t q, ring, bars;
  int stages;

  // Lays the CTA's shared memory out at `base` (1024-byte aligned) and has
  // thread 0 initialise the barriers; every thread of the CTA calls it.
  __device__ __forceinline__ static Ring setup(unsigned char* base, int panels, int stages) {
    Ring r;
    r.q = mma::smem_addr(base);
    r.ring = r.q + panels * kPanelBytes;
    r.bars = r.ring + stages * kPanelBytes;
    r.stages = stages;
    if (threadIdx.x == 0) {
      mbar_init(r.bars, 1);
      for (int s = 0; s < stages; ++s) {
        mbar_init(r.full(s), 1);
        mbar_init(r.empty(s), 4);             // one arrival a consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    return r;
  }

  __device__ __forceinline__ uint32_t q_panel(int p) const { return q + p * kPanelBytes; }
  __device__ __forceinline__ uint32_t stage(int g) const {
    return ring + (g % stages) * kPanelBytes;
  }
  __device__ __forceinline__ uint32_t full(int g) const { return bars + 8 + 8 * (g % stages); }
  __device__ __forceinline__ uint32_t empty(int g) const {
    return bars + 8 + 8 * (stages + g % stages);
  }

  // Producer: q's `panels` boxes, then load g (the walk's g-th panel) into
  // its stage once the consumer has freed it.  `box` starts the copy into
  // (dst, barrier).
  template <typename Box>
  __device__ __forceinline__ void load_q(int panels, Box box) const {
    mbar_expect_tx(bars, panels * kPanelBytes);
    for (int p = 0; p < panels; ++p) box(q_panel(p), bars, p);
  }
  template <typename Box>
  __device__ __forceinline__ void load(int g, Box box) const {
    if (g >= stages) mbar_wait(empty(g), (g / stages - 1) & 1);
    mbar_expect_tx(full(g), kPanelBytes);
    box(stage(g), full(g));
  }

  // Consumer: q has landed; load g has landed (its stage's address); this
  // warp is done with load g.
  __device__ __forceinline__ void wait_q() const { mbar_wait(bars, 0); }
  __device__ __forceinline__ uint32_t take(int g) const {
    mbar_wait(full(g), (g / stages) & 1);
    return stage(g);
  }
  __device__ __forceinline__ void give(int g) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(g));
  }
};

__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime (so nothing
// more is linked); null where libcuda has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 (or `type`: float32) tensor of `rank` dims (innermost first, the
// innermost contiguous) whose outer dims lie `strides` bytes apart, as a TMA
// map with boxes of `box` elements, rows 128 bytes (128-byte swizzle) or 64
// (64-byte).
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint32_t elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box[0] * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace panel
