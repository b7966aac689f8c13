// Native host runtime of the tracker's PyTorch/CUDA port.
//
// The reference's runtime plumbing is native Rust: a GStreamer pipeline with
// a bounded leaky queue (pipeline_ir.rs:75-78), a rayon-parallel NV12->RGB
// converter (nv12_convert.rs:46-92), and per-frame timing
// (timing_stats.rs).  This file provides the native equivalents, exposed
// over a C ABI for ctypes:
//
//  * FrameRing  — ring of fixed-size frame slots with drop-oldest ("leaky
//                 downstream") semantics: the producer never blocks; old
//                 frames are overwritten when the consumer lags.
//  * nv12_to_rgb_mt — BT.601 integer conversion, bit-exact with the
//                 reference LUT math, parallelised over row pairs with
//                 std::thread (the rayon par_chunks_mut analog) — the CPU
//                 golden baseline and host-side converter.
//  * yuy2_to_rgb_mt — same math for the YUY2 camera format.
//  * synth_nv12 — procedural NV12 frame generator (moving patterned
//                 square) for host-side benchmarking without Python
//                 overhead.
//
// Build: runtime/__init__.py compiles it with g++ at first use into
// build/torch_runtime/; by hand: make -C this directory OUT=<library>.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// BT.601 limited-range YUV -> RGB, 8.8 fixed point, computed as a direct
// integer affine per sample (the standard coefficients 298/409/100/208/516
// with the +128 rounding term and >>8; identical arithmetic to
// ops/colorspace.py, which the golden tests pin bit-for-bit).  At ~5 ops
// per channel a LUT buys nothing on modern cores and the multiplies
// auto-vectorise.
struct Rgb24 {
  uint8_t r, g, b;
};

inline uint8_t sat_u8(int v) {
  if (v & ~0xFF) return v < 0 ? 0 : 255;  // branch only off-range
  return static_cast<uint8_t>(v);
}

inline Rgb24 bt601_px(int y, int cb, int cr) {
  const int luma = 298 * (y - 16) + 128;
  const int u = cb - 128, v = cr - 128;
  return Rgb24{sat_u8((luma + 409 * v) >> 8),
               sat_u8((luma - 100 * u - 208 * v) >> 8),
               sat_u8((luma + 516 * u) >> 8)};
}

inline void store_px(uint8_t* dst, Rgb24 px) {
  dst[0] = px.r;
  dst[1] = px.g;
  dst[2] = px.b;
}

// NV12 conversion organised around the chroma plane: each iteration owns
// one UV row and decodes BOTH luma rows that share it (a 2x2 quad per
// chroma sample), so chroma loads happen exactly once.  Workers partition
// the chroma rows [uv_begin, uv_end).
void convert_uv_rows_nv12(const uint8_t* y_plane, const uint8_t* uv_plane,
                          uint8_t* out, int width, int height, int uv_begin,
                          int uv_end) {
  for (int ur = uv_begin; ur < uv_end; ++ur) {
    const uint8_t* uvrow = uv_plane + static_cast<size_t>(ur) * width;
    const int r0 = ur * 2;
    const int rows = (r0 + 1 < height) ? 2 : 1;  // odd-height tail
    for (int sub = 0; sub < rows; ++sub) {
      const uint8_t* yrow = y_plane + static_cast<size_t>(r0 + sub) * width;
      uint8_t* orow = out + static_cast<size_t>(r0 + sub) * width * 3;
      for (int col = 0; col < width; ++col) {
        const int cb = uvrow[(col & ~1)];
        const int cr = uvrow[(col & ~1) + 1];
        store_px(orow + col * 3, bt601_px(yrow[col], cb, cr));
      }
    }
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Multithreaded converters
// ---------------------------------------------------------------------------

void nv12_to_rgb_mt(const uint8_t* nv12, int width, int height,
                    uint8_t* out_rgb, int num_threads) {
  const uint8_t* y_plane = nv12;
  const uint8_t* uv_plane = nv12 + static_cast<size_t>(width) * height;
  const int uv_rows = (height + 1) / 2;
  if (num_threads <= 1) {
    convert_uv_rows_nv12(y_plane, uv_plane, out_rgb, width, height, 0,
                         uv_rows);
    return;
  }
  std::vector<std::thread> threads;
  const int per = (uv_rows + num_threads - 1) / num_threads;
  for (int tid = 0; tid < num_threads; ++tid) {
    const int u0 = tid * per;
    const int u1 = std::min(uv_rows, u0 + per);
    if (u0 >= u1) break;
    threads.emplace_back(convert_uv_rows_nv12, y_plane, uv_plane, out_rgb,
                         width, height, u0, u1);
  }
  for (auto& th : threads) th.join();
}

void yuy2_to_rgb_mt(const uint8_t* yuy2, int width, int height,
                    uint8_t* out_rgb, int num_threads) {
  auto work = [=](int r0, int r1) {
    for (int row = r0; row < r1; ++row) {
      const uint8_t* in = yuy2 + static_cast<size_t>(row) * width * 2;
      uint8_t* orow = out_rgb + static_cast<size_t>(row) * width * 3;
      // One Y0-U-Y1-V quad decodes two pixels sharing the chroma pair.
      for (int col = 0; col < width; col += 2) {
        const uint8_t* q = in + col * 2;
        store_px(orow + col * 3, bt601_px(q[0], q[1], q[3]));
        store_px(orow + col * 3 + 3, bt601_px(q[2], q[1], q[3]));
      }
    }
  };
  if (num_threads <= 1) {
    work(0, height);
    return;
  }
  std::vector<std::thread> threads;
  int per = (height + num_threads - 1) / num_threads;
  for (int tid = 0; tid < num_threads; ++tid) {
    int r0 = tid * per, r1 = std::min(height, (tid + 1) * per);
    if (r0 >= r1) break;
    threads.emplace_back(work, r0, r1);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// FrameRing: bounded drop-oldest frame queue
// ---------------------------------------------------------------------------

struct FrameRing {
  std::vector<uint8_t> storage;
  std::vector<uint64_t> seq;       // sequence number per slot (0 = empty)
  size_t slot_size;
  int capacity;
  std::mutex mu;                   // slots are large; contention is tiny
  uint64_t next_seq = 1;
  uint64_t pushed = 0, dropped = 0, popped = 0;
  int head = 0;                    // oldest occupied slot
  int count = 0;
};

FrameRing* ring_create(int capacity, uint64_t slot_size) {
  auto* r = new FrameRing();
  r->capacity = capacity;
  r->slot_size = slot_size;
  r->storage.resize(static_cast<size_t>(capacity) * slot_size);
  r->seq.assign(capacity, 0);
  return r;
}

void ring_destroy(FrameRing* r) { delete r; }

// Push: copies `data` (slot_size bytes) in; drops the oldest when full.
// Returns 1 if an old frame was dropped, 0 otherwise.
int ring_push(FrameRing* r, const uint8_t* data) {
  std::lock_guard<std::mutex> lock(r->mu);
  int dropped = 0;
  int slot;
  if (r->count == r->capacity) {
    slot = r->head;                       // overwrite oldest (leaky)
    r->head = (r->head + 1) % r->capacity;
    r->dropped++;
    dropped = 1;
  } else {
    slot = (r->head + r->count) % r->capacity;
    r->count++;
  }
  std::memcpy(&r->storage[static_cast<size_t>(slot) * r->slot_size], data,
              r->slot_size);
  r->seq[slot] = r->next_seq++;
  r->pushed++;
  return dropped;
}

// Pop oldest into `out`; returns the frame's sequence number, 0 if empty.
uint64_t ring_pop(FrameRing* r, uint8_t* out) {
  std::lock_guard<std::mutex> lock(r->mu);
  if (r->count == 0) return 0;
  int slot = r->head;
  std::memcpy(out, &r->storage[static_cast<size_t>(slot) * r->slot_size],
              r->slot_size);
  uint64_t s = r->seq[slot];
  r->seq[slot] = 0;
  r->head = (r->head + 1) % r->capacity;
  r->count--;
  r->popped++;
  return s;
}

int ring_len(FrameRing* r) {
  std::lock_guard<std::mutex> lock(r->mu);
  return r->count;
}

uint64_t ring_stat_pushed(FrameRing* r) { return r->pushed; }
uint64_t ring_stat_dropped(FrameRing* r) { return r->dropped; }
uint64_t ring_stat_popped(FrameRing* r) { return r->popped; }

// ---------------------------------------------------------------------------
// Synthetic NV12 frame generator (bench feed)
// ---------------------------------------------------------------------------

// Writes one NV12 frame (Y then interleaved UV) of a patterned square at
// (obj_x, obj_y) over a gradient background.
void synth_nv12(uint8_t* out, int width, int height, int obj_x, int obj_y,
                int obj_size) {
  uint8_t* y_plane = out;
  uint8_t* uv_plane = out + static_cast<size_t>(width) * height;
  for (int r = 0; r < height; ++r) {
    uint8_t* yrow = y_plane + static_cast<size_t>(r) * width;
    for (int c = 0; c < width; ++c) {
      int inside = (c >= obj_x && c < obj_x + obj_size && r >= obj_y &&
                    r < obj_y + obj_size);
      if (inside) {
        int lx = c - obj_x, ly = r - obj_y;
        yrow[c] = static_cast<uint8_t>(60 + ((lx * 7 + ly * 13) % 160));
      } else {
        yrow[c] = static_cast<uint8_t>(40 + ((r >> 3) + (c >> 4)) % 60);
      }
    }
  }
  int uv_h = height / 2;
  for (int r = 0; r < uv_h; ++r) {
    uint8_t* uvrow = uv_plane + static_cast<size_t>(r) * width;
    for (int c = 0; c < width / 2; ++c) {
      int fy = r * 2, fx = c * 2;
      int inside = (fx >= obj_x && fx < obj_x + obj_size && fy >= obj_y &&
                    fy < obj_y + obj_size);
      uvrow[c * 2 + 0] = inside ? 90 : 128;
      uvrow[c * 2 + 1] = inside ? 170 : 128;
    }
  }
}

}  // extern "C"
