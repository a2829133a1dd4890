// shadernn_tpu_torch native host runtime.
//
// The pieces that surround the device's compute path, in C++ as the
// reference's host runtime has them (core/src/ic2/modelparser.cpp,
// conv2d.cpp oihw2hwo4i4, libyuv, demo queues.h):
//
//   - weight-stream loading and OIHW->HWIO repack (the artifact parser)
//   - per-output-channel symmetric int8 quantization
//   - NV12/NV21 -> RGB conversion (BT.601, libyuv-equivalent)
//   - a lock-free SPSC frame ring (the moodycamel readerwriterqueue
//     analog)
//   - raw float32 dump writing (the --dump_outputs path)
//
// Exposed as a plain C ABI consumed via ctypes (shadernn_tpu_torch/native.py),
// which builds this file at first use with the host's C++ compiler
// (c++ -O3 -std=c++17 -shared -fPIC) into build/native/.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Weight repack: OIHW float32 stream (the artifact's bin layout,
// modelparser.cpp:512+) -> HWIO. Returns 0 on success.
int snn_repack_oihw_to_hwio(const float* src, float* dst, int o, int i, int kh,
                            int kw) {
  if (!src || !dst || o <= 0 || i <= 0 || kh <= 0 || kw <= 0) return -1;
  // src[(oo*i + ii)*kh*kw + y*kw + x] -> dst[((y*kw + x)*i + ii)*o + oo]
  for (int oo = 0; oo < o; ++oo) {
    for (int ii = 0; ii < i; ++ii) {
      const float* s = src + (static_cast<int64_t>(oo) * i + ii) * kh * kw;
      for (int y = 0; y < kh; ++y) {
        for (int x = 0; x < kw; ++x) {
          dst[((static_cast<int64_t>(y) * kw + x) * i + ii) * o + oo] =
              s[y * kw + x];
        }
      }
    }
  }
  return 0;
}

// Depthwise stream: per-output-channel kxk (o, kh, kw) -> HW1O layout
// (kh, kw, 1, o).
int snn_repack_dw_to_hw1o(const float* src, float* dst, int o, int kh,
                          int kw) {
  if (!src || !dst || o <= 0 || kh <= 0 || kw <= 0) return -1;
  for (int oo = 0; oo < o; ++oo) {
    for (int y = 0; y < kh; ++y) {
      for (int x = 0; x < kw; ++x) {
        dst[(static_cast<int64_t>(y) * kw + x) * o + oo] =
            src[(static_cast<int64_t>(oo) * kh + y) * kw + x];
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Symmetric per-output-channel int8 quantization over the trailing axis.
// w: (rows, channels) row-major; q: same shape int8; scale: (channels,).
int snn_quantize_int8(const float* w, int64_t rows, int64_t channels,
                      int8_t* q, float* scale) {
  if (!w || !q || !scale || rows <= 0 || channels <= 0) return -1;
  std::vector<float> amax(channels, 0.0f);
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = w + r * channels;
    for (int64_t c = 0; c < channels; ++c) {
      float a = std::fabs(row[c]);
      if (a > amax[c]) amax[c] = a;
    }
  }
  for (int64_t c = 0; c < channels; ++c) {
    scale[c] = amax[c] > 0.0f ? amax[c] / 127.0f : 1.0f;
  }
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = w + r * channels;
    int8_t* qr = q + r * channels;
    for (int64_t c = 0; c < channels; ++c) {
      float v = std::nearbyint(row[c] / scale[c]);
      if (v > 127.0f) v = 127.0f;
      if (v < -127.0f) v = -127.0f;
      qr[c] = static_cast<int8_t>(v);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// NV12/NV21 -> interleaved RGB888 (BT.601 limited range; libyuv-equivalent
// coefficients; shadernn_tpu_torch/image/color.py computes the same
// conversion as one matrix product, within one unit of this one).
int snn_nv12_to_rgb(const uint8_t* y_plane, const uint8_t* uv_plane,
                    int height, int width, int nv21, uint8_t* rgb) {
  if (!y_plane || !uv_plane || !rgb || height <= 0 || width <= 0) return -1;
  for (int r = 0; r < height; ++r) {
    const uint8_t* yrow = y_plane + static_cast<int64_t>(r) * width;
    const uint8_t* uvrow =
        uv_plane + static_cast<int64_t>(r / 2) * (width / 2) * 2;
    uint8_t* out = rgb + static_cast<int64_t>(r) * width * 3;
    for (int c = 0; c < width; ++c) {
      float yv = 1.164f * (static_cast<float>(yrow[c]) - 16.0f);
      int uvi = (c / 2) * 2;
      float u = static_cast<float>(uvrow[nv21 ? uvi + 1 : uvi]) - 128.0f;
      float v = static_cast<float>(uvrow[nv21 ? uvi : uvi + 1]) - 128.0f;
      float rr = yv + 1.596f * v;
      float gg = yv - 0.392f * u - 0.813f * v;
      float bb = yv + 2.017f * u;
      auto clamp = [](float x) -> uint8_t {
        if (x < 0.0f) return 0;
        if (x > 255.0f) return 255;
        return static_cast<uint8_t>(x + 0.5f);
      };
      out[c * 3 + 0] = clamp(rr);
      out[c * 3 + 1] = clamp(gg);
      out[c * 3 + 2] = clamp(bb);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Lock-free SPSC frame ring (fixed-size slots). One producer thread (frame
// source) and one consumer thread (dispatcher) — the moodycamel
// readerwriterqueue pattern from the reference's Android pipeline
// (demo/android/.../queues.h:26-100).
struct SnnFrameRing {
  int64_t capacity;     // number of slots (power of two)
  int64_t slot_bytes;   // bytes per slot
  std::atomic<int64_t> head;  // next write
  std::atomic<int64_t> tail;  // next read
  uint8_t* data;
  int64_t* sizes;       // payload size per slot
};

void* snn_ring_create(int64_t capacity, int64_t slot_bytes) {
  if (capacity <= 0 || slot_bytes <= 0) return nullptr;
  // round capacity up to a power of two for cheap masking
  int64_t cap = 1;
  while (cap < capacity) cap <<= 1;
  auto* ring = new SnnFrameRing();
  ring->capacity = cap;
  ring->slot_bytes = slot_bytes;
  ring->head.store(0);
  ring->tail.store(0);
  ring->data = new uint8_t[static_cast<size_t>(cap * slot_bytes)];
  ring->sizes = new int64_t[static_cast<size_t>(cap)];
  return ring;
}

void snn_ring_destroy(void* handle) {
  auto* ring = static_cast<SnnFrameRing*>(handle);
  if (!ring) return;
  delete[] ring->data;
  delete[] ring->sizes;
  delete ring;
}

// Returns 1 on success, 0 if the ring is full.
int snn_ring_push(void* handle, const uint8_t* payload, int64_t size) {
  auto* ring = static_cast<SnnFrameRing*>(handle);
  if (!ring || size > ring->slot_bytes) return 0;
  int64_t head = ring->head.load(std::memory_order_relaxed);
  int64_t tail = ring->tail.load(std::memory_order_acquire);
  if (head - tail >= ring->capacity) return 0;  // full
  int64_t slot = head & (ring->capacity - 1);
  std::memcpy(ring->data + slot * ring->slot_bytes, payload,
              static_cast<size_t>(size));
  ring->sizes[slot] = size;
  ring->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Returns payload size (>0) on success, 0 if empty.
int64_t snn_ring_pop(void* handle, uint8_t* out) {
  auto* ring = static_cast<SnnFrameRing*>(handle);
  if (!ring) return 0;
  int64_t tail = ring->tail.load(std::memory_order_relaxed);
  int64_t head = ring->head.load(std::memory_order_acquire);
  if (tail >= head) return 0;  // empty
  int64_t slot = tail & (ring->capacity - 1);
  int64_t size = ring->sizes[slot];
  std::memcpy(out, ring->data + slot * ring->slot_bytes,
              static_cast<size_t>(size));
  ring->tail.store(tail + 1, std::memory_order_release);
  return size;
}

int64_t snn_ring_size(void* handle) {
  auto* ring = static_cast<SnnFrameRing*>(handle);
  if (!ring) return 0;
  return ring->head.load(std::memory_order_acquire) -
         ring->tail.load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// Raw float32 dump writer (the --dump_outputs binary format).
int snn_write_dump(const char* path, const float* data, int64_t count) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t written = std::fwrite(data, sizeof(float), static_cast<size_t>(count), f);
  std::fclose(f);
  return written == static_cast<size_t>(count) ? 0 : -1;
}

int snn_version() { return 1; }

}  // extern "C"
