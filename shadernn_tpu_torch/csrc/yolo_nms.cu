// Class-aware greedy NMS of the YOLO head in one launch (ops/yolo.py
// `nms_fixed`, whose suppression loop issues two launches a row): one block
// a sample.
//
// In: the sample's candidates (boxes (M, 4) [x, y, w, h], classes (M) int64)
// and its K best, score-sorted (scores (K) f32, indices (K) int64 into M).
// Out: (K, 6) rows [class, score, x, y, w, h], a suppressed row's score 0.
//
// 1. Each row's box, class and score into shared memory.
// 2. The suppression mask: bit j of row i is set where j > i, the classes
//    are equal and IoU(i, j) > the threshold, a warp ballot per 32 j's. The
//    IoU is nms_fixed's float32 formula, op by op and each op rounded as
//    torch rounds it (no contraction into FMAs): x1 = x + w, area = w * h,
//    iw = clamp_min(min(x1i, x1j) - max(xi, xj), 0), inter = iw * ih,
//    iou = inter / (((area_i + area_j) - inter) + 1e-9f); a NaN anywhere
//    makes the test false, as torch.minimum and clamp_min propagate it.
// 3. The greedy sweep in one warp: lane w holds bits 32w..32w+31 of the
//    kept set (at first: score > 0); row by row, a kept row clears its
//    mask from the set. So K <= 32 * 32.
// 4. The rows out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "snn_common.cuh"

// 16 warps build the mask: 19.0 us a b8 step of 100 rows, against 28.1 at 256 threads and 44.4
// at 128 (H100, profiler device time).
#define SNN_NMS_THREADS 512
#define SNN_NMS_MAX_ROWS 1024

namespace {

__device__ __forceinline__ float nan_or(float a, float b, float v) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : v;
}

// torch.minimum, torch.maximum and clamp_min(v, 0): NaN in, NaN out.
__device__ __forceinline__ float tmin(float a, float b) { return nan_or(a, b, fminf(a, b)); }
__device__ __forceinline__ float tmax(float a, float b) { return nan_or(a, b, fmaxf(a, b)); }
__device__ __forceinline__ float clamp0(float v) { return v != v ? v : fmaxf(v, 0.f); }

__global__ void __launch_bounds__(SNN_NMS_THREADS)
yolo_nms_kernel(const float* __restrict__ boxes, const int64_t* __restrict__ classes,
                const float* __restrict__ scores, const int64_t* __restrict__ idx,
                float* __restrict__ out, int m, int k, float iou_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  float* x0 = reinterpret_cast<float*>(smem);
  float* y0 = x0 + k;
  float* x1 = y0 + k;
  float* y1 = x1 + k;
  float* area = y1 + k;
  float* sc = area + k;
  long long* cls = reinterpret_cast<long long*>(sc + k);  // 24k bytes in: 8-byte aligned
  unsigned* mask = reinterpret_cast<unsigned*>(cls + k);  // [k][words]
  unsigned* kept = mask + (size_t)k * words;  // [words]

  const int n = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* bx = boxes + (size_t)n * m * 4;
  for (int r = tid; r < k; r += SNN_NMS_THREADS) {
    const int64_t src = idx[(size_t)n * k + r];
    const float4 b = *reinterpret_cast<const float4*>(bx + src * 4);
    x0[r] = b.x;
    y0[r] = b.y;
    x1[r] = __fadd_rn(b.x, b.z);
    y1[r] = __fadd_rn(b.y, b.w);
    area[r] = __fmul_rn(b.z, b.w);
    sc[r] = scores[(size_t)n * k + r];
    cls[r] = classes[(size_t)n * m + src];
  }
  __syncthreads();

  for (int t = warp; t < k * words; t += SNN_NMS_THREADS / 32) {
    const int i = t / words, j = (t - i * words) * 32 + lane;
    bool sup = false;
    if (j > i && j < k && cls[j] == cls[i]) {
      const float iw = clamp0(__fsub_rn(tmin(x1[i], x1[j]), tmax(x0[i], x0[j])));
      const float ih = clamp0(__fsub_rn(tmin(y1[i], y1[j]), tmax(y0[i], y0[j])));
      const float inter = __fmul_rn(iw, ih);
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(area[i], area[j]), inter), 1e-9f);
      sup = __fdiv_rn(inter, den) > iou_threshold;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, sup);
    if (lane == 0) mask[(size_t)i * words + (t - i * words)] = bits;
  }
  __syncthreads();

  if (warp == 0) {
    unsigned mine = 0;
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, j < k && sc[j] > 0.f);
      if (lane == w) mine = bits;
    }
    for (int i = 0; i < k; ++i) {
      const unsigned word = __shfl_sync(0xffffffffu, mine, i >> 5);
      if ((word >> (i & 31)) & 1u) {
        if (lane < words) mine &= ~mask[(size_t)i * words + lane];
      }
    }
    if (lane < words) kept[lane] = mine;
  }
  __syncthreads();

  for (int r = tid; r < k; r += SNN_NMS_THREADS) {
    const int64_t src = idx[(size_t)n * k + r];
    const float4 b = *reinterpret_cast<const float4*>(bx + src * 4);
    float* o = out + ((size_t)n * k + r) * 6;
    o[0] = (float)cls[r];
    o[1] = ((kept[r >> 5] >> (r & 31)) & 1u) ? sc[r] : 0.f;
    o[2] = b.x;
    o[3] = b.y;
    o[4] = b.z;
    o[5] = b.w;
  }
}

}  // namespace

extern "C" {

// Shared memory of one block: six floats and a class a row, the mask, the
// kept set.
int snn_yolo_nms_smem(int k) {
  const int words = (k + 31) / 32;
  return 4 * 6 * k + 8 * k + 4 * (k * words + words);
}

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_yolo_nms_error), or the cudaError_t of the launch.
// boxes: device f32 (n, m, 4), 16-byte aligned; classes: device int64 (n, m);
// scores: device f32 (n, k), sorted descending; idx: device int64 (n, k),
// each in [0, m); out: device f32 (n, k, 6).
int snn_yolo_nms(const float* boxes, const void* classes, const float* scores, const void* idx,
                 float* out, int n, int m, int k, float iou_threshold, void* stream) {
  if (n < 1 || k < 1 || m < k) return -1;
  if (k > SNN_NMS_MAX_ROWS) return -2;
  if (reinterpret_cast<uintptr_t>(boxes) % 16) return -3;
  const int smem = snn_yolo_nms_smem(k);
  if (smem > SNN_MAX_SMEM) return -2;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(yolo_nms_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  yolo_nms_kernel<<<n, SNN_NMS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, static_cast<const int64_t*>(classes), scores, static_cast<const int64_t*>(idx), out,
      m, k, iou_threshold);
  return (int)cudaGetLastError();
}

const char* snn_yolo_nms_error(int code) {
  switch (code) {
    case -1: return "empty batch or rows, or fewer candidates than rows";
    case -2: return "more rows than the kernel's greedy sweep holds (1024)";
    case -3: return "boxes not 16-byte aligned";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
