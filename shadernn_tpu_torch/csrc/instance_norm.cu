// InstanceNormalization of bfloat16 NHWC activations in two launches
// (ops/normalize.py InstanceNormalization, kernels/instnorm.py), in the
// JAX op's order: the mean and the biased variance over H and W in float32,
// (x - mean) * rsqrt(var + eps), then * gamma, then + beta in float32, one
// rounding to bfloat16, and the activation (linear, relu, relu6, leaky) on
// the bfloat16 value.
//
// It replaces no TPU kernel: the JAX op is plain jnp, which XLA fuses. On
// the card the op took ten ATen passes over float32 copies (a cast, two
// means, two subtracts, a square, the affine, the cast back, the relu).
//
// Bound: bytes. Each value is read twice and written once, 3 x 2 bytes; at
// 3.35 TB/s StyleTransfer 512 b4's 15 norms (192.9M values) take 0.35 ms.
// The design:
// 1. instance_norm_stats_kernel, one block a (sample, chunk of pixels), the
//    grid one wave of 2 blocks an SM: each thread loads 16 bytes (8
//    channels) of a pixel, a warp contiguous pixel rows, 4 loads in flight;
//    a Welford run a thread (count, mean, M2 of its 8 channels) over the
//    values less the sample's first pixel (exact in f32, so the statistics
//    keep their precision where |mean| >> std, as sum and sum of squares in
//    f32 would not), merged across the block's rows by Chan's formula in a
//    fixed tree (`rows_tree`), into an f32 scratch (n, chunks, 2, C): the
//    chunk's shifted means, then its M2s.
// 2. instance_norm_apply_kernel, the same grid: each block merges its
//    sample's chunk partials in one fixed order (row r of the block walks
//    chunks r, r + rows, ..., then the same tree), then streams its chunk,
//    16 bytes in and out a thread, 4 loads in flight.
// What the card showed (H100, profiler device time): StyleTransfer 512 b4's
// 15 norms take 0.51 ms a step against the 0.35 bound, the stats pass
// reading at ~1.9 TB/s and the apply pass moving ~2.5 TB/s at 512x512x32
// (a bf16 copy there: 2.9). Loads staged deeper (8 a thread, software-
// pipelined, a cp.async ring of 2-4 stages) and chunks interleaved by row
// gained nothing; one division a merge for all 8 channels in place of
// one each took 0.60 ms to 0.51; 2 blocks an SM beat 4, since every block
// repeats the chunk merge.
// No float atomics and a fixed merge order: two calls are bit-equal, and
// every block of a sample derives the same statistics. kernels/instnorm.py
// `plain` repeats this arithmetic op by op (each op rounded, no
// contraction), and its launch geometry is decided there and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "snn_common.cuh"

#define SNN_IN_THREADS 256  // at most, a block
#define SNN_IN_MAX_C 1024
#define SNN_IN_MIN_BLOCKS 2  // an SM's blocks, as kernels/instnorm.py BLOCKS_PER_SM
#define SNN_IN_UNROLL 4  // loads in flight a thread

namespace {

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a) for 8 channels of one
// count, each op rounded; an empty side takes the other as it is.
__device__ __forceinline__ void chan8(float& na, float (&ma)[8], float (&m2a)[8], float nb,
                                      const float (&mb)[8], const float (&m2b)[8]) {
  if (nb == 0.f) return;
  if (na == 0.f) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ma[i] = mb[i];
      m2a[i] = m2b[i];
    }
    na = nb;
    return;
  }
  const float n = __fadd_rn(na, nb);
  const float f = __fdiv_rn(nb, n);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float d = __fsub_rn(mb[i], ma[i]);
    ma[i] = __fadd_rn(ma[i], __fmul_rn(d, f));
    m2a[i] = __fadd_rn(__fadd_rn(m2a[i], m2b[i]), __fmul_rn(__fmul_rn(__fmul_rn(d, d), na), f));
  }
  na = n;
}

__device__ __forceinline__ int half_of(int cur) {  // pow2ceil(cur) / 2, cur >= 2
  int p = 1;
  while (p < cur) p <<= 1;
  return p >> 1;
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Welford's update of a thread's 8 channels by its cnt-th pixel, shifted
// by the sample's first pixel (exact: two bfloat16 values).
__device__ __forceinline__ void welford(const uint4& q, int cnt, const float (&shift)[8],
                                        float (&mean)[8], float (&m2)[8]) {
  float v[8];
  unpack(q, v);
  const float rn = __frcp_rn((float)cnt);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = __fsub_rn(v[i], shift[i]);
    const float d = __fsub_rn(v[i], mean[i]);
    mean[i] = __fadd_rn(mean[i], __fmul_rn(d, rn));
    m2[i] = __fadd_rn(m2[i], __fmul_rn(d, __fsub_rn(v[i], mean[i])));
  }
}

// The fixed tree over a block's rows (thread (g, r) holds the 8 channels
// 8g.. of row r): rows [half, cur) hand their partials to rows
// [0, cur - half), until row 0 holds the merge of all.
__device__ __forceinline__ void rows_tree(int r, int g, int g_n, int rows, float& na,
                                          float (&mean)[8], float (&m2)[8], float* s_mean,
                                          float* s_m2, float* s_cnt) {
  for (int cur = rows; cur > 1;) {
    const int half = half_of(cur);
    if (r >= half && r < cur) {
      const int slot = (r - half) * g_n + g;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s_mean[slot * 8 + i] = mean[i];
        s_m2[slot * 8 + i] = m2[i];
      }
      s_cnt[slot] = na;
    }
    __syncthreads();
    if (r < cur - half) {
      const int slot = r * g_n + g;
      float mb[8], m2b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mb[i] = s_mean[slot * 8 + i];
        m2b[i] = s_m2[slot * 8 + i];
      }
      chan8(na, mean, m2, s_cnt[slot], mb, m2b);
    }
    __syncthreads();
    cur = half;
  }
}

// grid: n * chunks blocks; block: threads = (c / 8) * rows.
__global__ void __launch_bounds__(SNN_IN_THREADS, SNN_IN_MIN_BLOCKS)
instance_norm_stats_kernel(const uint4* __restrict__ x, float* __restrict__ part, int hw, int c,
                           int chunks, int pixels) {
  __shared__ __align__(16) float s_mean[SNN_IN_THREADS * 8];
  __shared__ __align__(16) float s_m2[SNN_IN_THREADS * 8];
  __shared__ float s_cnt[SNN_IN_THREADS];
  const int g_n = c >> 3, rows = blockDim.x / g_n;
  const int tid = threadIdx.x, g = tid % g_n, r = tid / g_n;
  const int n = blockIdx.x / chunks, j = blockIdx.x - n * chunks;
  const int start = j * pixels, end = min(hw, start + pixels);
  const uint4* src = x + (size_t)n * hw * g_n + g;

  float shift[8], mean[8], m2[8];
  unpack(__ldg(src), shift);
#pragma unroll
  for (int i = 0; i < 8; ++i) mean[i] = m2[i] = 0.f;
  int cnt = 0, p = start + r;
  for (; p + (SNN_IN_UNROLL - 1) * rows < end; p += SNN_IN_UNROLL * rows) {
    uint4 q[SNN_IN_UNROLL];
#pragma unroll
    for (int u = 0; u < SNN_IN_UNROLL; ++u) q[u] = __ldg(src + (size_t)(p + u * rows) * g_n);
#pragma unroll
    for (int u = 0; u < SNN_IN_UNROLL; ++u) welford(q[u], ++cnt, shift, mean, m2);
  }
  for (; p < end; p += rows) welford(__ldg(src + (size_t)p * g_n), ++cnt, shift, mean, m2);

  float na = (float)cnt;
  rows_tree(r, g, g_n, rows, na, mean, m2, s_mean, s_m2, s_cnt);
  if (r == 0) {
    float* out = part + (size_t)blockIdx.x * 2 * c + 8 * g;
    reinterpret_cast<float4*>(out)[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(mean[4], mean[5], mean[6], mean[7]);
    reinterpret_cast<float4*>(out + c)[0] = make_float4(m2[0], m2[1], m2[2], m2[3]);
    reinterpret_cast<float4*>(out + c)[1] = make_float4(m2[4], m2[5], m2[6], m2[7]);
  }
}

__device__ __forceinline__ float act_bf16(float v, int act, float alpha) {
  // v is a bfloat16 value; NaN passes as torch's ops pass it.
  switch (act) {
    case 1: return v < 0.f ? 0.f : v;
    case 2: return v < 0.f ? 0.f : (v > 6.f ? 6.f : v);
    case 3: return v >= 0.f ? v : round_bf16(__fmul_rn(alpha, v));
    default: return v;
  }
}

// grid: n * chunks blocks; block as the stats kernel's.
// stats, where not null: (n, 2, C) f32, each channel's mean and variance.
__global__ void __launch_bounds__(SNN_IN_THREADS, SNN_IN_MIN_BLOCKS)
instance_norm_apply_kernel(const uint4* __restrict__ x, const float* __restrict__ part,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           uint4* __restrict__ y, float* __restrict__ stats, int hw, int c,
                           int chunks, int pixels, float eps, int act, float alpha) {
  __shared__ __align__(16) float s_mean[SNN_IN_THREADS * 8];
  __shared__ __align__(16) float s_m2[SNN_IN_THREADS * 8];
  __shared__ float s_cnt[SNN_IN_THREADS];
  __shared__ __align__(16) float s_a[4][SNN_IN_MAX_C];  // mean, rstd, gamma, beta
  const int tid = threadIdx.x, threads = blockDim.x;
  const int n = blockIdx.x / chunks, j = blockIdx.x - n * chunks;

  // Thread (g, r) merges chunks r, r + rows, ... of channels 8g..; then the
  // stats kernel's tree over the rows.
  const int g_n = c >> 3, rows = threads / g_n, g = tid % g_n, r = tid / g_n;
  const float* base = part + (size_t)n * chunks * 2 * c + 8 * g;
  float na = 0.f, ma[8], m2a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ma[i] = m2a[i] = 0.f;
  for (int k = r; k < chunks; k += rows) {
    const float4* pk = reinterpret_cast<const float4*>(base + (size_t)k * 2 * c);
    const float4 a0 = pk[0], a1 = pk[1], b0 = pk[c / 4], b1 = pk[c / 4 + 1];
    const float mb[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float m2b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    chan8(na, ma, m2a, (float)(min(hw, (k + 1) * pixels) - k * pixels), mb, m2b);
  }
  rows_tree(r, g, g_n, rows, na, ma, m2a, s_mean, s_m2, s_cnt);
  if (r == 0) {
    const __nv_bfloat16* first_px =
        reinterpret_cast<const __nv_bfloat16*>(x) + (size_t)n * hw * c + 8 * g;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = 8 * g + i;
      const float mean = __fadd_rn(__bfloat162float(first_px[i]), ma[i]);
      const float var = __fdiv_rn(m2a[i], na);
      s_a[0][ch] = mean;
      s_a[1][ch] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
      s_a[2][ch] = gamma ? gamma[ch] : 1.f;
      s_a[3][ch] = beta ? beta[ch] : 0.f;
      if (stats && j == 0) {
        stats[(size_t)n * 2 * c + ch] = mean;
        stats[(size_t)n * 2 * c + c + ch] = var;
      }
    }
  }
  __syncthreads();

  float mu[8], rs[8], ga[8], be[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mu[i] = s_a[0][8 * g + i];
    rs[i] = s_a[1][8 * g + i];
    ga[i] = s_a[2][8 * g + i];
    be[i] = s_a[3][8 * g + i];
  }
  const bool has_g = gamma != nullptr, has_b = beta != nullptr;
  const size_t first = ((size_t)n * hw + (size_t)j * pixels) * g_n;
  const size_t last = ((size_t)n * hw + min(hw, (j + 1) * pixels)) * g_n;
  auto norm = [&](const uint4& in) {
    float f[8];
    unpack(in, f);
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float o[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = 2 * i + k;
        float t = __fmul_rn(__fsub_rn(f[ch], mu[ch]), rs[ch]);
        if (has_g) t = __fmul_rn(t, ga[ch]);
        if (has_b) t = __fadd_rn(t, be[ch]);
        o[k] = act_bf16(round_bf16(t), act, alpha);
      }
      h[i] = __floats2bfloat162_rn(o[0], o[1]);
    }
    return q;
  };
  // SNN_IN_UNROLL loads in flight a thread, then their stores.
  size_t v = first + tid;
  for (; v + (SNN_IN_UNROLL - 1) * (size_t)threads < last; v += SNN_IN_UNROLL * threads) {
    uint4 q[SNN_IN_UNROLL];
#pragma unroll
    for (int u = 0; u < SNN_IN_UNROLL; ++u) q[u] = __ldg(x + v + u * threads);
#pragma unroll
    for (int u = 0; u < SNN_IN_UNROLL; ++u) y[v + u * threads] = norm(q[u]);
  }
  for (; v < last; v += threads) y[v] = norm(__ldg(x + v));
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_instance_norm_error), or the cudaError_t of a launch.
// x, y: device bf16 (n, hw, c), 16-byte aligned; part: device f32
// (n * chunks, 2, c); gamma, beta: device f32 (c) or null; stats: device f32
// (n, 2, c) or null; threads, chunks and pixels as kernels/instnorm.py
// `launch_geometry` decides them.
int snn_instance_norm(const void* x, void* y, float* part, const float* gamma, const float* beta,
                      float* stats, int n, int hw, int c, int threads, int chunks, int pixels,
                      float eps, int act, float alpha, void* stream) {
  if (n < 1 || hw < 1 || hw >= (1 << 24)) return -1;
  if (c < 8 || c % 8 != 0 || c > SNN_IN_MAX_C) return -2;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(part) % 16)
    return -3;
  const int g_n = c / 8;
  const int rows = threads / g_n;
  if (threads != g_n * (SNN_IN_THREADS / g_n) || pixels < rows || pixels % rows != 0 ||
      chunks != (hw + pixels - 1) / pixels || (long long)n * chunks > (1ll << 31) - 1)
    return -4;
  if (act < 0 || act > 3) return -5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  instance_norm_stats_kernel<<<n * chunks, threads, 0, s>>>(static_cast<const uint4*>(x), part,
                                                           hw, c, chunks, pixels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  instance_norm_apply_kernel<<<n * chunks, threads, 0, s>>>(
      static_cast<const uint4*>(x), part, gamma, beta, static_cast<uint4*>(y), stats, hw, c,
      chunks, pixels, eps, act, alpha);
  return (int)cudaGetLastError();
}

const char* snn_instance_norm_error(int code) {
  switch (code) {
    case -1: return "empty input, or H * W of 2^24 or more (counts are f32)";
    case -2: return "channels not a multiple of 8 in [8, 1024]";
    case -3: return "x, y or the scratch not 16-byte aligned";
    case -4: return "launch geometry outside the kernel (threads, chunks or pixels)";
    case -5: return "activation outside linear, relu, relu6, leaky_relu";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
