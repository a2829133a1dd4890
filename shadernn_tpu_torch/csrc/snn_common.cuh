// Device helpers shared by the port's kernels (conv_chain.cu,
// conv_single.cu, invres_block.cu, conv_igemm.cu, matmul_fused.cu): the
// shared-memory limit, bf16 rounding, loads and stores, the activation
// codes of the f32 epilogues, and division by a multiply (FastDiv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SNN_MAX_SMEM 232448  // 227 KB, what one block may use on Hopper

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
// int8 weights: every value is exact in bf16, and so in f32.
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

// One rounding to the output dtype.
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Codes as in kernels/chain.py ACT_CODES.
__device__ __forceinline__ float apply_act(float v, int act, float alpha) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return fminf(fmaxf(v, 0.f), 6.f);
    case 3: return v >= 0.f ? v : alpha * v;
    case 4: return tanhf(v);
    case 5: return 1.f / (1.f + expf(-v));
    case 6: return v / (1.f + expf(-v));
    case 7: return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    default: return v;
  }
}

// CH consecutive f32 weights into registers, as float4s where CH allows.
template <int CH>
__device__ __forceinline__ void load_w(const float* p, float (&w)[CH]) {
  if constexpr (CH % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CH; j += 4) {
      float4 q = *reinterpret_cast<const float4*>(p + j);
      w[j] = q.x; w[j + 1] = q.y; w[j + 2] = q.z; w[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CH; ++j) w[j] = p[j];
  }
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund-Montgomery;
// m and s made on the host): the per-tile index arithmetic has no integer
// division, whose dependent chain a tile would otherwise wait on.
struct FastDiv {
  unsigned int d, m;
  int s;
};

inline FastDiv fast_div(int d) {
  FastDiv f;
  f.d = d;
  f.m = 0;
  f.s = 0;
  if (d > 1) {
    int l = 0;
    while ((1u << l) < (unsigned)d) ++l;
    const int p = 31 + l;
    f.m = (unsigned)(((1ull << p) + d - 1) / d);
    f.s = p - 32;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.m ? (int)(__umulhi((unsigned)n, f.m) >> f.s) : n;
}

}  // namespace
