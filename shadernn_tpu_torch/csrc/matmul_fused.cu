// Fused matmul with a per-column epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package
//   shadernn_tpu/kernels/matmul_pallas.py : _matmul_kernel
//       (entry point fused_matmul, reached through shadernn_tpu/ops/dense.py
//        when the backend is forced to the kernel)
//
// Function: y = act((x @ W) * scale + offset), x (M,K) f32 or bf16, W (K,N)
// in x's dtype or int8 (upcast on load; every int8 value is exact in bf16,
// the dequantisation scale arrives folded into `scale`), the sum and the
// epilogue in f32, one rounding to x's dtype on store. bf16 x bf16 products
// are exact in f32; f32 runs as true f32 FMAs (nothing rounds to TF32).
// M, K and N need not be multiples of anything: the ragged tiles are
// masked here, and x and W are never padded on the host.
//
// softmax is taken over the N true columns of a row. (The TPU kernel
// applies the activation per padded 128-column tile, which is wrong for
// softmax; this kernel does not copy that.)
//
// What bounds it on an H100: the classifier heads this serves (8x512x10,
// 64x128x10, 8x1280x1000) move a few KB to 2.6 MB and do at most 20 MFLOP:
// every one is bound by launch latency, then by reading W once. This first
// version issues f32 FMAs on the CUDA cores.
//
// Design, elementwise activations: one CTA of 256 threads per (32 rows, 64
// columns) tile; K walked in chunks of 32 staged in shared memory as f32 (x
// transposed so that a thread's rows are a broadcast read); a thread owns
// 2 x 4 outputs in registers. With M = 8 most of a CTA idles, which is a
// matter of speed for later.
// Design, softmax: a batch of 8 rows gives the tile form one CTA with 16
// barriers' worth of load latency in a row, so this mode spreads K over
// the threads instead. One CTA per (row, block of CT <= 32 columns); its
// 256 threads are CT column threads times 256/CT K groups: a thread sums
// its K group's share of one column, reading W rows coalesced over the
// columns and x as a broadcast, all loads independent; the K groups'
// partial sums are added in group order (deterministic). Where one block
// holds the row (N <= 32: the 10-class heads) the CTA takes the softmax
// itself and the logits never leave the chip. A longer row's logits go to
// an f32 scratch and a second kernel, one CTA per row, reduces max and sum
// and writes: a row's softmax needs every column block, and blocks of one
// grid cannot wait for each other.

#include "snn_common.cuh"

#define SNN_MM_BK 32
#define SNN_MM_ROW_COLS 32  // as kernels/matmul.py SOFTMAX_FUSED_N

namespace {

struct MatmulDesc {
  int m, k, n;
  int act;
  float alpha;
};

// TY x (256 / TY) threads; BM = TY * TM rows, BN = (256 / TY) * TN columns.
template <int TY, int TM, int TN, typename TX, typename TW>
__global__ void __launch_bounds__(256)
matmul_fused_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ offset,
                    TX* __restrict__ y, const __grid_constant__ MatmulDesc d) {
  constexpr int TXN = 256 / TY;
  constexpr int BM = TY * TM, BN = TXN * TN;
  __shared__ float xs[SNN_MM_BK][BM + 1];
  __shared__ float ws[SNN_MM_BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TXN, ty = tid / TXN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d.k; k0 += SNN_MM_BK) {
    __syncthreads();  // the previous chunk is done with the tiles
    for (int i = tid; i < BM * SNN_MM_BK; i += 256) {
      const int r = i / SNN_MM_BK, kk = i % SNN_MM_BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < d.m && gk < d.k) ? to_float(x[(size_t)gm * d.k + gk]) : 0.f;
    }
    for (int i = tid; i < SNN_MM_BK * BN; i += 256) {
      const int kk = i / BN, j = i % BN;
      const int gk = k0 + kk, gn = n0 + j;
      ws[kk][j] = (gk < d.k && gn < d.n) ? to_float(w[(size_t)gk * d.n + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SNN_MM_BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= d.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < d.n)
        store_out(y + (size_t)gm * d.n + gn,
                  apply_act(fmaf(acc[i][j], scale[gn], offset[gn]), d.act, d.alpha));
    }
  }
}

// Max or sum of one value per thread over the 256 threads of the CTA;
// `red` holds 8 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, s);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // `red` is free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) v = MAX ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

// Logits (x @ W) * scale + offset of row blockIdx.x, columns
// [blockIdx.y * ct, +ct); ct column threads (a power of two, at most 32)
// times 256 / ct K groups. With one column block the CTA writes the row's
// softmax to y; with more it writes the f32 logits to `logits_out`.
template <typename TX, typename TW>
__global__ void __launch_bounds__(256)
matmul_row_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ offset,
                  TX* __restrict__ y, float* __restrict__ logits_out,
                  const __grid_constant__ MatmulDesc d, int ct) {
  __shared__ float part[256];  // [K group][column thread]
  const int tid = threadIdx.x;
  const int cin = tid & (ct - 1), kg = tid / ct, kgs = 256 / ct;
  const int row = blockIdx.x, c = blockIdx.y * ct + cin;
  const TX* __restrict__ xr = x + (size_t)row * d.k;
  float acc = 0.f;
  if (c < d.n) {
    const TW* __restrict__ wc = w + c;
#pragma unroll 8
    for (int k = kg; k < d.k; k += kgs)
      acc = fmaf(to_float(xr[k]), to_float(wc[(size_t)k * d.n]), acc);
  }
  part[tid] = acc;
  __syncthreads();
  if (tid >= 32) return;
  // The first warp holds the column threads (ct <= 32).
  float v = -INFINITY;
  if (tid < ct && c < d.n) {
    float s = part[cin];
    for (int g = 1; g < kgs; ++g) s += part[g * ct + cin];
    v = fmaf(s, scale[c], offset[c]);
    if (gridDim.y > 1) logits_out[(size_t)row * d.n + c] = v;
  }
  if (gridDim.y > 1) return;
  float mx = v;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
  const float e = (tid < ct && c < d.n) ? expf(v - mx) : 0.f;
  float sum = e;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (tid < ct && c < d.n) store_out(y + (size_t)row * d.n + c, e / sum);
}

// Row softmax of f32 logits (m, n) into y; one CTA per row.
template <typename TX>
__global__ void __launch_bounds__(256)
softmax_rows_kernel(const float* __restrict__ logits, TX* __restrict__ y, int n) {
  __shared__ float red[8];
  const float* __restrict__ row = logits + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  float mx = -INFINITY;
  for (int j = tid; j < n; j += 256) mx = fmaxf(mx, row[j]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int j = tid; j < n; j += 256) sum += expf(row[j] - mx);
  sum = block_reduce<false>(sum, red);
  TX* yr = y + (size_t)blockIdx.x * n;
  for (int j = tid; j < n; j += 256) store_out(yr + j, expf(row[j] - mx) / sum);
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, const float* scale, const float* offset,
           void* y, float* scratch, const MatmulDesc& d, bool softmax, cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (!softmax) {
    matmul_fused_kernel<16, 2, 4, TX, TW>
        <<<dim3((d.n + 63) / 64, (d.m + 31) / 32), 256, 0, s>>>(xp, wp, scale, offset, yp, d);
    return (int)cudaGetLastError();
  }
  int ct = 1;
  while (ct < d.n && ct < SNN_MM_ROW_COLS) ct *= 2;
  const int blocks = (d.n + ct - 1) / ct;
  if (blocks > 1 && scratch == nullptr) return -2;
  matmul_row_kernel<TX, TW><<<dim3(d.m, blocks), 256, 0, s>>>(
      xp, wp, scale, offset, yp, scratch, d, ct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return (int)err;
  softmax_rows_kernel<TX><<<d.m, 256, 0, s>>>(scratch, yp, d.n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_matmul_error), or the cudaError_t of the launch.
// x, y: device (m,k) and (m,n) in f32 or bf16 (x_bf16); w: device (k,n) in
// x's dtype, or int8 when w_int8; scale, offset: device f32 (n); scratch:
// device f32 (m,n), read and written only for a softmax over n > 32.
int snn_matmul_fused(const void* x, int x_bf16, const void* w, int w_int8,
                     const float* scale, const float* offset, void* y,
                     void* scratch, int m, int k, int n, int act, float alpha,
                     int softmax, void* stream) {
  if (m < 1 || k < 1 || n < 1) return -1;
  if (softmax ? (n + SNN_MM_ROW_COLS - 1) / SNN_MM_ROW_COLS > 65535 : (m + 31) / 32 > 65535)
    return -3;
  MatmulDesc d;
  d.m = m; d.k = k; d.n = n; d.act = act; d.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
  if (x_bf16) {
    return w_int8 ? launch<__nv_bfloat16, int8_t>(x, w, scale, offset, y, sp, d, softmax, s)
                  : launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, offset, y, sp, d, softmax, s);
  }
  return w_int8 ? launch<float, int8_t>(x, w, scale, offset, y, sp, d, softmax, s)
                : launch<float, float>(x, w, scale, offset, y, sp, d, softmax, s);
}

const char* snn_matmul_error(int code) {
  switch (code) {
    case -1: return "empty x or w";
    case -2: return "a softmax over more than 32 columns needs the logits scratch";
    case -3: return "more row or column blocks than a grid holds";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
