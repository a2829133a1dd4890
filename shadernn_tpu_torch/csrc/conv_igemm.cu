// Per-layer convolution as an implicit GEMM with a fused epilogue, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package
//   shadernn_tpu/kernels/conv_pallas.py : _conv_kernel
//       (entry points fused_conv2d_nhcw and conv2d_pallas_nhwc, reached
//        through shadernn_tpu/ops/conv.py Conv2D.run when the backend is
//        forced to the kernel and no chain takes the conv)
// which builds a (k*k*C, W) patch per output row in an NHCW layout and
// multiplies it with the (K, O) weight matrix. The NHCW transposes, the
// channel padding to the sublane tile and the 128-lane width padding are
// TPU layout and are not carried over: this kernel takes NHWC in and gives
// NHWC out.
//
// Function: x NHWC (N,H,W,C) f32 or bf16; w HWIO (kh,kw,C,O), read as the
// (K, O) matrix with K = kh*kw*C in (dy, dx, c) order, in x's dtype or
// int8 (upcast on load, exact; the dequantisation scale arrives folded
// into `scale`); an f32 sum over K; y = act(acc * scale[o] + offset[o]) in
// f32, one rounding to x's dtype on store. Zero pads (pt, pb, pl, pr) may
// be asymmetric; a tap outside the image contributes an exact zero.
// Stride s >= 1 is index arithmetic: output (oy, ox) reads input
// (oy*s - pt + dy, ox*s - pl + dx).
//
// What bounds it on an H100: a k3 conv over 64-128 channels does 500-1000
// FLOPs per byte of input and output, above the ridge of the tensor cores
// (295 FLOP/byte) and far above the CUDA cores' (20): operations bound it.
// This first version issues them as f32 FMAs on the CUDA cores; the GEMM
// form (pixels x channels tiles over K chunks in shared memory) is the one
// a tensor-core version builds on.
//
// Design: the output is the (M, O) matrix with M = N*Ho*Wo pixels. One CTA
// of 256 threads owns 64 consecutive pixels and BN = 16*TN output channels
// (all O channels for O <= 128, fewer where the grid would not fill the
// card) and walks K in chunks of 32: the chunk of
// the patch matrix is gathered from x into shared memory (a thread keeps
// one K column, so its tap (dy, dx, c) is decoded once per chunk; a warp
// reads 32 consecutive K entries, which are contiguous channels of NHWC),
// the chunk of W is staged beside it. A thread owns 4 pixels x TN channels
// in registers. Shared memory does not grow with k, C or O.

#include "snn_common.cuh"

#define SNN_IG_BM 64
#define SNN_IG_BK 32
#define SNN_IG_TM 4

namespace {

struct IgemmDesc {
  int n, h, w, c, kh, kw, o, pt, pl, ho, wo, stride;
  int kdim;          // kh * kw * c
  long long pixels;  // n * ho * wo
  int act;
  float alpha;
};

template <int TN, typename TX, typename TW>
__global__ void __launch_bounds__(256)
conv_igemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ offset,
                  TX* __restrict__ y, const __grid_constant__ IgemmDesc d) {
  constexpr int BN = 16 * TN;
  __shared__ float as[SNN_IG_BK][SNN_IG_BM + 1];
  __shared__ __align__(16) float ws[SNN_IG_BK][BN];
  // Per pixel of the tile: image (-1 past the end) and the input row and
  // column of its tap (0, 0).
  __shared__ int pix_n[SNN_IG_BM], pix_y[SNN_IG_BM], pix_x[SNN_IG_BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * SNN_IG_BM;
  const int n0 = blockIdx.y * BN;

  if (tid < SNN_IG_BM) {
    const long long m = m0 + tid;
    int img = -1, iy = 0, ix = 0;
    if (m < d.pixels) {
      const long long row = m / d.wo;
      img = (int)(row / d.ho);
      iy = (int)(row - (long long)img * d.ho) * d.stride - d.pt;
      ix = (int)(m - row * d.wo) * d.stride - d.pl;
    }
    pix_n[tid] = img; pix_y[tid] = iy; pix_x[tid] = ix;
  }

  float acc[SNN_IG_TM][TN];
#pragma unroll
  for (int i = 0; i < SNN_IG_TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kk = tid % SNN_IG_BK;  // this thread's K column of the patch tile
  const int p0 = tid / SNN_IG_BK;  // and its pixels: p0, p0 + 8, ...
  for (int k0 = 0; k0 < d.kdim; k0 += SNN_IG_BK) {
    __syncthreads();  // pix_* are written; the previous chunk is done
    const int gk = k0 + kk;
    const bool k_ok = gk < d.kdim;
    const int tap = k_ok ? gk / d.c : 0;
    const int ci = gk - tap * d.c;
    const int dy = tap / d.kw, dx = tap - dy * d.kw;
#pragma unroll
    for (int r = 0; r < SNN_IG_BM / 8; ++r) {
      const int p = p0 + 8 * r;
      const int img = pix_n[p];
      const int iy = pix_y[p] + dy, ix = pix_x[p] + dx;
      float v = 0.f;
      if (k_ok && img >= 0 && iy >= 0 && iy < d.h && ix >= 0 && ix < d.w)
        v = to_float(x[(((size_t)img * d.h + iy) * d.w + ix) * d.c + ci]);
      as[kk][p] = v;
    }
    for (int i = tid; i < SNN_IG_BK * BN; i += 256) {
      const int r = i / BN, j = i % BN;
      const int wk = k0 + r, gn = n0 + j;
      ws[r][j] = (wk < d.kdim && gn < d.o) ? to_float(w[(size_t)wk * d.o + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < SNN_IG_BK; ++q) {
      float a[SNN_IG_TM], b[TN];
#pragma unroll
      for (int i = 0; i < SNN_IG_TM; ++i) a[i] = as[q][ty * SNN_IG_TM + i];
      load_w<TN>(&ws[q][tx * TN], b);
#pragma unroll
      for (int i = 0; i < SNN_IG_TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < SNN_IG_TM; ++i) {
    const long long m = m0 + ty * SNN_IG_TM + i;
    if (m >= d.pixels) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < d.o)
        store_out(y + (size_t)m * d.o + gn,
                  apply_act(fmaf(acc[i][j], scale[gn], offset[gn]), d.act, d.alpha));
    }
  }
}

template <int TN, typename TX, typename TW>
int launch(const void* x, const void* w, const float* scale, const float* offset,
           void* y, const IgemmDesc& d, cudaStream_t s) {
  const long long tiles = (d.pixels + SNN_IG_BM - 1) / SNN_IG_BM;
  if (tiles > 2147483647LL) return -2;
  dim3 grid((unsigned)tiles, (d.o + 16 * TN - 1) / (16 * TN));
  conv_igemm_kernel<TN, TX, TW><<<grid, 256, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), scale, offset,
      static_cast<TX*>(y), d);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int dispatch(const void* x, const void* w, const float* scale, const float* offset,
             void* y, const IgemmDesc& d, int sms, cudaStream_t s) {
  // The narrowest channel block (16 * TN, at most 128) that holds every
  // output channel; halved while the grid would leave some of the card's
  // `sms` SMs without a CTA (a 16x16 plane at batch 8 is 32 pixel tiles for
  // 132 SMs): the patch gather is repeated per channel block, which idle
  // SMs do for nothing. Speed only: the block does not change the result.
  const long long tiles = (d.pixels + SNN_IG_BM - 1) / SNN_IG_BM;
  int tn = d.o <= 16 ? 1 : d.o <= 32 ? 2 : d.o <= 64 ? 4 : 8;
  while (tn > 1 && tiles * ((d.o + 16 * tn - 1) / (16 * tn)) < sms) tn /= 2;
  switch (tn) {
    case 1: return launch<1, TX, TW>(x, w, scale, offset, y, d, s);
    case 2: return launch<2, TX, TW>(x, w, scale, offset, y, d, s);
    case 4: return launch<4, TX, TW>(x, w, scale, offset, y, d, s);
    default: return launch<8, TX, TW>(x, w, scale, offset, y, d, s);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_conv_igemm_error), or the cudaError_t of the launch.
// x, y: device NHWC in f32 or bf16 (x_bf16); w: device HWIO (kh*kw*c*o) in
// x's dtype, or int8 when w_int8; scale, offset: device f32 (o); sms: the
// SM count of x's device (1 or less: no narrowing of the channel block).
int snn_conv_igemm(const void* x, int x_bf16, const void* w, int w_int8,
                   const float* scale, const float* offset, void* y, int n, int h,
                   int wd, int c, int kh, int kw, int o, int stride, int pt, int pb,
                   int pl, int pr, int act, float alpha, int sms, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || kh < 1 || kw < 1 || stride < 1) return -1;
  if (pt < 0 || pb < 0 || pl < 0 || pr < 0) return -1;
  if (h + pt + pb < kh || wd + pl + pr < kw) return -1;
  IgemmDesc d;
  d.n = n; d.h = h; d.w = wd; d.c = c; d.kh = kh; d.kw = kw; d.o = o;
  d.pt = pt; d.pl = pl; d.stride = stride; d.act = act; d.alpha = alpha;
  d.ho = (h + pt + pb - kh) / stride + 1;
  d.wo = (wd + pl + pr - kw) / stride + 1;
  d.kdim = kh * kw * c;
  d.pixels = (long long)n * d.ho * d.wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return w_int8 ? dispatch<__nv_bfloat16, int8_t>(x, w, scale, offset, y, d, sms, s)
                  : dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, offset, y, d, sms, s);
  }
  return w_int8 ? dispatch<float, int8_t>(x, w, scale, offset, y, d, sms, s)
                : dispatch<float, float>(x, w, scale, offset, y, d, sms, s);
}

const char* snn_conv_igemm_error(int code) {
  switch (code) {
    case -1: return "empty input, kernel or output, a negative pad or a stride below 1";
    case -2: return "more than 2^31 tiles of 64 output pixels";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
