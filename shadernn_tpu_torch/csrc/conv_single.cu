// One stride-1 convolution with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package
//   shadernn_tpu/kernels/conv_pallas.py : _haloed_kernel
//       (entry point fused_conv2d_haloed, reached through
//        shadernn_tpu/ops/conv.py conv_run_pallas_chain)
// which computes this function in a haloed NHCW layout with margins; the
// layout (and its C=1 row packing) is a TPU detail, so this kernel takes
// NHWC in and gives NHWC out.
//
// Function: x NHWC (N,H,W,C), f32 or bf16, cast to the compute dtype on
// load; w HWIO (kh,kw,C,O) in the compute dtype; an f32 sum
// over (dy, dx, c); y = act(acc * scale[o] + offset[o]) in f32, rounded to
// the compute dtype. Pads (pt, pb, pl, pr) are zeros; the output is
// (N, H+pt+pb-kh+1, W+pl+pr-kw+1, O). Limits as the planner's gate
// (ops/conv.py kernel_chain_supported): c <= 128, o <= 128, kh*kw*c <= 4096.
//
// What bounds it on an H100: at the shapes the port plans (small-channel
// convs; the folded MobileNetV2 stem is 12->16 channels, k=2) a conv does a
// few hundred FLOPs per byte of input and output, near the ridge of the
// CUDA cores (67 TFLOP/s f32 over 3.35 TB/s = 20 FLOP/byte) and far below
// the tensor cores' (295 FLOP/byte). This first version issues its FLOPs as
// f32 FMAs on the CUDA cores; what the design secures is one read of each
// input tile (plus halo) and one write of the output.
//
// Design: one CTA per (image, tile of TH x TW output pixels, block of OB
// output channels). The input channels are walked in chunks of CC: each
// chunk stages the input tile plus its (kh-1, kw-1) halo (zero outside the
// image, channel-planar so that neighbouring threads read neighbouring
// words) and the chunk's weights [dy][dx][c][OB] in shared memory. One
// thread owns one output pixel and CH consecutive output channels in
// registers; the weights are read as broadcast float4s.

#include "snn_common.cuh"

#define SNN_SMEM_TARGET 98304  // 96 KB: two CTAs per SM where a chunk fits

namespace {

struct ConvDesc {
  int n, h, w, c, kh, kw, o, pt, pl, ho, wo;
  int act;
  float alpha;
  int tile_h, tile_w, tiles_x;
  int ob, groups, cc;      // output channels per CTA, CH-groups, input chunk
  int rows, cols;          // staged input region: tile + halo
  int in_off, w_off;       // smem offsets (floats)
};

template <int CH, typename TIn, bool BF16>
__global__ void __launch_bounds__(256)
conv_single_kernel(const TIn* __restrict__ x, void* __restrict__ y,
                   const void* __restrict__ w_raw, const float* __restrict__ scale,
                   const float* __restrict__ offset, const __grid_constant__ ConvDesc d) {
  using TOut = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  const TOut* __restrict__ wg = static_cast<const TOut*>(w_raw);  // compute dtype
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* in_s = smem + d.in_off;
  float* w_s = smem + d.w_off;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int P = d.tile_h * d.tile_w;
  const int n = blockIdx.z;
  const int ob0 = blockIdx.y * d.ob;
  const int ty0 = (blockIdx.x / d.tiles_x) * d.tile_h;
  const int tx0 = (blockIdx.x % d.tiles_x) * d.tile_w;
  // Thread -> (pixel of the tile, group of CH output channels); the pixel
  // index runs fastest so that a warp shares its weights.
  const int p = tid % P, g = tid / P;
  const int py = p / d.tile_w, px = p - py * d.tile_w;
  const int plane = d.rows * d.cols;
  const int taps = d.kh * d.kw;

  float acc[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < d.c; c0 += d.cc) {
    const int ccn = min(d.cc, d.c - c0);
    __syncthreads();  // the previous chunk is done with the buffers
    for (int i = tid; i < plane * ccn; i += nthreads) {
      const int ci = i % ccn, pix = i / ccn;
      const int rr = pix / d.cols, cc = pix - rr * d.cols;
      const int gy = ty0 - d.pt + rr, gx = tx0 - d.pl + cc;
      float v = 0.f;
      if (gy >= 0 && gy < d.h && gx >= 0 && gx < d.w) {
        v = to_float(x[(((size_t)n * d.h + gy) * d.w + gx) * d.c + c0 + ci]);
        if (BF16) v = round_bf16(v);
      }
      in_s[ci * plane + pix] = v;
    }
    // Weights of the chunk as [tap][ci][OB], zeros past o.
    for (int i = tid; i < taps * ccn * d.ob; i += nthreads) {
      const int j = i % d.ob, r = i / d.ob;
      const int ci = r % ccn, tap = r / ccn;
      const int oc = ob0 + j;
      w_s[i] = oc < d.o ? to_float(wg[((size_t)tap * d.c + c0 + ci) * d.o + oc]) : 0.f;
    }
    __syncthreads();
    if (g < d.groups) {
      const float* wp = w_s + g * CH;
      for (int dy = 0; dy < d.kh; ++dy) {
        for (int dx = 0; dx < d.kw; ++dx) {
          const float* ip = in_s + (py + dy) * d.cols + px + dx;
          const float* wt = wp + (dy * d.kw + dx) * ccn * d.ob;
          for (int ci = 0; ci < ccn; ++ci) {
            const float v = ip[ci * plane];
            float wv[CH];
            load_w<CH>(wt + ci * d.ob, wv);
#pragma unroll
            for (int j = 0; j < CH; ++j) acc[j] = fmaf(v, wv[j], acc[j]);
          }
        }
      }
    }
  }

  const int gy = ty0 + py, gx = tx0 + px;
  if (g >= d.groups || gy >= d.ho || gx >= d.wo) return;
  TOut* yo = static_cast<TOut*>(y) + (((size_t)n * d.ho + gy) * d.wo + gx) * d.o;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int oc = ob0 + g * CH + j;
    if (oc < d.o) {
      const float v = apply_act(fmaf(acc[j], scale[oc], offset[oc]), d.act, d.alpha);
      if constexpr (BF16) {
        yo[oc] = __float2bfloat16_rn(v);
      } else {
        yo[oc] = v;
      }
    }
  }
}

inline int round4(int v) { return (v + 3) & ~3; }

template <int CH, typename TIn, bool BF16>
int launch(const void* x, void* y, const void* w, const float* scale,
           const float* offset, const ConvDesc& d, size_t smem, cudaStream_t s) {
  auto kern = conv_single_kernel<CH, TIn, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (d.ho + d.tile_h - 1) / d.tile_h;
  dim3 grid(d.tiles_x * tiles_y, (d.o + d.ob - 1) / d.ob, d.n);
  const int threads = d.tile_h * d.tile_w * d.groups;
  kern<<<grid, threads, smem, s>>>(static_cast<const TIn*>(x), y, w, scale, offset, d);
  return (int)cudaGetLastError();
}

template <int CH>
int dispatch(int x_bf16, int compute_bf16, const void* x, void* y, const void* w,
             const float* scale, const float* offset, const ConvDesc& d,
             size_t smem, cudaStream_t s) {
  if (x_bf16) {
    return compute_bf16 ? launch<CH, __nv_bfloat16, true>(x, y, w, scale, offset, d, smem, s)
                        : launch<CH, __nv_bfloat16, false>(x, y, w, scale, offset, d, smem, s);
  }
  return compute_bf16 ? launch<CH, float, true>(x, y, w, scale, offset, d, smem, s)
                      : launch<CH, float, false>(x, y, w, scale, offset, d, smem, s);
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_conv_single_error), or the cudaError_t of the launch.
// w: device HWIO (kh*kw*c*o) in the compute dtype; scale, offset: device
// f32 (o).
int snn_conv_single(const void* x, int x_bf16, void* y, const void* w,
                    const float* scale, const float* offset, int n, int h,
                    int wd, int c, int kh, int kw, int o, int pt, int pb,
                    int pl, int pr, int act, float alpha, int compute_bf16,
                    void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || kh < 1 || kw < 1) return -1;
  if (pt < 0 || pb < 0 || pl < 0 || pr < 0) return -1;
  if (c > 128 || o > 128 || kh * kw * c > 4096) return -3;
  ConvDesc d;
  d.n = n; d.h = h; d.w = wd; d.c = c; d.kh = kh; d.kw = kw; d.o = o;
  d.pt = pt; d.pl = pl; d.act = act; d.alpha = alpha;
  d.ho = h + pt + pb - kh + 1;
  d.wo = wd + pl + pr - kw + 1;
  if (d.ho < 1 || d.wo < 1) return -1;
  const int ch = o > 4 ? 8 : (o > 1 ? 4 : 1);
  const int o_pad = (o + ch - 1) / ch * ch;
  d.ob = o_pad < 32 ? o_pad : 32;
  d.groups = d.ob / ch;
  // About 256 threads: pixels per tile times channel groups.
  const int pixels = 256 / d.groups;
  d.tile_w = pixels >= 128 ? 16 : 8;
  d.tile_h = pixels / d.tile_w;
  d.tiles_x = (d.wo + d.tile_w - 1) / d.tile_w;
  d.rows = d.tile_h + kh - 1;
  d.cols = d.tile_w + kw - 1;
  // Largest input-channel chunk within 96 KB (two CTAs per SM), else
  // within 227 KB.
  const int per_c = round4(d.rows * d.cols) + kh * kw * d.ob;
  int budget = SNN_SMEM_TARGET / 4;
  if (per_c > budget) budget = SNN_MAX_SMEM / 4;
  d.cc = budget / per_c;
  if (d.cc < 1) return -2;
  if (d.cc > c) d.cc = c;
  d.in_off = 0;
  d.w_off = round4(d.cc * d.rows * d.cols);
  const size_t smem = (size_t)(d.w_off + kh * kw * d.cc * d.ob) * sizeof(float);
  if (smem > SNN_MAX_SMEM) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 8: return dispatch<8>(x_bf16, compute_bf16, x, y, w, scale, offset, d, smem, s);
    case 4: return dispatch<4>(x_bf16, compute_bf16, x, y, w, scale, offset, d, smem, s);
    default: return dispatch<1>(x_bf16, compute_bf16, x, y, w, scale, offset, d, smem, s);
  }
}

const char* snn_conv_single_error(int code) {
  switch (code) {
    case -1: return "empty input, kernel, output or a negative pad";
    case -2: return "shared memory of one input channel of the tile exceeds 227 KB";
    case -3: return "shape outside the kernel's limits (c <= 128, o <= 128, kh*kw*c <= 4096)";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
