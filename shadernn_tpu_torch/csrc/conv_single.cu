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
// load; w HWIO (kh,kw,C,O) in the compute dtype, or int8 under bf16 (its
// scale folded into scale[o]; upcast to bf16, exactly, as it is staged,
// as the JAX kernel's dequant upcasts it); an f32 sum
// over (dy, dx, c); y = act(acc * scale[o] + offset[o]) in f32, rounded to
// the compute dtype. Pads (pt, pb, pl, pr) are zeros; the output is
// (N, H+pt+pb-kh+1, W+pl+pr-kw+1, O). Limits as the planner's gate
// (ops/conv.py kernel_chain_supported): c <= 128, o <= 128, kh*kw*c <= 4096.
//
// What bounds it on an H100: a k3 conv over 64-128 channels does 500-1000
// FLOPs per byte of input and output, above the ridge of the bf16 tensor
// cores (989 TFLOP/s over 3.35 TB/s = 295 FLOP/byte); the small-channel
// convs (the stems) are near it. At the shapes the port plans the bound is
// a microsecond or less, so what a launch costs is staging, the halo and
// filling 132 SMs.
//
// Two forms, one per compute dtype:
//
// bf16 (the JAX kernel's numerics: bf16 x bf16 products, f32 sums) is an
// implicit GEMM on the tensor cores: M = output pixels, N = O, K = kh*kw*C
// walked tap by tap and 8 channels at a time (a "unit"; C zero-padded to a
// multiple of 8). One CTA of 8 warps owns 64 output pixels (one tile of an
// image with its (kh-1, kw-1) halo, or several whole small images, each
// with its own halo region) and NB output channels. It walks the input
// channels in chunks of CC: each chunk's input region is staged in shared
// memory as bf16, pixel-major with channels contiguous, rows padded to an
// odd number of 16-byte units so that ldmatrix is free of bank conflicts;
// the weights as [tap][c][NB] bf16, in groups of taps when a chunk's taps
// do not fit. cp.async brings the next stage in while the current one
// computes (two buffers). For each pair of units, the A fragments come
// from ldmatrix with one row address per output pixel, shifted by the
// unit's tap (dy, dx), which is how the halo shift stays free; the B
// fragments from ldmatrix.trans; mma.sync m16n8k16 accumulates in f32
// registers. Warp w owns pixels 16*(w%4).. and half of the NB channels.
// Taps outside an image read staged zeros; pixels and channels past the
// output are never written.
//
// f32 (no TF32 on this path) keeps the CUDA cores: one CTA per (image,
// tile of TH x TW output pixels, block of OB output channels), input
// channels in chunks of CC staged channel-planar with the halo, one
// thread per output pixel and CH output channels, weights read as
// broadcast float4s.
//
// The launch geometry (tiles, images per CTA, channel blocks and chunks,
// taps per stage, strides and the shared-memory layout) is the wrapper's
// (kernels/conv.py launch_geometry); this file checks it and launches.

#include "snn_common.cuh"
#include "snn_mma.cuh"

// Fields of the geometry array the wrapper passes.
enum {
  G_TILE_H, G_TILE_W, G_IMGS, G_NB, G_CC, G_TG, G_CH, G_IN_STRIDE, G_W_STRIDE, G_W_ROWS,
  G_IN_OFF, G_IN_BUFS, G_W_OFF, G_W_BUFS, G_SMEM, G_FIELDS
};

namespace {

// ---------------------------------------------------------------- f32 ----

struct ConvDesc {
  int n, h, w, c, kh, kw, o, pt, pl, ho, wo;
  int act;
  float alpha;
  int tile_h, tile_w, tiles_x;
  int ob, groups, cc;      // output channels per CTA, CH-groups, input chunk
  int rows, cols;          // staged input region: tile + halo
  int in_off, w_off;       // smem offsets (floats)
};

template <int CH, typename TIn>
__global__ void __launch_bounds__(256)
conv_single_kernel(const TIn* __restrict__ x, float* __restrict__ y,
                   const float* __restrict__ wg, const float* __restrict__ scale,
                   const float* __restrict__ offset, const __grid_constant__ ConvDesc d) {
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
      if (gy >= 0 && gy < d.h && gx >= 0 && gx < d.w)
        v = to_float(x[(((size_t)n * d.h + gy) * d.w + gx) * d.c + c0 + ci]);
      in_s[ci * plane + pix] = v;
    }
    // Weights of the chunk as [tap][ci][OB], zeros past o.
    for (int i = tid; i < taps * ccn * d.ob; i += nthreads) {
      const int j = i % d.ob, r = i / d.ob;
      const int ci = r % ccn, tap = r / ccn;
      const int oc = ob0 + j;
      w_s[i] = oc < d.o ? wg[((size_t)tap * d.c + c0 + ci) * d.o + oc] : 0.f;
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
  float* yo = y + (((size_t)n * d.ho + gy) * d.wo + gx) * d.o;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int oc = ob0 + g * CH + j;
    if (oc < d.o) yo[oc] = apply_act(fmaf(acc[j], scale[oc], offset[oc]), d.act, d.alpha);
  }
}

template <int CH, typename TIn>
int launch_f32(const void* x, void* y, const void* w, const float* scale,
               const float* offset, const ConvDesc& d, size_t smem, cudaStream_t s) {
  auto kern = conv_single_kernel<CH, TIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (d.ho + d.tile_h - 1) / d.tile_h;
  dim3 grid(d.tiles_x * tiles_y, (d.o + d.ob - 1) / d.ob, d.n);
  const int threads = d.tile_h * d.tile_w * d.groups;
  kern<<<grid, threads, smem, s>>>(static_cast<const TIn*>(x), static_cast<float*>(y),
                                   static_cast<const float*>(w), scale, offset, d);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bf16 ----

#define SNN_TC_THREADS 256
#define SNN_TC_BM 64  // output pixels per CTA: 4 warps of 16 rows, twice over N

struct TcDesc {
  int n, h, w, c, kh, kw, o, pt, pl, ho, wo;
  int act;
  float alpha;
  int tile_h, tile_w, imgs;  // imgs > 1: that many whole images per CTA
  int tiles_x, tiles_img;    // tiles of one image (imgs == 1)
  int rows, cols;            // staged region of one image: tile + halo
  int region;                // staged positions (imgs * rows * cols); a zero row follows
  int cc, cunits;            // input channels per chunk (multiple of 8), cc / 8
  int tg, groups, stages;    // taps per stage, tap groups, chunks * groups
  int in_stride, w_stride;   // bf16 per staged input position / weight row
  int w_rows;                // staged weight rows per stage (tg * cc, rounded up to 16)
  int in_off, in_buf, w_off, w_buf;  // smem bytes: offsets and one buffer's size
  int in_bufs, w_bufs;
  int vec_x, vec_w;          // 16-byte cp.async loads of x / w
  int w_int8;                // w is int8: upcast to bf16 (exact) as it is staged
};

// NT: n8-tiles per warp (NB = 16 * NT channels per CTA).
template <int NT, typename TIn>
__global__ void __launch_bounds__(SNN_TC_THREADS)
conv_single_tc_kernel(const TIn* __restrict__ x, __nv_bfloat16* __restrict__ y,
                      const void* __restrict__ wv, const float* __restrict__ scale,
                      const float* __restrict__ offset, const __grid_constant__ TcDesc d) {
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wv);
  const int8_t* wq = static_cast<const int8_t*>(wv);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int ob0 = blockIdx.y * (16 * NT);
  int n0, ty0 = 0, tx0 = 0;
  if (d.imgs > 1) {
    n0 = blockIdx.x * d.imgs;
  } else {
    n0 = blockIdx.x / d.tiles_img;
    const int t = blockIdx.x - n0 * d.tiles_img;
    ty0 = (t / d.tiles_x) * d.tile_h;
    tx0 = (t % d.tiles_x) * d.tile_w;
  }
  const int tile_px = d.tile_h * d.tile_w;
  const int bm = d.imgs * tile_px;
  const int plane = d.rows * d.cols;
  const int taps = d.kh * d.kw;
  auto in_buf = [&](int b) {
    return reinterpret_cast<__nv_bfloat16*>(smem + d.in_off + b * d.in_buf);
  };
  auto w_buf = [&](int b) {
    return reinterpret_cast<__nv_bfloat16*>(smem + d.w_off + b * d.w_buf);
  };

  // The zero row after each input region: what masked pixels and padded
  // units read.
  for (int i = tid; i < d.in_bufs * (d.in_stride / 8); i += SNN_TC_THREADS) {
    const int b = i / (d.in_stride / 8), u = i - b * (d.in_stride / 8);
    reinterpret_cast<uint4*>(in_buf(b) + (size_t)d.region * d.in_stride)[u] = make_uint4(0, 0, 0, 0);
  }

  // This lane's A row: pixel 16*wm + (lane & 15) of the CTA, as a staged
  // position (-1: past the CTA's pixels).
  int a_base = -1;
  {
    const int p = wm * 16 + (lane & 15);
    if (p < bm) {
      const int il = p / tile_px, rem = p - il * tile_px;
      const int py = rem / d.tile_w, px = rem - py * d.tile_w;
      a_base = il * plane + py * d.cols + px;
    }
  }

  auto load_stage = [&](int s) {
    const int ci = s / d.groups, grp = s - ci * d.groups;
    const int c0 = ci * d.cc;
    if (grp == 0) {  // the chunk's input region, zero outside the images
      __nv_bfloat16* dst = in_buf(ci % d.in_bufs);
      if (d.vec_x) {
        for (int i = tid; i < d.region * d.cunits; i += SNN_TC_THREADS) {
          const int pos = i / d.cunits, u = i - pos * d.cunits;
          const int il = pos / plane, rem = pos - il * plane;
          const int rr = rem / d.cols, cl = rem - rr * d.cols;
          const int nn = n0 + il, gy = ty0 - d.pt + rr, gx = tx0 - d.pl + cl;
          const int c = c0 + u * 8;
          const bool ok = nn < d.n && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w && c < d.c;
          const TIn* src = ok ? x + (((size_t)nn * d.h + gy) * d.w + gx) * d.c + c : x;
          cp_async16(dst + (size_t)pos * d.in_stride + u * 8, src, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < d.region * d.cc; i += SNN_TC_THREADS) {
          const int pos = i / d.cc, e = i - pos * d.cc;
          const int il = pos / plane, rem = pos - il * plane;
          const int rr = rem / d.cols, cl = rem - rr * d.cols;
          const int nn = n0 + il, gy = ty0 - d.pt + rr, gx = tx0 - d.pl + cl;
          const int c = c0 + e;
          float v = 0.f;
          if (nn < d.n && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w && c < d.c)
            v = to_float(x[(((size_t)nn * d.h + gy) * d.w + gx) * d.c + c]);
          dst[(size_t)pos * d.in_stride + e] = __float2bfloat16_rn(v);
        }
      }
    }
    // Weights of (chunk, tap group): row r = tap_l * cc + c_l, zero past
    // the taps, C and O.
    __nv_bfloat16* dst = w_buf(s % d.w_bufs);
    constexpr int NB = 16 * NT;
    if (d.w_int8) {  // 8 channels of a row per thread, upcast on the way in
      for (int i = tid; i < d.w_rows * (NB / 8); i += SNN_TC_THREADS) {
        const int r = i / (NB / 8), v = i - r * (NB / 8);
        const int tap_l = r / d.cc, cl = r - tap_l * d.cc;
        const int tap = grp * d.tg + tap_l, c = c0 + cl, oc = ob0 + v * 8;
        const bool ok = tap_l < d.tg && tap < taps && c < d.c;
        const int8_t* src = wq + ((size_t)tap * d.c + c) * d.o + oc;
        uint32_t q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = ok && oc + 2 * j < d.o ? (float)src[2 * j] : 0.f;
          const float hi = ok && oc + 2 * j + 1 < d.o ? (float)src[2 * j + 1] : 0.f;
          q[j] = pack_bf16x2(lo, hi);
        }
        *reinterpret_cast<uint4*>(dst + (size_t)r * d.w_stride + v * 8) =
            make_uint4(q[0], q[1], q[2], q[3]);
      }
    } else if (d.vec_w) {
      for (int i = tid; i < d.w_rows * (NB / 8); i += SNN_TC_THREADS) {
        const int r = i / (NB / 8), v = i - r * (NB / 8);
        const int tap_l = r / d.cc, cl = r - tap_l * d.cc;
        const int tap = grp * d.tg + tap_l, c = c0 + cl, oc = ob0 + v * 8;
        const bool ok = tap_l < d.tg && tap < taps && c < d.c && oc < d.o;
        const __nv_bfloat16* src = ok ? w + ((size_t)tap * d.c + c) * d.o + oc : w;
        cp_async16(dst + (size_t)r * d.w_stride + v * 8, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < d.w_rows * NB; i += SNN_TC_THREADS) {
        const int r = i / NB, j = i - r * NB;
        const int tap_l = r / d.cc, cl = r - tap_l * d.cc;
        const int tap = grp * d.tg + tap_l, c = c0 + cl, oc = ob0 + j;
        const bool ok = tap_l < d.tg && tap < taps && c < d.c && oc < d.o;
        dst[(size_t)r * d.w_stride + j] = ok ? w[((size_t)tap * d.c + c) * d.o + oc]
                                             : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  load_stage(0);
  cp_async_commit();
  for (int s = 0; s < d.stages; ++s) {
    if (s + 1 < d.stages) load_stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage s has landed (this thread's copies)
    __syncthreads();     // (everyone's)
    const int ci = s / d.groups, grp = s - ci * d.groups;
    const __nv_bfloat16* ib = in_buf(ci % d.in_bufs);
    const __nv_bfloat16* wb = w_buf(s % d.w_bufs);
    const int ntap = min(d.tg, taps - grp * d.tg), units = ntap * d.cunits;
    const __nv_bfloat16* zero_row = ib + (size_t)d.region * d.in_stride;
    // One k16 step: A rows at ap (this lane's pixel and unit), B rows at
    // bp (k row lane & 15 of the step).
    auto step = [&](const __nv_bfloat16* ap, const __nv_bfloat16* bp) {
      uint32_t a[4];
      ldmatrix_x4(a, ap);
      bp += wn * 8 * NT;
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, bp);
        mma_bf16(acc[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bp + j * 8 + (lane >> 4) * 8);
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    };
    const __nv_bfloat16* b_lane = wb + (size_t)(lane & 15) * d.w_stride;
    if ((d.cunits & 1) == 0) {
      // Pairs of units within one tap: walk the taps, shifting the A rows.
      int tap = grp * d.tg;
      int dy = tap / d.kw, dx = tap - dy * d.kw;
      const __nv_bfloat16* a_lane =
          (a_base >= 0 ? ib + (size_t)a_base * d.in_stride : zero_row) + (lane >> 4) * 8;
      for (int tl = 0; tl < ntap; ++tl) {
        const __nv_bfloat16* ap =
            a_base >= 0 ? a_lane + (size_t)(dy * d.cols + dx) * d.in_stride : a_lane;
        const __nv_bfloat16* bp = b_lane + (size_t)tl * d.cc * d.w_stride;
#pragma unroll 4
        for (int u = 0; u < d.cunits; u += 2) step(ap + u * 8, bp + (size_t)u * 8 * d.w_stride);
        if (++dx == d.kw) {
          dx = 0;
          ++dy;
        }
      }
    } else {
      // One unit per tap (cc = 8, 24, ...): a pair may straddle two taps.
      for (int ks = 0; ks < (units + 1) / 2; ++ks) {
        const int ua = 2 * ks + (lane >> 4);
        const __nv_bfloat16* ap = zero_row;
        if (ua < units && a_base >= 0) {
          const int tap_l = ua / d.cunits, u = ua - tap_l * d.cunits;
          const int tap = grp * d.tg + tap_l;
          const int dy = tap / d.kw, dx = tap - dy * d.kw;
          ap = ib + (size_t)(a_base + dy * d.cols + dx) * d.in_stride + u * 8;
        }
        step(ap, b_lane + (size_t)16 * ks * d.w_stride);
      }
    }
    __syncthreads();  // the buffers of stage s are free for stage s + 2
  }

  // Epilogue on the fragments: rows g and g + 8 of the warp's 16 pixels,
  // columns 2t, 2t + 1 of each n8-tile.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = wm * 16 + g + 8 * half;
    if (p >= bm) continue;
    const int il = p / tile_px, rem = p - il * tile_px;
    const int py = rem / d.tile_w, px = rem - py * d.tile_w;
    const int nn = n0 + il, gy = ty0 + py, gx = tx0 + px;
    if (nn >= d.n || gy >= d.ho || gx >= d.wo) continue;
    __nv_bfloat16* yo = y + (((size_t)nn * d.ho + gy) * d.wo + gx) * d.o;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int oc = ob0 + wn * 8 * NT + j * 8 + 2 * t;
      if (oc >= d.o) continue;
      const float v0 = apply_act(fmaf(acc[j][2 * half], scale[oc], offset[oc]), d.act, d.alpha);
      if (oc + 1 < d.o) {
        const float v1 =
            apply_act(fmaf(acc[j][2 * half + 1], scale[oc + 1], offset[oc + 1]), d.act, d.alpha);
        if ((d.o & 1) == 0) {
          *reinterpret_cast<uint32_t*>(yo + oc) = pack_bf16x2(v0, v1);
        } else {
          yo[oc] = __float2bfloat16_rn(v0);
          yo[oc + 1] = __float2bfloat16_rn(v1);
        }
      } else {
        yo[oc] = __float2bfloat16_rn(v0);
      }
    }
  }
}

template <int NT, typename TIn>
int launch_tc(const void* x, void* y, const void* w, const float* scale, const float* offset,
              const TcDesc& d, size_t smem, cudaStream_t s) {
  auto kern = conv_single_tc_kernel<NT, TIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mtiles = d.imgs > 1 ? (d.n + d.imgs - 1) / d.imgs : d.n * d.tiles_img;
  dim3 grid(mtiles, (d.o + 16 * NT - 1) / (16 * NT));
  kern<<<grid, SNN_TC_THREADS, smem, s>>>(static_cast<const TIn*>(x),
                                          static_cast<__nv_bfloat16*>(y),
                                          w, scale, offset, d);
  return (int)cudaGetLastError();
}

template <typename TIn>
int dispatch_tc(int nt, const void* x, void* y, const void* w, const float* scale,
                const float* offset, const TcDesc& d, size_t smem, cudaStream_t s) {
  switch (nt) {
    case 1: return launch_tc<1, TIn>(x, y, w, scale, offset, d, smem, s);
    case 2: return launch_tc<2, TIn>(x, y, w, scale, offset, d, smem, s);
    case 4: return launch_tc<4, TIn>(x, y, w, scale, offset, d, smem, s);
    default: return launch_tc<8, TIn>(x, y, w, scale, offset, d, smem, s);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// [off, off + need) within [lo, hi), 16-byte aligned.
inline bool fits(long long off, long long need, long long lo, long long hi) {
  return off % 16 == 0 && off >= lo && off + need <= hi;
}

int run_tc(const void* x, int x_bf16, void* y, const void* w, const float* scale,
           const float* offset, TcDesc d, const int* g, cudaStream_t s) {
  const int nb = g[G_NB], taps = d.kh * d.kw;
  d.tile_h = g[G_TILE_H]; d.tile_w = g[G_TILE_W]; d.imgs = g[G_IMGS];
  d.cc = g[G_CC]; d.tg = g[G_TG];
  d.in_stride = g[G_IN_STRIDE]; d.w_stride = g[G_W_STRIDE]; d.w_rows = g[G_W_ROWS];
  d.in_off = g[G_IN_OFF]; d.in_bufs = g[G_IN_BUFS]; d.w_off = g[G_W_OFF]; d.w_bufs = g[G_W_BUFS];
  const long long smem = g[G_SMEM];
  if (nb != 16 && nb != 32 && nb != 64 && nb != 128) return -4;
  if (d.tile_h < 1 || d.tile_w < 1 || d.imgs < 1 || d.imgs * d.tile_h * d.tile_w > SNN_TC_BM)
    return -4;
  if (d.imgs > 1 && (d.tile_h != d.ho || d.tile_w != d.wo)) return -4;
  if (d.cc < 8 || d.cc % 8 || d.tg < 1 || d.tg > taps) return -4;
  if (d.in_stride < d.cc || d.in_stride % 8 || d.w_stride < nb || d.w_stride % 8) return -4;
  if (d.w_rows < d.tg * d.cc || d.w_rows % 16) return -4;
  const int chunks = (d.c + d.cc - 1) / d.cc;
  d.groups = (taps + d.tg - 1) / d.tg;
  d.stages = chunks * d.groups;
  if (d.in_bufs != (chunks > 1 ? 2 : 1) || d.w_bufs != (d.stages > 1 ? 2 : 1)) return -4;
  d.cunits = d.cc / 8;
  d.tiles_x = (d.wo + d.tile_w - 1) / d.tile_w;
  d.tiles_img = d.tiles_x * ((d.ho + d.tile_h - 1) / d.tile_h);
  d.rows = d.tile_h + d.kh - 1;
  d.cols = d.tile_w + d.kw - 1;
  d.region = d.imgs * d.rows * d.cols;
  d.in_buf = (d.region + 1) * d.in_stride * 2;
  d.w_buf = d.w_rows * d.w_stride * 2;
  if (smem > SNN_MAX_SMEM || !fits(d.in_off, (long long)d.in_bufs * d.in_buf, 0, d.w_off) ||
      !fits(d.w_off, (long long)d.w_bufs * d.w_buf, d.in_off, smem))
    return -2;
  d.vec_x = x_bf16 && d.c % 8 == 0 && aligned16(x);
  d.vec_w = !d.w_int8 && d.o % 8 == 0 && aligned16(w);
  return x_bf16 ? dispatch_tc<__nv_bfloat16>(nb / 16, x, y, w, scale, offset, d, smem, s)
                : dispatch_tc<float>(nb / 16, x, y, w, scale, offset, d, smem, s);
}

int run_f32(const void* x, int x_bf16, void* y, const void* w, const float* scale,
            const float* offset, const TcDesc& t, const int* g, cudaStream_t s) {
  ConvDesc d;
  d.n = t.n; d.h = t.h; d.w = t.w; d.c = t.c; d.kh = t.kh; d.kw = t.kw; d.o = t.o;
  d.pt = t.pt; d.pl = t.pl; d.ho = t.ho; d.wo = t.wo; d.act = t.act; d.alpha = t.alpha;
  d.tile_h = g[G_TILE_H]; d.tile_w = g[G_TILE_W];
  d.ob = g[G_NB]; d.cc = g[G_CC];
  const int ch = g[G_CH];
  const long long smem = g[G_SMEM];
  if (ch != 1 && ch != 4 && ch != 8) return -4;
  if (g[G_IMGS] != 1 || d.ob < ch || d.ob % ch || d.cc < 1 || d.cc > d.c) return -4;
  if (d.tile_h < 1 || d.tile_w < 1) return -4;
  d.groups = d.ob / ch;
  const int threads = d.tile_h * d.tile_w * d.groups;
  if (threads > 256) return -4;  // __launch_bounds__
  d.tiles_x = (d.wo + d.tile_w - 1) / d.tile_w;
  d.rows = d.tile_h + d.kh - 1;
  d.cols = d.tile_w + d.kw - 1;
  d.in_off = 0;
  const long long w_off = g[G_W_OFF];
  if (smem > SNN_MAX_SMEM || !fits(0, 4LL * d.cc * d.rows * d.cols, 0, w_off) ||
      !fits(w_off, 4LL * d.kh * d.kw * d.cc * d.ob, 0, smem))
    return -2;
  d.w_off = (int)(w_off / 4);
  auto go = [&](auto tag) {
    using TIn = decltype(tag);
    switch (ch) {
      case 8: return launch_f32<8, TIn>(x, y, w, scale, offset, d, smem, s);
      case 4: return launch_f32<4, TIn>(x, y, w, scale, offset, d, smem, s);
      default: return launch_f32<1, TIn>(x, y, w, scale, offset, d, smem, s);
    }
  };
  return x_bf16 ? go(__nv_bfloat16()) : go(float());
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_conv_single_error), or the cudaError_t of the launch.
// w: device HWIO (kh*kw*c*o) in the compute dtype, or int8 when w_int8
// (bf16 compute only); scale, offset: device
// f32 (o). geom: G_FIELDS ints, the wrapper's launch geometry (the fields
// of the enum above; kernels/conv.py ConvLaunch).
int snn_conv_single(const void* x, int x_bf16, void* y, const void* w, int w_int8,
                    const float* scale, const float* offset, int n, int h,
                    int wd, int c, int kh, int kw, int o, int pt, int pb,
                    int pl, int pr, int act, float alpha, int compute_bf16,
                    const int* geom, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || kh < 1 || kw < 1) return -1;
  if (pt < 0 || pb < 0 || pl < 0 || pr < 0) return -1;
  if (c > 128 || o > 128 || kh * kw * c > 4096) return -3;
  if (w_int8 && !compute_bf16) return -3;
  TcDesc d;
  d.w_int8 = w_int8;
  d.n = n; d.h = h; d.w = wd; d.c = c; d.kh = kh; d.kw = kw; d.o = o;
  d.pt = pt; d.pl = pl; d.act = act; d.alpha = alpha;
  d.ho = h + pt + pb - kh + 1;
  d.wo = wd + pl + pr - kw + 1;
  if (d.ho < 1 || d.wo < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? run_tc(x, x_bf16, y, w, scale, offset, d, geom, s)
                      : run_f32(x, x_bf16, y, w, scale, offset, d, geom, s);
}

const char* snn_conv_single_error(int code) {
  switch (code) {
    case -1: return "empty input, kernel, output or a negative pad";
    case -2: return "the launch geometry's shared-memory layout does not hold its buffers "
                    "within 227 KB";
    case -3: return "shape outside the kernel's limits (c <= 128, o <= 128, kh*kw*c <= 4096), "
                    "or int8 weights under f32 activations";
    case -4: return "launch geometry outside the kernel (tile, channel block, chunk, taps "
                    "per stage or buffers)";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
