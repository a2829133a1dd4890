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
// f32 (f32 x f32 products at about f32's accuracy, as the JAX package runs
// f32 at HIGHEST precision) is the same implicit GEMM in 3xTF32 on mma.sync
// m16n8k8 tf32 (csrc/snn_mma.cuh): the input region staged as f32 (a bf16
// input converted as it is staged), rows of the chunk's channels plus 4
// floats; one k8 step per unit, so a pair never straddles two taps. The
// weights come n-major from the host (O rows of kh*kw*C8, C zero-padded to
// 8; kernels/conv.py makes them once per weight tensor) and are staged as
// [NB][tg * cc + 4]: ldmatrix has no 32-bit transpose. Each fragment is
// split into its TF32 hi and lo in registers, three passes per k8 step (two
// from a bf16 input, exact in TF32). Within a tap, a_hi b_hi and the small
// passes sum in accumulators of their own, added into the f32 sums with
// round-to-nearest adds after the tap: the tensor cores' accumulation
// truncates, and promoted per tap its error no longer grows with K.
//
// The launch geometry (tiles, images per CTA, channel blocks and chunks,
// taps per stage, strides and the shared-memory layout) is the wrapper's
// (kernels/conv.py launch_geometry); this file checks it and launches.

#include "snn_common.cuh"
#include "snn_mma.cuh"

// Fields of the geometry array the wrapper passes.
enum {
  G_TILE_H, G_TILE_W, G_IMGS, G_NB, G_CC, G_TG, G_IN_STRIDE, G_W_STRIDE, G_W_ROWS,
  G_IN_OFF, G_IN_BUFS, G_W_OFF, G_W_BUFS, G_SMEM, G_FIELDS
};

namespace {

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
  int in_stride, w_stride;   // elements per staged input position / weight row
  int w_rows;                // staged weight rows per stage (bf16: tg * cc rounded up to
                             // 16; f32, n-major: NB)
  int in_off, in_buf, w_off, w_buf;  // smem bytes: offsets and one buffer's size
  int in_bufs, w_bufs;
  int vec_x, vec_w;          // 16-byte cp.async loads of x / w
  int w_int8;                // w is int8: upcast to bf16 (exact) as it is staged
};

// --------------------------------------------------------------- bf16 ----

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

// ---------------------------------------------------------------- f32 ----

// NT: n8-tiles per warp (NB = 16 * NT channels per CTA). TIn: the input's
// dtype; a bf16 input is exact in TF32 (lo = 0: two passes).
template <int NT, typename TIn>
__global__ void __launch_bounds__(SNN_TC_THREADS)
conv_single_tf32_kernel(const TIn* __restrict__ x, float* __restrict__ y,
                        const float* __restrict__ w, const float* __restrict__ scale,
                        const float* __restrict__ offset, const __grid_constant__ TcDesc d) {
  constexpr bool a_exact = std::is_same<TIn, __nv_bfloat16>::value;
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
  const int c8 = (d.c + 7) / 8 * 8, k_row = taps * c8;  // the n-major weight's rows
  auto in_buf = [&](int b) { return reinterpret_cast<float*>(smem + d.in_off + b * d.in_buf); };
  auto w_buf = [&](int b) { return reinterpret_cast<float*>(smem + d.w_off + b * d.w_buf); };

  // The zero row after each input region: what masked pixels read.
  for (int i = tid; i < d.in_bufs * (d.in_stride / 4); i += SNN_TC_THREADS) {
    const int b = i / (d.in_stride / 4), u = i - b * (d.in_stride / 4);
    reinterpret_cast<float4*>(in_buf(b) + (size_t)d.region * d.in_stride)[u] =
        make_float4(0.f, 0.f, 0.f, 0.f);
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

  constexpr int NB = 16 * NT;
  auto load_stage = [&](int s) {
    const int ci = s / d.groups, grp = s - ci * d.groups;
    const int c0 = ci * d.cc;
    if (grp == 0) {  // the chunk's input region as f32, zero outside the images
      float* dst = in_buf(ci % d.in_bufs);
      if (d.vec_x) {  // f32 x, C % 4 == 0: four channels per copy
        for (int i = tid; i < d.region * (d.cc / 4); i += SNN_TC_THREADS) {
          const int pos = i / (d.cc / 4), u = i - pos * (d.cc / 4);
          const int il = pos / plane, rem = pos - il * plane;
          const int rr = rem / d.cols, cl = rem - rr * d.cols;
          const int nn = n0 + il, gy = ty0 - d.pt + rr, gx = tx0 - d.pl + cl;
          const int c = c0 + u * 4;
          const bool ok = nn < d.n && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w && c < d.c;
          const TIn* src = ok ? x + (((size_t)nn * d.h + gy) * d.w + gx) * d.c + c : x;
          cp_async16(dst + (size_t)pos * d.in_stride + u * 4, src, ok ? 16 : 0);
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
          dst[(size_t)pos * d.in_stride + e] = v;
        }
      }
    }
    // Weights of (chunk, tap group), n-major: row n = output channel ob0 + n,
    // column tap_l * cc + c_l; zero past the taps, C8 and O.
    float* dst = w_buf(s % d.w_bufs);
    const int units = d.tg * d.cc / 4;  // 16-byte units of a staged row
    for (int i = tid; i < NB * units; i += SNN_TC_THREADS) {
      const int r = i / units, k = 4 * (i - r * units);
      const int tap_l = k / d.cc, cl = k - tap_l * d.cc;
      const int tap = grp * d.tg + tap_l, c = c0 + cl, oc = ob0 + r;
      const bool ok = tap < taps && c < c8 && oc < d.o;
      cp_async16(dst + (size_t)r * d.w_stride + k,
                 ok ? w + (size_t)oc * k_row + (size_t)tap * c8 + c : w, ok ? 16 : 0);
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
    const float* ib = in_buf(ci % d.in_bufs);
    const float* wb = w_buf(s % d.w_bufs);
    const int ntap = min(d.tg, taps - grp * d.tg);
    const float* a_lane =
        (a_base >= 0 ? ib + (size_t)a_base * d.in_stride : ib + (size_t)d.region * d.in_stride) +
        4 * (lane >> 4);
    // B rows: n row (lane & 7) (+8 for lanes 16-31) of the warp's tiles,
    // float 4 ((lane >> 3) & 1) of the k8 step.
    const float* b_lane = wb + (size_t)(wn * 8 * NT + (lane & 7) + 8 * (lane >> 4)) * d.w_stride +
                          4 * ((lane >> 3) & 1);
    int tap = grp * d.tg;
    int dy = tap / d.kw, dx = tap - dy * d.kw;
    for (int tl = 0; tl < ntap; ++tl) {
      const float* ap = a_base >= 0 ? a_lane + (size_t)(dy * d.cols + dx) * d.in_stride : a_lane;
      const float* bp = b_lane + tl * d.cc;
      // The tap's sums: a_hi b_hi and the small passes in accumulators of
      // their own (three dependent chains instead of one), added into acc
      // after the tap with round-to-nearest f32 adds (the tensor cores'
      // accumulation truncates: promoted per tap, its error stops growing
      // with K).
      float hh[NT][4], lo[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) hh[j][q] = lo[j][q] = 0.f;
#pragma unroll 2
      for (int u = 0; u < d.cunits; ++u) {  // one k8 step per unit of 8 channels
        uint32_t a[4], ah[4], al[4];
        ldmatrix_x4(a, ap + u * 8);
        split_tf32(a, ah, al);
        if constexpr (NT == 1) {
          uint32_t b[2], bh[2], bl[2];
          ldmatrix_x2(b, bp + u * 8);
          split_tf32(b, bh, bl);
          mma_tf32(lo[0], ah, bl[0], bl[1]);
          if (!a_exact) mma_tf32(lo[0], al, bh[0], bh[1]);
          mma_tf32(hh[0], ah, bh[0], bh[1]);
        } else {
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t b[4], bh[4], bl[4];
            ldmatrix_x4(b, bp + (size_t)j * 8 * d.w_stride + u * 8);
            split_tf32(b, bh, bl);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma_tf32(lo[j + h], ah, bl[2 * h], bl[2 * h + 1]);
              if (!a_exact) mma_tf32(lo[j + h], al, bh[2 * h], bh[2 * h + 1]);
              mma_tf32(hh[j + h], ah, bh[2 * h], bh[2 * h + 1]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += hh[j][q] + lo[j][q];
      if (++dx == d.kw) {
        dx = 0;
        ++dy;
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
    float* yo = y + (((size_t)nn * d.ho + gy) * d.wo + gx) * d.o;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int oc = ob0 + wn * 8 * NT + j * 8 + 2 * t;
      if (oc >= d.o) continue;
      const float v0 = apply_act(fmaf(acc[j][2 * half], scale[oc], offset[oc]), d.act, d.alpha);
      if (oc + 1 < d.o) {
        const float v1 =
            apply_act(fmaf(acc[j][2 * half + 1], scale[oc + 1], offset[oc + 1]), d.act, d.alpha);
        if ((d.o & 1) == 0) {
          *reinterpret_cast<float2*>(yo + oc) = make_float2(v0, v1);
        } else {
          yo[oc] = v0;
          yo[oc + 1] = v1;
        }
      } else {
        yo[oc] = v0;
      }
    }
  }
}

template <int NT, typename TIn>
int launch_tf32(const void* x, void* y, const void* w, const float* scale, const float* offset,
                const TcDesc& d, size_t smem, cudaStream_t s) {
  auto kern = conv_single_tf32_kernel<NT, TIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mtiles = d.imgs > 1 ? (d.n + d.imgs - 1) / d.imgs : d.n * d.tiles_img;
  dim3 grid(mtiles, (d.o + 16 * NT - 1) / (16 * NT));
  kern<<<grid, SNN_TC_THREADS, smem, s>>>(static_cast<const TIn*>(x), static_cast<float*>(y),
                                          static_cast<const float*>(w), scale, offset, d);
  return (int)cudaGetLastError();
}

template <typename TIn>
int dispatch_tf32(int nt, const void* x, void* y, const void* w, const float* scale,
                  const float* offset, const TcDesc& d, size_t smem, cudaStream_t s) {
  switch (nt) {
    case 1: return launch_tf32<1, TIn>(x, y, w, scale, offset, d, smem, s);
    case 2: return launch_tf32<2, TIn>(x, y, w, scale, offset, d, smem, s);
    case 4: return launch_tf32<4, TIn>(x, y, w, scale, offset, d, smem, s);
    default: return launch_tf32<8, TIn>(x, y, w, scale, offset, d, smem, s);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// [off, off + need) within [lo, hi), 16-byte aligned.
inline bool fits(long long off, long long need, long long lo, long long hi) {
  return off % 16 == 0 && off >= lo && off + need <= hi;
}

// The wrapper's geometry checked and completed; the bf16 form or (f32) the
// 3xTF32 form launched.
int run(const void* x, int x_bf16, void* y, const void* w, const float* scale,
        const float* offset, TcDesc d, const int* g, bool bf16, cudaStream_t s) {
  const int nb = g[G_NB], taps = d.kh * d.kw, esz = bf16 ? 2 : 4;
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
  if (bf16) {  // weights k-major: rows of NB channels
    if (d.in_stride < d.cc || d.in_stride % 8 || d.w_stride < nb || d.w_stride % 8) return -4;
    if (d.w_rows < d.tg * d.cc || d.w_rows % 16) return -4;
  } else {  // weights n-major: NB rows of the stage's k; 16-byte units
    if (d.in_stride < d.cc || d.in_stride % 4 || d.w_stride < d.tg * d.cc || d.w_stride % 4)
      return -4;
    if (d.w_rows != nb || !aligned16(w)) return -4;
  }
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
  d.in_buf = (d.region + 1) * d.in_stride * esz;
  d.w_buf = d.w_rows * d.w_stride * esz;
  if (smem > SNN_MAX_SMEM || !fits(d.in_off, (long long)d.in_bufs * d.in_buf, 0, d.w_off) ||
      !fits(d.w_off, (long long)d.w_bufs * d.w_buf, d.in_off, smem))
    return -2;
  if (!bf16) {
    d.vec_x = !x_bf16 && d.c % 4 == 0 && aligned16(x);
    return x_bf16 ? dispatch_tf32<__nv_bfloat16>(nb / 16, x, y, w, scale, offset, d, smem, s)
                  : dispatch_tf32<float>(nb / 16, x, y, w, scale, offset, d, smem, s);
  }
  d.vec_x = x_bf16 && d.c % 8 == 0 && aligned16(x);
  d.vec_w = !d.w_int8 && d.o % 8 == 0 && aligned16(w);
  return x_bf16 ? dispatch_tc<__nv_bfloat16>(nb / 16, x, y, w, scale, offset, d, smem, s)
                : dispatch_tc<float>(nb / 16, x, y, w, scale, offset, d, smem, s);
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_conv_single_error), or the cudaError_t of the launch.
// w: bf16 compute: device HWIO (kh*kw*c*o) bf16, or int8 when w_int8;
// f32 compute: the n-major f32 weight (o rows of kh*kw*c8, c zero-padded
// to a multiple of 8; kernels/conv.py nmajor_weight), 16-byte aligned.
// scale, offset: device f32 (o). geom: G_FIELDS ints, the wrapper's launch geometry (the fields
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
  return run(x, x_bf16, y, w, scale, offset, d, geom, compute_bf16 != 0, s);
}

const char* snn_conv_single_error(int code) {
  switch (code) {
    case -1: return "empty input, kernel, output or a negative pad";
    case -2: return "the launch geometry's shared-memory layout does not hold its buffers "
                    "within 227 KB";
    case -3: return "shape outside the kernel's limits (c <= 128, o <= 128, kh*kw*c <= 4096), "
                    "or int8 weights under f32 activations";
    case -4: return "launch geometry outside the kernel (tile, channel block, chunk, taps "
                    "per stage, strides or buffers), or an unaligned f32 weight";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
