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
// convs (the stems) are near it. At the k3 shapes the port plans the bound
// is a microsecond or less, so what a launch costs is staging, the halo and
// filling 132 SMs. StyleTransfer's 9x9 stem (3 -> 32) and head (32 -> 3) at
// 512x512 b4 do 16.3 GFLOP each over 73 MB (bf16): 0.022 ms of bytes, 0.016
// of bf16 products; in f32 0.044 of bytes, 0.243 of CUDA-core products.
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
// Two bodies, picked by the wrapper's launch geometry (field G_BODY):
//
// The tile body (above; designed for the k3 convs of ResNet18, MobileNetV2,
// YOLOv3-tiny and U-Net) gives each CTA one 64-pixel tile and stages the
// weights of every stage for it. At a 9x9 kernel that is the whole weight
// (StyleTransfer's head: 2592 x 16 bf16, 124 KB) for every 64 outputs, in
// one stage that nothing overlaps, and N padded to 16 (3 of 16 columns of
// the head carry data) and, at C = 3, C padded to 8 per tap (the stem: 648
// of K for 243 values). Measured there (tools/phase_stamps.py, PERF.md), a
// CTA spends 42% of its cycles issuing the weight's copies and the rest on
// a k-loop of one n16 block per 64 pixels, one CTA a SM.
//
// The wide body (conv_single_wide_kernel, bf16), for kernels of at least 25
// taps: a persistent grid of CTAs, each of one channel block of NB = 8*NT*(8/WM)
// channels (n8 where O <= 8: every warp on M, no column past O = 8 is
// computed), walks output tiles of up to 32*WM pixels (16x16 at WM = 8),
// tile blockIdx.x, + gridDim.x, .... The block's whole weight is staged once
// per CTA and kept; the tiles' input regions come through a ring of two
// buffers (one where that lets two CTAs share a SM), cp.async bringing tile
// t+1's region while tile t computes where the input's channels make
// 16-byte copies, else loads eight values a thread in flight while the SM's
// other CTA computes. Where C < 8, K is packed across taps: a staged
// position holds the (dx, c) values of its kw taps, kw*C rounded up to 8
// (the stem: 27 -> 32, K = 9 x 32 = 288 for 243 values instead of 648); the
// region's rows are loaded as NHWC holds them (a position's taps are one
// run of its row) and unfolded along W into positions in shared memory; the
// tap walk is then over dy only. A per-CTA table gives each 8-value unit of
// K its offset from a pixel's first staged position (a tap's (dy, dx)
// shift, or a dy row), so one loop serves both layouts. mma.sync m16n8k16
// (two chains of sums, even and odd k-steps). The epilogue
// writes the fragments into a shared-memory tile and copies it out,
// 16-byte pieces where O allows. At the head's n8 block the k-loop reads
// 512 bytes of A from shared memory per mma: shared-memory bandwidth, not
// the tensor cores, bounds it (PERF.md).
//
// Under f32, where kw is 5, 7 or 9 and the block's weight fits, the wide
// body runs on the CUDA cores (conv_single_fma_kernel, below): exact f32
// products and sums; at these narrow channels 3xTF32's splits and n8 k8
// steps cost more than the products (measured at StyleTransfer's stem and
// head, PERF.md). Every other f32 conv runs on the tile body.
//
// The launch geometry (the body; tiles, images per CTA, channel blocks and
// chunks, taps per stage, strides, the shared-memory layout and, for the
// wide body, the packing, warps and grid) is the wrapper's (kernels/conv.py
// launch_geometry); this file checks it and launches.

#include "snn_common.cuh"
#include "snn_mma.cuh"

// Fields of the geometry array the wrapper passes.
// The wide body reads G_CC as the elements per staged position (C, or kw*C
// when packed, rounded up to 8), G_TG as the taps (all in its one stage)
// and G_IN_BUFS as the ring's depth (1 or 2).
enum {
  G_TILE_H, G_TILE_W, G_IMGS, G_NB, G_CC, G_TG, G_IN_STRIDE, G_W_STRIDE, G_W_ROWS,
  G_IN_OFF, G_IN_BUFS, G_W_OFF, G_W_BUFS, G_SMEM,
  G_BODY, G_PACKED, G_WM, G_TAB_OFF, G_OUT_OFF, G_OUT_STRIDE, G_GRID, G_FIELDS
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

// --------------------------------------------------------------- wide ----

struct WideDesc {
  int n, h, w, c, kh, kw, o, pt, pl, ho, wo;
  int act;
  float alpha;
  int wm, tile_h, tile_w, tiles_x, tiles_img, mtiles;
  int cols, region;            // staged region of a tile: rows x cols positions
  int packed, kp, kunits;      // elements per staged position (kp = 8 * kunits)
  int real;                    // the values of a position: c, or packed kw * c
  int units;                   // 8-value units of K (taps or dy rows, times kunits)
  int in_stride, w_stride, w_rows;  // elements per staged position / weight row; weight rows
  int tab_off, so_off, w_off, in_off, in_buf, out_off, out_stride, bufs;  // smem bytes
  int raw_off, raw_len;        // packed: the region's rows as NHWC holds them (raw_len values)
  int x_bf16, w_int8, vec_x, vec_y;
  FastDiv f_tiles_img, f_tiles_x, f_cols, f_kp, f_upp, f_tile_w, f_vpp, f_raw_len, f_kunits;
};

// NT: n8-tiles per warp (NB = 8 * NT * (8 / wm) channels per CTA). bf16
// compute; x is f32 or bf16 (d.x_bf16).
template <int NT>
__global__ void __launch_bounds__(SNN_TC_THREADS, 2)
conv_single_wide_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                        const float* __restrict__ scale, const float* __restrict__ offset,
                        __nv_bfloat16* __restrict__ y, const __grid_constant__ WideDesc d) {
  using T = __nv_bfloat16;
  constexpr int EPU = 8;  // elements per 16 bytes
  const float* xf = static_cast<const float*>(xv);
  const T* xb = static_cast<const T*>(xv);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % d.wm, wn = warp / d.wm;
  const int nb = 8 * NT * (8 / d.wm);  // channels of the CTA
  const int ob0 = blockIdx.y * nb;
  const int wcol = wn * 8 * NT;        // the warp's first channel within the block
  const int tile_px = d.tile_h * d.tile_w;
  int* tab = reinterpret_cast<int*>(smem + d.tab_off);
  float* so = reinterpret_cast<float*>(smem + d.so_off);  // the block's scale, then offset
  T* wb = reinterpret_cast<T*>(smem + d.w_off);
  T* ob = reinterpret_cast<T*>(smem + d.out_off);
  auto in_slot = [&](int b) { return reinterpret_cast<T*>(smem + d.in_off + b * d.in_buf); };

  // Each unit's offset (elements) from a pixel's first staged position: row
  // r of the table is a tap (dy, dx) or, packed, a dy row; the last entry,
  // for the padding unit of an odd count (bf16), is 0 (its B rows are zero,
  // so any finite A serves).
  for (int i = tid; i <= d.units; i += SNN_TC_THREADS) {
    int off = 0;
    if (i < d.units) {
      const int r = i / d.kunits, u = i - r * d.kunits;
      const int pos = d.packed ? r * d.cols : (r / d.kw) * d.cols + r % d.kw;
      off = pos * d.in_stride + 8 * u;
    }
    tab[i] = off;
  }
  for (int i = tid; i < nb; i += SNN_TC_THREADS) {
    so[i] = ob0 + i < d.o ? scale[ob0 + i] : 0.f;
    so[nb + i] = ob0 + i < d.o ? offset[ob0 + i] : 0.f;
  }
  // K index k (unit k / 8, value k % 8) as the HWIO row tap * c + ci of the
  // weight; -1 for padding (past C in a tap, past kw*C in a dy row, past K).
  auto k_row = [&](int k) -> int {
    const int u = k >> 3;
    if (u >= d.units) return -1;
    const int r = u / d.kunits, e = (u - r * d.kunits) * 8 + (k & 7);
    if (e >= d.real) return -1;
    // packed: (dy, dx, c) with e = dx * c + ci, contiguous in HWIO; else (tap, c)
    return (d.packed ? r * d.kw * d.c : r * d.c) + e;
  };
  // The channel block's whole weight, once, k-major ([k][nb], an int8
  // weight upcast exactly); zero past K and O.
  {
    const int cnt = min(nb, d.o - ob0);
    for (int k = tid; k < d.w_rows; k += SNN_TC_THREADS) {  // a K row a thread: its HWIO row once
      const int row = k_row(k);
#pragma unroll 8
      for (int r = 0; r < nb; ++r) {
        float v = 0.f;
        if (row >= 0 && r < cnt) {
          const size_t src = (size_t)row * d.o + ob0 + r;
          v = d.w_int8 ? (float)static_cast<const int8_t*>(wv)[src]
                       : __bfloat162float(static_cast<const T*>(wv)[src]);
        }
        store_out(wb + (size_t)k * d.w_stride + r, v);
      }
    }
  }
  // This lane's A rows: pixels 32*wm + 16*i + (lane & 15) of the tile, as
  // element offsets of their first staged position (0 past the tile).
  int a_base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = 32 * wm + 16 * i + (lane & 15);
    const int py = p / d.tile_w, px = p - py * d.tile_w;
    a_base[i] = p < tile_px ? (py * d.cols + px) * d.in_stride : 0;
  }

  const int my_tiles =
      (int)blockIdx.x < d.mtiles ? (d.mtiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto tile_origin = [&](int q, int& n0, int& oy0, int& ox0) {
    const int tile = (int)blockIdx.x + q * (int)gridDim.x;
    n0 = fdiv(tile, d.f_tiles_img);
    const int tt = tile - n0 * d.tiles_img;
    const int ty = fdiv(tt, d.f_tiles_x);
    oy0 = ty * d.tile_h;
    ox0 = (tt - ty * d.tiles_x) * d.tile_w;
  };

  // The input region of this CTA's tile q into slot q % bufs, zero outside
  // the image: a position holds its C channels or, packed, the kw*C values
  // of its kw taps (contiguous in NHWC), then zeros up to kp.
  auto load_tile = [&](int q) {
    int n0, oy0, ox0;
    tile_origin(q, n0, oy0, ox0);
    const int iy0 = oy0 - d.pt, ix0 = ox0 - d.pl;
    T* dst = in_slot(q % d.bufs);
    if (d.vec_x) {  // unpacked, x bf16: 16 bytes of channels per copy
      const int upp = d.kp / EPU;
      for (int i = tid; i < d.region * upp; i += SNN_TC_THREADS) {
        const int pos = fdiv(i, d.f_upp), u = i - pos * upp;
        const int rr = fdiv(pos, d.f_cols), cl = pos - rr * d.cols;
        const int gy = iy0 + rr, gx = ix0 + cl, c = u * EPU;
        const bool ok = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w && c < d.c;
        const T* src = ok ? xb + (((size_t)n0 * d.h + gy) * d.w + gx) * d.c + c : xb;
        cp_async16(dst + (size_t)pos * d.in_stride + u * EPU, src, ok ? 16 : 0);
      }
    } else if (d.packed) {
      // The region's rows as they lie in NHWC (tile_w + kw - 1 pixels of C
      // values: raw_len), zero outside the image, eight loads in flight a
      // thread; then each position's kp values, the run of its kw taps
      // (raw values cl * C ..), one 16-byte unit a thread.
      T* raw = reinterpret_cast<T*>(smem + d.raw_off);
      const int row_len = d.w * d.c, total = (d.tile_h + d.kh - 1) * d.raw_len;
      for (int i0 = tid; i0 < total; i0 += 8 * SNN_TC_THREADS) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + j * SNN_TC_THREADS;
          const int rr = fdiv(i, d.f_raw_len), f = i - rr * d.raw_len;
          const int gy = iy0 + rr, flat = ix0 * d.c + f;
          v[j] = 0.f;
          if (i < total && gy >= 0 && gy < d.h && flat >= 0 && flat < row_len) {
            const size_t src = ((size_t)n0 * d.h + gy) * row_len + flat;
            v[j] = d.x_bf16 ? __bfloat162float(xb[src]) : xf[src];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (i0 + j * SNN_TC_THREADS < total) store_out(raw + i0 + j * SNN_TC_THREADS, v[j]);
      }
      __syncthreads();
      for (int i = tid; i < d.region * d.kunits; i += SNN_TC_THREADS) {
        const int pos = fdiv(i, d.f_kunits), u = i - pos * d.kunits;
        const int rr = fdiv(pos, d.f_cols), cl = pos - rr * d.cols;
        const T* src = raw + rr * d.raw_len + cl * d.c + 8 * u;
        __align__(16) T v8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v8[j] = 8 * u + j < d.real ? src[j] : T(0.f);
        *reinterpret_cast<uint4*>(dst + (size_t)pos * d.in_stride + 8 * u) =
            *reinterpret_cast<const uint4*>(v8);
      }
      __syncthreads();  // raw is read out: the next tile's rows may land in it
    } else {
      // Value by value, converted to the compute dtype, eight loads in
      // flight a thread; zero past C and outside the image.
      const int total = d.region * d.kp, row_len = d.w * d.c;
      for (int i0 = tid; i0 < total; i0 += 8 * SNN_TC_THREADS) {
        float v[8];
        int at[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + j * SNN_TC_THREADS;
          v[j] = 0.f;
          at[j] = -1;
          if (i < total) {
            const int pos = fdiv(i, d.f_kp), e = i - pos * d.kp;
            const int rr = fdiv(pos, d.f_cols), cl = pos - rr * d.cols;
            const int gy = iy0 + rr, flat = (ix0 + cl) * d.c + e;
            at[j] = pos * d.in_stride + e;
            if (e < d.real && gy >= 0 && gy < d.h && flat >= 0 && flat < row_len) {
              const size_t src = ((size_t)n0 * d.h + gy) * row_len + flat;
              v[j] = d.x_bf16 ? __bfloat162float(xb[src]) : xf[src];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (at[j] >= 0) store_out(dst + at[j], v[j]);
      }
    }
  };

  // The f32 sums: even k-steps in acc, odd in acc2 (two independent chains
  // of mma.sync per fragment).
  float acc[2][NT][4], acc2[2][NT][4];
  for (int q = 0; q < d.bufs - 1; ++q) {
    if (q < my_tiles) load_tile(q);
    cp_async_commit();
  }
  for (int q = 0; q < my_tiles; ++q) {
    if (q + d.bufs - 1 < my_tiles) load_tile(q + d.bufs - 1);
    cp_async_commit();
    if (d.bufs > 1) {
      cp_async_wait<1>();  // tile q has landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // (everyone's; the weights and table too, at q = 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = acc2[i][j][r] = 0.f;
    const T* ib = in_slot(q % d.bufs);
    // k16 steps of two units: lanes 0-15 give the first unit's rows,
    // lanes 16-31 the second's; B rows: k row (lane & 15) of the step.
    const __nv_bfloat16* b_lane =
        wb + (size_t)(lane & 15) * d.w_stride + wcol + (lane >> 4) * 8;
    auto step = [&](int ks, float (&ac)[2][NT][4]) {
      const int off = tab[2 * ks + (lane >> 4)];
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], ib + a_base[i] + off);
      const __nv_bfloat16* bp = b_lane + (size_t)16 * ks * d.w_stride;
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, bp);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(ac[i][0], a[i], b[0], b[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bp + j * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(ac[i][j], a[i], b[0], b[1]);
            mma_bf16(ac[i][j + 1], a[i], b[2], b[3]);
          }
        }
      }
    };
    const int nks = (d.units + 1) / 2;
    int ks = 0;
#pragma unroll 2
    for (; ks + 1 < nks; ks += 2) {
      step(ks, acc);
      step(ks + 1, acc2);
    }
    if (ks < nks) step(ks, acc);

    // Epilogue: the fragments (rows g, g + 8 of each m16 tile, columns
    // 8j + 2t, +1) into the output tile, then the tile's pixels out.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 32 * wm + 16 * i + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = wcol + 8 * j + 2 * t;  // columns past O are never copied out
          const float v0 = apply_act(fmaf(acc[i][j][2 * hh] + acc2[i][j][2 * hh], so[col],
                                          so[nb + col]), d.act, d.alpha);
          const float v1 = apply_act(fmaf(acc[i][j][2 * hh + 1] + acc2[i][j][2 * hh + 1],
                                          so[col + 1], so[nb + col + 1]), d.act, d.alpha);
          store_pair(ob + (size_t)p * d.out_stride + col, v0, v1);
        }
      }
    __syncthreads();
    int n0, oy0, ox0;
    tile_origin(q, n0, oy0, ox0);
    const int cnt = min(nb, d.o - ob0);  // the last block may hold fewer channels
    if (d.vec_y) {  // 16-byte pieces of each pixel's channels (o * esz a multiple of 16)
      const int vpp = nb / EPU;
      for (int i = tid; i < tile_px * vpp; i += SNN_TC_THREADS) {
        const int p = fdiv(i, d.f_vpp), v = i - p * vpp;
        const int py = fdiv(p, d.f_tile_w), px = p - py * d.tile_w;
        const int gy = oy0 + py, gx = ox0 + px;
        if (gy < d.ho && gx < d.wo && v * EPU < cnt)
          *reinterpret_cast<uint4*>(y + (((size_t)n0 * d.ho + gy) * d.wo + gx) * d.o + ob0 +
                                    v * EPU) =
              *reinterpret_cast<const uint4*>(ob + (size_t)p * d.out_stride + v * EPU);
      }
    } else {  // value by value: the tile's pixels' cnt channels, contiguous runs of NHWC
      for (int i = tid; i < tile_px * cnt; i += SNN_TC_THREADS) {
        const int p = i / cnt, e = i - p * cnt;
        const int py = fdiv(p, d.f_tile_w), px = p - py * d.tile_w;
        const int gy = oy0 + py, gx = ox0 + px;
        if (gy < d.ho && gx < d.wo)
          y[(((size_t)n0 * d.ho + gy) * d.wo + gx) * d.o + ob0 + e] =
              ob[(size_t)p * d.out_stride + e];
      }
    }
    __syncthreads();  // the slot and the output tile are free again
  }
}

template <int NT>
int launch_wide(const void* x, const void* w, const float* scale, const float* offset, void* y,
                const WideDesc& d, int grid_x, int smem, cudaStream_t s) {
  auto kern = conv_single_wide_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = 8 * NT * (8 / d.wm);
  dim3 grid(grid_x, (d.o + nb - 1) / nb);
  kern<<<grid, SNN_TC_THREADS, smem, s>>>(x, w, scale, offset,
                                          static_cast<__nv_bfloat16*>(y), d);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ------------------------------------------------------- wide, f32 FMA ----

struct FmaDesc {
  int n, h, w, c, kh, kw, o, pt, pl, ho, wo;
  int act;
  float alpha;
  int g, s;                        // channel groups x segments = the 8 warps
  int tile_w, tiles_x, tiles_img, mtiles;  // tiles of 32 rows x tile_w columns
  int cc, chunks, rows, cols, cstride, plane;  // a chunk's planes: rows x cstride floats
  int so_off, w_off, in_off, in_buf, bufs;     // smem bytes
  int x_bf16;
  FastDiv f_tiles_img, f_tiles_x, f_cc, f_cols, f_chunks;
};

// The wide body's f32 form on the CUDA cores: exact f32 products and sums
// (fmaf), for narrow channels, where 3xTF32's splits and n8 k8 steps
// cost more than the products (PERF.md). A CTA of 8 warps, g
// channel groups of OB channels x s segments of PX columns, walks tiles of
// 32 rows x s*PX columns: lane = row, so each lane keeps PX x OB sums of
// its row segment. The input region comes in chunks of cc channels, one
// plane per channel (rows of cstride floats, an odd number of 16-byte
// units: the lanes' 16-byte loads are free of bank conflicts), by 4-byte
// cp.async (a bf16 input: eight loads in flight a thread, converted) into a
// ring of two buffers; the block's weight is staged once,
// [group][dy][c][dx][OBP] (OB padded to 4 or 8 floats), read as 16-byte
// broadcasts. Per (c, dy) a lane loads its row segment (PX + KW - 1 values)
// once and reuses it over the KW taps of the row.
template <int KW, int OB>
__global__ void __launch_bounds__(SNN_TC_THREADS, 2)
conv_single_fma_kernel(const void* __restrict__ xv, const float* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ offset,
                       float* __restrict__ y, const __grid_constant__ FmaDesc d) {
  constexpr int PX = OB == 8 ? 8 : 4;       // columns per lane
  constexpr int OBP = OB <= 4 ? 4 : 8;      // a tap's staged channels
  constexpr int XN = (PX + KW - 1 + 3) / 4 * 4;  // a row segment, whole 16-byte units
  const float* xf = static_cast<const float*>(xv);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(xv);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / d.s, seg = warp - grp * d.s;
  const int nb = d.g * OB;
  const int ob0 = blockIdx.y * nb;
  float* so = reinterpret_cast<float*>(smem + d.so_off);
  float* wsm = reinterpret_cast<float*>(smem + d.w_off);
  constexpr int WROW = KW * OBP;  // floats of one (group, dy, c)
  const int w_total = d.g * d.kh * d.c * WROW;
  for (int i0 = tid; i0 < w_total; i0 += 8 * SNN_TC_THREADS) {  // eight loads in flight
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * SNN_TC_THREADS;
      int rest = i / OBP;
      const int oo = i - rest * OBP;
      const int dx = rest % KW;
      rest /= KW;
      const int ci = rest % d.c;
      rest /= d.c;
      const int dy = rest % d.kh, gg = rest / d.kh;
      const int oc = ob0 + gg * OB + oo;
      v[j] = i < w_total && oo < OB && oc < d.o
                 ? w[((size_t)(dy * KW + dx) * d.c + ci) * d.o + oc] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j * SNN_TC_THREADS < w_total) wsm[i0 + j * SNN_TC_THREADS] = v[j];
  }
  for (int i = tid; i < nb; i += SNN_TC_THREADS) {
    so[i] = ob0 + i < d.o ? scale[ob0 + i] : 0.f;
    so[nb + i] = ob0 + i < d.o ? offset[ob0 + i] : 0.f;
  }

  const int my_tiles =
      (int)blockIdx.x < d.mtiles ? (d.mtiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int items = my_tiles * d.chunks;
  auto tile_origin = [&](int tl, int& n0, int& oy0, int& ox0) {
    const int tile = (int)blockIdx.x + tl * (int)gridDim.x;
    n0 = fdiv(tile, d.f_tiles_img);
    const int tt = tile - n0 * d.tiles_img;
    const int ty = fdiv(tt, d.f_tiles_x);
    oy0 = ty * 32;
    ox0 = (tt - ty * d.tiles_x) * d.tile_w;
  };
  auto slot = [&](int q) {
    return reinterpret_cast<float*>(smem + d.in_off + (q % d.bufs) * d.in_buf);
  };
  // Item q: chunk q % chunks of tile q / chunks, zero outside the image and
  // past C; channels fastest, as NHWC holds them.
  auto load_item = [&](int q) {
    const int tl = fdiv(q, d.f_chunks), ci = q - tl * d.chunks;
    int n0, oy0, ox0;
    tile_origin(tl, n0, oy0, ox0);
    const int iy0 = oy0 - d.pt, ix0 = ox0 - d.pl, c0 = ci * d.cc;
    float* dst = slot(q);
    const int total = d.rows * d.cols * d.cc;
    if (!d.x_bf16) {  // f32: 4-byte cp.async, zero-filled outside the image and past C
      for (int i = tid; i < total; i += SNN_TC_THREADS) {
        const int pos = fdiv(i, d.f_cc), e = i - pos * d.cc;
        const int rr = fdiv(pos, d.f_cols), cl = pos - rr * d.cols;
        const int gy = iy0 + rr, gx = ix0 + cl, c = c0 + e;
        const bool ok = c < d.c && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
        cp_async4(dst + e * d.plane + rr * d.cstride + cl,
                  ok ? xf + (((size_t)n0 * d.h + gy) * d.w + gx) * d.c + c : xf, ok);
      }
      return;
    }
    for (int i0 = tid; i0 < total; i0 += 8 * SNN_TC_THREADS) {  // bf16: eight loads in flight
      float v[8];
      int at[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * SNN_TC_THREADS;
        v[j] = 0.f;
        at[j] = -1;
        if (i < total) {
          const int pos = fdiv(i, d.f_cc), e = i - pos * d.cc;
          const int rr = fdiv(pos, d.f_cols), cl = pos - rr * d.cols;
          const int gy = iy0 + rr, gx = ix0 + cl, c = c0 + e;
          at[j] = e * d.plane + rr * d.cstride + cl;
          if (c < d.c && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w) {
            const size_t src = (((size_t)n0 * d.h + gy) * d.w + gx) * d.c + c;
            v[j] = __bfloat162float(xb[src]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (at[j] >= 0) dst[at[j]] = v[j];
    }
  };

  float acc[PX][OB];
  for (int q = 0; q < d.bufs - 1; ++q) {
    if (q < items) load_item(q);
    cp_async_commit();
  }
  for (int q = 0; q < items; ++q) {
    if (q + d.bufs - 1 < items) load_item(q + d.bufs - 1);
    cp_async_commit();
    if (d.bufs > 1) {
      cp_async_wait<1>();  // item q has landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // (everyone's; the weights too, at q = 0)
    const int tl = fdiv(q, d.f_chunks), ci = q - tl * d.chunks;
    if (ci == 0) {
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int oo = 0; oo < OB; ++oo) acc[p][oo] = 0.f;
    }
    const int c0 = ci * d.cc, ccn = min(d.cc, d.c - c0);
    const float* xs = slot(q) + lane * d.cstride + seg * PX;
    for (int e = 0; e < ccn; ++e) {
      const float* xc = xs + e * d.plane;
      const float* wc = wsm + ((size_t)grp * d.kh * d.c + c0 + e) * WROW;
      for (int dy = 0; dy < d.kh; ++dy) {
        float xr[XN];
        const float4* xp = reinterpret_cast<const float4*>(xc + dy * d.cstride);
#pragma unroll
        for (int v = 0; v < XN / 4; ++v) {
          const float4 t4 = xp[v];
          xr[4 * v] = t4.x; xr[4 * v + 1] = t4.y; xr[4 * v + 2] = t4.z; xr[4 * v + 3] = t4.w;
        }
        const float4* wp = reinterpret_cast<const float4*>(wc + (size_t)dy * d.c * WROW);
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          float wv[OBP];
#pragma unroll
          for (int v = 0; v < OBP / 4; ++v) {
            const float4 t4 = wp[dx * (OBP / 4) + v];
            wv[4 * v] = t4.x; wv[4 * v + 1] = t4.y; wv[4 * v + 2] = t4.z; wv[4 * v + 3] = t4.w;
          }
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int oo = 0; oo < OB; ++oo) acc[p][oo] = fmaf(xr[p + dx], wv[oo], acc[p][oo]);
        }
      }
    }
    if (ci == d.chunks - 1) {
      // Epilogue: the lane's row segment, PX pixels x OB channels, out.
      int n0, oy0, ox0;
      tile_origin(tl, n0, oy0, ox0);
      const int gy = oy0 + lane, gx0 = ox0 + seg * PX, oc0 = ob0 + grp * OB;
      if (gy < d.ho) {
        float (&v)[PX][OB] = acc;  // the epilogue in place: no second set of registers
#pragma unroll
        for (int p = 0; p < PX; ++p)
#pragma unroll
          for (int oo = 0; oo < OB; ++oo)
            v[p][oo] = apply_act(fmaf(acc[p][oo], so[grp * OB + oo], so[nb + grp * OB + oo]),
                                 d.act, d.alpha);
        float* yr = y + (((size_t)n0 * d.ho + gy) * d.wo + gx0) * d.o + oc0;
        const bool whole = gx0 + PX <= d.wo && oc0 + OB <= d.o;
        if (whole && OB == d.o && (PX * OB) % 4 == 0 && (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
          // The segment's pixels hold every channel: one contiguous run.
          float4* yv = reinterpret_cast<float4*>(yr);
#pragma unroll
          for (int k = 0; k < PX * OB; k += 4)
            yv[k / 4] = make_float4(v[k / OB][k % OB], v[(k + 1) / OB][(k + 1) % OB],
                                    v[(k + 2) / OB][(k + 2) % OB], v[(k + 3) / OB][(k + 3) % OB]);
        } else if (whole && OB % 4 == 0 && d.o % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int oo = 0; oo < OB; oo += 4)
              *reinterpret_cast<float4*>(yr + (size_t)p * d.o + oo) =
                  make_float4(v[p][oo], v[p][oo + 1], v[p][oo + 2], v[p][oo + 3]);
        } else {
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int oo = 0; oo < OB; ++oo)
              if (gx0 + p < d.wo && oc0 + oo < d.o) yr[(size_t)p * d.o + oo] = v[p][oo];
        }
      }
    }
    __syncthreads();  // the slot of item q is free for item q + bufs
  }
}

template <int KW, int OB>
int launch_fma(const void* x, const void* w, const float* scale, const float* offset, void* y,
               const FmaDesc& d, int grid_x, int smem, cudaStream_t s) {
  auto kern = conv_single_fma_kernel<KW, OB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = d.g * OB;
  dim3 grid(grid_x, (d.o + nb - 1) / nb);
  kern<<<grid, SNN_TC_THREADS, smem, s>>>(x, static_cast<const float*>(w), scale, offset,
                                          static_cast<float*>(y), d);
  return (int)cudaGetLastError();
}

template <int KW>
int dispatch_fma(int ob, const void* x, const void* w, const float* scale, const float* offset,
                 void* y, const FmaDesc& d, int grid_x, int smem, cudaStream_t s) {
  switch (ob) {
    case 1: return launch_fma<KW, 1>(x, w, scale, offset, y, d, grid_x, smem, s);
    case 2: return launch_fma<KW, 2>(x, w, scale, offset, y, d, grid_x, smem, s);
    case 3: return launch_fma<KW, 3>(x, w, scale, offset, y, d, grid_x, smem, s);
    case 4: return launch_fma<KW, 4>(x, w, scale, offset, y, d, grid_x, smem, s);
    default: return launch_fma<KW, 8>(x, w, scale, offset, y, d, grid_x, smem, s);
  }
}

// [off, off + need) within [lo, hi), 16-byte aligned.
inline bool fits(long long off, long long need, long long lo, long long hi) {
  return off % 16 == 0 && off >= lo && off + need <= hi;
}

inline bool apart(long long a, long long na, long long b, long long nb) {
  return a + na <= b || b + nb <= a;
}

// The wide body's geometry checked and completed, then launched (bf16
// compute only).
int run_wide(const void* x, int x_bf16, void* y, const void* w, const float* scale,
             const float* offset, const TcDesc& t, const int* g, cudaStream_t s) {
  WideDesc d;
  d.n = t.n; d.h = t.h; d.w = t.w; d.c = t.c; d.kh = t.kh; d.kw = t.kw; d.o = t.o;
  d.pt = t.pt; d.pl = t.pl; d.ho = t.ho; d.wo = t.wo; d.act = t.act; d.alpha = t.alpha;
  d.x_bf16 = x_bf16; d.w_int8 = t.w_int8;
  constexpr int esz = 2, epu = 8;
  const int taps = d.kh * d.kw;
  const int nb = g[G_NB];
  d.wm = g[G_WM]; d.tile_h = g[G_TILE_H]; d.tile_w = g[G_TILE_W];
  d.packed = g[G_PACKED]; d.kp = g[G_CC]; d.bufs = g[G_IN_BUFS];
  d.in_stride = g[G_IN_STRIDE]; d.w_stride = g[G_W_STRIDE]; d.w_rows = g[G_W_ROWS];
  d.tab_off = g[G_TAB_OFF]; d.w_off = g[G_W_OFF]; d.in_off = g[G_IN_OFF];
  d.out_off = g[G_OUT_OFF]; d.out_stride = g[G_OUT_STRIDE];
  const long long smem = g[G_SMEM];
  const int grid_x = g[G_GRID];
  if (d.wm != 1 && d.wm != 2 && d.wm != 4 && d.wm != 8) return -4;
  const int nt = nb / (8 * (8 / d.wm));
  if ((nt != 1 && nt != 2 && nt != 4) || nb != 8 * nt * (8 / d.wm)) return -4;
  if (g[G_IMGS] != 1 || g[G_TG] != taps || g[G_W_BUFS] != 1) return -4;
  if (d.tile_h < 1 || d.tile_w < 1 || d.tile_h * d.tile_w > 32 * d.wm) return -4;
  if (d.packed != 0 && d.packed != 1) return -4;
  d.real = d.packed ? d.kw * d.c : d.c;  // values of a staged position
  if (d.kp % 8 || d.kp < d.real || d.kp >= d.real + 8) return -4;
  if (d.bufs != 1 && d.bufs != 2) return -4;
  if (d.in_stride < d.kp || d.in_stride % epu) return -4;
  d.kunits = d.kp / 8;
  d.units = (d.packed ? d.kh : taps) * d.kunits;
  // weights k-major: rows of nb channels, k16 steps
  if (d.w_stride < nb || d.w_stride % 8 || d.w_rows != (d.units + 1) / 2 * 16) return -4;
  if (d.out_stride < nb || d.out_stride % epu) return -4;
  d.tiles_x = (d.wo + d.tile_w - 1) / d.tile_w;
  d.tiles_img = d.tiles_x * ((d.ho + d.tile_h - 1) / d.tile_h);
  const long long mtiles = (long long)d.n * d.tiles_img;
  if (mtiles > 2147483647LL) return -2;
  d.mtiles = (int)mtiles;
  if (grid_x < 1 || grid_x > d.mtiles) return -4;
  d.cols = d.packed ? d.tile_w : d.tile_w + d.kw - 1;
  d.region = (d.tile_h + d.kh - 1) * d.cols;
  d.in_buf = (int)(((long long)d.region * d.in_stride * esz + 15) & ~15LL);
  d.so_off = d.tab_off + ((4 * (d.units + 1) + 15) & ~15);  // after the table
  const long long tab_bytes = d.so_off - d.tab_off + 8LL * nb;  // table, scale, offset
  const long long w_bytes = (long long)d.w_rows * d.w_stride * esz;
  const long long in_bytes = (long long)d.bufs * d.in_buf;
  const long long out_bytes = 32LL * d.wm * d.out_stride * esz;
  d.raw_len = (d.tile_w + d.kw - 1) * d.c;
  d.raw_off = (int)((d.out_off + out_bytes + 15) & ~15LL);  // packed: after the output tile
  const long long raw_bytes =
      d.packed ? (long long)(d.tile_h + d.kh - 1) * d.raw_len * esz : 0;
  auto inside = [&](long long off, long long need) {
    return off % 16 == 0 && off >= 0 && off + need <= smem;
  };
  if (smem > SNN_MAX_SMEM || !inside(d.tab_off, tab_bytes) || !inside(d.w_off, w_bytes) ||
      !inside(d.in_off, in_bytes) || !inside(d.out_off, out_bytes) ||
      !inside(d.raw_off, raw_bytes) ||
      !apart(d.tab_off, tab_bytes, d.w_off, w_bytes) ||
      !apart(d.tab_off, tab_bytes, d.in_off, in_bytes) ||
      !apart(d.tab_off, tab_bytes, d.out_off, out_bytes) ||
      !apart(d.w_off, w_bytes, d.in_off, in_bytes) ||
      !apart(d.w_off, w_bytes, d.out_off, out_bytes) ||
      !apart(d.in_off, in_bytes, d.out_off, out_bytes))
    return -2;
  d.vec_x = !d.packed && x_bf16 && d.c % epu == 0 && aligned16(x);
  // 16-byte output pieces where every block's channels are whole ones.
  d.vec_y = (d.o * esz) % 16 == 0 && nb % epu == 0 && aligned16(y);
  d.f_tiles_img = fast_div(d.tiles_img);
  d.f_tiles_x = fast_div(d.tiles_x);
  d.f_cols = fast_div(d.cols);
  d.f_kp = fast_div(d.kp);
  d.f_upp = fast_div(d.kp / epu);
  d.f_tile_w = fast_div(d.tile_w);
  d.f_vpp = fast_div(nb / epu > 0 ? nb / epu : 1);
  d.f_raw_len = fast_div(d.raw_len);
  d.f_kunits = fast_div(d.kunits);
  const int sm = (int)smem;
  switch (nt) {
    case 1: return launch_wide<1>(x, w, scale, offset, y, d, grid_x, sm, s);
    case 2: return launch_wide<2>(x, w, scale, offset, y, d, grid_x, sm, s);
    default: return launch_wide<4>(x, w, scale, offset, y, d, grid_x, sm, s);
  }
}

// The wide body's f32 form on the CUDA cores: its geometry checked and
// completed, then launched. G_WM is the warps along M (segments), G_NB the
// channels of a block (channel groups x OB), G_CC the channels per chunk,
// G_IN_STRIDE the floats per staged row, G_TAB_OFF the scale and offset.
int run_fma(const void* x, int x_bf16, void* y, const void* w, const float* scale,
            const float* offset, const TcDesc& t, const int* g, cudaStream_t s) {
  FmaDesc d;
  d.n = t.n; d.h = t.h; d.w = t.w; d.c = t.c; d.kh = t.kh; d.kw = t.kw; d.o = t.o;
  d.pt = t.pt; d.pl = t.pl; d.ho = t.ho; d.wo = t.wo; d.act = t.act; d.alpha = t.alpha;
  d.x_bf16 = x_bf16;
  if (t.w_int8) return -3;
  d.s = g[G_WM];
  if (d.s != 1 && d.s != 2 && d.s != 4 && d.s != 8) return -4;
  d.g = 8 / d.s;
  const int nb = g[G_NB], ob = nb / d.g;
  if (nb != d.g * ob || (ob != 1 && ob != 2 && ob != 3 && ob != 4 && ob != 8)) return -4;
  if (ob < 8 && d.g != 1) return -4;
  if (d.kw != 5 && d.kw != 7 && d.kw != 9) return -4;
  const int px = ob == 8 ? 8 : 4, obp = ob <= 4 ? 4 : 8, xn = (px + d.kw - 1 + 3) / 4 * 4;
  d.tile_w = g[G_TILE_W];
  if (g[G_TILE_H] != 32 || d.tile_w != d.s * px || g[G_IMGS] != 1) return -4;
  if (g[G_TG] != d.kh * d.kw || g[G_W_BUFS] != 1 || g[G_PACKED] != 0) return -4;
  d.cc = g[G_CC]; d.bufs = g[G_IN_BUFS]; d.cstride = g[G_IN_STRIDE];
  if (d.cc < 1 || d.cc > d.c || (d.bufs != 1 && d.bufs != 2)) return -4;
  d.rows = 32 + d.kh - 1;
  d.cols = d.tile_w + d.kw - 1;
  if (d.cstride < d.cols || d.cstride < (d.s - 1) * px + xn || d.cstride % 4) return -4;
  if (g[G_W_STRIDE] != d.kw * obp || g[G_W_ROWS] != d.g * d.kh * d.c) return -4;
  d.plane = d.rows * d.cstride;
  d.chunks = (d.c + d.cc - 1) / d.cc;
  d.tiles_x = (d.wo + d.tile_w - 1) / d.tile_w;
  d.tiles_img = d.tiles_x * ((d.ho + 31) / 32);
  const long long mtiles = (long long)d.n * d.tiles_img;
  if (mtiles * d.chunks > 2147483647LL) return -2;
  d.mtiles = (int)mtiles;
  const int grid_x = g[G_GRID];
  if (grid_x < 1 || grid_x > d.mtiles) return -4;
  d.so_off = g[G_TAB_OFF]; d.w_off = g[G_W_OFF]; d.in_off = g[G_IN_OFF];
  d.in_buf = (int)(((long long)d.cc * d.plane * 4 + 15) & ~15LL);
  const long long smem = g[G_SMEM];
  const long long so_bytes = 8LL * nb, w_bytes = 4LL * g[G_W_ROWS] * g[G_W_STRIDE];
  const long long in_bytes = (long long)d.bufs * d.in_buf;
  auto inside = [&](long long off, long long need) {
    return off % 16 == 0 && off >= 0 && off + need <= smem;
  };
  if (smem > SNN_MAX_SMEM || !inside(d.so_off, so_bytes) || !inside(d.w_off, w_bytes) ||
      !inside(d.in_off, in_bytes) || !apart(d.so_off, so_bytes, d.w_off, w_bytes) ||
      !apart(d.so_off, so_bytes, d.in_off, in_bytes) || !apart(d.w_off, w_bytes, d.in_off, in_bytes))
    return -2;
  d.f_tiles_img = fast_div(d.tiles_img);
  d.f_tiles_x = fast_div(d.tiles_x);
  d.f_cc = fast_div(d.cc);
  d.f_cols = fast_div(d.cols);
  d.f_chunks = fast_div(d.chunks);
  const int sm = (int)smem;
  switch (d.kw) {
    case 5: return dispatch_fma<5>(ob, x, w, scale, offset, y, d, grid_x, sm, s);
    case 7: return dispatch_fma<7>(ob, x, w, scale, offset, y, d, grid_x, sm, s);
    default: return dispatch_fma<9>(ob, x, w, scale, offset, y, d, grid_x, sm, s);
  }
}

// The wrapper's geometry checked and completed; the wide body (bf16) or its
// f32 form on the CUDA cores, or the tile body's bf16 form or (f32) its
// 3xTF32 form, launched.
int run(const void* x, int x_bf16, void* y, const void* w, const float* scale,
        const float* offset, TcDesc d, const int* g, bool bf16, cudaStream_t s) {
  if (g[G_BODY] == 1) return bf16 ? run_wide(x, x_bf16, y, w, scale, offset, d, g, s) : -4;
  if (g[G_BODY] == 2) return bf16 ? -4 : run_fma(x, x_bf16, y, w, scale, offset, d, g, s);
  if (g[G_BODY] != 0) return -4;
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
// f32 compute: the tile body takes the n-major f32 weight (o rows of
// kh*kw*c8, c zero-padded to a multiple of 8; kernels/conv.py
// nmajor_weight), 16-byte aligned, the wide body's CUDA-core form the HWIO
// f32 weight.
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
                    "apart within 227 KB, or more than 2^31 output tiles";
    case -3: return "shape outside the kernel's limits (c <= 128, o <= 128, kh*kw*c <= 4096), "
                    "or int8 weights under f32 activations";
    case -4: return "launch geometry outside the kernel (body, tile, channel block, warps, "
                    "chunk or packing, taps per stage, strides, buffers or grid), or an "
                    "unaligned f32 weight";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
