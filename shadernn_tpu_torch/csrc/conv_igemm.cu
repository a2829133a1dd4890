// Per-layer convolution as an implicit GEMM with a fused epilogue, on the
// tensor cores of Hopper (sm_90a).
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
// Function: x NHWC (N,H,W,C) f32 or bf16; w HWIO (kh,kw,C,O), the (K, O)
// matrix with K = kh*kw*C in (dy, dx, c) order, in x's dtype or int8
// (upcast as it is staged, exactly; the dequantisation scale arrives
// folded into `scale`); an f32 sum over K; y = act(acc * scale[o] +
// offset[o]) in f32, one rounding to x's dtype on store. Zero pads (pt,
// pb, pl, pr) may be asymmetric; a tap outside the image contributes an
// exact zero. Stride s >= 1: output (oy, ox) reads input (oy*s - pt + dy,
// ox*s - pl + dx).
//
// What bounds it on an H100: the main path's conv (the two-input graph,
// 8x540x960, C = 3+5 -> 16, k3) moves 48 bytes per output pixel at bf16
// (199 MB, 0.059 ms at 3.35 TB/s) for 9.6 GFLOP (0.01 ms on the bf16
// tensor cores): bytes bound it. A k3 conv over 64-128 channels is bound
// by its products. So the design streams large planes and keeps the
// products on the tensor cores.
//
// Design (B3's implicit GEMM, csrc/conv_single.cu, made persistent): the
// output is the (M, O) matrix, M = output pixels. A CTA of 8 warps owns a
// channel block of NB = 8*NT*WN output channels (blockIdx.y) and walks its
// 2-D output tiles of 32*WM pixels (tile_h x tile_w of one image), tile
// blockIdx.x, + gridDim.x, ...: the grid is one wave of the card. Warp w
// computes pixels 32*(w % WM).. (two m16 tiles) and channels 8*NT*(w / WM)..
// K is walked tap by tap in units of 8 input channels (C zero-padded), in
// chunks of cc channels and groups of tg taps where the stage would not
// fit; each (tile, chunk, group) is one item of a ring of `bufs` stages in
// shared memory, filled by cp.async `bufs - 1` items ahead, so a tile's
// input region (with its halo: (th-1)*s+kh rows) streams in while the
// tiles before it compute. One staged pixel's 8 bf16 channels are one
// 16-byte copy; a per-CTA table gives each unit's offset from a pixel's
// first tap, and ldmatrix takes one row address per output pixel, shifted
// by that offset, so the halo shift and the stride cost nothing. Where
// one stage holds every tap and channel the weights are staged once per
// CTA. The epilogue applies scale, offset and the activation to the C
// fragments, writes them into a shared-memory tile and copies it out in
// 16-byte stores, whole 32-byte sectors of NHWC rows.
//
// bf16: mma.sync m16n8k16 with f32 sums; B from the HWIO weight staged
// k-major ([k][NB], rows padded to an odd number of 16-byte units) and read
// with ldmatrix.trans; a k16 step is two units (a pair may straddle two
// taps). f32: 3xTF32 on mma.sync m16n8k8 (csrc/snn_mma.cuh), one k8 step
// per unit: A split into TF32 hi and lo in registers, B n-major (ldmatrix
// has no 32-bit transpose) and split into hi and lo on the host, once per
// weight tensor (kernels/conv_igemm.py); an int8 weight is exact in TF32,
// has no lo and skips its pass. A tap's a_hi b_hi products sum in
// accumulators of their own, added into the f32 sums with round-to-nearest
// adds after the tap: the tensor cores' accumulation truncates, and
// promoted per tap its error does not grow with K. The small passes (2^-11
// of the result) sum over all of K in a third set, whose truncation stays
// below f32's rounding; the sets are independent chains of mma.sync, whose
// latency, not its rate, would bound a single chain. bf16 alternates two
// sets of sums between k-steps for the same reason.
//
// The launch geometry (warp layout, tile, chunk, taps per stage, ring
// depth, strides, shared-memory layout, grid) is the wrapper's
// (kernels/conv_igemm.py launch_geometry); this file checks it and launches.

#include "snn_common.cuh"
#include "snn_mma.cuh"

// Fields of the geometry array the wrapper passes (IgemmLaunch).
enum {
  IG_NT, IG_WM, IG_TILE_H, IG_TILE_W, IG_CC, IG_TG, IG_BUFS, IG_IN_STRIDE, IG_W_STRIDE,
  IG_W_ROWS, IG_TAB_OFF, IG_IN_OFF, IG_W_OFF, IG_OUT_OFF, IG_OUT_STRIDE, IG_SMEM, IG_GRID,
  IG_FIELDS
};

namespace {

#define SNN_IG_THREADS 256

struct IgDesc {
  int n, h, w, c, kh, kw, o, stride, pt, pl, ho, wo;
  int act;
  float alpha;
  int wm, tile_h, tile_w, tiles_x, tiles_img, mtiles;
  int cols, region;             // staged region of a tile: rows x cols positions
  int cc, cunits, chunks, tg, groups, stages, bufs;
  int in_stride, w_stride, w_rows;  // elements per staged position / weight row; weight rows
  int tab_off, so_off, in_off, in_buf, w_off, w_buf, w_slots, out_off, out_stride;  // smem bytes
  int k_row;                    // f32: elements per row of the n-major weight (taps * C8)
  int vec_x, vec_w, w_int8, b_lo, vec_y;
  // Divisors of the per-tile index arithmetic.
  FastDiv f_tiles_img, f_tiles_x, f_cols, f_stage_unit, f_stages, f_groups, f_bufs, f_tile_w,
      f_copy_unit;
};

// Wait until at most n (0-3) committed groups of this thread are in flight.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// NT: n8-tiles per warp. F32: the 3xTF32 form (x, y f32), else bf16.
template <int NT, bool F32>
__global__ void __launch_bounds__(SNN_IG_THREADS, 2)
conv_igemm_tc_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                     const float* __restrict__ w_lo, const float* __restrict__ scale,
                     const float* __restrict__ offset, void* __restrict__ yv,
                     const __grid_constant__ IgDesc d) {
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  constexpr int EPU = F32 ? 4 : 8;  // elements per 16 bytes
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % d.wm, wn = warp / d.wm;
  const int nb = 8 * NT * (8 / d.wm);  // channels of the CTA
  const int ob0 = blockIdx.y * nb;
  const int wcol = wn * 8 * NT;        // the warp's first channel within the block
  const int tile_px = d.tile_h * d.tile_w;
  const int taps = d.kh * d.kw;
  int* tab = reinterpret_cast<int*>(smem + d.tab_off);
  auto in_slot = [&](int b) { return reinterpret_cast<T*>(smem + d.in_off + b * d.in_buf); };
  auto w_slot = [&](int b) { return reinterpret_cast<T*>(smem + d.w_off + b * d.w_buf); };
  T* ob = reinterpret_cast<T*>(smem + d.out_off);
  float* so = reinterpret_cast<float*>(smem + d.so_off);  // the block's scale, then offset

  // Each unit's offset (elements) from a pixel's first staged position;
  // the last entry, for the padding unit of an odd count, is 0 (its B
  // rows are zero, so any finite A serves).
  for (int i = tid; i <= taps * d.cunits; i += SNN_IG_THREADS) {
    const int tap = i / d.cunits, u = i - tap * d.cunits;
    tab[i] = tap < taps ? ((tap / d.kw) * d.cols + tap % d.kw) * d.in_stride + 8 * u : 0;
  }
  for (int i = tid; i < nb; i += SNN_IG_THREADS) {
    so[i] = ob0 + i < d.o ? scale[ob0 + i] : 0.f;
    so[nb + i] = ob0 + i < d.o ? offset[ob0 + i] : 0.f;
  }
  // This lane's A rows: pixels 32*wm + 16*i + (lane & 15) of the tile, as
  // element offsets of their first staged position (0 past the tile).
  int a_base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = 32 * wm + 16 * i + (lane & 15);
    const int py = p / d.tile_w, px = p - py * d.tile_w;
    a_base[i] = p < tile_px ? (py * d.cols + px) * d.stride * d.in_stride : 0;
  }

  const int my_tiles =
      (int)blockIdx.x < d.mtiles ? (d.mtiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int items = my_tiles * d.stages;
  auto tile_origin = [&](int tile, int& n0, int& oy0, int& ox0) {
    n0 = fdiv(tile, d.f_tiles_img);
    const int tt = tile - n0 * d.tiles_img;
    const int ty = fdiv(tt, d.f_tiles_x);
    oy0 = ty * d.tile_h;
    ox0 = (tt - ty * d.tiles_x) * d.tile_w;
  };
  auto slot = [&](int v) { return v - fdiv(v, d.f_bufs) * d.bufs; };  // v % bufs

  // The weights of (chunk ci, tap group grp) into slot b.
  auto load_weights = [&](int ci, int grp, int b) {
    const int c0 = ci * d.cc;
    T* dst = w_slot(b);
    if constexpr (F32) {
      // n-major: row r = output channel ob0 + r, column tap_l * cc + c_l;
      // hi rows, then lo rows; zero past the taps, C8 and O.
      const int c8 = (d.c + 7) & ~7;
      const int units = d.tg * d.cc / 4;  // 16-byte units of a staged row
      for (int i = tid; i < nb * units; i += SNN_IG_THREADS) {
        const int r = i / units, k = 4 * (i - r * units);
        const int tap_l = k / d.cc, cl = k - tap_l * d.cc;
        const int tap = grp * d.tg + tap_l, c = c0 + cl, oc = ob0 + r;
        const bool ok = tap_l < d.tg && tap < taps && c < c8 && oc < d.o;
        const size_t src = (size_t)oc * d.k_row + (size_t)tap * c8 + c;
        float* hi = dst + (size_t)r * d.w_stride + k;
        if (d.w_int8) {  // int8 n-major: four values, upcast (exact)
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) {
            const char4 q = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(wv) + src);
            v = make_float4((float)q.x, (float)q.y, (float)q.z, (float)q.w);
          }
          *reinterpret_cast<float4*>(hi) = v;
        } else {
          const float* wf = static_cast<const float*>(wv);
          cp_async16(hi, ok ? wf + src : wf, ok ? 16 : 0);
          if (d.b_lo) cp_async16(hi + (size_t)nb * d.w_stride, ok ? w_lo + src : w_lo, ok ? 16 : 0);
        }
      }
    } else {
      // k-major: row r = tap_l * cc + c_l, NB columns; zero past the taps, C and O.
      const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(wv);
      const int8_t* wq = static_cast<const int8_t*>(wv);
      if (d.w_int8 || d.vec_w) {  // 8 channels of a row per thread
        for (int i = tid; i < d.w_rows * (nb / 8); i += SNN_IG_THREADS) {
          const int r = i / (nb / 8), v = i - r * (nb / 8);
          const int tap_l = r / d.cc, cl = r - tap_l * d.cc;
          const int tap = grp * d.tg + tap_l, c = c0 + cl, oc = ob0 + v * 8;
          const bool ok = tap_l < d.tg && tap < taps && c < d.c && oc < d.o;
          __nv_bfloat16* dp = dst + (size_t)r * d.w_stride + v * 8;
          const size_t src = ((size_t)tap * d.c + c) * d.o + oc;
          if (d.w_int8) {  // upcast on the way in
            uint32_t q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float lo = ok && oc + 2 * j < d.o ? (float)wq[src + 2 * j] : 0.f;
              const float hi = ok && oc + 2 * j + 1 < d.o ? (float)wq[src + 2 * j + 1] : 0.f;
              q[j] = pack_bf16x2(lo, hi);
            }
            *reinterpret_cast<uint4*>(dp) = make_uint4(q[0], q[1], q[2], q[3]);
          } else {
            cp_async16(dp, ok ? wb + src : wb, ok ? 16 : 0);
          }
        }
      } else {
        for (int i = tid; i < d.w_rows * nb; i += SNN_IG_THREADS) {
          const int r = i / nb, j = i - r * nb;
          const int tap_l = r / d.cc, cl = r - tap_l * d.cc;
          const int tap = grp * d.tg + tap_l, c = c0 + cl, oc = ob0 + j;
          const bool ok = tap_l < d.tg && tap < taps && c < d.c && oc < d.o;
          dst[(size_t)r * d.w_stride + j] =
              ok ? wb[((size_t)tap * d.c + c) * d.o + oc] : __float2bfloat16_rn(0.f);
        }
      }
    }
  };

  // Item q of this CTA: tile q / stages, stage q % stages. Its input chunk
  // (when the stage opens one) and, where there are several stages, its
  // weights.
  auto load_item = [&](int q) {
    const int tl = fdiv(q, d.f_stages), s = q - tl * d.stages;
    const int ci = fdiv(s, d.f_groups), grp = s - ci * d.groups;
    if (grp == 0) {
      int n0, oy0, ox0;
      tile_origin((int)blockIdx.x + tl * (int)gridDim.x, n0, oy0, ox0);
      const int iy0 = oy0 * d.stride - d.pt, ix0 = ox0 * d.stride - d.pl;
      const int c0 = ci * d.cc;
      T* dst = in_slot(slot(tl * d.chunks + ci));
      if (d.vec_x) {  // 16 bytes of channels per copy
        const int upp = d.cc / EPU;
        for (int i = tid; i < d.region * upp; i += SNN_IG_THREADS) {
          const int pos = fdiv(i, d.f_stage_unit), u = i - pos * upp;
          const int rr = fdiv(pos, d.f_cols), cl = pos - rr * d.cols;
          const int gy = iy0 + rr, gx = ix0 + cl, c = c0 + u * EPU;
          const bool ok = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w && c < d.c;
          const T* src = ok ? x + (((size_t)n0 * d.h + gy) * d.w + gx) * d.c + c : x;
          cp_async16(dst + (size_t)pos * d.in_stride + u * EPU, src, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < d.region * d.cc; i += SNN_IG_THREADS) {
          const int pos = fdiv(i, d.f_stage_unit), e = i - pos * d.cc;
          const int rr = fdiv(pos, d.f_cols), cl = pos - rr * d.cols;
          const int gy = iy0 + rr, gx = ix0 + cl, c = c0 + e;
          T v = T(0.f);
          if (gy >= 0 && gy < d.h && gx >= 0 && gx < d.w && c < d.c)
            v = x[(((size_t)n0 * d.h + gy) * d.w + gx) * d.c + c];
          dst[(size_t)pos * d.in_stride + e] = v;
        }
      }
    }
    if (d.stages > 1) load_weights(ci, grp, slot(q));
  };

  // The f32 sums; bf16: even k-steps in acc, odd in acc2 (two independent
  // chains of mma.sync per fragment); f32: acc2 holds the small passes'
  // sums of the tap.
  float acc[2][NT][4], acc2[2][NT][4];
  if (d.stages == 1) load_weights(0, 0, 0);  // once: every tap and channel in one stage
  for (int q = 0; q < d.bufs - 1; ++q) {
    if (q < items) load_item(q);
    cp_async_commit();
  }
  for (int q = 0; q < items; ++q) {
    if (q + d.bufs - 1 < items) load_item(q + d.bufs - 1);
    cp_async_commit();
    cp_async_wait_n(d.bufs - 1);  // item q has landed (this thread's copies)
    __syncthreads();              // (everyone's)
    const int tl = fdiv(q, d.f_stages), s = q - tl * d.stages;
    const int ci = fdiv(s, d.f_groups), grp = s - ci * d.groups;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = acc2[i][j][r] = 0.f;
    }
    const T* ib = in_slot(slot(tl * d.chunks + ci));
    const T* wb = w_slot(d.stages > 1 ? slot(q) : 0);
    const int ntap = min(d.tg, taps - grp * d.tg), units = ntap * d.cunits;
    const int* tb = tab + grp * d.tg * d.cunits;
    if constexpr (F32) {
      // B rows: n row (lane & 7) (+8 for lanes 16-31) of the warp's tiles,
      // float 4 ((lane >> 3) & 1) of the k8 step; lo rows nb further.
      const float* b_lane = wb + (size_t)(wcol + (lane & 7) + 8 * (lane >> 4)) * d.w_stride +
                            4 * ((lane >> 3) & 1);
      const size_t lo_off = (size_t)nb * d.w_stride;
      for (int tl_ = 0; tl_ < ntap; ++tl_) {
        float tp[2][NT][4];  // the tap's sums of a_hi b_hi (the small passes go to acc2)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) tp[i][j][r] = 0.f;
        for (int u = 0; u < d.cunits; ++u) {  // one k8 step per unit
          const int ua = tl_ * d.cunits + u;
          const int off = tb[ua] + 4 * (lane >> 4);
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t a[4];
            ldmatrix_x4(a, ib + a_base[i] + off);
            split_tf32(a, ah[i], al[i]);
          }
          const float* bp = b_lane + ua * 8;
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            constexpr int NR = NT == 1 ? 2 : 4;
            uint32_t bh[NR], bl[NR];
            if constexpr (NT == 1) {
              uint32_t b2[2];
              ldmatrix_x2(b2, bp);
              bh[0] = b2[0]; bh[1] = b2[1];
              if (d.b_lo) { ldmatrix_x2(b2, bp + lo_off); bl[0] = b2[0]; bl[1] = b2[1]; }
            } else {
              uint32_t b4[4];
              ldmatrix_x4(b4, bp + (size_t)j * 8 * d.w_stride);
#pragma unroll
              for (int r = 0; r < 4; ++r) bh[r] = b4[r];
              if (d.b_lo) {
                ldmatrix_x4(b4, bp + lo_off + (size_t)j * 8 * d.w_stride);
#pragma unroll
                for (int r = 0; r < 4; ++r) bl[r] = b4[r];
              }
            }
#pragma unroll
            for (int h = 0; h < (NT == 1 ? 1 : 2); ++h)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                if (d.b_lo) mma_tf32(acc2[i][j + h], ah[i], bl[2 * h], bl[2 * h + 1]);
                mma_tf32(acc2[i][j + h], al[i], bh[2 * h], bh[2 * h + 1]);
                mma_tf32(tp[i][j + h], ah[i], bh[2 * h], bh[2 * h + 1]);
              }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += tp[i][j][r];
      }
    } else {
      // k16 steps of two units: lanes 0-15 give the first unit's rows,
      // lanes 16-31 the second's; B rows: k row (lane & 15) of the step.
      const __nv_bfloat16* b_lane =
          wb + (size_t)(lane & 15) * d.w_stride + wcol + (lane >> 4) * 8;
      const int pad = taps * d.cunits - grp * d.tg * d.cunits;  // the padding entry
      auto step = [&](int ks, float (&ac)[2][NT][4]) {
        const int ua = 2 * ks + (lane >> 4);
        const int off = tb[ua < units ? ua : pad];
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
      const int nks = (units + 1) / 2;
      int ks = 0;
      for (; ks + 1 < nks; ks += 2) {
        step(ks, acc);
        step(ks + 1, acc2);
      }
      if (ks < nks) step(ks, acc);
    }

    if (s == d.stages - 1) {
      // Epilogue: the fragments (rows g, g + 8 of each m16 tile, columns
      // 8j + 2t, +1) into the output tile, then whole rows out.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 32 * wm + 16 * i + g + 8 * h;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = wcol + 8 * j + 2 * t;  // columns past O are never copied out
            const float v0 = apply_act(fmaf(acc[i][j][2 * h] + acc2[i][j][2 * h], so[col],
                                            so[nb + col]), d.act, d.alpha);
            const float v1 = apply_act(fmaf(acc[i][j][2 * h + 1] + acc2[i][j][2 * h + 1],
                                            so[col + 1], so[nb + col + 1]), d.act, d.alpha);
            store_pair(ob + (size_t)p * d.out_stride + wcol + 8 * j + 2 * t, v0, v1);
          }
        }
      __syncthreads();
      int n0, oy0, ox0;
      tile_origin((int)blockIdx.x + tl * (int)gridDim.x, n0, oy0, ox0);
      const int cnt = min(nb, d.o - ob0);  // the last block may hold fewer channels
      if (d.vec_y) {  // 16-byte pieces of each pixel's channels
        const int vpp = nb / EPU;
        for (int i = tid; i < tile_px * vpp; i += SNN_IG_THREADS) {
          const int p = fdiv(i, d.f_copy_unit), v = i - p * vpp;
          const int py = fdiv(p, d.f_tile_w), px = p - py * d.tile_w;
          const int gy = oy0 + py, gx = ox0 + px;
          if (gy < d.ho && gx < d.wo && v * EPU < cnt)
            *reinterpret_cast<uint4*>(y + (((size_t)n0 * d.ho + gy) * d.wo + gx) * d.o + ob0 +
                                      v * EPU) =
                *reinterpret_cast<const uint4*>(ob + (size_t)p * d.out_stride + v * EPU);
        }
      } else {
        for (int i = tid; i < tile_px * nb; i += SNN_IG_THREADS) {
          const int p = fdiv(i, d.f_copy_unit), e = i - p * nb;
          const int py = fdiv(p, d.f_tile_w), px = p - py * d.tile_w;
          const int gy = oy0 + py, gx = ox0 + px;
          if (gy < d.ho && gx < d.wo && e < cnt)
            y[(((size_t)n0 * d.ho + gy) * d.wo + gx) * d.o + ob0 + e] =
                ob[(size_t)p * d.out_stride + e];
        }
      }
    }
    __syncthreads();  // the slots of item q are free for item q + bufs
  }
}

template <int NT, bool F32>
int launch(const void* x, const void* w, const float* w_lo, const float* scale,
           const float* offset, void* y, const IgDesc& d, int grid_x, int smem,
           cudaStream_t s) {
  auto kern = conv_igemm_tc_kernel<NT, F32>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = 8 * NT * (8 / d.wm);
  dim3 grid(grid_x, (d.o + nb - 1) / nb);
  kern<<<grid, SNN_IG_THREADS, smem, s>>>(x, w, w_lo, scale, offset, y, d);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// [off, off + need) within [0, smem), 16-byte aligned.
inline bool inside(long long off, long long need, long long smem) {
  return off % 16 == 0 && off >= 0 && off + need <= smem;
}

inline bool apart(long long a, long long na, long long b, long long nb) {
  return a + na <= b || b + nb <= a;
}

int run(const void* x, int x_bf16, const void* w, const float* w_lo, int w_int8, int b_lo,
        const float* scale, const float* offset, void* y, IgDesc d, const int* g,
        cudaStream_t s) {
  const bool f32 = !x_bf16;
  const int esz = f32 ? 4 : 2, epu = 16 / esz;
  const int nt = g[IG_NT];
  d.wm = g[IG_WM]; d.tile_h = g[IG_TILE_H]; d.tile_w = g[IG_TILE_W];
  d.cc = g[IG_CC]; d.tg = g[IG_TG]; d.bufs = g[IG_BUFS];
  d.in_stride = g[IG_IN_STRIDE]; d.w_stride = g[IG_W_STRIDE]; d.w_rows = g[IG_W_ROWS];
  d.tab_off = g[IG_TAB_OFF]; d.in_off = g[IG_IN_OFF]; d.w_off = g[IG_W_OFF];
  d.out_off = g[IG_OUT_OFF]; d.out_stride = g[IG_OUT_STRIDE];
  const long long smem = g[IG_SMEM];
  const int grid_x = g[IG_GRID];
  const int taps = d.kh * d.kw;
  if (nt != 1 && nt != 2 && nt != 4) return -4;
  if (d.wm != 1 && d.wm != 2 && d.wm != 4 && d.wm != 8) return -4;
  const int nb = 8 * nt * (8 / d.wm);
  if (d.tile_h < 1 || d.tile_w < 1 || d.tile_h * d.tile_w > 32 * d.wm) return -4;
  if (d.cc < 8 || d.cc % 8 || d.tg < 1 || d.tg > taps || d.bufs < 2 || d.bufs > 4) return -4;
  if (d.in_stride < d.cc || d.in_stride % epu) return -4;
  if (f32) {  // weights n-major: nb rows of the stage's k, hi then lo
    if (d.w_stride < d.tg * d.cc || d.w_stride % 4 || d.w_rows != nb) return -4;
    if (!aligned16(w) || (!w_int8 && b_lo && !aligned16(w_lo))) return -4;
  } else {  // weights k-major: rows of nb channels
    if (d.w_stride < nb || d.w_stride % 8 || d.w_rows < d.tg * d.cc || d.w_rows % 16) return -4;
  }
  if (d.out_stride < nb || d.out_stride % epu) return -4;
  d.cunits = d.cc / 8;
  d.chunks = (d.c + d.cc - 1) / d.cc;
  d.groups = (taps + d.tg - 1) / d.tg;
  d.stages = d.chunks * d.groups;
  d.tiles_x = (d.wo + d.tile_w - 1) / d.tile_w;
  d.tiles_img = d.tiles_x * ((d.ho + d.tile_h - 1) / d.tile_h);
  const long long mtiles = (long long)d.n * d.tiles_img;
  if (mtiles > 2147483647LL) return -2;
  d.mtiles = (int)mtiles;
  if (grid_x < 1 || grid_x > d.mtiles) return -4;
  const int rows = (d.tile_h - 1) * d.stride + d.kh;
  d.cols = (d.tile_w - 1) * d.stride + d.kw;
  d.region = rows * d.cols;
  d.in_buf = (d.region * d.in_stride * esz + 15) & ~15;
  d.w_slots = d.stages > 1 ? d.bufs : 1;
  d.w_buf = d.w_rows * d.w_stride * esz * (f32 ? 2 : 1);
  d.k_row = taps * ((d.c + 7) & ~7);
  d.so_off = (int)(((4LL * (taps * d.cunits + 1)) + 15) & ~15LL);  // after the table
  const long long tab_bytes = d.so_off + 8LL * nb;  // the table, then scale and offset
  const long long out_bytes = 32LL * d.wm * d.out_stride * esz;
  if (smem > SNN_MAX_SMEM || !inside(d.tab_off, tab_bytes, smem) ||
      !inside(d.in_off, (long long)d.bufs * d.in_buf, smem) ||
      !inside(d.w_off, (long long)d.w_slots * d.w_buf, smem) ||
      !inside(d.out_off, out_bytes, smem) ||
      !apart(d.tab_off, tab_bytes, d.in_off, (long long)d.bufs * d.in_buf) ||
      !apart(d.tab_off, tab_bytes, d.w_off, (long long)d.w_slots * d.w_buf) ||
      !apart(d.tab_off, tab_bytes, d.out_off, out_bytes) ||
      !apart(d.in_off, (long long)d.bufs * d.in_buf, d.w_off, (long long)d.w_slots * d.w_buf) ||
      !apart(d.in_off, (long long)d.bufs * d.in_buf, d.out_off, out_bytes) ||
      !apart(d.w_off, (long long)d.w_slots * d.w_buf, d.out_off, out_bytes))
    return -2;
  d.w_int8 = w_int8;
  d.b_lo = f32 && !w_int8 && b_lo;
  d.vec_x = d.c % epu == 0 && aligned16(x);
  d.vec_w = !f32 && !w_int8 && d.o % 8 == 0 && aligned16(w);
  // 16-byte output pieces where every block's channels are whole ones:
  // nb * esz is a multiple of 16 (nb >= 8), and so then is the last's.
  d.vec_y = (d.o * esz) % 16 == 0 && aligned16(y);
  d.f_tiles_img = fast_div(d.tiles_img);
  d.f_tiles_x = fast_div(d.tiles_x);
  d.f_cols = fast_div(d.cols);
  d.f_stage_unit = fast_div(d.vec_x ? d.cc / epu : d.cc);
  d.f_stages = fast_div(d.stages);
  d.f_groups = fast_div(d.groups);
  d.f_bufs = fast_div(d.bufs);
  d.f_tile_w = fast_div(d.tile_w);
  d.f_copy_unit = fast_div(d.vec_y ? nb / epu : nb);
  const int sm = (int)smem;
  if (f32) {
    switch (nt) {
      case 1: return launch<1, true>(x, w, w_lo, scale, offset, y, d, grid_x, sm, s);
      case 2: return launch<2, true>(x, w, w_lo, scale, offset, y, d, grid_x, sm, s);
      default: return launch<4, true>(x, w, w_lo, scale, offset, y, d, grid_x, sm, s);
    }
  }
  switch (nt) {
    case 1: return launch<1, false>(x, w, w_lo, scale, offset, y, d, grid_x, sm, s);
    case 2: return launch<2, false>(x, w, w_lo, scale, offset, y, d, grid_x, sm, s);
    default: return launch<4, false>(x, w, w_lo, scale, offset, y, d, grid_x, sm, s);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_conv_igemm_error), or the cudaError_t of the launch.
// x, y: device NHWC in f32 or bf16 (x_bf16). w: bf16 x: HWIO (kh*kw*c*o)
// bf16, or int8 when w_int8; f32 x: the n-major weight (o rows of
// kh*kw*c8, c zero-padded to a multiple of 8; kernels/conv_igemm.py
// nmajor_split), its TF32 hi part (f32; w_lo its lo part, read where b_lo)
// or, when w_int8, int8. scale, offset: device f32 (o). geom: IG_FIELDS
// ints, the wrapper's launch geometry (IgemmLaunch).
int snn_conv_igemm(const void* x, int x_bf16, const void* w, const float* w_lo, int w_int8,
                   int b_lo, const float* scale, const float* offset, void* y, int n, int h,
                   int wd, int c, int kh, int kw, int o, int stride, int pt, int pb, int pl,
                   int pr, int act, float alpha, const int* geom, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || kh < 1 || kw < 1 || stride < 1) return -1;
  if (pt < 0 || pb < 0 || pl < 0 || pr < 0) return -1;
  if (h + pt + pb < kh || wd + pl + pr < kw) return -1;
  IgDesc d;
  d.n = n; d.h = h; d.w = wd; d.c = c; d.kh = kh; d.kw = kw; d.o = o;
  d.pt = pt; d.pl = pl; d.stride = stride; d.act = act; d.alpha = alpha;
  d.ho = (h + pt + pb - kh) / stride + 1;
  d.wo = (wd + pl + pr - kw) / stride + 1;
  return run(x, x_bf16, w, w_lo, w_int8, b_lo, scale, offset, y, d, geom,
             static_cast<cudaStream_t>(stream));
}

const char* snn_conv_igemm_error(int code) {
  switch (code) {
    case -1: return "empty input, kernel or output, a negative pad or a stride below 1";
    case -2: return "more than 2^31 output tiles, or the launch geometry's shared-memory layout "
                    "does not hold its buffers apart within 227 KB";
    case -4: return "launch geometry outside the kernel (warps, tile, chunk, taps per stage, "
                    "ring depth, strides or grid), or an unaligned f32 weight";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
