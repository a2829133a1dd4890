// Fused inverted-residual block (MobileNetV2) for Hopper (sm_90a):
// [1x1 expand + epilogue + act] -> 3x3 stride-1 SAME depthwise + epilogue
// + act -> 1x1 project + epilogue [+ residual] -> act, in ONE kernel; the
// expanded tensor never goes through device memory.
//
// Replaces the TPU kernel of the JAX package
//   shadernn_tpu/kernels/block_pallas.py : _invres_kernel
//       (entry point fused_invres_block)
// whose flat and padded-pitch layouts are TPU details; this kernel takes
// NHWC in and gives NHWC out.
//
// Function (numerics of the JAX kernel; T is the compute dtype, the dtype
// of x): e = act_e(x @ w1 * s1 + o1) with an f32 sum, zero outside the
// image, rounded to T (the t=1 form, no expand, takes e = x); d =
// act_d(dw3x3(e) * sd + od) with f32 taps (the depthwise weight is NOT
// rounded to T) and an f32 sum, rounded to T; y = d @ w2 * s2 + o2 with an
// f32 sum, plus x when the block has a residual, then act_o, rounded to T.
// w1 and w2 are T, or int8 (their scales folded into s1 / s2), which the
// kernel reads as int8 and upcasts as it stages them (exact); the
// depthwise taps and the epilogue vectors f32, every int8 scale folded in.
//
// A8W8 (bf16 only; the JAX kernel's ax1 / ax2): under ax1 the expand runs
// q8(x) @ w1 with x quantized in the kernel, under ax2 the project runs
// q8(d) @ w2 with d after its activation and rounded to bf16; q8(v) =
// clip(rint(v * inv_ax), +-127) with inv_ax = 1/ax in f32, and the product
// int8 x int8 with s32 sums (exact), ax folded into s1 / s2 on the host.
//
// What bounds it on an H100: the blocks MobileNetV2 fuses (28x28 down to
// 7x7, E up to 960) do about 2 FLOPs per weight per pixel and read Cin and
// write Cout values per pixel, tens to hundreds of FLOPs per byte: with
// the expanded tensor kept on chip they are bound by operations on the
// tensor cores (a few microseconds for a whole MobileNetV2 step in bf16,
// about 16 in f32's 3xTF32: three TF32 products at half the bf16 rate).
// What the design secures is the traffic: each input pixel is read about
// once (plus a one-pixel halo), each output written once, nothing else
// leaves the chip. What is left is latency:
// the dependent phases of each E chunk, the halo recompute and filling
// 132 SMs with few tiles.
//
// Design: one CTA per (image, tile of TH x TW output pixels, at most 8x8,
// slice of E), 256 threads. The CTA stages its input tile with a one-pixel
// halo in shared memory and walks its slice of E in chunks of 32 channels.
// For each chunk it recomputes the expanded halo tile (masked to exact
// zeros outside the image, rounded), runs the depthwise over the tile with
// the taps in registers (rounded), and adds d_chunk @ W2[chunk, :] into an
// f32 accumulator held in registers. Small images give few tiles, so when
// the tiles alone would leave SMs idle, E is split over the CTAs of a
// thread-block cluster (up to 8): each writes its partial sums to its
// shared memory and, after a cluster barrier, each finishes a share of the
// outputs by adding the partials of every CTA of the cluster in rank order
// (distributed shared memory; deterministic). The summation order over E
// differs from the TPU kernel's whole-E dot.
//
// bf16 puts both 1x1 products (about 95% of the FLOPs) on the tensor
// cores, mma.sync m16n8k16 with f32 accumulators: the expand multiplies
// the halo tile (rows padded to 16, Cin to 16, staged as bf16) by the
// chunk of w1, and its epilogue (s1, o1, act, the mask, the rounding)
// runs on the fragments; the project multiplies d [pixels][32] by the
// chunk of w2, each warp holding 16 pixels x a share of Cout in f32
// fragments. The depthwise stays on the CUDA cores with f32 taps. cp.async
// brings the next chunk's w1, w2, taps and vectors in while the current
// chunk computes (two buffers). Rows in shared memory are padded to an
// odd number of 16-byte units, so that ldmatrix is free of bank conflicts.
//
// The A8W8 products run mma.sync m16n8k32 s8 with s32 accumulators. The
// quantized input tile (rows of Cin padded to 32 plus a 16-byte unit) is
// made once per CTA from the staged bf16 tile; the int8 d chunk is a
// [pixels][32] tile of rows of 48 bytes, one k32 step. ldmatrix has no
// 8-bit transpose, so w1 and w2 come n-major from the host (w1q: E rows of
// Cin, w2q: Cout rows of E, both padded to 32) and are staged as rows of
// an odd number of 16-byte units. The project's int32 chunk sums are added
// into the f32 accumulators; they stay exact, since E <= 1024 keeps every
// sum under 2^24 (E x 127^2). The int8 form (int8 weights, upcast to bf16
// as they are staged or, under ax1 / ax2, fed to the s8 products) is its
// own instantiation of the bf16 kernel, so that a block with bf16 weights
// runs no int8 code.
//
// f32 runs both products in 3xTF32 on the same tiles (mma.sync m16n8k8 tf32,
// f32 accumulators; csrc/snn_mma.cuh): each operand split into a TF32 hi
// and lo in registers after its fragment load, three passes per product,
// about f32's accuracy (the JAX package runs f32 at HIGHEST precision).
// ldmatrix has no 32-bit transpose, so w1 and w2 come n-major from the host
// (w1n: E rows of Cin padded to 8, w2n: Cout rows of E padded to 32; made
// once per operand set) and are staged as rows of an odd number of 16-byte
// units, as the staged f32 tiles are. The form with int8 weights (its own
// instantiation) reads the n-major int8 w1q / w2q of the A8W8 form and
// upcasts them as they are staged: exact in TF32, so those products take
// two passes. In the expand each pass sums in an accumulator of its own
// (the chains of dependent products set its time). The
// depthwise, e and d stay f32 (nothing rounded). The wrapper gives two
// buffers of the chunk weights or, where its cost model finds that
// cheaper or no tile holds two, one: the next chunk is then staged after
// the current one.
//
// The launch geometry (tile, split of E, strides and the shared-memory
// layout) is the wrapper's (kernels/invres.py pick_launch); this file
// checks it and launches.

#include <cooperative_groups.h>
#include "snn_common.cuh"
#include "snn_mma.cuh"

#define SNN_EC 32            // expanded channels per chunk (one per lane)
#define SNN_MAX_TILE 64      // pixels of a tile (4 warps of 16 rows)
#define SNN_MAX_COUT 320
#define SNN_THREADS 256
#define SNN_ES 40            // bf16 per row of es, ds and w1s: 32 + 8
#define SNN_ESF 36           // f32 per row of the f32 form's es, ds and staged w2: 32 + 4

// Fields of the geometry array the wrapper passes (offsets and buffer
// sizes in bytes, strides in elements).
enum {
  G_TILE_H, G_TILE_W, G_SPLIT, G_XS_STRIDE, G_W2_STRIDE, G_XS_OFF, G_ES_OFF, G_DS_OFF,
  G_W1_OFF, G_WD_OFF, G_W2_OFF, G_RED_OFF, G_W1_BUF, G_WD_BUF, G_W2_BUF, G_SMEM,
  G_Q_STRIDE, G_XQ_OFF, G_BUFS, G_FIELDS
};

#define SNN_QROW 48          // bytes per row of the int8 d chunk and staged int8 w2: 32 + 16

namespace cg = cooperative_groups;

namespace {

struct InvResDesc {
  int n, h, w, cin, e, cout;
  int has_expand, residual;
  int act_e, act_d, act_o;
  float alpha;
  int tile_h, tile_w, tiles_x;
  int split;      // CTAs of the cluster that share the tile's E (gridDim.z)
  int xs_stride;  // staged input row: f32 cin rounded up to 8, + 4; bf16 >= cin rounded up to 16
  int w2_stride;  // staged w2 row: f32 SNN_ESF (n-major); bf16 >= cout rounded up to 8
  int xs_off, es_off, ds_off, w1_off, wd_off, w2_off, red_off;  // smem bytes
  int w1_buf, wd_buf, w2_buf;  // bytes of one buffer
  int bufs;                    // buffers of the chunk weights: bf16 2, f32 1 or 2
  int vec_x, vec_w1, vec_wd, vec_w2;  // 16-byte cp.async loads
  int q1, q2;                  // A8W8 expand / project (bf16 only)
  float inv_ax1, inv_ax2;      // 1/ax1, 1/ax2 (f32)
  int q_stride, xq_off;        // q1: bytes per row of the int8 input tile and of staged w1
  int w1_i8, w2_i8;            // int8 w1 / w2 in the k-major layout, upcast as staged
};

__host__ __device__ __forceinline__ int round32(int v) { return (v + 31) & ~31; }

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// The first n (<= 8; none where n <= 0) int8 values at p as 8 bf16 (exact),
// zero past n.
__device__ __forceinline__ uint4 upcast_s8x8(const int8_t* p, int n) {
  uint32_t q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = pack_bf16x2(2 * j < n ? (float)p[2 * j] : 0.f, 2 * j + 1 < n ? (float)p[2 * j + 1] : 0.f);
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// --------------------------------------------------------------- bf16 ----

typedef __nv_bfloat16 bf16;

// NT: the project's n8-tiles per warp (warps over Cout: 8 / (pixel rows / 16)).
// Q: the int8 form (int8 weights: w1_i8 / w2_i8, or ax1 / ax2 set); a
// kernel without it is compiled without any int8 code.
template <int NT, bool Q>
__global__ void __launch_bounds__(SNN_THREADS, NT <= 8 ? 3 : 1)  // 3 CTAs per SM where they fit
invres_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                 const void* __restrict__ w1v, const float* __restrict__ s1,
                 const float* __restrict__ o1, const float* __restrict__ wd,
                 const float* __restrict__ sd, const float* __restrict__ od,
                 const void* __restrict__ w2v, const float* __restrict__ s2,
                 const float* __restrict__ o2, const __grid_constant__ InvResDesc d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // bf16 weights; (q1 / q2) the n-major int8 w1q (E x cin32) / w2q (Cout x
  // E32); or (w1_i8 / w2_i8) the k-major int8 weights, read through the same
  // int8 pointers.
  const bf16* w1 = static_cast<const bf16*>(w1v);
  const bf16* w2 = static_cast<const bf16*>(w2v);
  const int8_t* w1q = static_cast<const int8_t*>(w1v);
  const int8_t* w2q = static_cast<const int8_t*>(w2v);
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw + d.xq_off);  // q1: [HP16][q_stride]
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + d.xs_off);  // [HP16][xs_stride] input tile + halo
  bf16* es = reinterpret_cast<bf16*>(smem_raw + d.es_off);  // [HP16][ES] expanded chunk
  bf16* ds = reinterpret_cast<bf16*>(smem_raw + d.ds_off);  // [P16][ES] depthwise output chunk
  // Two buffers each: w1 [cin16][ES], taps and vectors [13][EC] f32, w2 [EC][w2_stride].
  auto w1s = [&](int b) { return reinterpret_cast<bf16*>(smem_raw + d.w1_off + b * d.w1_buf); };
  auto wds = [&](int b) { return reinterpret_cast<float*>(smem_raw + d.wd_off + b * d.wd_buf); };
  auto w2s = [&](int b) { return reinterpret_cast<bf16*>(smem_raw + d.w2_off + b * d.w2_buf); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / d.tiles_x) * d.tile_h;
  const int tx0 = (blockIdx.x % d.tiles_x) * d.tile_w;
  const int HC = d.tile_w + 2, HP = (d.tile_h + 2) * HC, HP16 = round16(HP);
  const int P = d.tile_h * d.tile_w, P16 = round16(P);
  const int cin = d.cin, cin16 = round16(cin), cout = d.cout, xst = d.xs_stride;
  const int nt_total = (cout + 7) / 8;

  // Input tile + one-pixel halo as bf16 (x is bf16: exact), zero outside
  // the image, past cin and in the padding rows.
  if (d.vec_x) {
    for (int i = tid; i < HP16 * (cin16 / 8); i += SNN_THREADS) {
      const int hp = i / (cin16 / 8), u = i - hp * (cin16 / 8);
      const int gy = ty0 - 1 + hp / HC, gx = tx0 - 1 + hp % HC;
      const bool ok = hp < HP && u * 8 < cin && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
      const bf16* src = ok ? x + (((size_t)n * d.h + gy) * d.w + gx) * cin + u * 8 : x;
      cp_async16(xs + hp * xst + u * 8, src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < HP16 * cin16; i += SNN_THREADS) {
      const int hp = i / cin16, ci = i - hp * cin16;
      const int gy = ty0 - 1 + hp / HC, gx = tx0 - 1 + hp % HC;
      const bool ok = hp < HP && ci < cin && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
      xs[hp * xst + ci] = ok ? x[(((size_t)n * d.h + gy) * d.w + gx) * cin + ci]
                             : __float2bfloat16_rn(0.f);
    }
  }
  // The project reads 16-row tiles of ds: its rows past P stay zero (q2:
  // the int8 rows of SNN_QROW bytes).
  const int ds_row = (Q && d.q2) ? SNN_QROW : 2 * SNN_ES;
  for (int i = tid; i < (P16 - P) * (ds_row / 16); i += SNN_THREADS)
    reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(ds) + P * ds_row)[i] =
        make_uint4(0, 0, 0, 0);
  int8_t* ds8 = reinterpret_cast<int8_t*>(ds);
  const int cin32 = round32(cin), e32 = round32(d.e), cout8 = (cout + 7) / 8 * 8;

  // A chunk's weights into buffer b, zero past E, cin and cout.
  auto load_chunk = [&](int c, int b) {
    const int e0 = c * SNN_EC;
    if (d.has_expand && (Q && d.q1)) {  // rows e0.. of w1q, cin32 bytes each
      int8_t* dst = reinterpret_cast<int8_t*>(w1s(b));
      const int units = cin32 / 16;
      for (int i = tid; i < SNN_EC * units; i += SNN_THREADS) {
        const int j = i / units, u = i - j * units;
        const bool ok = e0 + j < d.e;
        cp_async16(dst + j * d.q_stride + 16 * u,
                   ok ? w1q + (size_t)(e0 + j) * cin32 + 16 * u : w1q, ok ? 16 : 0);
      }
    } else if (d.has_expand && (Q && d.w1_i8)) {  // int8 rows ci, upcast as staged
      bf16* dst = w1s(b);
      for (int i = tid; i < cin16 * (SNN_EC / 8); i += SNN_THREADS) {
        const int ci = i / (SNN_EC / 8), u = i - ci * (SNN_EC / 8), e1 = e0 + u * 8;
        *reinterpret_cast<uint4*>(dst + ci * SNN_ES + u * 8) =
            upcast_s8x8(w1q + (size_t)ci * d.e + e1, ci < cin ? min(8, d.e - e1) : 0);
      }
    } else if (d.has_expand) {
      bf16* dst = w1s(b);
      if (d.vec_w1) {
        for (int i = tid; i < cin16 * (SNN_EC / 8); i += SNN_THREADS) {
          const int ci = i / (SNN_EC / 8), u = i - ci * (SNN_EC / 8);
          const bool ok = ci < cin && e0 + u * 8 < d.e;
          cp_async16(dst + ci * SNN_ES + u * 8, ok ? w1 + (size_t)ci * d.e + e0 + u * 8 : w1,
                     ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < cin16 * SNN_EC; i += SNN_THREADS) {
          const int ci = i / SNN_EC, j = i - ci * SNN_EC;
          dst[ci * SNN_ES + j] = ci < cin && e0 + j < d.e ? w1[(size_t)ci * d.e + e0 + j]
                                                          : __float2bfloat16_rn(0.f);
        }
      }
    }
    // Rows 0-8: depthwise taps; 9-12: s1, o1, sd, od.
    float* wdst = wds(b);
    auto wd_row = [&](int r) {
      return r < 9 ? wd + r * d.e : r == 9 ? s1 : r == 10 ? o1 : r == 11 ? sd : od;
    };
    if (d.vec_wd) {
      for (int i = tid; i < 13 * (SNN_EC / 4); i += SNN_THREADS) {
        const int r = i / (SNN_EC / 4), u = i - r * (SNN_EC / 4), ec = e0 + u * 4;
        const bool ok = ec < d.e && (r < 9 || r > 10 || d.has_expand);
        cp_async16(wdst + i * 4, ok ? wd_row(r) + ec : wd, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < 13 * SNN_EC; i += SNN_THREADS) {
        const int r = i / SNN_EC, ec = e0 + i - r * SNN_EC;
        const bool ok = ec < d.e && (r < 9 || r > 10 || d.has_expand);
        cp_async4(wdst + i, ok ? wd_row(r) + ec : wd, ok);
      }
    }
    bf16* dst = w2s(b);
    if (Q && d.q2) {  // the chunk's 32 bytes of each w2q row, zero rows past cout
      int8_t* dst8 = reinterpret_cast<int8_t*>(dst);
      for (int i = tid; i < cout8 * 2; i += SNN_THREADS) {
        const int r = i >> 1, u = i & 1;
        const bool ok = r < cout;
        cp_async16(dst8 + r * SNN_QROW + 16 * u, ok ? w2q + (size_t)r * e32 + e0 + 16 * u : w2q,
                   ok ? 16 : 0);
      }
    } else if (Q && d.w2_i8) {  // int8 rows e0 + j, upcast as staged
      for (int i = tid; i < SNN_EC * (d.w2_stride / 8); i += SNN_THREADS) {
        const int j = i / (d.w2_stride / 8), u = i - j * (d.w2_stride / 8);
        *reinterpret_cast<uint4*>(dst + j * d.w2_stride + u * 8) = upcast_s8x8(
            w2q + (size_t)(e0 + j) * cout + u * 8, e0 + j < d.e ? min(8, cout - u * 8) : 0);
      }
    } else if (d.vec_w2) {  // warp -> rows, lane -> 16-byte units of the row
      for (int j = warp; j < SNN_EC; j += SNN_THREADS / 32) {
        for (int u = lane; u < d.w2_stride / 8; u += 32) {
          const bool ok = e0 + j < d.e && u * 8 < cout;
          cp_async16(dst + j * d.w2_stride + u * 8,
                     ok ? w2 + (size_t)(e0 + j) * cout + u * 8 : w2, ok ? 16 : 0);
        }
      }
    } else {
      for (int i = tid; i < SNN_EC * d.w2_stride; i += SNN_THREADS) {
        const int j = i / d.w2_stride, co = i - j * d.w2_stride;
        dst[i] = e0 + j < d.e && co < cout ? w2[(size_t)(e0 + j) * cout + co]
                                           : __float2bfloat16_rn(0.f);
      }
    }
  };

  // Project warps: WM of 16 pixels times WN over the n8-tiles of Cout.
  const int WM = P16 / 16, WN = SNN_THREADS / 32 / WM;
  const int wm = warp % WM, wn = warp / WM;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  // This CTA's slice of the E chunks.
  const int chunks = (d.e + SNN_EC - 1) / SNN_EC;
  const int rank = blockIdx.z;
  const int c_begin = rank * chunks / d.split, c_end = (rank + 1) * chunks / d.split;
  if (c_begin < c_end) load_chunk(c_begin, 0);
  cp_async_commit();  // with xs
  if (Q && d.q1) {  // the input tile quantized once: rows of q_stride bytes, zero past cin
    cp_async_wait<0>();
    __syncthreads();
    const int units = d.q_stride / 16;
    for (int i = tid; i < HP16 * units; i += SNN_THREADS) {
      const int r = i / units, u = i - r * units;
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = 16 * u + 4 * j + e;
          v[e] = ch < cin ? quant_s8(__bfloat162float(xs[r * xst + ch]), d.inv_ax1) : 0;
        }
        q[j] = pack_s8x4(v[0], v[1], v[2], v[3]);
      }
      *reinterpret_cast<uint4*>(xq + r * d.q_stride + 16 * u) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  for (int c = c_begin; c < c_end; ++c) {
    const int b = (c - c_begin) & 1, e0 = c * SNN_EC;
    if (c + 1 < c_end) load_chunk(c + 1, b ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c (and xs) staged
    const float* vec = wds(b) + 9 * SNN_EC;

    // Expand over the halo tile on the tensor cores: warp item -> 16 rows
    // x 16 channels; epilogue, mask and rounding on the fragments.
    if (d.has_expand) {
      const bf16* w1b = w1s(b);
      const int8_t* w1b8 = reinterpret_cast<const int8_t*>(w1b);
      for (int it = warp; it < (HP16 / 16) * 2; it += SNN_THREADS / 32) {
        const int mt = it >> 1, nh = it & 1;
        float a2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (Q && d.q1) {  // s8: A rows of xq, B n-major rows of w1 (channels nh*16..)
          int s32[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
          for (int k0 = 0; k0 < cin32; k0 += 32) {
            uint32_t a[4], bb[4];
            ldmatrix_x4(a, xq + (mt * 16 + (lane & 15)) * d.q_stride + k0 + (lane >> 4) * 16);
            ldmatrix_x4(bb, w1b8 + (nh * 16 + (lane & 7) + 8 * (lane >> 4)) * d.q_stride + k0 +
                                16 * ((lane >> 3) & 1));
            mma_s8(s32[0], a, bb[0], bb[1]);
            mma_s8(s32[1], a, bb[2], bb[3]);
          }
#pragma unroll
          for (int jt = 0; jt < 2; ++jt)
#pragma unroll
            for (int q = 0; q < 4; ++q) a2[jt][q] = (float)s32[jt][q];
        } else {
          for (int k0 = 0; k0 < cin16; k0 += 16) {
            uint32_t a[4], bb[4];
            ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * xst + k0 + (lane >> 4) * 8);
            ldmatrix_x4_trans(bb, w1b + (k0 + (lane & 15)) * SNN_ES + nh * 16 + (lane >> 4) * 8);
            mma_bf16(a2[0], a, bb[0], bb[1]);
            mma_bf16(a2[1], a, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          if (r >= HP) continue;
          const int gy = ty0 - 1 + r / HC, gx = tx0 - 1 + r % HC;
          const bool inside = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
#pragma unroll
          for (int jt = 0; jt < 2; ++jt) {
            const int j = nh * 16 + jt * 8 + 2 * t;
            float v[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              v[q] = inside && e0 + j + q < d.e
                         ? apply_act(fmaf(a2[jt][2 * half + q], vec[j + q], vec[SNN_EC + j + q]),
                                     d.act_e, d.alpha)
                         : 0.f;
            }
            *reinterpret_cast<uint32_t*>(es + r * SNN_ES + j) = pack_bf16x2(v[0], v[1]);
          }
        }
      }
    } else {  // t=1: e = x (zero outside the image already)
      for (int i = tid; i < HP * SNN_EC; i += SNN_THREADS) {
        const int r = i / SNN_EC, j = i - r * SNN_EC;
        es[r * SNN_ES + j] = e0 + j < d.e ? xs[r * xst + e0 + j] : __float2bfloat16_rn(0.f);
      }
    }
    __syncthreads();

    // Depthwise 3x3 over the tile on the CUDA cores, f32 taps in registers.
    {
      const float* wdb = wds(b);
      float tap[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) tap[q] = wdb[q * SNN_EC + lane];
      const float sdl = vec[2 * SNN_EC + lane], odl = vec[3 * SNN_EC + lane];
      const bool live = e0 + lane < d.e;
      for (int p = warp; p < P; p += SNN_THREADS / 32) {
        const int py = p / d.tile_w, px = p - py * d.tile_w;
        const bf16* ep = es + (py * HC + px) * SNN_ES + lane;
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s = fmaf(__bfloat162float(ep[(dy * HC + dx) * SNN_ES]), tap[3 * dy + dx], s);
        const float v = apply_act(fmaf(s, sdl, odl), d.act_d, d.alpha);
        const bf16 dv = __float2bfloat16_rn(live ? v : 0.f);
        if (Q && d.q2)
          ds8[p * SNN_QROW + lane] = (int8_t)quant_s8(__bfloat162float(dv), d.inv_ax2);
        else
          ds[p * SNN_ES + lane] = dv;
      }
    }
    __syncthreads();

    // Project on the tensor cores: acc += d[16 pixels][32] . w2[32][n8-tiles].
    if (wn < WN && (Q && d.q2)) {  // s8, one k32 step; B n-major rows of 48 bytes
      uint32_t a[4];
      ldmatrix_x4(a, ds8 + (wm * 16 + (lane & 15)) * SNN_QROW + (lane >> 4) * 16);
      const int8_t* w2b = reinterpret_cast<const int8_t*>(w2s(b)) + (lane & 7) * SNN_QROW +
                          16 * ((lane >> 3) & 1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int jj = wn + WN * j;
        if (jj < nt_total) {
          uint32_t bb[2];
          ldmatrix_x2(bb, w2b + jj * 8 * SNN_QROW);
          int c4[4] = {0, 0, 0, 0};
          mma_s8(c4, a, bb[0], bb[1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] += (float)c4[q];
        }
      }
    } else if (wn < WN) {
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, ds + (wm * 16 + (lane & 15)) * SNN_ES + (lane >> 4) * 8);
      ldmatrix_x4(a1, ds + (wm * 16 + (lane & 15)) * SNN_ES + 16 + (lane >> 4) * 8);
      const bf16* w2b = w2s(b) + lane * d.w2_stride;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int jj = wn + WN * j;
        if (jj < nt_total) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, w2b + jj * 8);
          mma_bf16(acc[j], a0, bb[0], bb[1]);
          mma_bf16(acc[j], a1, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the chunk's buffers are free
  }
  cp_async_wait<0>();
  __syncthreads();  // xs is staged even where this CTA had no chunk

  // Epilogue of one output: scale/offset, residual, act_out, rounding, store.
  auto finish = [&](int p, int co, float a) {
    const int py = p / d.tile_w, px = p - py * d.tile_w;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= d.h || gx >= d.w) return;
    float v = fmaf(a, s2[co], o2[co]);
    if (d.residual) v += __bfloat162float(xs[((py + 1) * HC + px + 1) * xst + co]);
    y[(((size_t)n * d.h + gy) * d.w + gx) * cout + co] =
        __float2bfloat16_rn(apply_act(v, d.act_o, d.alpha));
  };
  // Fragment (j, q) of this thread: pixel wm*16 + g (+8 for q >= 2),
  // channel 8*(wn + WN*j) + 2t (+1 for odd q).
  auto each = [&](auto&& fn) {
    if (wn >= WN) return;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int jj = wn + WN * j;
      if (jj >= nt_total) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = wm * 16 + g + 8 * (q >> 1), co = jj * 8 + 2 * t + (q & 1);
        if (p < P && co < cout) fn(p, co, acc[j][q]);
      }
    }
  };

  if (d.split == 1) {
    each(finish);
    return;
  }

  // Split E: partial sums to shared memory, then each CTA of the cluster
  // finishes every split-th output, adding the partials in rank order.
  float* red = reinterpret_cast<float*>(smem_raw + d.red_off);  // [P][cout]
  each([&](int p, int co, float a) { red[p * cout + co] = a; });
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = rank + d.split * tid; i < P * cout; i += d.split * SNN_THREADS) {
    float part[8];  // every peer's partial read at once, then summed in rank order
#pragma unroll
    for (int q = 0; q < 8; ++q) part[q] = q < d.split ? cluster.map_shared_rank(red, q)[i] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < d.split) a += part[q];
    finish(i / cout, i % cout, a);
  }
  cluster.sync();  // peers' shared memory stays alive until every read is done
}

// ---------------------------------------------------------------- f32 ----

// NT: the project's n8-tiles per warp, as in the bf16 form. W8: the int8
// form (w1_i8 / w2_i8: int8 weights, upcast to f32 as they are staged and
// exact in TF32, so their products take two passes); a kernel without it is
// compiled without any int8 code.
template <int NT, bool W8>
__global__ void __launch_bounds__(SNN_THREADS, NT <= 8 ? 2 : 1)  // 2 CTAs per SM where they fit
invres_tf32_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const void* __restrict__ w1v, const float* __restrict__ s1,
                   const float* __restrict__ o1, const float* __restrict__ wd,
                   const float* __restrict__ sd, const float* __restrict__ od,
                   const void* __restrict__ w2v, const float* __restrict__ s2,
                   const float* __restrict__ o2, const __grid_constant__ InvResDesc d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // n-major weights: f32 w1n (E x cin8) and w2n (Cout x E32), or (W8) the
  // int8 w1q (E x cin32) and w2q (Cout x E32), through the int8 pointers.
  const float* w1 = static_cast<const float*>(w1v);
  const float* w2 = static_cast<const float*>(w2v);
  const int8_t* w1q = static_cast<const int8_t*>(w1v);
  const int8_t* w2q = static_cast<const int8_t*>(w2v);
  float* xs = reinterpret_cast<float*>(smem_raw + d.xs_off);  // [HP16][xs_stride] input tile + halo
  float* es = reinterpret_cast<float*>(smem_raw + d.es_off);  // [HP16][ESF] expanded chunk
  float* ds = reinterpret_cast<float*>(smem_raw + d.ds_off);  // [P16][ESF] depthwise output chunk
  // d.bufs buffers each: w1 [EC][xs_stride] and w2 [cout8][ESF] n-major,
  // taps and vectors [13][EC].
  auto w1s = [&](int b) { return reinterpret_cast<float*>(smem_raw + d.w1_off + b * d.w1_buf); };
  auto wds = [&](int b) { return reinterpret_cast<float*>(smem_raw + d.wd_off + b * d.wd_buf); };
  auto w2s = [&](int b) { return reinterpret_cast<float*>(smem_raw + d.w2_off + b * d.w2_buf); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / d.tiles_x) * d.tile_h;
  const int tx0 = (blockIdx.x % d.tiles_x) * d.tile_w;
  const int HC = d.tile_w + 2, HP = (d.tile_h + 2) * HC, HP16 = round16(HP);
  const int P = d.tile_h * d.tile_w, P16 = round16(P);
  const int cin = d.cin, cin8 = round8(cin), cout = d.cout, xst = d.xs_stride;
  const int nt_total = (cout + 7) / 8, e32 = round32(d.e);
  const bool w1x = W8 && d.w1_i8, w2x = W8 && d.w2_i8;  // exact in TF32: two passes

  // Input tile + one-pixel halo, zero outside the image, past cin and in
  // the padding rows.
  if (d.vec_x) {
    for (int i = tid; i < HP16 * (cin8 / 4); i += SNN_THREADS) {
      const int hp = i / (cin8 / 4), u = i - hp * (cin8 / 4);
      const int gy = ty0 - 1 + hp / HC, gx = tx0 - 1 + hp % HC;
      const bool ok = hp < HP && u * 4 < cin && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
      const float* src = ok ? x + (((size_t)n * d.h + gy) * d.w + gx) * cin + u * 4 : x;
      cp_async16(xs + hp * xst + u * 4, src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < HP16 * cin8; i += SNN_THREADS) {
      const int hp = i / cin8, ci = i - hp * cin8;
      const int gy = ty0 - 1 + hp / HC, gx = tx0 - 1 + hp % HC;
      const bool ok = hp < HP && ci < cin && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
      xs[hp * xst + ci] = ok ? x[(((size_t)n * d.h + gy) * d.w + gx) * cin + ci] : 0.f;
    }
  }
  // The project reads 16-row tiles of ds: its rows past P stay zero.
  for (int i = tid; i < (P16 - P) * SNN_ESF; i += SNN_THREADS) ds[P * SNN_ESF + i] = 0.f;

  // A chunk's weights into buffer b, n-major, zero past E, cin and cout.
  auto load_chunk = [&](int c, int b) {
    const int e0 = c * SNN_EC;
    if (d.has_expand) {  // rows e0.. of w1n: cin8 floats each
      float* dst = w1s(b);
      for (int i = tid; i < SNN_EC * (cin8 / 4); i += SNN_THREADS) {
        const int j = i / (cin8 / 4), u = i - j * (cin8 / 4);
        const bool ok = e0 + j < d.e;
        if (w1x) {  // four int8 to four f32 (exact)
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) {
            const char4 q = *reinterpret_cast<const char4*>(w1q + (size_t)(e0 + j) * round32(cin) + 4 * u);
            v = make_float4(q.x, q.y, q.z, q.w);
          }
          *reinterpret_cast<float4*>(dst + j * xst + 4 * u) = v;
        } else {
          cp_async16(dst + j * xst + 4 * u, ok ? w1 + (size_t)(e0 + j) * cin8 + 4 * u : w1,
                     ok ? 16 : 0);
        }
      }
    }
    // Rows 0-8: depthwise taps; 9-12: s1, o1, sd, od.
    float* wdst = wds(b);
    auto wd_row = [&](int r) {
      return r < 9 ? wd + r * d.e : r == 9 ? s1 : r == 10 ? o1 : r == 11 ? sd : od;
    };
    if (d.vec_wd) {
      for (int i = tid; i < 13 * (SNN_EC / 4); i += SNN_THREADS) {
        const int r = i / (SNN_EC / 4), u = i - r * (SNN_EC / 4), ec = e0 + u * 4;
        const bool ok = ec < d.e && (r < 9 || r > 10 || d.has_expand);
        cp_async16(wdst + i * 4, ok ? wd_row(r) + ec : wd, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < 13 * SNN_EC; i += SNN_THREADS) {
        const int r = i / SNN_EC, ec = e0 + i - r * SNN_EC;
        const bool ok = ec < d.e && (r < 9 || r > 10 || d.has_expand);
        cp_async4(wdst + i, ok ? wd_row(r) + ec : wd, ok);
      }
    }
    // The chunk's 32 columns of each row of w2n (zero past E there), zero
    // rows past cout.
    float* dst = w2s(b);
    for (int i = tid; i < nt_total * 8 * (SNN_EC / 4); i += SNN_THREADS) {
      const int r = i / (SNN_EC / 4), u = i - r * (SNN_EC / 4);
      const bool ok = r < cout;
      if (w2x) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          const char4 q = *reinterpret_cast<const char4*>(w2q + (size_t)r * e32 + e0 + 4 * u);
          v = make_float4(q.x, q.y, q.z, q.w);
        }
        *reinterpret_cast<float4*>(dst + r * SNN_ESF + 4 * u) = v;
      } else {
        cp_async16(dst + r * SNN_ESF + 4 * u, ok ? w2 + (size_t)r * e32 + e0 + 4 * u : w2,
                   ok ? 16 : 0);
      }
    }
  };

  // Project warps: WM of 16 pixels times WN over the n8-tiles of Cout.
  const int WM = P16 / 16, WN = SNN_THREADS / 32 / WM;
  const int wm = warp % WM, wn = warp / WM;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  // This CTA's slice of the E chunks; with one buffer, chunk c is loaded
  // once chunk c - 1 is done with it.
  const int chunks = (d.e + SNN_EC - 1) / SNN_EC;
  const int rank = blockIdx.z;
  const int c_begin = rank * chunks / d.split, c_end = (rank + 1) * chunks / d.split;
  if (c_begin < c_end) load_chunk(c_begin, 0);
  cp_async_commit();  // with xs
  for (int c = c_begin; c < c_end; ++c) {
    const int b = d.bufs == 2 ? (c - c_begin) & 1 : 0, e0 = c * SNN_EC;
    if (d.bufs == 2) {
      if (c + 1 < c_end) load_chunk(c + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (c > c_begin) load_chunk(c, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and xs) staged
    const float* vec = wds(b) + 9 * SNN_EC;

    // Expand over the halo tile on the tensor cores: warp item -> 16 rows
    // x 16 channels, k8 steps over cin8; epilogue and mask on the fragments.
    if (d.has_expand) {
      const float* ap0 = xs + (lane & 15) * xst + 4 * (lane >> 4);
      const float* bp0 = w1s(b) + ((lane & 7) + 8 * (lane >> 4)) * xst + 4 * ((lane >> 3) & 1);
      for (int it = warp; it < (HP16 / 16) * 2; it += SNN_THREADS / 32) {
        const int mt = it >> 1, nh = it & 1;
        // Each pass in an accumulator of its own (a_hi b_hi, a_lo b_hi,
        // a_hi b_lo): six independent chains of products, not two.
        float a2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float la[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float lb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const float* ap = ap0 + mt * 16 * xst;
        const float* bp = bp0 + nh * 16 * xst;
#pragma unroll 2
        for (int k0 = 0; k0 < cin8; k0 += 8) {
          uint32_t a[4], ah[4], al[4], bb[4], bh[4], bl[4];
          ldmatrix_x4(a, ap + k0);
          ldmatrix_x4(bb, bp + k0);
          split_tf32(a, ah, al);
          split_tf32(bb, bh, bl);
#pragma unroll
          for (int jt = 0; jt < 2; ++jt) {
            if (!w1x) mma_tf32(lb[jt], ah, bl[2 * jt], bl[2 * jt + 1]);
            mma_tf32(la[jt], al, bh[2 * jt], bh[2 * jt + 1]);
            mma_tf32(a2[jt], ah, bh[2 * jt], bh[2 * jt + 1]);
          }
        }
#pragma unroll
        for (int jt = 0; jt < 2; ++jt)
#pragma unroll
          for (int q = 0; q < 4; ++q) a2[jt][q] += la[jt][q] + lb[jt][q];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          if (r >= HP) continue;
          const int gy = ty0 - 1 + r / HC, gx = tx0 - 1 + r % HC;
          const bool inside = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
#pragma unroll
          for (int jt = 0; jt < 2; ++jt) {
            const int j = nh * 16 + jt * 8 + 2 * t;
            float v[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              v[q] = inside && e0 + j + q < d.e
                         ? apply_act(fmaf(a2[jt][2 * half + q], vec[j + q], vec[SNN_EC + j + q]),
                                     d.act_e, d.alpha)
                         : 0.f;
            }
            *reinterpret_cast<float2*>(es + r * SNN_ESF + j) = make_float2(v[0], v[1]);
          }
        }
      }
    } else {  // t=1: e = x (zero outside the image already)
      for (int i = tid; i < HP * SNN_EC; i += SNN_THREADS) {
        const int r = i / SNN_EC, j = i - r * SNN_EC;
        es[r * SNN_ESF + j] = e0 + j < d.e ? xs[r * xst + e0 + j] : 0.f;
      }
    }
    __syncthreads();

    // Depthwise 3x3 over the tile on the CUDA cores, f32 taps in registers.
    {
      const float* wdb = wds(b);
      float tap[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) tap[q] = wdb[q * SNN_EC + lane];
      const float sdl = vec[2 * SNN_EC + lane], odl = vec[3 * SNN_EC + lane];
      const bool live = e0 + lane < d.e;
      for (int p = warp; p < P; p += SNN_THREADS / 32) {
        const int py = p / d.tile_w, px = p - py * d.tile_w;
        const float* ep = es + (py * HC + px) * SNN_ESF + lane;
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) s = fmaf(ep[(dy * HC + dx) * SNN_ESF], tap[3 * dy + dx], s);
        ds[p * SNN_ESF + lane] = live ? apply_act(fmaf(s, sdl, odl), d.act_d, d.alpha) : 0.f;
      }
    }
    __syncthreads();

    // Project on the tensor cores: acc += d[16 pixels][32] . w2[32][n8-tiles],
    // two k8 steps per B load.
    if (wn < WN) {
      const float* ap = ds + (wm * 16 + (lane & 15)) * SNN_ESF + 4 * (lane >> 4);
      const float* w2b = w2s(b) + (lane & 7) * SNN_ESF + 4 * (lane >> 3);
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a[4];
          ldmatrix_x4(a, ap + 16 * kp + 8 * s);
          split_tf32(a, ah[s], al[s]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int jj = wn + WN * j;
          if (jj < nt_total) {
            uint32_t bb[4], bh[4], bl[4];
            ldmatrix_x4(bb, w2b + jj * 8 * SNN_ESF + 16 * kp);
            split_tf32(bb, bh, bl);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              if (!w2x) mma_tf32(acc[j], ah[s], bl[2 * s], bl[2 * s + 1]);
              mma_tf32(acc[j], al[s], bh[2 * s], bh[2 * s + 1]);
              mma_tf32(acc[j], ah[s], bh[2 * s], bh[2 * s + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the chunk's buffers are free
  }
  cp_async_wait<0>();
  __syncthreads();  // xs is staged even where this CTA had no chunk

  // Epilogue of one output: scale/offset, residual, act_out, store.
  auto finish = [&](int p, int co, float a) {
    const int py = p / d.tile_w, px = p - py * d.tile_w;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= d.h || gx >= d.w) return;
    float v = fmaf(a, s2[co], o2[co]);
    if (d.residual) v += xs[((py + 1) * HC + px + 1) * xst + co];
    y[(((size_t)n * d.h + gy) * d.w + gx) * cout + co] = apply_act(v, d.act_o, d.alpha);
  };
  // Fragment (j, q) of this thread: pixel wm*16 + g (+8 for q >= 2),
  // channel 8*(wn + WN*j) + 2t (+1 for odd q).
  auto each = [&](auto&& fn) {
    if (wn >= WN) return;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int jj = wn + WN * j;
      if (jj >= nt_total) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = wm * 16 + g + 8 * (q >> 1), co = jj * 8 + 2 * t + (q & 1);
        if (p < P && co < cout) fn(p, co, acc[j][q]);
      }
    }
  };

  if (d.split == 1) {
    each(finish);
    return;
  }

  // Split E: partial sums to shared memory, then each CTA of the cluster
  // finishes every split-th output, adding the partials in rank order.
  float* red = reinterpret_cast<float*>(smem_raw + d.red_off);  // [P][cout]
  each([&](int p, int co, float a) { red[p * cout + co] = a; });
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = rank + d.split * tid; i < P * cout; i += d.split * SNN_THREADS) {
    float part[8];  // every peer's partial read at once, then summed in rank order
#pragma unroll
    for (int q = 0; q < 8; ++q) part[q] = q < d.split ? cluster.map_shared_rank(red, q)[i] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < d.split) a += part[q];
    finish(i / cout, i % cout, a);
  }
  cluster.sync();  // peers' shared memory stays alive until every read is done
}

template <typename T, typename K>
int launch(K kern, const void* x, void* y, const void* const* ops, const InvResDesc& d,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (d.h + d.tile_h - 1) / d.tile_h;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d.tiles_x * tiles_y, d.n, d.split);
  cfg.blockDim = dim3(SNN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = d.split;
  cfg.attrs = attr;
  cfg.numAttrs = d.split > 1 ? 1 : 0;
  auto f = [&](int i) { return static_cast<const float*>(ops[i]); };
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<T*>(y), ops[0], f(1),
                           f(2), f(3), f(4), f(5), ops[6], f(7), f(8), d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Does the wrapper's layout hold each buffer, 16-byte aligned, inside the
// shared memory it asks for, without overlaps (the split-E partial sums
// may overlay the per-chunk buffers, never the input tile)?
// Under q1 the int8 input tile is held as well (the partial sums may
// overlay it: the residual reads xs).
bool layout_holds(const InvResDesc& d, int tile_px, int halo_px, bool bf16, long long smem) {
  const int esz = bf16 ? 2 : 4, ecs = bf16 ? SNN_ES : SNN_ESF, cout8 = (d.cout + 7) / 8 * 8;
  const int rows = round16(halo_px), prow = round16(tile_px);
  const long long need[8] = {
      (long long)rows * d.xs_stride * esz,
      (long long)rows * ecs * esz,
      (long long)prow * ecs * esz,
      d.has_expand ? (long long)d.bufs * d.w1_buf : 0,
      (long long)d.bufs * d.wd_buf,
      (long long)d.bufs * d.w2_buf,
      d.q1 ? (long long)rows * d.q_stride : 0,
      d.split > 1 ? (long long)tile_px * d.cout * 4 : 0};
  const long long off[8] = {d.xs_off, d.es_off, d.ds_off, d.w1_off, d.wd_off, d.w2_off, d.xq_off,
                            d.red_off};
  const int w1_need = !bf16 ? SNN_EC * d.xs_stride * 4
                      : d.q1 ? SNN_EC * d.q_stride : round16(d.cin) * SNN_ES * 2;
  const int w2_need = !bf16 ? cout8 * SNN_ESF * 4
                      : d.q2 ? cout8 * SNN_QROW : SNN_EC * d.w2_stride * 2;
  if ((d.has_expand && d.w1_buf < w1_need) || d.wd_buf < 13 * SNN_EC * 4 || d.w2_buf < w2_need)
    return false;
  for (int i = 0; i < 8; ++i) {
    if (off[i] % 16 || off[i] < 0 || off[i] + need[i] > smem) return false;
    for (int j = 0; j < i; ++j) {
      const bool overlay_ok = i == 7 && j > 0;
      if (!overlay_ok && need[i] && need[j] && off[i] < off[j] + need[j] &&
          off[j] < off[i] + need[i])
        return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_invres_error), or the cudaError_t of the launch.
// ops: 9 device pointers w1 (bf16: cin x e, bf16 or int8 with bit 0 of
// w8, under ax1 the n-major int8 w1q; f32: the n-major w1n, or w1q with bit
// 0 of w8; unused without expand), s1, o1, wd (9 x e), sd, od (f32), w2
// (bf16: e x cout, bf16 or int8 with bit 1 of w8, under ax2 the n-major
// int8 w2q; f32: the n-major w2n, or w2q with bit 1 of w8), s2, o2 (f32).
// acts: act_e, act_d, act_o. geom: G_FIELDS ints, the
// wrapper's launch geometry (kernels/invres.py InvResLaunch): the tile (at
// most 8x8 pixels), the split of E over a cluster (1, 2, 4 or 8 CTAs), the
// strides, the shared-memory layout and its buffers; they change the speed,
// and the split the order of the sum over E.
int snn_invres_block(const void* x, int is_bf16, void* y, const void* const* ops,
                     int n, int h, int w, int cin, int e, int cout,
                     int has_expand, int residual, const int* acts, float alpha,
                     float inv_ax1, float inv_ax2, int w8, const int* geom, void* stream) {
  const int tile_h = geom[G_TILE_H], tile_w = geom[G_TILE_W], split = geom[G_SPLIT];
  if (n < 1 || h < 1 || w < 1 || cin < 1 || e < 1 || cout < 1) return -1;
  if (tile_h < 1 || tile_w < 1 || tile_h * tile_w > SNN_MAX_TILE) return -1;
  if (split != 1 && split != 2 && split != 4 && split != 8) return -4;
  if (cout > SNN_MAX_COUT || (!has_expand && e != cin) || (residual && cin != cout)) return -3;
  InvResDesc d;
  d.n = n; d.h = h; d.w = w; d.cin = cin; d.e = e; d.cout = cout;
  d.has_expand = has_expand; d.residual = residual;
  d.act_e = acts[0]; d.act_d = acts[1]; d.act_o = acts[2];
  d.alpha = alpha;
  d.tile_h = tile_h; d.tile_w = tile_w;
  d.tiles_x = (w + tile_w - 1) / tile_w;
  d.split = split;
  d.xs_stride = geom[G_XS_STRIDE]; d.w2_stride = geom[G_W2_STRIDE];
  d.xs_off = geom[G_XS_OFF]; d.es_off = geom[G_ES_OFF]; d.ds_off = geom[G_DS_OFF];
  d.w1_off = geom[G_W1_OFF]; d.wd_off = geom[G_WD_OFF]; d.w2_off = geom[G_W2_OFF];
  d.red_off = geom[G_RED_OFF];
  d.w1_buf = geom[G_W1_BUF]; d.wd_buf = geom[G_WD_BUF]; d.w2_buf = geom[G_W2_BUF];
  d.bufs = geom[G_BUFS];
  d.q1 = inv_ax1 > 0.f; d.q2 = inv_ax2 > 0.f;
  d.inv_ax1 = inv_ax1; d.inv_ax2 = inv_ax2;
  d.q_stride = geom[G_Q_STRIDE]; d.xq_off = geom[G_XQ_OFF];
  d.w1_i8 = has_expand && (w8 & 1); d.w2_i8 = (w8 >> 1) & 1;
  if ((d.q1 || d.q2) && !is_bf16) return -3;
  if ((d.w1_i8 && d.q1) || (d.w2_i8 && d.q2)) return -4;
  if (d.q1 && (!has_expand || d.q_stride < round32(cin) || d.q_stride % 16 ||
               (d.q_stride / 16) % 2 == 0))
    return -4;
  if ((d.q1 && !aligned16(ops[0])) || (d.q2 && !aligned16(ops[6]))) return -4;
  // f32: the n-major weights are read in 16-byte (int8: 4-byte) units.
  if (!is_bf16 && ((has_expand && !aligned16(ops[0])) || !aligned16(ops[6]))) return -4;
  if (d.bufs != 2 && (is_bf16 || d.bufs != 1)) return -4;
  const long long smem = geom[G_SMEM];
  const bool strides_ok =
      is_bf16 ? d.xs_stride >= round16(cin) && d.xs_stride % 8 == 0 &&
                 d.w2_stride >= (cout + 7) / 8 * 8 && d.w2_stride % 8 == 0
           : d.xs_stride == round8(cin) + 4 && d.w2_stride == SNN_ESF;
  if (!strides_ok) return -4;
  if (smem > SNN_MAX_SMEM ||
      !layout_holds(d, tile_h * tile_w, (tile_h + 2) * (tile_w + 2), is_bf16, smem))
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  d.vec_x = cin % (is_bf16 ? 8 : 4) == 0 && aligned16(x);
  d.vec_w1 = has_expand && e % 8 == 0 && aligned16(ops[0]);
  d.vec_wd = e % 4 == 0;
  for (int i = 1; i < 6; ++i) d.vec_wd = d.vec_wd && (aligned16(ops[i]) || (!has_expand && i < 3));
  d.vec_w2 = cout % 8 == 0 && aligned16(ops[6]);
  // The project's n8-tiles per warp: Cout / 8 over 8 / (pixel rows / 16) warps.
  const int wm = round16(tile_h * tile_w) / 16, wn = SNN_THREADS / 32 / wm;
  const int need = ((cout + 7) / 8 + wn - 1) / wn;
  if (!is_bf16) {
    auto go = [&](auto plain, auto i8form) {
      return d.w1_i8 || d.w2_i8 ? launch<float>(i8form, x, y, ops, d, smem, s)
                                : launch<float>(plain, x, y, ops, d, smem, s);
    };
    if (need <= 1) return go(invres_tf32_kernel<1, false>, invres_tf32_kernel<1, true>);
    if (need <= 2) return go(invres_tf32_kernel<2, false>, invres_tf32_kernel<2, true>);
    if (need <= 4) return go(invres_tf32_kernel<4, false>, invres_tf32_kernel<4, true>);
    if (need <= 8) return go(invres_tf32_kernel<8, false>, invres_tf32_kernel<8, true>);
    return go(invres_tf32_kernel<20, false>, invres_tf32_kernel<20, true>);
  }
  auto go = [&](auto plain, auto i8form) {
    return d.q1 || d.q2 || d.w1_i8 || d.w2_i8 ? launch<bf16>(i8form, x, y, ops, d, smem, s)
                                              : launch<bf16>(plain, x, y, ops, d, smem, s);
  };
  if (need <= 1) return go(invres_tc_kernel<1, false>, invres_tc_kernel<1, true>);
  if (need <= 2) return go(invres_tc_kernel<2, false>, invres_tc_kernel<2, true>);
  if (need <= 4) return go(invres_tc_kernel<4, false>, invres_tc_kernel<4, true>);
  if (need <= 8) return go(invres_tc_kernel<8, false>, invres_tc_kernel<8, true>);
  return go(invres_tc_kernel<20, false>, invres_tc_kernel<20, true>);
}

const char* snn_invres_error(int code) {
  switch (code) {
    case -1: return "empty input or a tile outside 1..64 pixels";
    case -2: return "the launch geometry's shared-memory layout does not hold the block's "
                    "buffers within 227 KB";
    case -3: return "shapes outside the kernel (cout <= 320; e == cin without expand; "
                    "cin == cout with a residual; A8W8 only under bf16)";
    case -4: return "launch geometry outside the kernel (split of E not 1, 2, 4 or 8, "
                    "strides, buffers, int8 operands without an expand, unaligned n-major "
                    "weights, or a weight flagged int8 in both layouts)";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
