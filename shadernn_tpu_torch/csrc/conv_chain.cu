// Fused stride-1 conv chain for Hopper (sm_90a): a whole run of small-channel
// convolutions in ONE kernel, intermediates kept in shared memory.
//
// Replaces two TPU kernels of the JAX package, which compute the same
// function in two TPU layouts:
//   shadernn_tpu/kernels/chain_packed_pallas.py : _packed_kernel
//       (entry point fused_conv_chain_packed)
//   shadernn_tpu/kernels/chain_pallas.py        : _chain_kernel
//       (entry point fused_conv_chain)
//
// Function: NHWC input (f32 or bf16, cast to the compute dtype on load);
// per layer l an HWIO weight in the compute dtype (int8 weights arrive as
// their exact bf16 or f32 values, their scale folded into scale[o]), an
// f32 accumulation, then y = act(acc * scale[o] + offset[o]) in f32; every
// intermediate is zeroed outside the image (it is the next layer's
// padding) and rounded to the compute dtype. Tails: 0 = none, NHWC (N,H,W,o); 1 = c1, (N,H,W,1)
// (the same layout with o = 1); 2 = d2s2, o = 4 through depth_to_space(2)
// in TF channel order, (N,2H,2W,1).
//
// What bounds it on an H100: ESPCN at 540p does 2*518400*3280 = 3.4 GFLOP
// per frame over 6.2 MB of input and output, about 550 FLOP/byte: above
// the bf16 tensor cores' ridge (989 TFLOP/s over 3.35 TB/s = 295), so the
// chain is bound by its products once its intermediates stay on chip. The
// price of keeping them on chip is the halo: each CTA recomputes the rows
// and columns of the intermediates that its neighbours also need.
//
// Both forms work in tiles of TH x TW final-output pixels of one image (the
// bf16 form one CTA per tile, the f32 form a persistent grid of one wave,
// each CTA taking tile after tile). A CTA stages the tile's input plus the
// chain's accumulated halo, runs each layer over its shrinking region
// between two ping-pong buffers, and the last layer writes device memory;
// nothing in between leaves the chip.
//
// bf16 (conv_chain_tc_kernel) runs every layer as an implicit GEMM on the
// tensor cores (mma.sync m16n8k16, f32 accumulators): M = the pixels of the
// layer's output region, N = o padded to 8, K = taps x C. Regions are bf16,
// pixel-major with a pixel's channels contiguous. A layer with C >= 8 walks
// K in units of 8 channels (C padded to 8; the row pitch an odd number of
// 16-byte units, so that ldmatrix is free of bank conflicts), two units per
// k16 step; its A rows come from ldmatrix with one row address per pixel,
// shifted by the unit's tap offset from a per-CTA table. A layer with C < 8
// (ESPCN's head, C = 1, k = 5) packs its taps densely, K = round16(taps *
// C): each thread gathers its A fragment from the staged plane through a
// table of K offsets, 2 k-steps where padding C to 8 would take 13. A warp
// takes its m-tiles in pairs, so that each B fragment serves two products
// and the tensor cores see two independent sums. The weights are a B image
// [K][N] per layer, packed on the host in that K order, copied with
// cp.async, and read with ldmatrix.trans. The epilogue runs on the C
// fragments with its scale and offset in registers: the activation, zero
// outside the image, the bf16 round, then a store into the next layer's
// region or, on the last layer, to device memory (d2s2: a thread's channel
// pair is one bf16x2 of output row 2gy+py). At these channel counts the
// products are not the cost; the instructions around them and the
// kernel's code size are: so the n-tile count is a uniform bound (two
// copies of the layer: dense or not), relu and linear stay inline and the
// other activations are one call, the address walk is a table and the
// pixel division a multiply. The launch geometry (tile, threads, region
// strides, shared-memory layout, whether all weights stay resident) is
// the wrapper's (kernels/chain.py launch_geometry); this file checks it
// and launches.
//
// A8 (bf16 form; the int8 `in_q` dots of _packed_kernel): a layer whose
// input is int8 runs m16n8k32 s8 products with s32 sums (exact), then the
// same f32 epilogue (in_q folded into its scale on the host). Its region
// is int8, pixel-major, C padded to units of 16 and the pitch an odd
// number of 16-byte units, so ldmatrix reads it as it reads bf16; K walks
// in k32 steps of two units. ldmatrix has no 8-bit transpose, so its B
// image is packed n-major on the host (K contiguous per output channel,
// the row an odd number of 16-byte units) and read without .trans. The
// producer quantizes: the previous layer's epilogue writes
// clip(rint(y * inv_q), +-127) from the f32 y after the activation (inv_q
// = 1/in_q, f32), or, for the head, stage_input from the frame.
//
// f32 (conv_chain_tf32_kernel; f32 x f32 products at about f32's accuracy,
// as the JAX package runs f32 at HIGHEST precision) is the same implicit
// GEMM in 3xTF32 on mma.sync m16n8k8 tf32 (csrc/snn_mma.cuh), one k8 step
// per unit of 8 channels (dense layers: 8 K indices). Regions are f32,
// pixel-major, C padded to 8 and the pitch an odd number of 16-byte units,
// a 16x8 f32 A tile read by ldmatrix as a 16x16 b16 one. Each region is
// held twice, as its TF32 hi and lo parts: the producer splits, once per
// value, what every tap would otherwise split again at its fragment load
// (the previous layer's epilogue writes the next input split; the head's
// frame is split as it is staged; a bf16 frame is exact in TF32, has no lo
// and skips its pass). ldmatrix has no 32-bit transpose, so the B images
// come n-major from the host, already split into hi and lo (an int8
// weight has no lo: its pass is skipped). A tap's products (kp k-steps)
// sum in accumulators of their own and join the f32 sums with
// round-to-nearest adds: the tensor cores' accumulation truncates, and
// promoted per tap its error does not grow with K. A layer runs in passes
// of at most two n8-tiles (16 output channels; registers); with the
// weights staged layer by layer, each pass stages its own rows, so that
// the largest layer the gate admits (k9, C 16, o 32) fits; where even one
// n8-tile's hi and lo do not fit beside the regions (a k9 C32 layer under
// the halo of more layers), the pass stages its f32 values and splits B
// at the fragment load. The CTAs are persistent: resident weights are
// staged once per CTA, and the next tile's frame is fetched by cp.async
// while the current one computes (a staging a CTA of 512 threads, one per
// SM, could otherwise not hide). The launch
// geometry (tile, threads, region strides, passes, shared-memory layout,
// whether all weights stay resident) is the wrapper's (kernels/chain.py
// f32_launch_geometry); this file checks it and launches.

#include "snn_common.cuh"
#include "snn_mma.cuh"

#define SNN_MAX_LAYERS 8
#define SNN_TC_MAX_THREADS 512

// Fields of the bf16 form's geometry array: SNN_CG_FIELDS globals, then
// SNN_CL_FIELDS per layer (kernels/chain.py ChainLaunch.array).
enum { CG_TILE_H, CG_TILE_W, CG_THREADS, CG_W_ALL, CG_BUF0, CG_BUF1, CG_SMEM, CG_PARAM_BYTES,
       SNN_CG_FIELDS };
enum { CL_CS, CL_OSTRIDE, CL_W_OFF, CL_KTAB_OFF, CL_PW, CL_PS, CL_Q8, SNN_CL_FIELDS };

namespace {

// Accumulated pads of the layers from l on: A (top), B (bottom), Lp
// (left), Rp (right); `layers` holds nl rows of (k, c, o, pt, pb, pl, pr, act).
void halo(const int* layers, int nl, int* A, int* B, int* Lp, int* Rp) {
  A[nl] = B[nl] = Lp[nl] = Rp[nl] = 0;
  for (int l = nl - 1; l >= 0; --l) {
    const int* r = layers + 8 * l;
    A[l] = A[l + 1] + r[3];
    B[l] = B[l + 1] + (r[0] - 1 - r[3]);
    Lp[l] = Lp[l + 1] + r[5];
    Rp[l] = Rp[l + 1] + (r[0] - 1 - r[5]);
  }
}

// --------------------------------------------------------------- bf16 ----

typedef __nv_bfloat16 bf16;

struct TcLayer {
  int k, c, o, act;
  float alpha;
  int dense;                    // C < 8: taps packed densely into K
  int q8;                       // int8 input: s8 products (C % 8 == 0)
  float inv_q;                  // q8: 1 / in_q, what the producer multiplies by
  int cs;                       // elements (bf16, or int8 for q8) per staged input position
  int ksteps, nt, ostride;      // k16 (k32 for q8) steps, n8-tiles, bf16 per B row
                                // (q8: bytes per n-major B row)
  int w_off, w_bytes, ktab_off; // smem bytes
  int pw, ps;                   // byte offsets in params: B image, scale|offset (f32, nt*8 each)
  int rows_in, cols_in, rows_out, cols_out;
  float inv_cols;               // 1 / cols_out: pixel -> (row, column) by a multiply
  int a_out, l_out, h_out, w_out;
  int in_off, out_off;          // smem bytes of the input / output regions
  int ncs, ndense, nq8;         // the next layer's input layout
  float inv_nq;                 // nq8: the next layer's inv_q
};

struct TcDesc {
  int nl, n, h, w, cin, a0, l0;
  int tile_h, tile_w, tail, w_all;
  TcLayer L[SNN_MAX_LAYERS];
};

// Pixel p of a region `cols` wide -> its row, exactly for p < 2^20.
__device__ __forceinline__ int region_row(int p, float inv_cols) {
  return (int)(((float)p + 0.5f) * inv_cols);
}

// The B image of one layer, global -> shared, 16 bytes per copy.
__device__ __forceinline__ void stage_weights(unsigned char* smem, const unsigned char* params,
                                              const TcLayer& L) {
  for (int i = threadIdx.x; i < L.w_bytes / 16; i += blockDim.x)
    cp_async16(smem + L.w_off + 16 * i, params + L.pw + 16 * i, 16);
}

// Layer l's table of K offsets, in elements from a pixel's first element of
// the input region: dense, one per K index (-1: padding); else one per
// 16-byte unit (8 bf16 or 16 int8 channels) of each k step (the padding
// unit points at the pixel's first: its B rows are zero).
__device__ void build_ktab(unsigned char* smem, const TcLayer& L) {
  int* tab = reinterpret_cast<int*>(smem + L.ktab_off);
  const int ue = L.q8 ? 16 : 8;  // elements of a unit
  const int U = (L.c + ue - 1) / ue;  // units of a tap (the pitch's padding unit is never read)
  const int entries = L.dense ? 16 * L.ksteps : 2 * L.ksteps;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    if (L.dense) {
      const int tap = i / L.c, ci = i - tap * L.c;
      tab[i] = tap < L.k * L.k ? ((tap / L.k) * L.cols_in + tap % L.k) * L.c + ci : -1;
    } else {
      const int tap = i / U, u = i - tap * U;
      tab[i] = tap < L.k * L.k ? ((tap / L.k) * L.cols_in + tap % L.k) * L.cs + ue * u : 0;
    }
  }
}

// Layer 0's input region: zero outside the image and past C (A8: int8
// where layer 0's input is).
template <typename TIn, bool A8>
__device__ void stage_input(const TIn* __restrict__ x, unsigned char* smem, const TcDesc& d,
                            int n, int ty0, int tx0, bool vec) {
  const TcLayer& L = d.L[0];
  bf16* buf = reinterpret_cast<bf16*>(smem + L.in_off);
  const int R = L.rows_in, C = L.cols_in, c = L.c;
  const int gy0 = ty0 - d.a0, gx0 = tx0 - d.l0;
  if (A8 && L.q8) {  // the frame quantized as it is staged: units of 16 channels
    int8_t* buf8 = reinterpret_cast<int8_t*>(smem + L.in_off);
    const int U = (c + 15) >> 4;
    const float inv = L.inv_q;
    for (int i = threadIdx.x; i < R * C * U; i += blockDim.x) {
      const int u = i % U, pos = i / U;
      const int rr = pos / C, cc = pos - rr * C;
      const int gy = gy0 + rr, gx = gx0 + cc;
      const bool ok = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
      const TIn* src = x + (((size_t)n * d.h + (ok ? gy : 0)) * d.w + (ok ? gx : 0)) * c + 16 * u;
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = 16 * u + 4 * j + e;
          b[e] = ok && ch < c ? quant_s8(to_float(src[4 * j + e]), inv) : 0;
        }
        q[j] = pack_s8x4(b[0], b[1], b[2], b[3]);
      }
      *reinterpret_cast<uint4*>(buf8 + pos * L.cs + 16 * u) = make_uint4(q[0], q[1], q[2], q[3]);
    }
    return;
  }
  if (L.dense) {
    for (int i = threadIdx.x; i < R * C * c; i += blockDim.x) {
      const int ci = i % c, pos = i / c;
      const int rr = pos / C, cc = pos - rr * C;
      const int gy = gy0 + rr, gx = gx0 + cc;
      float v = 0.f;
      if (gy >= 0 && gy < d.h && gx >= 0 && gx < d.w)
        v = to_float(x[(((size_t)n * d.h + gy) * d.w + gx) * c + ci]);
      buf[i] = __float2bfloat16_rn(v);
    }
    return;
  }
  const int U = (c + 7) >> 3;  // channels past C within a unit are zeros
  for (int i = threadIdx.x; i < R * C * U; i += blockDim.x) {
    const int u = i % U, pos = i / U;
    const int rr = pos / C, cc = pos - rr * C;
    const int gy = gy0 + rr, gx = gx0 + cc;
    const bool ok = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w && 8 * u < c;
    const TIn* src = x + (((size_t)n * d.h + (ok ? gy : 0)) * d.w + (ok ? gx : 0)) * c + 8 * u;
    bf16* dst = buf + pos * L.cs + 8 * u;
    if (vec) {  // bf16 input, C a multiple of 8, 16-byte aligned
      cp_async16(dst, ok ? src : x, ok ? 16 : 0);
    } else {
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = 8 * u + 2 * j;
        const float lo = ok && ch < c ? to_float(src[2 * j]) : 0.f;
        const float hi = ok && ch + 1 < c ? to_float(src[2 * j + 1]) : 0.f;
        q[j] = pack_bf16x2(lo, hi);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

// The activations other than relu and linear, as one call: inlined at
// each of the epilogue's sites they make the kernel too large for the
// instruction cache, and the epilogue several times slower.
__device__ __noinline__ float apply_act_call(float v, int act, float alpha) {
  return apply_act(v, act, alpha);
}

__device__ __forceinline__ float chain_act(float v, int act, float alpha) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 0) return v;
  return apply_act_call(v, act, alpha);
}

// The three forms of a layer's products: bf16 in 8-channel units, bf16 with
// dense taps, int8 in 16-channel units.
enum { MODE_UNITS, MODE_DENSE, MODE_Q8 };

// One layer over its output region: pairs of m-tiles of 16 pixels
// round-robin over the warps (the pair shares each B fragment and gives
// the tensor cores two independent sums); nt <= 4 n8-tiles (o <= 8 nt),
// a uniform bound rather than a template, which keeps the kernel to one
// copy of this function per MODE. A8: the kernel has int8 layers, whose
// producers quantize in this epilogue; a kernel without them is compiled
// without any int8 code (code size is the bf16 form's cost, PERF.md §6). Every
// field the loops read is copied to a register first: read through the
// reference it would be read again after each asm statement.
template <int MODE, bool A8>
__device__ void run_tc_layer(unsigned char* smem, const unsigned char* __restrict__ params,
                             const TcLayer& L, int tail, bool last, int n, int ty0, int tx0,
                             bf16* __restrict__ y) {
  constexpr int NTM = 4;  // most n8-tiles of a layer (o <= 32)
  constexpr bool DENSE = MODE == MODE_DENSE, Q8 = MODE == MODE_Q8;
  using Acc = typename std::conditional<Q8, int, float>::type;
  const bf16* in = reinterpret_cast<const bf16*>(smem + L.in_off);
  const int8_t* in8 = reinterpret_cast<const int8_t*>(smem + L.in_off);
  const bf16* wb = reinterpret_cast<const bf16*>(smem + L.w_off);
  const int* tab = reinterpret_cast<const int*>(smem + L.ktab_off);
  bf16* out = last ? nullptr : reinterpret_cast<bf16*>(smem + L.out_off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int M = L.rows_out * L.cols_out, mtiles = (M + 15) / 16;
  const int cols_in = L.cols_in, cols_out = L.cols_out, cs = L.cs, ksteps = L.ksteps;
  const int nt = L.nt, ostride = L.ostride, o = L.o, act = L.act, ncs = L.ncs;
  const int ndense = L.ndense, nq8 = L.nq8;
  const float inv_nq = L.inv_nq;
  const int gy0 = ty0 - L.a_out, gx0 = tx0 - L.l_out, h_out = L.h_out, w_out = L.w_out;
  const float alpha = L.alpha, inv_cols = L.inv_cols;
  // This thread's epilogue columns 8j + 2t, +1.
  float sc[NTM][2], of[NTM][2];
  {
    const float* so = reinterpret_cast<const float*>(params + L.ps);
#pragma unroll
    for (int j = 0; j < NTM; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        sc[j][q] = j < nt ? so[8 * j + 2 * t + q] : 0.f;
        of[j][q] = j < nt ? so[8 * nt + 8 * j + 2 * t + q] : 0.f;
      }
  }
  // This lane's B row of each k-step: k row (lane & 15), n-tile (lane >> 4) past j;
  // q8 (n-major): n row (lane & 7) + 8 (lane >> 4), k byte 16 ((lane >> 3) & 1).
  const bf16* brow = wb + (lane & 15) * ostride + (lane >> 4) * 8;
  const int8_t* brow8 = reinterpret_cast<const int8_t*>(smem + L.w_off) +
                        ((lane & 7) + 8 * (lane >> 4)) * ostride + 16 * ((lane >> 3) & 1);
  auto pixel = [&](int p) {  // element offset of pixel p's first input position
    const int ry = region_row(p, inv_cols);
    return (ry * cols_in + p - ry * cols_out) * cs;
  };
  for (int mt0 = 2 * warp; mt0 < mtiles; mt0 += 2 * nwarps) {
    Acc acc[2][NTM][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTM; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

    int pix[2][2];  // A rows: dense, pixels g and g + 8; else pixel lane & 15
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (DENSE) {
        pix[i][0] = pixel(min((mt0 + i) * 16 + g, M - 1));
        pix[i][1] = pixel(min((mt0 + i) * 16 + g + 8, M - 1));
      } else {
        pix[i][0] = pix[i][1] = pixel(min((mt0 + i) * 16 + (lane & 15), M - 1));
      }
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[2][4];
      if constexpr (DENSE) {
        // A gathered in registers: rows g and g + 8, k 2t, 2t+1, 2t+8, 2t+9.
        const unsigned short* inu = reinterpret_cast<const unsigned short*>(in);
        const int kb = ks * 16 + 2 * t;
        const int ko[4] = {tab[kb], tab[kb + 1], tab[kb + 8], tab[kb + 9]};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          auto ld = [&](int h, int q) -> uint32_t {
            return ko[q] >= 0 ? (uint32_t)inu[pix[i][h] + ko[q]] : 0u;
          };
          a[i][0] = ld(0, 0) | ld(0, 1) << 16;
          a[i][1] = ld(1, 0) | ld(1, 1) << 16;
          a[i][2] = ld(0, 2) | ld(0, 3) << 16;
          a[i][3] = ld(1, 2) | ld(1, 3) << 16;
        }
      } else if constexpr (Q8) {
        // A from ldmatrix as below (16 int8 per row); B n-major, no .trans.
        const int off = tab[2 * ks + (lane >> 4)];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], in8 + pix[i][0] + off);
        const int8_t* bp = brow8 + ks * 32;
#pragma unroll
        for (int j = 0; j < NTM; j += 2) {
          if (j + 1 < nt) {
            uint32_t b[4];
            ldmatrix_x4(b, bp + j * 8 * ostride);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_s8(acc[i][j], a[i], b[0], b[1]);
              mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
            }
          } else if (j < nt) {
            uint32_t b[2];
            ldmatrix_x2(b, bp + j * 8 * ostride);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b[0], b[1]);
          }
        }
      } else {
        // A from ldmatrix: this lane's pixel, shifted by its unit's tap offset.
        const int off = tab[2 * ks + (lane >> 4)];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], in + pix[i][0] + off);
      }
      if constexpr (!Q8) {
        const bf16* bp = brow + ks * 16 * ostride;
#pragma unroll
        for (int j = 0; j < NTM; j += 2) {
          if (j + 1 < nt) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bp + j * 8);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][j], a[i], b[0], b[1]);
              mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
            }
          } else if (j < nt) {
            uint32_t b[2];
            ldmatrix_x2_trans(b, bp + j * 8);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b[0], b[1]);
          }
        }
      }
    }

    // Epilogue on the fragments: rows g and g + 8, channels 8j + 2t, +1.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mt0 + i) * 16 + g + 8 * h;
        if (p >= M) continue;
        const int ry = region_row(p, inv_cols), rx = p - ry * cols_out;
        const int gy = gy0 + ry, gx = gx0 + rx;
        const bool inside = gy >= 0 && gy < h_out && gx >= 0 && gx < w_out;
        if (last && !inside) continue;
#pragma unroll
        for (int j = 0; j < NTM; ++j) {
          if (j >= nt) break;
          const int oc = 8 * j + 2 * t;
          float v0 = chain_act(fmaf((float)acc[i][j][2 * h], sc[j][0], of[j][0]), act, alpha);
          float v1 = chain_act(fmaf((float)acc[i][j][2 * h + 1], sc[j][1], of[j][1]), act, alpha);
          if (!inside || oc >= o) v0 = 0.f;
          if (!inside || oc + 1 >= o) v1 = 0.f;
          if (!last) {
            if (A8 && nq8) {  // the next layer's int8 input (o % 8 == 0): quantized here
              const uint32_t q2 = pack_s8x4(quant_s8(v0, inv_nq), quant_s8(v1, inv_nq), 0, 0);
              if (oc < o)
                *reinterpret_cast<uint16_t*>(reinterpret_cast<int8_t*>(out) + p * ncs + oc) =
                    (uint16_t)q2;
            } else if (ndense) {  // the next layer's C = o < 8: stride o
              if (oc < o) out[p * o + oc] = __float2bfloat16_rn(v0);
              if (oc + 1 < o) out[p * o + oc + 1] = __float2bfloat16_rn(v1);
            } else {  // every channel of the padded units, zeros past o
              *reinterpret_cast<uint32_t*>(out + p * ncs + oc) = pack_bf16x2(v0, v1);
            }
          } else if (tail == 2) {
            // o == 4: the pair (py = t, px = 0..1) is one bf16x2 of row 2gy+py.
            if (j == 0 && t < 2)
              *reinterpret_cast<uint32_t*>(
                  y + ((size_t)n * 2 * h_out + 2 * gy + t) * 2 * w_out + 2 * gx) =
                  pack_bf16x2(v0, v1);
          } else {
            bf16* q = y + (((size_t)n * h_out + gy) * w_out + gx) * o;
            if ((o & 1) == 0 && oc < o) {
              *reinterpret_cast<uint32_t*>(q + oc) = pack_bf16x2(v0, v1);
            } else {
              if (oc < o) q[oc] = __float2bfloat16_rn(v0);
              if (oc + 1 < o) q[oc + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
  }
}

template <typename TIn, bool A8>
__global__ void __launch_bounds__(SNN_TC_MAX_THREADS)
conv_chain_tc_kernel(const TIn* __restrict__ x, bf16* __restrict__ y,
                     const unsigned char* __restrict__ params, int vec_x,
                     const __grid_constant__ TcDesc d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * d.tile_h;
  const int tx0 = blockIdx.x * d.tile_w;
  if (d.w_all)
    for (int l = 0; l < d.nl; ++l) stage_weights(smem, params, d.L[l]);
  stage_input<TIn, A8>(x, smem, d, n, ty0, tx0, vec_x);
  cp_async_commit();
  for (int l = 0; l < d.nl; ++l) build_ktab(smem, d.L[l]);
  cp_async_wait<0>();
  __syncthreads();
  for (int l = 0; l < d.nl; ++l) {
    const TcLayer& L = d.L[l];
    if (!d.w_all) {  // one weight buffer: the previous layer is done with it
      stage_weights(smem, params, L);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const bool last = l == d.nl - 1;
    bool q8 = false;
    if constexpr (A8) {
      q8 = L.q8;
      if (q8) run_tc_layer<MODE_Q8, true>(smem, params, L, d.tail, last, n, ty0, tx0, y);
    }
    if (!q8) {
      if (L.dense) {
        run_tc_layer<MODE_DENSE, A8>(smem, params, L, d.tail, last, n, ty0, tx0, y);
      } else {
        run_tc_layer<MODE_UNITS, A8>(smem, params, L, d.tail, last, n, ty0, tx0, y);
      }
    }
    __syncthreads();
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int run_tc(const void* x, int x_bf16, void* y, const unsigned char* params, const int* layers,
           const float* alphas, const float* inv_q, int nl, int n, int h, int w, int tail,
           const int* geom, cudaStream_t stream) {
  TcDesc d;
  d.nl = nl; d.n = n; d.h = h; d.w = w; d.cin = layers[1]; d.tail = tail;
  d.tile_h = geom[CG_TILE_H]; d.tile_w = geom[CG_TILE_W]; d.w_all = geom[CG_W_ALL];
  const int threads = geom[CG_THREADS], smem = geom[CG_SMEM], pbytes = geom[CG_PARAM_BYTES];
  if (d.tile_h < 1 || d.tile_w < 1 || threads < 32 || threads % 32 ||
      threads > SNN_TC_MAX_THREADS || smem < 0 || smem > SNN_MAX_SMEM)
    return -5;
  int A[SNN_MAX_LAYERS + 1], B[SNN_MAX_LAYERS + 1], Lp[SNN_MAX_LAYERS + 1], Rp[SNN_MAX_LAYERS + 1];
  halo(layers, nl, A, B, Lp, Rp);
  d.a0 = A[0]; d.l0 = Lp[0];
  // Intervals of shared memory: (offset, bytes, slot). Two may overlap only
  // where they share a slot: the regions of one ping-pong buffer, or every
  // layer's weights when they take turns in one buffer.
  long long iv[3 * SNN_MAX_LAYERS][3];
  int niv = 0;
  int hh = h, ww = w, c = d.cin;
  for (int l = 0; l < nl; ++l) {
    const int* r = layers + 8 * l;
    const int* gl = geom + SNN_CG_FIELDS + SNN_CL_FIELDS * l;
    TcLayer& L = d.L[l];
    L.k = r[0]; L.c = r[1]; L.o = r[2]; L.act = r[7]; L.alpha = alphas[l];
    if (L.c != c || L.k < 1 || L.o < 1 || L.o > 32 || L.c > 32) return -3;
    hh = hh + r[3] + r[4] - L.k + 1;
    ww = ww + r[5] + r[6] - L.k + 1;
    if (hh < 1 || ww < 1) return -3;
    L.h_out = hh; L.w_out = ww;
    L.a_out = A[l + 1]; L.l_out = Lp[l + 1];
    L.rows_in = d.tile_h + A[l] + B[l]; L.cols_in = d.tile_w + Lp[l] + Rp[l];
    L.rows_out = d.tile_h + A[l + 1] + B[l + 1];
    L.cols_out = d.tile_w + Lp[l + 1] + Rp[l + 1];
    if ((long long)L.rows_in * L.cols_in >= (1 << 20)) return -5;
    L.inv_cols = 1.f / (float)L.cols_out;
    L.q8 = gl[CL_Q8];
    L.inv_q = inv_q[l];
    if (L.q8 && (L.c % 8 || !(L.inv_q > 0.f))) return -3;
    L.dense = L.c < 8;
    // Unit layers: C padded to a unit of 16 bytes, rows an odd number of units.
    const int ue = L.q8 ? 16 : 8;
    L.cs = gl[CL_CS];
    if (L.dense ? L.cs != L.c : (L.cs < L.c || L.cs % ue || (L.cs / ue) % 2 == 0)) return -5;
    L.ksteps = L.dense ? (L.k * L.k * L.c + 15) / 16 : (L.k * L.k * ((L.c + ue - 1) / ue) + 1) / 2;
    L.nt = (L.o + 7) / 8;
    L.ostride = gl[CL_OSTRIDE];
    if (L.q8) {  // bytes per n-major row: the k32 steps, an odd number of 16-byte units
      if (L.ostride < 32 * L.ksteps || L.ostride % 16 || (L.ostride / 16) % 2 == 0) return -5;
      L.w_bytes = 8 * L.nt * L.ostride;
    } else {
      if (L.ostride < 8 * L.nt || L.ostride % 8) return -5;
      L.w_bytes = L.ksteps * 16 * L.ostride * 2;
    }
    L.w_off = gl[CL_W_OFF]; L.ktab_off = gl[CL_KTAB_OFF];
    L.pw = gl[CL_PW]; L.ps = gl[CL_PS];
    if (L.pw < 0 || L.pw % 16 || L.pw + L.w_bytes > pbytes || L.ps < 0 || L.ps % 16 ||
        L.ps + 64 * L.nt > pbytes)
      return -5;
    L.in_off = geom[l % 2 ? CG_BUF1 : CG_BUF0];
    L.out_off = geom[l % 2 ? CG_BUF0 : CG_BUF1];
    iv[niv][0] = L.in_off; iv[niv][1] = (L.q8 ? 1LL : 2LL) * L.rows_in * L.cols_in * L.cs;
    iv[niv++][2] = l % 2;
    iv[niv][0] = L.w_off; iv[niv][1] = L.w_bytes; iv[niv++][2] = d.w_all ? 10 + l : 2;
    iv[niv][0] = L.ktab_off; iv[niv][1] = (L.dense ? 64LL : 8LL) * L.ksteps; iv[niv++][2] = 20 + l;
    c = L.o;
  }
  for (int l = 0; l < nl; ++l) {
    const bool has_next = l + 1 < nl;
    d.L[l].ncs = has_next ? d.L[l + 1].cs : 0;
    d.L[l].ndense = has_next && d.L[l + 1].dense;
    d.L[l].nq8 = has_next && d.L[l + 1].q8;
    d.L[l].inv_nq = has_next ? d.L[l + 1].inv_q : 0.f;
  }
  if (tail == 1 && d.L[nl - 1].o != 1) return -3;
  if (tail == 2 && d.L[nl - 1].o != 4) return -3;
  for (int i = 0; i < niv; ++i) {
    if (iv[i][0] < 0 || iv[i][0] % 16 || iv[i][0] + iv[i][1] > smem) return -2;
    for (int j = 0; j < i; ++j)
      if (iv[i][2] != iv[j][2] && iv[i][0] < iv[j][0] + iv[j][1] && iv[j][0] < iv[i][0] + iv[i][1])
        return -2;
  }
  bool a8 = false;
  for (int l = 0; l < nl; ++l) a8 = a8 || d.L[l].q8;
  const int vec_x = x_bf16 && d.cin % 8 == 0 && aligned16(x) && !d.L[0].q8;
  const TcLayer& last = d.L[nl - 1];
  dim3 grid((last.w_out + d.tile_w - 1) / d.tile_w, (last.h_out + d.tile_h - 1) / d.tile_h, n);
  auto go = [&](auto kern, const auto* xin, int vec) -> int {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, threads, smem, stream>>>(xin, static_cast<bf16*>(y), params, vec, d);
    return (int)cudaGetLastError();
  };
  const bf16* xb = static_cast<const bf16*>(x);
  const float* xf = static_cast<const float*>(x);
  if (x_bf16) return a8 ? go(conv_chain_tc_kernel<bf16, true>, xb, vec_x)
                        : go(conv_chain_tc_kernel<bf16, false>, xb, vec_x);
  return a8 ? go(conv_chain_tc_kernel<float, true>, xf, 0)
            : go(conv_chain_tc_kernel<float, false>, xf, 0);
}


// ------------------------------------------------------------ f32 (3xTF32) ----

// Fields of the f32 form's geometry array: the SNN_CG_FIELDS globals, two of
// its own (CF_GRID persistent CTAs, CF_RAW_OFF the frame buffer), then
// SNN_CF_FIELDS per layer (kernels/chain.py ChainF32Launch.array).
enum { CF_GRID = SNN_CG_FIELDS, CF_RAW_OFF, SNN_CF_GLOBALS };
enum { CF_CS, CF_OSTRIDE, CF_NG, CF_W_OFF, CF_KTAB_OFF, CF_PW, CF_PW_LO, CF_PS, CF_REG, CF_KP,
       CF_B_RAW, CF_PW_RAW, SNN_CF_FIELDS };

struct F32Layer {
  int k, c, o, act;
  float alpha;
  int dense;                    // C < 8: taps packed densely into K
  int a_lo, b_lo;               // A (the input region) / B (the weights) have a TF32 lo part
  int b_raw;                    // B staged as its f32 values and split at the fragment load
                                // (half the buffer: where the hi and lo images do not fit)
  int cs;                       // floats per staged input position
  int ksteps, nt, ng, ostride;  // k8 steps, n8-tiles, n8-tiles per pass, floats per B row
  int kp;                       // k8 steps whose products sum before they join the f32 sums
  int w_off, w_lo, ktab_off;    // smem bytes: B hi (the layer's, or the buffer's); lo - hi
  int pw, pw_lo, pw_raw, ps;    // byte offsets in params: B hi, lo, f32 values; scale|offset
  int rows_in, cols_in, rows_out, cols_out;
  float inv_cols;
  int a_out, l_out, h_out, w_out;
  int in_off, in_lo, out_off, out_lo;  // smem bytes of the regions (hi, lo)
  int ncs, ndense;              // the next layer's input layout
};

struct F32Desc {
  int nl, n, h, w, cin, a0, l0;
  int tile_h, tile_w, tail, w_all;
  int tiles, tiles_x, tiles_img;  // final-output tiles: all, of a row, of an image
  int raw_off, vec_x;             // the frame buffer (smem bytes); 16-byte copies into it
  F32Layer L[SNN_MAX_LAYERS];
};

__device__ __forceinline__ float tf32_hi(float v) { return __uint_as_float(tf32_rna(v)); }

// B rows [8 j0, 8 (j0 + cnt)) of a layer, hi and (b_lo) lo, or (b_raw) its
// f32 values, global -> shared.
__device__ __forceinline__ void stage_weights_f32(unsigned char* smem, const unsigned char* params,
                                                  const F32Layer& L, int j0, int cnt, bool w_all) {
  const int row = L.ostride * 4, bytes = 8 * cnt * row;
  const int src = 8 * j0 * row, dst = L.w_off + (w_all ? src : 0);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    cp_async16(smem + dst + 16 * i, params + (L.b_raw ? L.pw_raw : L.pw) + src + 16 * i, 16);
    if (L.b_lo && !L.b_raw)
      cp_async16(smem + dst + L.w_lo + 16 * i, params + L.pw_lo + src + 16 * i, 16);
  }
}

// Layer l's table of K offsets, in floats from a pixel's first staged
// position: dense, one per K index (-1: padding); else one per k8 step
// (one 8-channel unit of one tap).
__device__ void build_ktab_f32(unsigned char* smem, const F32Layer& L) {
  int* tab = reinterpret_cast<int*>(smem + L.ktab_off);
  const int U = (L.c + 7) >> 3;
  const int entries = L.dense ? 8 * L.ksteps : L.ksteps;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    if (L.dense) {
      const int tap = i / L.c, ci = i - tap * L.c;
      tab[i] = tap < L.k * L.k ? ((tap / L.k) * L.cols_in + tap % L.k) * L.c + ci : -1;
    } else {
      const int tap = i / U, u = i - tap * U;
      tab[i] = ((tap / L.k) * L.cols_in + tap % L.k) * L.cs + 8 * u;
    }
  }
}

// Layer 0's input region of a tile, raw (pixel-major, C contiguous, zero
// outside the image), into the frame buffer: by cp.async where the frame's
// rows allow 16-byte (or, f32, 4-byte) copies, so that it lands while the
// tile before computes; else by loads and stores.
template <typename TIn>
__device__ void fetch_input_f32(const TIn* __restrict__ x, unsigned char* smem, const F32Desc& d,
                                int n, int ty0, int tx0) {
  const F32Layer& L = d.L[0];
  TIn* raw = reinterpret_cast<TIn*>(smem + d.raw_off);
  const int R = L.rows_in, C = L.cols_in, c = L.c;
  const int gy0 = ty0 - d.a0, gx0 = tx0 - d.l0;
  constexpr int EPU = 16 / sizeof(TIn);  // elements of a 16-byte copy
  if (d.vec_x) {  // C % EPU == 0, x 16-byte aligned
    const int U = c / EPU;
    for (int i = threadIdx.x; i < R * C * U; i += blockDim.x) {
      const int u = i % U, pos = i / U;
      const int rr = pos / C, cc = pos - rr * C;
      const int gy = gy0 + rr, gx = gx0 + cc;
      const bool ok = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
      cp_async16(raw + pos * c + EPU * u,
                 ok ? x + (((size_t)n * d.h + gy) * d.w + gx) * c + EPU * u : x, ok ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < R * C * c; i += blockDim.x) {
    const int ci = i % c, pos = i / c;
    const int rr = pos / C, cc = pos - rr * C;
    const int gy = gy0 + rr, gx = gx0 + cc;
    const bool ok = gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
    const TIn* src = x + (((size_t)n * d.h + (ok ? gy : 0)) * d.w + (ok ? gx : 0)) * c + ci;
    if constexpr (sizeof(TIn) == 4) {
      cp_async4(raw + i, src, ok);
    } else {
      raw[i] = ok ? *src : TIn(0.f);
    }
  }
}

// The frame buffer split into layer 0's TF32 hi and (a_lo) lo regions.
template <typename TIn>
__device__ void split_input_f32(unsigned char* smem, const F32Desc& d) {
  const F32Layer& L = d.L[0];
  const TIn* raw = reinterpret_cast<const TIn*>(smem + d.raw_off);
  float* hi = reinterpret_cast<float*>(smem + L.in_off);
  float* lo = reinterpret_cast<float*>(smem + L.in_lo);
  const int P = L.rows_in * L.cols_in, c = L.c;
  if (L.dense) {
    for (int i = threadIdx.x; i < P * c; i += blockDim.x) {
      const float v = to_float(raw[i]), h = tf32_hi(v);
      hi[i] = h;
      if (L.a_lo) lo[i] = tf32_hi(v - h);
    }
    return;
  }
  const int U = (c + 7) >> 3;
  for (int i = threadIdx.x; i < P * U; i += blockDim.x) {
    const int u = i % U, pos = i / U;
    float vh[8], vl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = 8 * u + j < c ? to_float(raw[pos * c + 8 * u + j]) : 0.f;
      vh[j] = tf32_hi(v);
      vl[j] = tf32_hi(v - vh[j]);
    }
    float4* ph = reinterpret_cast<float4*>(hi + pos * L.cs + 8 * u);
    ph[0] = make_float4(vh[0], vh[1], vh[2], vh[3]);
    ph[1] = make_float4(vh[4], vh[5], vh[6], vh[7]);
    if (L.a_lo) {
      float4* pl = reinterpret_cast<float4*>(lo + pos * L.cs + 8 * u);
      pl[0] = make_float4(vl[0], vl[1], vl[2], vl[3]);
      pl[1] = make_float4(vl[4], vl[5], vl[6], vl[7]);
    }
  }
}

// The epilogue's activation over N values, each kind inlined once (the
// f32 form's epilogue is not the bf16 form's: its code size is not what
// bounds it, and a call per value was most of its last layer's epilogue
// under ESPCN's folded tanh).
template <int ACT, int G>
__device__ __forceinline__ void act_each(float (&v)[2][2][G][2], float alpha) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) v[i][h][j][q] = apply_act(v[i][h][j][q], ACT, alpha);
}

// Codes as in kernels/chain.py ACT_CODES; another code leaves v as it is,
// as apply_act does.
template <int G>
__device__ __forceinline__ void act_all(float (&v)[2][2][G][2], int act, float alpha) {
  switch (act) {
    case 1: act_each<1>(v, alpha); return;
    case 2: act_each<2>(v, alpha); return;
    case 3: act_each<3>(v, alpha); return;
    case 4: act_each<4>(v, alpha); return;
    case 5: act_each<5>(v, alpha); return;
    case 6: act_each<6>(v, alpha); return;
    case 7: act_each<7>(v, alpha); return;
    default: return;
  }
}

// One pass of a layer (output channels 8 j0 .. 8 (j0 + ng)) over its output
// region: pairs of m-tiles of 16 pixels round-robin over the warps, each B
// fragment serving both. 3xTF32: a_hi b_lo, a_lo b_hi (each only where
// that lo exists) and a_hi b_hi sum for kp k-steps (one tap) in
// accumulators of their own, then join the f32 sums with round-to-nearest
// adds. The epilogue writes the next layer's input already split (hi and
// lo regions) or, on the last layer, device memory.
template <bool DENSE>
__device__ void run_f32_layer(unsigned char* smem, const unsigned char* __restrict__ params,
                              const F32Layer& L, int tail, bool last, int n, int ty0, int tx0,
                              float* __restrict__ y, int j0, bool w_all) {
  constexpr int NG = 2;  // most n8-tiles of a pass
  const float* in_hi = reinterpret_cast<const float*>(smem + L.in_off);
  const float* in_lo = reinterpret_cast<const float*>(smem + L.in_lo);
  const int* tab = reinterpret_cast<const int*>(smem + L.ktab_off);
  float* out_hi = last ? nullptr : reinterpret_cast<float*>(smem + L.out_off);
  float* out_lo = last ? nullptr : reinterpret_cast<float*>(smem + L.out_lo);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int M = L.rows_out * L.cols_out, mtiles = (M + 15) / 16;
  const int cols_in = L.cols_in, cols_out = L.cols_out, cs = L.cs, ksteps = L.ksteps;
  const int kp = L.kp, ostride = L.ostride, o = L.o, act = L.act, ncs = L.ncs, ndense = L.ndense;
  const int nt = L.nt, np = min(L.ng, nt - j0);
  const bool a_lo = L.a_lo, b_lo = L.b_lo, b_raw = L.b_raw;
  const int gy0 = ty0 - L.a_out, gx0 = tx0 - L.l_out, h_out = L.h_out, w_out = L.w_out;
  const float alpha = L.alpha, inv_cols = L.inv_cols;
  const float* bhi = reinterpret_cast<const float*>(smem + L.w_off) + (w_all ? 8 * j0 * ostride : 0);
  const int blo = L.w_lo / 4;  // floats from a B hi row to its lo row
  // This thread's epilogue columns 8 (j0 + j) + 2t, +1.
  float sc[NG][2], of[NG][2];
  {
    const float* so = reinterpret_cast<const float*>(params + L.ps);
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * (j0 + j) + 2 * t + q;
        sc[j][q] = j < np ? so[col] : 0.f;
        of[j][q] = j < np ? so[8 * nt + col] : 0.f;
      }
  }
  // This lane's B row of each k8 step (n-major): n row (lane & 7) + 8 (lane >> 4),
  // float 4 ((lane >> 3) & 1).
  const float* brow = bhi + ((lane & 7) + 8 * (lane >> 4)) * ostride + 4 * ((lane >> 3) & 1);
  auto pixel = [&](int p) {  // float offset of pixel p's first input position
    const int ry = region_row(p, inv_cols);
    return (ry * cols_in + p - ry * cols_out) * cs;
  };
  for (int mt0 = 2 * warp; mt0 < mtiles; mt0 += 2 * nwarps) {
    float acc[2][NG][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    int pix[2][2];  // A rows: dense, pixels g and g + 8; else pixel lane & 15
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (DENSE) {
        pix[i][0] = pixel(min((mt0 + i) * 16 + g, M - 1));
        pix[i][1] = pixel(min((mt0 + i) * 16 + g + 8, M - 1));
      } else {
        pix[i][0] = pix[i][1] = pixel(min((mt0 + i) * 16 + (lane & 15), M - 1)) + 4 * (lane >> 4);
      }
    }
    for (int ks0 = 0; ks0 < ksteps; ks0 += kp) {
      // The tap's sums, one set per pass: three independent chains of
      // mma.sync for each fragment (its latency, not its rate, would bound
      // one chain).
      float hh[2][NG][4], lb[2][NG][4], la[2][NG][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) hh[i][j][q] = lb[i][j][q] = la[i][j][q] = 0.f;
      const int ke = min(ks0 + kp, ksteps);
#pragma unroll 2
      for (int ks = ks0; ks < ke; ++ks) {
        uint32_t ah[2][4], al[2][4];
        if constexpr (DENSE) {
          // A gathered in registers: rows g and g + 8, k t and t + 4.
          const int k0 = tab[ks * 8 + t], k1 = tab[ks * 8 + t + 4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            auto ld = [&](const float* r, int h, int ko) -> uint32_t {
              return ko >= 0 ? __float_as_uint(r[pix[i][h] + ko]) : 0u;
            };
            ah[i][0] = ld(in_hi, 0, k0); ah[i][1] = ld(in_hi, 1, k0);
            ah[i][2] = ld(in_hi, 0, k1); ah[i][3] = ld(in_hi, 1, k1);
            if (a_lo) {
              al[i][0] = ld(in_lo, 0, k0); al[i][1] = ld(in_lo, 1, k0);
              al[i][2] = ld(in_lo, 0, k1); al[i][3] = ld(in_lo, 1, k1);
            }
          }
        } else {
          // A from ldmatrix: this lane's pixel, shifted by the step's tap and unit.
          const int off = tab[ks];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ldmatrix_x4(ah[i], in_hi + pix[i][0] + off);
            if (a_lo) ldmatrix_x4(al[i], in_lo + pix[i][0] + off);
          }
        }
        const float* bp = brow + ks * 8;
        uint32_t bh[4], bl[4];
        if (b_raw) {  // split here: hi and lo of the staged f32 values
          uint32_t b4[4] = {0u, 0u, 0u, 0u};
          if (np > 1) {
            ldmatrix_x4(b4, bp);
          } else {
            uint32_t b2[2];
            ldmatrix_x2(b2, bp);
            b4[0] = b2[0]; b4[1] = b2[1];
          }
          split_tf32(b4, bh, bl);
        } else if (np > 1) {
          ldmatrix_x4(bh, bp);
          if (b_lo) ldmatrix_x4(bl, bp + blo);
        } else {
          uint32_t b2[2];
          ldmatrix_x2(b2, bp);
          bh[0] = b2[0]; bh[1] = b2[1]; bh[2] = bh[3] = 0u;
          if (b_lo) {
            ldmatrix_x2(b2, bp + blo);
            bl[0] = b2[0]; bl[1] = b2[1];
          }
          bl[2] = bl[3] = 0u;
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          if (j >= np) break;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (b_lo) mma_tf32(lb[i][j], ah[i], bl[2 * j], bl[2 * j + 1]);
            if (a_lo) mma_tf32(la[i][j], al[i], bh[2 * j], bh[2 * j + 1]);
            mma_tf32(hh[i][j], ah[i], bh[2 * j], bh[2 * j + 1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += hh[i][j][q] + (la[i][j][q] + lb[i][j][q]);
    }

    // Epilogue on the fragments: rows g and g + 8, channels 8 (j0 + j) + 2t, +1.
    // The pair's values first, then the activation over all of them (one
    // inlined copy per activation, the switch outside the loop).
    float v[2][2][NG][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) v[i][h][j][q] = fmaf(acc[i][j][2 * h + q], sc[j][q], of[j][q]);
    act_all(v, act, alpha);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mt0 + i) * 16 + g + 8 * h;
        if (p >= M) continue;
        const int ry = region_row(p, inv_cols), rx = p - ry * cols_out;
        const int gy = gy0 + ry, gx = gx0 + rx;
        const bool inside = gy >= 0 && gy < h_out && gx >= 0 && gx < w_out;
        if (last && !inside) continue;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          if (j >= np) break;
          const int oc = 8 * (j0 + j) + 2 * t;
          float v0 = v[i][h][j][0], v1 = v[i][h][j][1];
          if (!inside || oc >= o) v0 = 0.f;
          if (!inside || oc + 1 >= o) v1 = 0.f;
          if (!last) {  // the next layer's input, split as it will be read
            const float h0 = tf32_hi(v0), h1 = tf32_hi(v1);
            const float l0 = tf32_hi(v0 - h0), l1 = tf32_hi(v1 - h1);
            if (ndense) {  // the next layer's C = o < 8: stride o
              if (oc < o) { out_hi[p * o + oc] = h0; out_lo[p * o + oc] = l0; }
              if (oc + 1 < o) { out_hi[p * o + oc + 1] = h1; out_lo[p * o + oc + 1] = l1; }
            } else {  // every channel of the padded units, zeros past o
              *reinterpret_cast<float2*>(out_hi + p * ncs + oc) = make_float2(h0, h1);
              *reinterpret_cast<float2*>(out_lo + p * ncs + oc) = make_float2(l0, l1);
            }
          } else if (tail == 2) {
            // o == 4: the pair (py = t, px = 0..1) is one float2 of row 2gy+py.
            if (j0 + j == 0 && t < 2)
              *reinterpret_cast<float2*>(
                  y + ((size_t)n * 2 * h_out + 2 * gy + t) * 2 * w_out + 2 * gx) =
                  make_float2(v0, v1);
          } else {
            float* q = y + (((size_t)n * h_out + gy) * w_out + gx) * o;
            if ((o & 1) == 0 && oc < o) {
              *reinterpret_cast<float2*>(q + oc) = make_float2(v0, v1);
            } else {
              if (oc < o) q[oc] = v0;
              if (oc + 1 < o) q[oc + 1] = v1;
            }
          }
        }
      }
    }
  }
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ...; resident weights
// are staged once, and each tile's frame is fetched while the tile before
// computes.
template <typename TIn>
__global__ void __launch_bounds__(SNN_TC_MAX_THREADS)
conv_chain_tf32_kernel(const TIn* __restrict__ x, float* __restrict__ y,
                       const unsigned char* __restrict__ params,
                       const __grid_constant__ F32Desc d) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto origin = [&](int tile, int& n, int& ty0, int& tx0) {
    n = tile / d.tiles_img;
    const int t = tile - n * d.tiles_img, ty = t / d.tiles_x;
    ty0 = ty * d.tile_h;
    tx0 = (t - ty * d.tiles_x) * d.tile_w;
  };
  int n, ty0, tx0;
  if (d.w_all)
    for (int l = 0; l < d.nl; ++l) stage_weights_f32(smem, params, d.L[l], 0, d.L[l].nt, true);
  origin(blockIdx.x, n, ty0, tx0);
  fetch_input_f32<TIn>(x, smem, d, n, ty0, tx0);
  cp_async_commit();
  for (int l = 0; l < d.nl; ++l) build_ktab_f32(smem, d.L[l]);
  for (int tile = blockIdx.x; tile < d.tiles; tile += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's frame has landed; the tile before is done
    split_input_f32<TIn>(smem, d);
    __syncthreads();
    origin(tile, n, ty0, tx0);
    if (tile + (int)gridDim.x < d.tiles) {  // the next tile's frame, while this one computes
      int n1, ty1, tx1;
      origin(tile + gridDim.x, n1, ty1, tx1);
      fetch_input_f32<TIn>(x, smem, d, n1, ty1, tx1);
    }
    cp_async_commit();
    for (int l = 0; l < d.nl; ++l) {
      const F32Layer& L = d.L[l];
      const bool last = l == d.nl - 1;
      for (int j0 = 0; j0 < L.nt; j0 += L.ng) {
        if (!d.w_all) {  // one weight buffer: the pass before is done with it
          stage_weights_f32(smem, params, L, j0, min(L.ng, L.nt - j0), false);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        if (L.dense) {
          run_f32_layer<true>(smem, params, L, d.tail, last, n, ty0, tx0, y, j0, d.w_all);
        } else {
          run_f32_layer<false>(smem, params, L, d.tail, last, n, ty0, tx0, y, j0, d.w_all);
        }
        __syncthreads();
      }
    }
  }
}

int run_f32(const void* x, int x_bf16, void* y, const unsigned char* params, const int* layers,
            const float* alphas, const int* b_lo, int nl, int n, int h, int w, int tail,
            const int* geom, cudaStream_t stream) {
  F32Desc d;
  d.nl = nl; d.n = n; d.h = h; d.w = w; d.cin = layers[1]; d.tail = tail;
  d.tile_h = geom[CG_TILE_H]; d.tile_w = geom[CG_TILE_W]; d.w_all = geom[CG_W_ALL];
  const int threads = geom[CG_THREADS], smem = geom[CG_SMEM], pbytes = geom[CG_PARAM_BYTES];
  if (d.tile_h < 1 || d.tile_w < 1 || threads < 32 || threads % 32 ||
      threads > SNN_TC_MAX_THREADS || smem < 0 || smem > SNN_MAX_SMEM)
    return -5;
  int A[SNN_MAX_LAYERS + 1], B[SNN_MAX_LAYERS + 1], Lp[SNN_MAX_LAYERS + 1], Rp[SNN_MAX_LAYERS + 1];
  halo(layers, nl, A, B, Lp, Rp);
  d.a0 = A[0]; d.l0 = Lp[0];
  // Intervals of shared memory: (offset, bytes, slot), as in run_tc.
  long long iv[3 * SNN_MAX_LAYERS][3];
  int niv = 0, regs[SNN_MAX_LAYERS];
  int hh = h, ww = w, c = d.cin;
  for (int l = 0; l < nl; ++l) {
    const int* r = layers + 8 * l;
    const int* gl = geom + SNN_CF_GLOBALS + SNN_CF_FIELDS * l;
    F32Layer& L = d.L[l];
    L.k = r[0]; L.c = r[1]; L.o = r[2]; L.act = r[7]; L.alpha = alphas[l];
    if (L.c != c || L.k < 1 || L.o < 1 || L.o > 32 || L.c > 32) return -3;
    hh = hh + r[3] + r[4] - L.k + 1;
    ww = ww + r[5] + r[6] - L.k + 1;
    if (hh < 1 || ww < 1) return -3;
    L.h_out = hh; L.w_out = ww;
    L.a_out = A[l + 1]; L.l_out = Lp[l + 1];
    L.rows_in = d.tile_h + A[l] + B[l]; L.cols_in = d.tile_w + Lp[l] + Rp[l];
    L.rows_out = d.tile_h + A[l + 1] + B[l + 1];
    L.cols_out = d.tile_w + Lp[l + 1] + Rp[l + 1];
    if ((long long)L.rows_in * L.cols_in >= (1 << 20)) return -5;
    L.inv_cols = 1.f / (float)L.cols_out;
    L.dense = L.c < 8;
    L.a_lo = l > 0 || !x_bf16;  // a bf16 frame is exact in TF32
    L.b_lo = b_lo[l] != 0;
    L.b_raw = gl[CF_B_RAW];
    if (L.b_raw && d.w_all) return -5;
    const int U = (L.c + 7) / 8;
    L.cs = gl[CF_CS];
    if (L.dense ? L.cs != L.c : (L.cs < 8 * U || L.cs % 4 || (L.cs / 4) % 2 == 0)) return -5;
    L.ksteps = L.dense ? (L.k * L.k * L.c + 7) / 8 : L.k * L.k * U;
    L.nt = (L.o + 7) / 8;
    L.ng = gl[CF_NG];
    L.ostride = gl[CF_OSTRIDE];
    L.kp = gl[CF_KP];
    if (L.ng < 1 || L.ng > 2 || L.kp < 1 || L.ostride < 8 * L.ksteps || L.ostride % 4 ||
        (L.ostride / 4) % 2 == 0)
      return -5;
    const int image = 8 * L.nt * L.ostride * 4;  // bytes of one B image (hi or lo)
    L.w_off = gl[CF_W_OFF]; L.ktab_off = gl[CF_KTAB_OFF];
    L.w_lo = d.w_all ? image : 8 * L.ng * L.ostride * 4;
    L.pw = gl[CF_PW]; L.pw_lo = gl[CF_PW_LO]; L.pw_raw = gl[CF_PW_RAW]; L.ps = gl[CF_PS];
    for (int off : {L.pw, L.pw_lo, L.pw_raw})
      if (off < 0 || off % 16 || off + image > pbytes) return -5;
    if (L.ps < 0 || L.ps % 16 || L.ps + 64 * L.nt > pbytes) return -5;
    regs[l] = gl[CF_REG];
    if (regs[l] % 16 || regs[l] < 4 * L.rows_in * L.cols_in * L.cs) return -5;
    L.in_off = geom[l % 2 ? CG_BUF1 : CG_BUF0];
    L.out_off = geom[l % 2 ? CG_BUF0 : CG_BUF1];
    L.in_lo = L.in_off + regs[l];
    iv[niv][0] = L.in_off; iv[niv][1] = 2LL * regs[l]; iv[niv++][2] = l % 2;
    iv[niv][0] = L.w_off; iv[niv][1] = (L.b_raw ? 1LL : 2LL) * L.w_lo;
    iv[niv++][2] = d.w_all ? 10 + l : 2;
    iv[niv][0] = L.ktab_off; iv[niv][1] = 4LL * (L.dense ? 8 * L.ksteps : L.ksteps);
    iv[niv++][2] = 20 + l;
    c = L.o;
  }
  for (int l = 0; l < nl; ++l) {
    const bool has_next = l + 1 < nl;
    d.L[l].ncs = has_next ? d.L[l + 1].cs : 0;
    d.L[l].ndense = has_next && d.L[l + 1].dense;
    d.L[l].out_lo = has_next ? d.L[l].out_off + regs[l + 1] : 0;
  }
  if (tail == 1 && d.L[nl - 1].o != 1) return -3;
  if (tail == 2 && d.L[nl - 1].o != 4) return -3;
  for (int i = 0; i < niv; ++i) {
    if (iv[i][0] < 0 || iv[i][0] % 16 || iv[i][0] + iv[i][1] > smem) return -2;
    for (int j = 0; j < i; ++j)
      if (iv[i][2] != iv[j][2] && iv[i][0] < iv[j][0] + iv[j][1] && iv[j][0] < iv[i][0] + iv[i][1])
        return -2;
  }
  const F32Layer& last = d.L[nl - 1];
  d.tiles_x = (last.w_out + d.tile_w - 1) / d.tile_w;
  d.tiles_img = d.tiles_x * ((last.h_out + d.tile_h - 1) / d.tile_h);
  if ((long long)n * d.tiles_img > 2147483647LL) return -5;
  d.tiles = n * d.tiles_img;
  const int grid = geom[CF_GRID];
  d.raw_off = geom[CF_RAW_OFF];
  const long long raw = (long long)d.L[0].rows_in * d.L[0].cols_in * d.cin * (x_bf16 ? 2 : 4);
  if (grid < 1 || grid > d.tiles) return -5;
  if (d.raw_off < 0 || d.raw_off % 16 || d.raw_off + raw > smem) return -2;
  for (int i = 0; i < niv; ++i)
    if (d.raw_off < iv[i][0] + iv[i][1] && iv[i][0] < d.raw_off + raw) return -2;
  d.vec_x = d.cin % (x_bf16 ? 8 : 4) == 0 && aligned16(x);
  auto go = [&](auto kern, const auto* xin) -> int {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, threads, smem, stream>>>(xin, static_cast<float*>(y), params, d);
    return (int)cudaGetLastError();
  };
  if (x_bf16) return go(conv_chain_tf32_kernel<bf16>, static_cast<const bf16*>(x));
  return go(conv_chain_tf32_kernel<float>, static_cast<const float*>(x));
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (see snn_error_string). layers:
// nl rows of 8 ints (k, c, o, pt, pb, pl, pr, act), host memory.

// The f32 form (3xTF32). params: device bytes, per layer the B images hi,
// lo and the f32 values (n-major: 8 * nt rows of ostride floats, K in the
// kernel's order) and scale|offset (f32, nt * 8 each, zeros past o), at the offsets
// of geom; b_lo: per layer, host, whether its B lo image is read (0: the
// weights are exact in TF32, e.g. int8, and that pass is skipped); geom:
// SNN_CG_FIELDS + nl * SNN_CF_FIELDS ints (kernels/chain.py ChainF32Launch).
int snn_conv_chain_f32(const void* x, int x_bf16, void* y, const void* params, const int* layers,
                       const float* alphas, const int* b_lo, int nl, int n, int h, int w,
                       int tail, const int* geom, void* stream) {
  if (nl < 1 || nl > SNN_MAX_LAYERS) return -1;
  if (n < 1 || h < 1 || w < 1) return -4;
  return run_f32(x, x_bf16, y, static_cast<const unsigned char*>(params), layers, alphas, b_lo,
                 nl, n, h, w, tail, geom, static_cast<cudaStream_t>(stream));
}

// The bf16 form. params: device bytes, per layer the B image (bf16, K rows
// of ostride; an int8 layer's int8, n-major rows of ostride bytes) and
// scale|offset (f32, nt * 8 each, zeros past o), at the offsets of geom;
// inv_q: per layer 1/in_q where its input is int8 (CL_Q8), host f32; geom:
// the wrapper's launch geometry (SNN_CG_FIELDS + nl * SNN_CL_FIELDS ints;
// kernels/chain.py ChainLaunch).
int snn_conv_chain_tc(const void* x, int x_bf16, void* y, const void* params,
                      const int* layers, const float* alphas, const float* inv_q, int nl,
                      int n, int h, int w, int tail, const int* geom, void* stream) {
  if (nl < 1 || nl > SNN_MAX_LAYERS) return -1;
  if (n < 1 || h < 1 || w < 1) return -4;
  return run_tc(x, x_bf16, y, static_cast<const unsigned char*>(params), layers, alphas, inv_q,
                nl, n, h, w, tail, geom, static_cast<cudaStream_t>(stream));
}

const char* snn_error_string(int code) {
  switch (code) {
    case -1: return "number of layers outside [1, 8]";
    case -2: return "shared memory of the chain tile exceeds 227 KB, or the launch geometry's "
                    "buffers overlap";
    case -3: return "layer shapes do not chain (channels, o > 32, output size or tail), or an "
                    "int8 layer input without C % 8 == 0 and in_q > 0";
    case -4: return "empty input or tile";
    case -5: return "launch geometry outside the kernel (tile, threads, strides or parameter "
                    "offsets)";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
