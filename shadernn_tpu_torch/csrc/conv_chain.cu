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
// per layer l an HWIO weight (values in the compute dtype, staged as f32),
// an f32 accumulation, then y = act(acc * scale[o] + offset[o]) in f32;
// every intermediate is zeroed outside the image (it is the next layer's
// padding) and rounded to the compute dtype. Tails: 0 = none, NHWC
// (N,H,W,o); 1 = c1, (N,H,W,1) (the same layout with o = 1); 2 = d2s2,
// o = 4 through depth_to_space(2) in TF channel order, (N,2H,2W,1).
//
// What bounds it on an H100: ESPCN at 540p does 2*518400*3280 = 3.4 GFLOP
// per frame over 6.2 MB of input and output, about 550 FLOP/byte, so the
// chain is compute-bound once its intermediates stay on chip (as here).
// This first version issues those FLOPs as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16), so it
// cannot come near the bound; what the design does is keep the data
// movement at the bound: one read of the input tile plus its halo, one
// write of the output, nothing in between through device memory.
//
// Design: one CTA per (image, tile of TH x TW final-output pixels). The
// CTA loads its input tile plus the chain's accumulated halo, stages all
// weights and scale/offset in shared memory, and computes each layer over
// its shrinking region (ping-pong buffers, channel-planar so neighbouring
// threads read neighbouring words), one thread per output pixel, CH output
// channels per pass held in registers (weights read as broadcast float4).
// The halo rows/columns are recomputed by neighbouring tiles. No wgmma and
// no TMA yet: those are for a later version.

#include "snn_common.cuh"

#define SNN_MAX_LAYERS 8
#define SNN_THREADS 256

namespace {

struct LayerDesc {
  int k, c, o, pt, pl, act, ch, o_pad;
  float alpha;
  int p_off;                   // float offset of [w | scale | offset] in params
  int sw_off, ss_off;          // smem offsets: chunked weights, scale+offset
  int h_out, w_out;            // valid output size of this layer
  int a_out, l_out;            // accumulated top/left pads of later layers
  int rows_in, cols_in, rows_out, cols_out;
  int in_buf, out_buf;         // smem offsets of the input/output regions
};

struct ChainDesc {
  int nl, n, h, w, cin;
  int a0, l0;
  int tile_h, tile_w, tail;
  LayerDesc L[SNN_MAX_LAYERS];
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One layer over its output region. The last layer writes device memory.
template <int CH, bool BF16>
__device__ void run_layer(float* smem, const LayerDesc& L, const ChainDesc& d,
                          bool last, int n, int ty0, int tx0, void* y) {
  using TOut = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  const float* in = smem + L.in_buf;
  float* out = smem + L.out_buf;
  const float* wts = smem + L.sw_off;
  const float* sc = smem + L.ss_off;
  const float* of = sc + L.o_pad;
  const int R = L.rows_out, C = L.cols_out;
  const int Cin = L.cols_in, plane = L.rows_in * L.cols_in;
  const int kk = L.k * L.k * L.c;
  const int gy0 = ty0 - L.a_out, gx0 = tx0 - L.l_out;
  for (int p = threadIdx.x; p < R * C; p += SNN_THREADS) {
    const int ry = p / C, rx = p - ry * C;
    const int gy = gy0 + ry, gx = gx0 + rx;
    const bool inside = gy >= 0 && gy < L.h_out && gx >= 0 && gx < L.w_out;
    if (last && !inside) continue;
    const float* ip = in + ry * Cin + rx;
    for (int chunk = 0; chunk < L.o_pad / CH; ++chunk) {
      float acc[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) acc[j] = 0.f;
      const float* wp = wts + chunk * kk * CH;
      for (int dy = 0; dy < L.k; ++dy) {
        for (int dx = 0; dx < L.k; ++dx) {
          const float* ipp = ip + dy * Cin + dx;
          for (int ci = 0; ci < L.c; ++ci) {
            const float v = ipp[ci * plane];
            float w[CH];
            load_w<CH>(wp, w);
#pragma unroll
            for (int j = 0; j < CH; ++j) acc[j] = fmaf(v, w[j], acc[j]);
            wp += CH;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int oc = chunk * CH + j;
        float v = apply_act(fmaf(acc[j], sc[oc], of[oc]), L.act, L.alpha);
        if (!inside) v = 0.f;
        acc[j] = BF16 ? round_bf16(v) : v;
      }
      if (!last) {
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int oc = chunk * CH + j;
          if (oc < L.o) out[(oc * R + ry) * C + rx] = acc[j];
        }
      } else if (d.tail == 2) {
        // depth_to_space(2), channel py*2+px -> (2gy+py, 2gx+px); o == 4
        // gives CH == 4 (checked on the host).
        if constexpr (CH == 4) {
          TOut* yo = static_cast<TOut*>(y);
          const int W2 = 2 * L.w_out;
#pragma unroll
          for (int py = 0; py < 2; ++py) {
            TOut* row = yo + ((size_t)n * 2 * L.h_out + 2 * gy + py) * W2 + 2 * gx;
            if constexpr (BF16) {
              *reinterpret_cast<__nv_bfloat162*>(row) =
                  __floats2bfloat162_rn(acc[2 * py], acc[2 * py + 1]);
            } else {
              *reinterpret_cast<float2*>(row) = make_float2(acc[2 * py], acc[2 * py + 1]);
            }
          }
        }
      } else {
        TOut* yo = static_cast<TOut*>(y) +
                   (((size_t)n * L.h_out + gy) * L.w_out + gx) * L.o;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int oc = chunk * CH + j;
          if (oc < L.o) yo[oc] = from_float<TOut>(acc[j]);
        }
      }
    }
  }
}

template <typename TIn, bool BF16>
__global__ void __launch_bounds__(SNN_THREADS)
conv_chain_kernel(const TIn* __restrict__ x, void* __restrict__ y,
                  const float* __restrict__ params,
                  const __grid_constant__ ChainDesc d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * d.tile_h;
  const int tx0 = blockIdx.x * d.tile_w;

  // Stage weights as [chunk][dy][dx][c][CH] (zeros past o) and scale/offset.
  for (int l = 0; l < d.nl; ++l) {
    const LayerDesc& L = d.L[l];
    const float* gw = params + L.p_off;
    const int kk = L.k * L.k * L.c;
    for (int i = tid; i < L.o_pad * kk; i += SNN_THREADS) {
      const int j = i % L.ch, r = i / L.ch;
      const int q = r % kk, oc = (r / kk) * L.ch + j;
      smem[L.sw_off + i] = oc < L.o ? gw[q * L.o + oc] : 0.f;
    }
    for (int i = tid; i < L.o_pad; i += SNN_THREADS) {
      smem[L.ss_off + i] = i < L.o ? gw[kk * L.o + i] : 0.f;
      smem[L.ss_off + L.o_pad + i] = i < L.o ? gw[kk * L.o + L.o + i] : 0.f;
    }
  }

  // Input tile + halo, channel-planar, zero outside the image.
  {
    const LayerDesc& L0 = d.L[0];
    float* buf = smem + L0.in_buf;
    const int R = L0.rows_in, C = L0.cols_in;
    const int gy0 = ty0 - d.a0, gx0 = tx0 - d.l0;
    for (int i = tid; i < R * C * d.cin; i += SNN_THREADS) {
      const int ci = i % d.cin, p = i / d.cin;
      const int rr = p / C, cc = p - rr * C;
      const int gy = gy0 + rr, gx = gx0 + cc;
      float v = 0.f;
      if (gy >= 0 && gy < d.h && gx >= 0 && gx < d.w) {
        v = to_float(x[(((size_t)n * d.h + gy) * d.w + gx) * d.cin + ci]);
        if (BF16) v = round_bf16(v);
      }
      buf[(ci * R + rr) * C + cc] = v;
    }
  }
  __syncthreads();

  for (int l = 0; l < d.nl; ++l) {
    const LayerDesc& L = d.L[l];
    const bool last = l == d.nl - 1;
    switch (L.ch) {
      case 8: run_layer<8, BF16>(smem, L, d, last, n, ty0, tx0, y); break;
      case 4: run_layer<4, BF16>(smem, L, d, last, n, ty0, tx0, y); break;
      default: run_layer<1, BF16>(smem, L, d, last, n, ty0, tx0, y); break;
    }
    __syncthreads();
  }
}

inline int round4(int v) { return (v + 3) & ~3; }

template <typename TIn, bool BF16>
int launch(const void* x, void* y, const float* params, const ChainDesc& d,
           size_t smem, cudaStream_t stream) {
  auto kern = conv_chain_kernel<TIn, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const LayerDesc& last = d.L[d.nl - 1];
  dim3 grid((last.w_out + d.tile_w - 1) / d.tile_w,
            (last.h_out + d.tile_h - 1) / d.tile_h, d.n);
  kern<<<grid, SNN_THREADS, smem, stream>>>(static_cast<const TIn*>(x), y, params, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (see snn_error_string).
// layers: nl rows of 8 ints (k, c, o, pt, pb, pl, pr, act), host memory.
// params: device f32, per layer [w HWIO (k*k*c*o) | scale (o) | offset (o)].
int snn_conv_chain(const void* x, int x_bf16, void* y, const float* params,
                   const int* layers, const float* alphas, int nl, int n,
                   int h, int w, int compute_bf16, int tail, int tile_h,
                   int tile_w, void* stream) {
  if (nl < 1 || nl > SNN_MAX_LAYERS) return -1;
  if (tile_h < 1 || tile_w < 1 || n < 1 || h < 1 || w < 1) return -4;
  ChainDesc d;
  d.nl = nl; d.n = n; d.h = h; d.w = w; d.cin = layers[1];
  d.tile_h = tile_h; d.tile_w = tile_w; d.tail = tail;
  int A[SNN_MAX_LAYERS + 1], B[SNN_MAX_LAYERS + 1];
  int Lp[SNN_MAX_LAYERS + 1], Rp[SNN_MAX_LAYERS + 1];
  A[nl] = B[nl] = Lp[nl] = Rp[nl] = 0;
  for (int l = nl - 1; l >= 0; --l) {
    const int* r = layers + 8 * l;
    A[l] = A[l + 1] + r[3];
    B[l] = B[l + 1] + (r[0] - 1 - r[3]);
    Lp[l] = Lp[l + 1] + r[5];
    Rp[l] = Rp[l + 1] + (r[0] - 1 - r[5]);
  }
  d.a0 = A[0]; d.l0 = Lp[0];
  int hh = h, ww = w, c = d.cin, p_off = 0, cur = 0;
  int buf_size[2] = {0, 0};
  for (int l = 0; l < nl; ++l) {
    const int* r = layers + 8 * l;
    LayerDesc& L = d.L[l];
    L.k = r[0]; L.c = r[1]; L.o = r[2]; L.pt = r[3]; L.pl = r[5]; L.act = r[7];
    L.alpha = alphas[l];
    if (L.c != c || L.k < 1 || L.o < 1 || L.o > 32) return -3;
    L.ch = L.o > 4 ? 8 : (L.o > 1 ? 4 : 1);
    L.o_pad = (L.o + L.ch - 1) / L.ch * L.ch;
    L.p_off = p_off;
    p_off += L.k * L.k * L.c * L.o + 2 * L.o;
    L.sw_off = cur; cur += round4(L.o_pad * L.k * L.k * L.c);
    L.ss_off = cur; cur += round4(2 * L.o_pad);
    hh = hh + r[3] + r[4] - L.k + 1;
    ww = ww + r[5] + r[6] - L.k + 1;
    if (hh < 1 || ww < 1) return -3;
    L.h_out = hh; L.w_out = ww;
    L.a_out = A[l + 1]; L.l_out = Lp[l + 1];
    L.rows_in = tile_h + A[l] + B[l]; L.cols_in = tile_w + Lp[l] + Rp[l];
    L.rows_out = tile_h + A[l + 1] + B[l + 1];
    L.cols_out = tile_w + Lp[l + 1] + Rp[l + 1];
    int region = L.c * L.rows_in * L.cols_in;
    if (region > buf_size[l % 2]) buf_size[l % 2] = region;
    c = L.o;
  }
  if (tail == 1 && d.L[nl - 1].o != 1) return -3;
  if (tail == 2 && d.L[nl - 1].o != 4) return -3;
  const int buf0 = cur; cur += round4(buf_size[0]);
  const int buf1 = cur; cur += round4(buf_size[1]);
  for (int l = 0; l < nl; ++l) {
    d.L[l].in_buf = l % 2 ? buf1 : buf0;
    d.L[l].out_buf = l % 2 ? buf0 : buf1;
  }
  const size_t smem = (size_t)cur * sizeof(float);
  if (smem > SNN_MAX_SMEM) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return compute_bf16 ? launch<__nv_bfloat16, true>(x, y, params, d, smem, s)
                        : launch<__nv_bfloat16, false>(x, y, params, d, smem, s);
  }
  return compute_bf16 ? launch<float, true>(x, y, params, d, smem, s)
                      : launch<float, false>(x, y, params, d, smem, s);
}

const char* snn_error_string(int code) {
  switch (code) {
    case -1: return "number of layers outside [1, 8]";
    case -2: return "shared memory of the chain tile exceeds 227 KB";
    case -3: return "layer shapes do not chain (channels, o > 32, output size or tail)";
    case -4: return "empty input or tile";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
