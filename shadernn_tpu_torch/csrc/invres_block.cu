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
// w1 and w2 are T; the depthwise taps and the epilogue vectors f32.
//
// What bounds it on an H100: the blocks MobileNetV2 fuses (28x28 down to
// 7x7, E up to 960) do about 2 FLOPs per weight per pixel and read Cin and
// write Cout values per pixel, tens to hundreds of FLOPs per byte: with
// the expanded tensor kept on chip they are bound by operations on the
// tensor cores in bf16 and near the ridge in f32. This first version
// issues its FLOPs as f32 FMAs on the CUDA cores; what its design secures
// is the traffic: each input pixel is read about once (plus a one-pixel
// halo), each output written once, nothing else leaves the chip.
//
// Design: one CTA per (image, tile of TH x TW output pixels, at most 8x8,
// slice of E), 256 threads. The CTA stages its input tile with a one-pixel
// halo in shared memory and walks its slice of E in chunks of 32 channels
// (one per lane). For each chunk it stages the chunk's weights, recomputes
// the expanded halo tile (each warp four pixels at a time, the input read
// as broadcast float4s; masked to exact zeros outside the image, rounded),
// runs the depthwise over the tile with the taps in registers (rounded),
// and adds d_chunk @ W2[chunk, :] into an f32 accumulator held in
// registers: warp w owns pixels w, w+8, ... and lane l owns output
// channels l, l+32, .... Small images give few tiles, so when the tiles
// alone would leave SMs idle, E is split over the CTAs of a thread-block
// cluster (up to 8): each writes its partial sums to its shared memory and,
// after a cluster barrier, each finishes a share of the outputs by adding
// the partials of every CTA of the cluster in rank order (distributed
// shared memory; deterministic). The summation order over E differs from
// the TPU kernel's whole-E dot.

#include <cooperative_groups.h>
#include "snn_common.cuh"

#define SNN_EC 32            // expanded channels per chunk (one per lane)
#define SNN_MP 8             // pixels per warp (tile <= 64 pixels, 8 warps)
#define SNN_KC 10            // output channels per lane (Cout <= 320)
#define SNN_THREADS 256

namespace cg = cooperative_groups;

namespace {

struct InvResDesc {
  int n, h, w, cin, e, cout;
  int has_expand, residual;
  int act_e, act_d, act_o;
  float alpha;
  int tile_h, tile_w, tiles_x;
  int split;   // CTAs of the cluster that share the tile's E (gridDim.z)
  int cin4;    // staged input row stride: cin rounded up to 4, zero-padded
  int xs_off, es_off, ds_off, w1_off, wd_off, w2_off, red_off;  // smem floats
};

template <typename T>
__global__ void __launch_bounds__(SNN_THREADS)
invres_kernel(const T* __restrict__ x, T* __restrict__ y,
              const T* __restrict__ w1, const float* __restrict__ s1,
              const float* __restrict__ o1, const float* __restrict__ wd,
              const float* __restrict__ sd, const float* __restrict__ od,
              const T* __restrict__ w2, const float* __restrict__ s2,
              const float* __restrict__ o2, const __grid_constant__ InvResDesc d) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + d.xs_off;   // [HP][cin]   input tile + halo
  float* es = smem + d.es_off;   // [HP][EC]    expanded chunk
  float* ds = smem + d.ds_off;   // [P][EC]     depthwise output chunk
  float* w1s = smem + d.w1_off;  // [cin][EC]
  float* wds = smem + d.wd_off;  // [9][EC] depthwise taps of the chunk
  float* vec = wds + 9 * SNN_EC; // [4][EC] s1, o1, sd, od of the chunk
  float* w2s = smem + d.w2_off;  // [EC][cout]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / d.tiles_x) * d.tile_h;
  const int tx0 = (blockIdx.x % d.tiles_x) * d.tile_w;
  const int HC = d.tile_w + 2, HP = (d.tile_h + 2) * HC;
  const int P = d.tile_h * d.tile_w;
  const int cin = d.cin, cin4 = d.cin4, cout = d.cout;

  // Input tile + one-pixel halo, zero outside the image and past cin.
  for (int i = tid; i < HP * cin4; i += SNN_THREADS) {
    const int ci = i % cin4, hp = i / cin4;
    const int gy = ty0 - 1 + hp / HC, gx = tx0 - 1 + hp % HC;
    float v = 0.f;
    if (ci < cin && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w)
      v = to_float(x[(((size_t)n * d.h + gy) * d.w + gx) * cin + ci]);
    xs[i] = v;
  }

  float acc[SNN_MP][SNN_KC];
#pragma unroll
  for (int m = 0; m < SNN_MP; ++m)
#pragma unroll
    for (int k = 0; k < SNN_KC; ++k) acc[m][k] = 0.f;

  // This CTA's slice of the E chunks.
  const int chunks = (d.e + SNN_EC - 1) / SNN_EC;
  const int rank = blockIdx.z;
  const int c_end = (rank + 1) * chunks / d.split;
  for (int c = rank * chunks / d.split; c < c_end; ++c) {
    const int e0 = c * SNN_EC;
    __syncthreads();  // xs staged; the previous chunk is done with the buffers
    const int ej = e0 + lane;
    const bool live = ej < d.e;
    if (d.has_expand) {
      for (int i = tid; i < cin4 * SNN_EC; i += SNN_THREADS) {
        const int ci = i / SNN_EC, j = i - ci * SNN_EC;
        w1s[i] = ci < cin && e0 + j < d.e ? to_float(w1[(size_t)ci * d.e + e0 + j]) : 0.f;
      }
    }
    // Rows 0-8: depthwise taps; 9-12: s1, o1, sd, od.
    for (int i = tid; i < 13 * SNN_EC; i += SNN_THREADS) {
      const int r = i / SNN_EC, ec = e0 + i - r * SNN_EC;
      float v = 0.f;
      if (ec < d.e) {
        if (r < 9) v = wd[r * d.e + ec];
        else if (r == 9) v = d.has_expand ? s1[ec] : 0.f;
        else if (r == 10) v = d.has_expand ? o1[ec] : 0.f;
        else v = r == 11 ? sd[ec] : od[ec];
      }
      wds[i] = v;
    }
    for (int i = tid; i < SNN_EC * cout; i += SNN_THREADS) {
      const int j = i / cout, co = i - j * cout;
      w2s[i] = e0 + j < d.e ? to_float(w2[(size_t)(e0 + j) * cout + co]) : 0.f;
    }
    __syncthreads();

    // Expand over the halo tile: warp -> 4 pixels (hb + 8q), lane -> channel.
    for (int hb = warp; hb < HP; hb += 4 * (SNN_THREADS / 32)) {
      int hp[4];
      bool inside[4], any = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hp[q] = hb + 8 * q;
        const int gy = ty0 - 1 + hp[q] / HC, gx = tx0 - 1 + hp[q] % HC;
        inside[q] = hp[q] < HP && gy >= 0 && gy < d.h && gx >= 0 && gx < d.w;
        any |= inside[q];
      }
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (any && d.has_expand) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        const float* xp[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xp[q] = xs + (hp[q] < HP ? hp[q] : 0) * cin4;
        for (int ci = 0; ci < cin4; ci += 4) {
          const float w0 = w1s[ci * SNN_EC + lane], w1v = w1s[(ci + 1) * SNN_EC + lane];
          const float w2v = w1s[(ci + 2) * SNN_EC + lane], w3 = w1s[(ci + 3) * SNN_EC + lane];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 xv = *reinterpret_cast<const float4*>(xp[q] + ci);
            s[q] = fmaf(xv.x, w0, s[q]);
            s[q] = fmaf(xv.y, w1v, s[q]);
            s[q] = fmaf(xv.z, w2v, s[q]);
            s[q] = fmaf(xv.w, w3, s[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = apply_act(fmaf(s[q], vec[lane], vec[SNN_EC + lane]), d.act_e, d.alpha);
          if (BF16) v[q] = round_bf16(v[q]);
        }
      } else if (any && live) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = hp[q] < HP ? xs[hp[q] * cin4 + ej] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (hp[q] < HP) es[hp[q] * SNN_EC + lane] = inside[q] && live ? v[q] : 0.f;
    }
    __syncthreads();

    // Depthwise 3x3 over the tile, f32 taps held in registers.
    {
      float tap[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) tap[t] = wds[t * SNN_EC + lane];
      const float sdl = vec[2 * SNN_EC + lane], odl = vec[3 * SNN_EC + lane];
      for (int p = warp; p < P; p += SNN_THREADS / 32) {
        const int py = p / d.tile_w, px = p - py * d.tile_w;
        const float* ep = es + (py * HC + px) * SNN_EC + lane;
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s = fmaf(ep[(dy * HC + dx) * SNN_EC], tap[3 * dy + dx], s);
        float v = apply_act(fmaf(s, sdl, odl), d.act_d, d.alpha);
        if (BF16) v = round_bf16(v);
        ds[p * SNN_EC + lane] = live ? v : 0.f;
      }
    }
    __syncthreads();

    // Project: acc[m][k] += d[pixel warp+8m][:] . w2[:, lane+32k].
    for (int j = 0; j < SNN_EC; ++j) {
      float dv[SNN_MP], wv[SNN_KC];
#pragma unroll
      for (int m = 0; m < SNN_MP; ++m) {
        const int p = warp + 8 * m;
        dv[m] = p < P ? ds[p * SNN_EC + j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < SNN_KC; ++k) {
        const int co = lane + 32 * k;
        wv[k] = co < cout ? w2s[j * cout + co] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < SNN_MP; ++m)
#pragma unroll
        for (int k = 0; k < SNN_KC; ++k) acc[m][k] = fmaf(dv[m], wv[k], acc[m][k]);
    }
  }

  // Epilogue of one output: scale/offset, residual, act_out, rounding, store.
  auto finish = [&](int p, int co, float a) {
    const int py = p / d.tile_w, px = p - py * d.tile_w;
    const int gy = ty0 + py, gx = tx0 + px;
    if (gy >= d.h || gx >= d.w) return;
    float v = fmaf(a, s2[co], o2[co]);
    if (d.residual) v += xs[((py + 1) * HC + px + 1) * cin4 + co];
    v = apply_act(v, d.act_o, d.alpha);
    T* yo = y + (((size_t)n * d.h + gy) * d.w + gx) * cout + co;
    if constexpr (BF16) {
      *yo = __float2bfloat16_rn(v);
    } else {
      *yo = v;
    }
  };

  if (d.split == 1) {
#pragma unroll
    for (int m = 0; m < SNN_MP; ++m) {
      const int p = warp + 8 * m;
      if (p >= P) continue;
#pragma unroll
      for (int k = 0; k < SNN_KC; ++k) {
        const int co = lane + 32 * k;
        if (co < cout) finish(p, co, acc[m][k]);
      }
    }
    return;
  }

  // Split E: partial sums to shared memory, then each CTA of the cluster
  // finishes every split-th output, adding the partials in rank order.
  __syncthreads();  // the chunk buffers (which red overlays) are free
  float* red = smem + d.red_off;  // [P][cout]
#pragma unroll
  for (int m = 0; m < SNN_MP; ++m) {
    const int p = warp + 8 * m;
    if (p >= P) continue;
#pragma unroll
    for (int k = 0; k < SNN_KC; ++k) {
      const int co = lane + 32 * k;
      if (co < cout) red[p * cout + co] = acc[m][k];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = rank + d.split * tid; i < P * cout; i += d.split * SNN_THREADS) {
    float a = 0.f;
    for (int q = 0; q < d.split; ++q) a += cluster.map_shared_rank(red, q)[i];
    finish(i / cout, i % cout, a);
  }
  cluster.sync();  // peers' shared memory stays alive until every read is done
}

// Shared-memory layout of one CTA (floats). The split-E partial sums
// overlay the per-chunk buffers, which are free by then.
int layout(InvResDesc& d) {
  const int hp = (d.tile_h + 2) * (d.tile_w + 2);
  int cur = 0;
  d.xs_off = cur; cur += hp * d.cin4;
  const int chunk_start = cur;
  d.es_off = cur; cur += hp * SNN_EC;
  d.ds_off = cur; cur += d.tile_h * d.tile_w * SNN_EC;
  d.w1_off = cur; cur += d.has_expand ? d.cin4 * SNN_EC : 0;
  d.wd_off = cur; cur += 13 * SNN_EC;  // taps, then s1, o1, sd, od
  d.w2_off = cur; cur += SNN_EC * d.cout;
  d.red_off = chunk_start;
  const int red_end = chunk_start + (d.split > 1 ? d.tile_h * d.tile_w * d.cout : 0);
  return cur > red_end ? cur : red_end;
}

template <typename T>
int launch(const void* x, void* y, const void* const* ops, const InvResDesc& d,
           size_t smem, cudaStream_t stream) {
  auto kern = invres_kernel<T>;
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
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<T*>(y),
                           static_cast<const T*>(ops[0]), f(1), f(2), f(3), f(4), f(5),
                           static_cast<const T*>(ops[6]), f(7), f(8), d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_invres_error), or the cudaError_t of the launch.
// ops: 9 device pointers w1 (cin x e, in x's dtype; unused without
// expand), s1, o1, wd (9 x e), sd, od (f32), w2 (e x cout, in x's dtype),
// s2, o2 (f32). acts: act_e, act_d, act_o.
// The tile (at most 8x8 pixels) and the split of E over a cluster (1, 2, 4
// or 8 CTAs) are the caller's choice; they change the speed, and the
// split the order of the sum over E.
int snn_invres_block(const void* x, int bf16, void* y, const void* const* ops,
                     int n, int h, int w, int cin, int e, int cout,
                     int has_expand, int residual, const int* acts, float alpha,
                     int tile_h, int tile_w, int split, void* stream) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || e < 1 || cout < 1) return -1;
  if (tile_h < 1 || tile_w < 1 || tile_h * tile_w > 8 * SNN_MP) return -1;
  if (split != 1 && split != 2 && split != 4 && split != 8) return -4;
  if (cout > 32 * SNN_KC || (!has_expand && e != cin) || (residual && cin != cout)) return -3;
  InvResDesc d;
  d.n = n; d.h = h; d.w = w; d.cin = cin; d.e = e; d.cout = cout;
  d.has_expand = has_expand; d.residual = residual;
  d.act_e = acts[0]; d.act_d = acts[1]; d.act_o = acts[2];
  d.alpha = alpha;
  d.tile_h = tile_h; d.tile_w = tile_w;
  d.tiles_x = (w + tile_w - 1) / tile_w;
  d.split = split;
  d.cin4 = (cin + 3) & ~3;
  const size_t smem = (size_t)layout(d) * sizeof(float);
  if (smem > SNN_MAX_SMEM) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, y, ops, d, smem, s)
              : launch<float>(x, y, ops, d, smem, s);
}

const char* snn_invres_error(int code) {
  switch (code) {
    case -1: return "empty input or a tile outside 1..64 pixels";
    case -2: return "shared memory of the block's tile exceeds 227 KB";
    case -3: return "shapes outside the kernel (cout <= 320; e == cin without expand; "
                    "cin == cout with a residual)";
    case -4: return "split of E not 1, 2, 4 or 8";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
