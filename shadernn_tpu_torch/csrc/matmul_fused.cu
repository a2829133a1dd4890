// Fused matmul with a per-column epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package
//   shadernn_tpu/kernels/matmul_pallas.py : _matmul_kernel
//       (entry point fused_matmul, reached through shadernn_tpu/ops/dense.py
//        when the backend is forced to the kernel)
//
// Function: y = act((x @ W) * scale + offset), x (M,K) f32 or bf16, W (K,N)
// in x's dtype or int8 (upcast on load; every int8 value is exact in bf16,
// the dequantisation scale arrives folded into `scale`), the sum and the
// epilogue in f32, one rounding to x's dtype on store. bf16 x bf16 products
// are exact in f32; f32 runs as true f32 FMAs (nothing rounds to TF32).
// M, K and N need not be multiples of anything: the ragged tiles are
// masked here, and x and W are never padded on the host.
//
// softmax is taken over the N true columns of a row. (The TPU kernel
// applies the activation per padded 128-column tile, which is wrong for
// softmax; this kernel does not copy that.)
//
// What bounds it on an H100: the classifier heads this serves (8x512x10,
// 64x128x10, 8x1280x1000) move a few KB to 2.6 MB and do at most 20 MFLOP:
// every one is bound by launch latency, then by reading W once. So the
// design reads W once, in 16-byte loads along N, and spreads that read
// over as many SMs as the shape allows.
//
// Design: one product core for both dtypes. A CTA owns a block of BN (16
// or 32) columns over a block of MB rows (bf16 16, f32 1; where W is
// large, up to 64 / 8 rows, so that W is read once); a cluster of `split`
// CTAs shares the block, each a contiguous share of K, where the blocks
// alone would leave SMs idle. x and W are staged in shared memory in
// chunks of K (cp.async, two buffers; a share of up to 256 is one chunk).
// bf16: mma.sync m16n8k16 (rows padded to 16 by zeros), warp (wn, wk)
// owns n8-tile wn and every WK-th k16 step. f32: thread (column, K group)
// FMAs its group's share (4 consecutive k of every 4 * groups) of one
// column for every row. Partial sums are added in warp (K group) order,
// then over the cluster through distributed shared memory in rank order,
// each rank finishing a share of the rows (a warp per row: the sum, the
// epilogue and, for softmax, the row's max and sum of exponentials): the
// result is deterministic.
// softmax: one column block takes the row in the CTA; with more, each CTA
// writes the f32 logits and the max and sum of exponentials of its rows to
// a scratch, and the last cluster of a row block to arrive (a per-row-block
// counter in a wrapper-owned scratch, counted after a __threadfence; that
// cluster sets the counter back to 0) combines the statistics and writes
// every probability of its rows, its CTAs a share each, 4 elements per
// load (one CTA alone would spend half of the 8x1280x1000 head's time on
// that pass). One launch at every N.
//
// The launch geometry (BN, MB, BK, split, strides, the shared-memory
// layout) is the wrapper's (kernels/matmul.py launch_geometry); this file
// checks it and launches.

#include <cooperative_groups.h>

#include "snn_common.cuh"
#include "snn_mma.cuh"

namespace cg = cooperative_groups;

#define SNN_MM_THREADS 256

// Fields of the geometry array (kernels/matmul.py MatmulLaunch).
enum { MG_BN, MG_MB, MG_BK, MG_SPLIT, MG_XSTRIDE, MG_WSTRIDE, MG_XS_OFF, MG_WS_OFF, MG_RED_OFF,
       MG_PART_OFF, MG_SO_OFF, MG_SMEM, MG_FIELDS };

namespace {

struct MatmulDesc {
  int m, k, n;
  int act;
  float alpha;
  int softmax;
  int bn, mb, bk, split, kr;  // kr: K per cluster rank
  int xstride, wstride;       // elements per staged x row / W row
  int xs_off, ws_off, red_off, part_off, so_off, xs_buf, ws_buf;  // smem bytes
  int col_blocks, vec_x, vec_w;
};

template <bool MAX>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, s);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  return v;
}

// TS: the staged dtype (bf16 on the tensor cores, f32 on the CUDA cores).
template <typename TX, typename TW>
__global__ void __launch_bounds__(SNN_MM_THREADS)
matmul_fused_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ offset,
                    TX* __restrict__ y, float* __restrict__ logits, int* __restrict__ counters,
                    const __grid_constant__ MatmulDesc d) {
  constexpr bool TC = std::is_same<TX, __nv_bfloat16>::value;
  using TS = TX;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cb = blockIdx.x / d.split, rank = blockIdx.x - cb * d.split;
  const int n0 = cb * d.bn, m0 = blockIdx.y * d.mb;
  const int k_lo = min(d.k, rank * d.kr), k_hi = min(d.k, k_lo + d.kr);
  const int chunks = (k_hi - k_lo + d.bk - 1) / d.bk;
  auto xs = [&](int b) { return reinterpret_cast<TS*>(smem + d.xs_off + b * d.xs_buf); };
  auto ws = [&](int b) { return reinterpret_cast<TS*>(smem + d.ws_off + b * d.ws_buf); };
  constexpr int XV = 16 / sizeof(TX);  // elements per 16-byte copy
  constexpr int WV = 16 / sizeof(TS);
  // The block's scale and offset, copied with the first chunk and read by
  // the epilogue.
  float* so = reinterpret_cast<float*>(smem + d.so_off);  // [2][bn]
  for (int i = tid; i < 2 * d.bn; i += SNN_MM_THREADS) {
    const int c = n0 + i % d.bn;
    cp_async4(so + i, c < d.n ? (i < d.bn ? scale + c : offset + c) : scale, c < d.n);
  }

  auto load_chunk = [&](int ch) {
    const int k0 = k_lo + ch * d.bk;
    TS* xd = xs(ch & 1);
    TS* wd = ws(ch & 1);
    if (d.vec_x) {
      for (int i = tid; i < d.mb * (d.bk / XV); i += SNN_MM_THREADS) {
        const int r = i / (d.bk / XV), v = i - r * (d.bk / XV);
        const int gm = m0 + r, gk = k0 + v * XV;
        const bool ok = gm < d.m && gk < k_hi;
        cp_async16(xd + r * d.xstride + v * XV, ok ? x + (size_t)gm * d.k + gk : x, ok ? 16 : 0);
      }
    } else {  // 8 loads in flight per thread before any is stored
      for (int i0 = tid; i0 < d.mb * d.bk; i0 += 8 * SNN_MM_THREADS) {
        TS v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * SNN_MM_THREADS, r = i / d.bk, gk = k0 + i - r * d.bk;
          v[u] = i < d.mb * d.bk && m0 + r < d.m && gk < k_hi ? x[(size_t)(m0 + r) * d.k + gk]
                                                             : TS(0.f);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * SNN_MM_THREADS, r = i / d.bk;
          if (i < d.mb * d.bk) xd[r * d.xstride + i - r * d.bk] = v[u];
        }
      }
    }
    if (d.vec_w) {  // W in the staged dtype, N a multiple of WV
      for (int i = tid; i < d.bk * (d.bn / WV); i += SNN_MM_THREADS) {
        const int kk = i / (d.bn / WV), v = i - kk * (d.bn / WV);
        const int gk = k0 + kk, gn = n0 + v * WV;
        const bool ok = gk < k_hi && gn < d.n;
        cp_async16(wd + kk * d.wstride + v * WV, ok ? w + (size_t)gk * d.n + gn : w, ok ? 16 : 0);
      }
    } else {  // int8 or unaligned W: a thread's column is fixed, 8 loads in flight
      const int j = tid % d.bn, kstep = SNN_MM_THREADS / d.bn;
      const bool col_ok = n0 + j < d.n;
      for (int kb = tid / d.bn; kb < d.bk; kb += 8 * kstep) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int kk = kb + u * kstep;
          v[u] = col_ok && kk < d.bk && k0 + kk < k_hi ? to_float(w[(size_t)(k0 + kk) * d.n + n0 + j])
                                                         : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int kk = kb + u * kstep;
          if (kk >= d.bk) break;
          if constexpr (TC) {
            wd[kk * d.wstride + j] = __float2bfloat16_rn(v[u]);
          } else {
            wd[kk * d.wstride + j] = v[u];
          }
        }
      }
    }
  };

  // Each thread's partial sums go to red[group][row][column] (group: the
  // warp's K share, or the thread's K group).
  float* red = reinterpret_cast<float*>(smem + d.red_off);
  float* part = reinterpret_cast<float*>(smem + d.part_off);  // [mb][bn]
  int groups;
  if constexpr (TC) {
    const int wn_count = d.bn / 8, wk_count = 8 / wn_count;
    const int wn = warp % wn_count, wk = warp / wn_count;
    const int mtiles = d.mb / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    if (chunks > 0) load_chunk(0);
    cp_async_commit();
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) load_chunk(ch + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const TS* xb = xs(ch & 1);
      const TS* wb = ws(ch & 1);
      for (int ks = wk; ks < d.bk / 16; ks += wk_count) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, wb + (ks * 16 + (lane & 15)) * d.wstride + wn * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= mtiles) break;
          uint32_t a[4];
          ldmatrix_x4(a, xb + (mt * 16 + (lane & 15)) * d.xstride + ks * 16 + (lane >> 4) * 8);
          mma_bf16(acc[mt], a, b[0], b[1]);
        }
      }
      __syncthreads();
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mtiles) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = mt * 16 + g + 8 * (q >> 1), c = wn * 8 + 2 * t + (q & 1);
        red[(wk * d.mb + r) * d.bn + c] = acc[mt][q];
      }
    }
    groups = wk_count;
  } else {
    const int col = tid % d.bn, kg = tid / d.bn, kgs = SNN_MM_THREADS / d.bn;
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
    if (chunks > 0) load_chunk(0);
    cp_async_commit();
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) load_chunk(ch + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const TS* xb = xs(ch & 1);
      const TS* wb = ws(ch & 1);
      // K group kg takes 4 consecutive k of every 4 * kgs: x as broadcast
      // float4s (32 products per 12 loads at 8 rows).
      for (int k4 = 4 * kg; k4 < d.bk; k4 += 4 * kgs) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = wb[(k4 + q) * d.wstride + col];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (r >= d.mb) break;
          const float4 xv = *reinterpret_cast<const float4*>(xb + r * d.xstride + k4);
          acc[r] = fmaf(xv.x, wv[0], acc[r]);
          acc[r] = fmaf(xv.y, wv[1], acc[r]);
          acc[r] = fmaf(xv.z, wv[2], acc[r]);
          acc[r] = fmaf(xv.w, wv[3], acc[r]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < d.mb) red[(kg * d.mb + r) * d.bn + col] = acc[r];
    groups = kgs;
  }
  cp_async_wait<0>();  // scale and offset (with no K, nothing else) have landed
  __syncthreads();
  for (int i = tid; i < d.mb * d.bn; i += SNN_MM_THREADS) {
    float s = red[i];
    for (int q = 1; q < groups; ++q) s += red[q * d.mb * d.bn + i];
    part[i] = s;
  }
  __syncthreads();

  // Each rank of the cluster finishes the rows rank, rank + split, ... of
  // the block, a warp per row, adding the ranks' partial sums in rank
  // order; a lane holds columns lane and lane + 32.
  const int rows = min(d.mb, d.m - m0);
  const int mine = (rows - rank + d.split - 1) / d.split;  // rows this CTA finishes
  float* stats = logits + (size_t)d.m * d.n;  // softmax scratch: [m][col_blocks][2]
  cg::cluster_group cluster = cg::this_cluster();
  if (d.split > 1) cluster.sync();
  for (int q = warp; q < mine; q += SNN_MM_THREADS / 32) {
    const int r = rank + d.split * q;
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      v[u] = -INFINITY;
      if (c >= d.bn || n0 + c >= d.n) continue;
      float sum = 0.f;
      if (d.split > 1) {  // every rank's partial in flight, then added in rank order
        float pr[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          pr[k] = k < d.split ? cluster.map_shared_rank(part, k)[r * d.bn + c] : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += pr[k];
      } else {
        sum = part[r * d.bn + c];
      }
      v[u] = fmaf(sum, so[c], so[d.bn + c]);
      if (!d.softmax) store_out(y + (size_t)(m0 + r) * d.n + n0 + c, apply_act(v[u], d.act, d.alpha));
    }
    if (!d.softmax) continue;
    const float mx = warp_reduce<true>(fmaxf(v[0], v[1]));
    const float e0 = expf(v[0] - mx), e1 = expf(v[1] - mx);  // 0 past N
    const float sum = warp_reduce<false>(e0 + e1);
    if (d.col_blocks == 1) {  // the block holds every column: softmax here
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c < d.n) store_out(y + (size_t)(m0 + r) * d.n + c, (u ? e1 : e0) / sum);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c < d.bn && n0 + c < d.n) logits[(size_t)(m0 + r) * d.n + n0 + c] = v[u];
      }
      if (lane == 0) {  // the row's max and sum of exponentials over this block
        stats[((size_t)(m0 + r) * d.col_blocks + cb) * 2] = mx;
        stats[((size_t)(m0 + r) * d.col_blocks + cb) * 2 + 1] = sum;
      }
    }
  }
  // Several column blocks (below): the logits are in the scratch.
  if (!d.softmax || d.col_blocks == 1) {
    if (d.split > 1) cluster.sync();  // peers' shared memory stays alive until every read is done
    return;
  }
  // One arrival per cluster, once every rank's logits and statistics are
  // out. The last cluster of the row block to arrive combines the
  // statistics and writes every probability of the rows, its ranks a
  // share each.
  __threadfence();
  __shared__ int is_last;
  if (d.split > 1) cluster.sync(); else __syncthreads();
  if (rank == 0 && tid == 0) {
    const int last = atomicAdd(counters + blockIdx.y, 1) == d.col_blocks - 1;
    if (d.split > 1) {
      for (int q = 0; q < d.split; ++q) *cluster.map_shared_rank(&is_last, q) = last;
    } else {
      is_last = last;
    }
    if (last) counters[blockIdx.y] = 0;  // every cluster has arrived: ready for the next launch
  }
  if (d.split > 1) cluster.sync(); else __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* stat = red;  // [mb][2]: each row's max and 1 / sum of exponentials
  for (int r = warp; r < rows; r += SNN_MM_THREADS / 32) {
    const float* sr = stats + (size_t)(m0 + r) * d.col_blocks * 2;
    float mx = -INFINITY;
    for (int b = lane; b < d.col_blocks; b += 32) mx = fmaxf(mx, __ldcg(sr + 2 * b));
    mx = warp_reduce<true>(mx);
    float sum = 0.f;
    for (int b = lane; b < d.col_blocks; b += 32)
      sum += __ldcg(sr + 2 * b + 1) * expf(__ldcg(sr + 2 * b) - mx);
    sum = warp_reduce<false>(sum);
    if (lane == 0) {
      stat[2 * r] = mx;
      stat[2 * r + 1] = 1.f / sum;
    }
  }
  __syncthreads();
  // The rows are contiguous in y and the logits: 4 elements per load where
  // N allows, 4 loads in flight per thread before any is used.
  const size_t base = (size_t)m0 * d.n;
  const int vw = d.n % 4 == 0 ? 4 : 1, units = rows * d.n / vw;
  const int step = d.split * SNN_MM_THREADS;
  for (int u0 = rank * SNN_MM_THREADS + tid; u0 < units; u0 += 4 * step) {
    float v[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = u0 + q * step;
      if (u >= units) break;
      if (vw == 4) {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(logits + base) + u);
        v[q][0] = f.x; v[q][1] = f.y; v[q][2] = f.z; v[q][3] = f.w;
      } else {
        v[q][0] = __ldcg(logits + base + u);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = u0 + q * step;
      if (u >= units) break;
      const int r = u * vw / d.n;
      const float mx = stat[2 * r], inv = stat[2 * r + 1];
      TX* yo = y + base + (size_t)u * vw;
      if (vw == 4) {
        const float p0 = expf(v[q][0] - mx) * inv, p1 = expf(v[q][1] - mx) * inv;
        const float p2 = expf(v[q][2] - mx) * inv, p3 = expf(v[q][3] - mx) * inv;
        if constexpr (TC) {
          *reinterpret_cast<uint2*>(yo) = make_uint2(pack_bf16x2(p0, p1), pack_bf16x2(p2, p3));
        } else {
          *reinterpret_cast<float4*>(yo) = make_float4(p0, p1, p2, p3);
        }
      } else {
        store_out(yo, expf(v[q][0] - mx) * inv);
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TW>
int launch(const void* x, const void* w, const float* scale, const float* offset, void* y,
           float* logits, int* counters, const MatmulDesc& d, int smem, cudaStream_t s) {
  auto kern = matmul_fused_kernel<TX, TW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d.col_blocks * d.split, (d.m + d.mb - 1) / d.mb);
  cfg.blockDim = dim3(SNN_MM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = d.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = d.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const TX*>(x), static_cast<const TW*>(w),
                           scale, offset, static_cast<TX*>(y), logits, counters, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (see snn_matmul_error), or the cudaError_t of the launch.
// x, y: device (m,k) and (m,n) in f32 or bf16 (x_bf16); w: device (k,n) in
// x's dtype, or int8 when w_int8; scale, offset: device f32 (n).
// logits: device f32 scratch, m*n logits then m*col_blocks*2 row
// statistics; counters: device int32, one per row block, all 0 (the kernel
// leaves them 0): both read and written only for a softmax over more than
// one column block. geom: MG_FIELDS ints, the wrapper's
// launch geometry (kernels/matmul.py MatmulLaunch).
int snn_matmul_fused(const void* x, int x_bf16, const void* w, int w_int8,
                     const float* scale, const float* offset, void* y, void* logits,
                     void* counters, int m, int k, int n, int act, float alpha,
                     int softmax, const int* geom, void* stream) {
  if (m < 1 || k < 1 || n < 1) return -1;
  MatmulDesc d;
  d.m = m; d.k = k; d.n = n; d.act = act; d.alpha = alpha; d.softmax = softmax;
  d.bn = geom[MG_BN]; d.mb = geom[MG_MB]; d.bk = geom[MG_BK]; d.split = geom[MG_SPLIT];
  d.xstride = geom[MG_XSTRIDE]; d.wstride = geom[MG_WSTRIDE];
  d.xs_off = geom[MG_XS_OFF]; d.ws_off = geom[MG_WS_OFF];
  d.red_off = geom[MG_RED_OFF]; d.part_off = geom[MG_PART_OFF]; d.so_off = geom[MG_SO_OFF];
  const int smem = geom[MG_SMEM];
  const int esz = x_bf16 ? 2 : 4;
  if (d.bn != 16 && d.bn != 32 && d.bn != 64) return -4;
  if (x_bf16 ? (d.mb < 16 || d.mb > 64 || d.mb % 16)
             : (d.mb < 1 || d.mb > 16 || SNN_MM_THREADS % d.bn))
    return -4;
  if (d.bk < 16 || d.bk % 16 || d.split < 1 || d.split > 8 || (d.split & (d.split - 1))) return -4;
  if (d.xstride < d.bk || d.wstride < d.bn || (d.xstride * esz) % 16 || (d.wstride * esz) % 16)
    return -4;
  d.col_blocks = (n + d.bn - 1) / d.bn;
  const int row_blocks = (m + d.mb - 1) / d.mb;
  if (row_blocks > 65535 || (long long)d.col_blocks * d.split > 0x7fffffff) return -3;
  d.kr = ((k + d.split - 1) / d.split + 15) / 16 * 16;
  d.xs_buf = d.mb * d.xstride * esz;
  d.ws_buf = d.bk * d.wstride * esz;
  const int groups = x_bf16 ? 64 / d.bn : SNN_MM_THREADS / d.bn;
  // Buffers in order, 16-byte aligned, within the shared memory asked for.
  // (red also holds the softmax's row statistics, [mb][2], once it is summed)
  const long long ends[5][2] = {{d.xs_off, d.xs_off + 2LL * d.xs_buf},
                                {d.ws_off, d.ws_off + 2LL * d.ws_buf},
                                {d.red_off, d.red_off + 4LL * groups * d.mb * d.bn},
                                {d.part_off, d.part_off + 4LL * d.mb * d.bn},
                                {d.so_off, d.so_off + 8LL * d.bn}};
  long long prev = 0;
  for (const auto& e : ends) {
    if (e[0] % 16 || e[0] < prev) return -2;
    prev = e[1];
  }
  if (prev > smem || smem > SNN_MAX_SMEM) return -2;
  if (softmax && d.col_blocks > 1 && (logits == nullptr || counters == nullptr)) return -5;
  d.vec_x = k % (16 / esz) == 0 && aligned16(x);
  d.vec_w = !w_int8 && n % (16 / esz) == 0 && aligned16(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(logits);
  int* cp = static_cast<int*>(counters);
  if (x_bf16) {
    return w_int8 ? launch<__nv_bfloat16, int8_t>(x, w, scale, offset, y, lp, cp, d, smem, s)
                  : launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, offset, y, lp, cp, d, smem, s);
  }
  return w_int8 ? launch<float, int8_t>(x, w, scale, offset, y, lp, cp, d, smem, s)
                : launch<float, float>(x, w, scale, offset, y, lp, cp, d, smem, s);
}

const char* snn_matmul_error(int code) {
  switch (code) {
    case -1: return "empty x or w";
    case -2: return "the launch geometry's shared-memory layout does not hold its buffers "
                    "within 227 KB";
    case -3: return "more row blocks than a grid holds";
    case -4: return "launch geometry outside the kernel (column block, row block, K chunk, "
                    "split or strides)";
    case -5: return "a softmax over several column blocks needs the logits and counter scratch";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "unknown error";
  }
}

}  // extern "C"
