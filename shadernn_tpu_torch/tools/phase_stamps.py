"""Where a CTA's cycles go in the chain kernel's f32 form and in the
implicit-GEMM conv kernel: `clock64()` stamps at the phase boundaries of a
copy of their sources, built into a library of its own, run at the main
paths' shapes on the card:

    python -m shadernn_tpu_torch.tools.phase_stamps [--out FILE]

The chain's f32 form (ESPCN 540p b8, the FP32 plan's chain, at the
geometry `f32_launch_geometry` gives it and at a second tile): cycles per
tile of staging and of each layer, and per pair of m-tiles of each
layer's k-loop and epilogue (thread 0 of each CTA; lane 0 of each warp).
The implicit-GEMM conv (the two-input graph's conv, 8x540x960, 8 -> 16,
k3, bf16 and f32): cycles per item of issuing the next items' copies,
waiting for this one's, the products, the epilogue up to its barrier and
in all. Cycles are the SM's clock; the stamps cost a few instructions a
phase. The copy is written to build/kernels/phase_stamps/ and the port's
own library is left as it is. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

PROBE = """
__device__ unsigned long long g_probe[64];
#define PRB(slot, v) atomicAdd(&g_probe[slot], (unsigned long long)(v))
"""

READ = """
extern "C" int snn_probe_{name}(void* host, int zero) {{
  if (zero) {{
    unsigned long long z[64] = {{0}};
    return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(host, g_probe, 64 * 8);
}}
"""

# (anchor, replacement): the stamps. Slots: chain 0 staging, 1+l layer l
# (per tile, thread 0), 16 + 4s (+2 last layer) k-loop and 17 + ... its
# epilogue per pair (s 0 dense, 1 units; lane 0), 32 + ... their counts, 63
# tiles. igemm 0 issuing copies, 1 waiting, 2 products, 3 the epilogue to
# its barrier, 4 the epilogue, 5 the closing barrier, 62 items, 63 CTAs.
CHAIN = [
    ("namespace {\n\n// Accumulated pads", PROBE + "namespace {\n\n// Accumulated pads"),
    ("""  for (int mt0 = 2 * warp; mt0 < mtiles; mt0 += 2 * nwarps) {
    float acc[2][NG][4];""", """  const int lslot = DENSE ? 0 : 1;
  for (int mt0 = 2 * warp; mt0 < mtiles; mt0 += 2 * nwarps) {
    long long P0 = clock64();
    float acc[2][NG][4];"""),
    ("""    // Epilogue on the fragments: rows g and g + 8, channels 8 (j0 + j) + 2t, +1.""",
     """    long long P1 = clock64();
    if (lane == 0) {
      PRB(16 + 4 * lslot + (last ? 2 : 0), P1 - P0);
      PRB(32 + 4 * lslot + (last ? 2 : 0), 1);
    }
    // Epilogue on the fragments: rows g and g + 8, channels 8 (j0 + j) + 2t, +1."""),
    ("""    cp_async_wait<0>();
    __syncthreads();  // this tile's frame has landed; the tile before is done""",
     """    long long T0 = clock64();
    cp_async_wait<0>();
    __syncthreads();  // this tile's frame has landed; the tile before is done"""),
    ("""    cp_async_commit();
    for (int l = 0; l < d.nl; ++l) {
      const F32Layer& L = d.L[l];
      const bool last = l == d.nl - 1;""", """    cp_async_commit();
    if (threadIdx.x == 0) {
      const long long T1 = clock64();
      PRB(0, T1 - T0);
      PRB(63, 1);
      T0 = T1;
    }
    for (int l = 0; l < d.nl; ++l) {
      const F32Layer& L = d.L[l];
      const bool last = l == d.nl - 1;"""),
    ("""          run_f32_layer<false>(smem, params, L, d.tail, last, n, ty0, tx0, y, j0, d.w_all);
        }
        __syncthreads();""", """          run_f32_layer<false>(smem, params, L, d.tail, last, n, ty0, tx0, y, j0, d.w_all);
        }
        __syncthreads();
        if (threadIdx.x == 0 && j0 + L.ng >= L.nt) {
          const long long T1 = clock64();
          PRB(1 + l, T1 - T0);
          T0 = T1;
        }"""),
]
# The end of run_f32_layer's pair loop: its epilogue's last stamp.
CHAIN_EPILOGUE_END = ("          }\n        }\n      }\n    }\n  }\n}\n\n// Persistent:",
                      "          }\n        }\n      }\n    }\n"
                      "    if (lane == 0) PRB(17 + 4 * lslot + (last ? 2 : 0), clock64() - P1);\n"
                      "  }\n}\n\n// Persistent:")
IGEMM = [
    ("namespace {\n\n#define SNN_IG_THREADS", PROBE + "namespace {\n\n#define SNN_IG_THREADS"),
    ("""  for (int q = 0; q < items; ++q) {
    if (q + d.bufs - 1 < items) load_item(q + d.bufs - 1);
    cp_async_commit();
    cp_async_wait_n(d.bufs - 1);  // item q has landed (this thread's copies)
    __syncthreads();              // (everyone's)""", """  long long T0 = clock64();
  if (threadIdx.x == 0) PRB(63, 1);
  for (int q = 0; q < items; ++q) {
    if (q + d.bufs - 1 < items) load_item(q + d.bufs - 1);
    const long long T1 = clock64();
    if (threadIdx.x == 0) PRB(0, T1 - T0);
    cp_async_commit();
    cp_async_wait_n(d.bufs - 1);  // item q has landed (this thread's copies)
    __syncthreads();              // (everyone's)
    const long long T2 = clock64();
    if (threadIdx.x == 0) PRB(1, T2 - T1);"""),
    ("""    if (s == d.stages - 1) {
      // Epilogue""", """    const long long T3 = clock64();
    if (threadIdx.x == 0) PRB(2, T3 - T2);
    if (s == d.stages - 1) {
      // Epilogue"""),
    ("""      __syncthreads();
      int n0, oy0, ox0;""", """      __syncthreads();
      if (threadIdx.x == 0) PRB(3, clock64() - T3);
      int n0, oy0, ox0;"""),
    ("""    __syncthreads();  // the slots of item q are free for item q + bufs
  }""", """    const long long T4 = clock64();
    __syncthreads();  // the slots of item q are free for item q + bufs
    T0 = clock64();
    if (threadIdx.x == 0) {
      PRB(4, T4 - T3);
      PRB(5, T0 - T4);
      PRB(62, 1);
    }
  }"""),
]


def _patch(path, pairs, tail):
    with open(path) as f:
        s = f.read()
    for anchor, new in pairs:
        if anchor not in s:
            raise RuntimeError(f"phase_stamps: {os.path.basename(path)} has no anchor "
                               f"{anchor[:60]!r}: update the stamps to the kernel")
        s = s.replace(anchor, new, 1)
    with open(path, "w") as f:
        f.write(s + tail)


def main(argv=None) -> int:
    import torch

    from shadernn_tpu_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_stamps: no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    root = os.path.join(_build.BUILD_DIR, "phase_stamps")
    src = os.path.join(root, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    _patch(os.path.join(src, "conv_chain.cu"), CHAIN + [CHAIN_EPILOGUE_END],
           READ.format(name="chain"))
    _patch(os.path.join(src, "conv_igemm.cu"), IGEMM, READ.format(name="igemm"))
    saved = (_build.CSRC, _build.BUILD_DIR, _build.LIB_PATH, _build._lib)
    _build.CSRC, _build.BUILD_DIR = src, root
    _build.LIB_PATH, _build._lib = os.path.join(root, "libsnn_phase_stamps.so"), None
    try:
        _build.build(force=True)
        _measure(_build.kernel_lib(), emit)
    finally:  # the port's own library again for any later call
        _build.CSRC, _build.BUILD_DIR, _build.LIB_PATH, _build._lib = saved
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def _measure(lib, emit) -> None:
    """The stamps of the chain's f32 form and the implicit-GEMM conv at the
    main paths' shapes, from the instrumented library `lib`."""
    import dataclasses

    import numpy as np
    import torch

    from shadernn_tpu_torch.kernels import chain, conv_igemm

    buf = (ctypes.c_ulonglong * 64)()

    def probe(fn, which):
        read = getattr(lib, which)
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn()
        torch.cuda.synchronize()
        read(None, 1)
        fn()
        torch.cuda.synchronize()
        read(ctypes.addressof(buf), 0)
        return list(buf)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    emit(f"card {torch.cuda.get_device_name(0)}; cycles of the SM clock")
    specs = [chain.ChainLayerSpec(5, 1, 16, 2, 2, 2, 2, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 16, 1, 1, 1, 1, "relu", 0.3),
             chain.ChainLayerSpec(3, 16, 4, 1, 1, 1, 1, "tanh", 0.3)]
    ops = [{"w": torch.from_numpy((rng.standard_normal((s.k, s.k, s.c, s.o))
                                   / np.sqrt(s.k * s.k * s.c)).astype(np.float32)).to(dev),
            "scale": torch.ones(s.o, device=dev), "offset": torch.zeros(s.o, device=dev)}
           for s in specs]
    x = torch.from_numpy(rng.random((8, 540, 960, 1), dtype=np.float32)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geometry = chain.f32_launch_geometry
    chosen = geometry(tuple(specs), 8, 540, 960, sms)
    other = chain._f32_launch(specs, 8, 16, True, chain.F32_PASS, 256)
    other = dataclasses.replace(other, grid=min(sms * 2, 8 * 68 * 60))
    try:
        for geo in (chosen, other):
            chain.f32_launch_geometry = lambda *_a, geo=geo: geo
            v = probe(lambda: chain.fused_conv_chain(x, ops, specs, compute_dtype=torch.float32),
                      "snn_probe_chain")
            tiles = max(1, v[63])
            emit(f"chain f32 espcn 8x540x960 tile {geo.tile_h}x{geo.tile_w} {geo.threads} threads "
                 f"grid {geo.grid}: per tile staging {v[0] / tiles:.0f}, layers "
                 + ", ".join(f"{v[1 + l] / tiles:.0f}" for l in range(len(specs))))
            for name, sl in (("layer 0 (dense)", 0), ("units layers", 1)):
                for last in (0, 2):
                    cnt = v[32 + 4 * sl + last]
                    if cnt:
                        emit(f"   {name}{', the last' if last else ', not the last'}: per pair "
                             f"of m-tiles k-loop {v[16 + 4 * sl + last] / cnt:.0f}, epilogue "
                             f"{v[17 + 4 * sl + last] / cnt:.0f} ({cnt} pairs)")
    finally:
        chain.f32_launch_geometry = geometry
    for dt in (torch.bfloat16, torch.float32):
        xx = torch.from_numpy(rng.standard_normal((8, 540, 960, 8)).astype(np.float32)).to(dev, dt)
        w = torch.from_numpy((rng.standard_normal((3, 3, 8, 16)) / 5).astype(np.float32)).to(dev, dt)
        one, zero = torch.ones(16, device=dev), torch.zeros(16, device=dev)
        v = probe(lambda: conv_igemm.conv2d_kernel_nhwc(xx, w, one, zero, stride=1,
                                                        pads=(1, 1, 1, 1), activation="relu"),
                  "snn_probe_igemm")
        items = max(1, v[62])
        emit(f"igemm {'bf16' if dt == torch.bfloat16 else 'fp32'} two-input 8x540x960 8->16 k3: "
             f"{v[63]} CTAs, {v[62]} items; per item issuing copies {v[0] / items:.0f}, waiting "
             f"{v[1] / items:.0f}, products {v[2] / items:.0f}, epilogue to its barrier "
             f"{v[3] / items:.0f}, epilogue {v[4] / items:.0f}, closing barrier {v[5] / items:.0f}")


if __name__ == "__main__":
    sys.exit(main())
