"""Where a CTA's cycles go in the chain kernel's f32 form, the
implicit-GEMM conv kernel and the single-conv kernel: `clock64()` stamps at
the phase boundaries of a copy of their sources, built into a library of
its own, run at the main paths' shapes on the card:

    python -m shadernn_tpu_torch.tools.phase_stamps [--out FILE]

The chain's f32 form (ESPCN 540p b8, the FP32 plan's chain, at the
geometry `f32_launch_geometry` gives it and at a second tile): cycles per
tile of staging and of each layer, and per pair of m-tiles of each
layer's k-loop and epilogue (thread 0 of each CTA; lane 0 of each warp).
The implicit-GEMM conv (the two-input graph's conv, 8x540x960, 8 -> 16,
k3, bf16 and f32): cycles per item of issuing the next items' copies,
waiting for this one's, the products, the epilogue up to its barrier and
in all. The single-conv kernel at StyleTransfer 512x512 b4's 9x9 stem
(3 -> 32) and head (32 -> 3), bf16 and fp32, in each body that can run
them (the tile body, the parent's launch there; under bf16 the wide body
on the tensor cores, under fp32 its form on the CUDA cores): cycles per CTA of staging
the input and the weights, waiting, the products and the epilogue (tile
body), or per CTA of staging the weight and per tile of issuing the next
tile's input, waiting, the products and the epilogue (wide body; thread 0
of each CTA). Cycles are the SM's clock; the stamps cost a few instructions a
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

# The single-conv kernel's tile body (conv_single_tc_kernel, bf16, and
# conv_single_tf32_kernel, 3xTF32), per CTA (thread 0): 0 issuing the input
# region's loads, 1 issuing the weights', 2 waiting for the stage, 3 the
# products, 4 the epilogue; 63 CTAs.
_TILE_STAMPS_END = """
  if (threadIdx.x == 0) {
    PRB(0, PI);
    PRB(1, PW);
    PRB(2, WT);
    PRB(3, PR);
    PRB(4, clock64() - Q5);
    PRB(63, 1);
  }
}"""
SINGLE = [
    ("// Fields of the geometry array the wrapper passes.",
     PROBE + "// Fields of the geometry array the wrapper passes."),
]
for _ib, _w_head, _w_end, _y_end in (
        ("const __nv_bfloat16* ib", ": row r", "                                             : "
         "__float2bfloat16_rn(0.f);\n      }\n    }\n  };",
         "        yo[oc] = __float2bfloat16_rn(v0);\n      }\n    }\n  }\n}"),
        ("const float* ib", ", n-major", "                 ok ? w + (size_t)oc * k_row + (size_t)tap * c8 + c : "
         "w, ok ? 16 : 0);\n    }\n  };", "        yo[oc] = v0;\n      }\n    }\n  }\n}")):
    SINGLE += [
        ("  auto load_stage = [&](int s) {\n    const int ci = s / d.groups, grp = s - ci * d.groups;",
         "  long long PI = 0, PW = 0, Q1 = 0, WT = 0, PR = 0;\n  auto load_stage = [&](int s) {\n"
         "    const long long Q0 = clock64();\n"
         "    const int ci = s / d.groups, grp = s - ci * d.groups;"),
        ("    // Weights of (chunk, tap group)" + _w_head,
         "    Q1 = clock64();\n    PI += Q1 - Q0;\n    // Weights of (chunk, tap group)" + _w_head),
        (_w_end, _w_end[:-4] + "\n    PW += clock64() - Q1;\n  };"),
        ("    cp_async_commit();\n    cp_async_wait<1>();  // stage s has landed (this thread's "
         "copies)\n    __syncthreads();     // (everyone's)\n"
         "    const int ci = s / d.groups, grp = s - ci * d.groups;\n    " + _ib,
         "    cp_async_commit();\n    const long long Q2 = clock64();\n    cp_async_wait<1>();\n"
         "    __syncthreads();\n    const long long Q3 = clock64();\n    WT += Q3 - Q2;\n"
         "    const int ci = s / d.groups, grp = s - ci * d.groups;\n    " + _ib),
        ("    __syncthreads();  // the buffers of stage s are free for stage s + 2\n  }\n",
         "    __syncthreads();\n    PR += clock64() - Q3;\n  }\n  const long long Q5 = clock64();\n"),
        (_y_end, _y_end[:-2] + _TILE_STAMPS_END),
    ]

# The wide body, per CTA (thread 0): 8 (tensor cores) / 16 (CUDA cores)
# staging the block's weight and table; per tile (item: chunk of a tile) +1
# issuing the next one's loads, +2 waiting for this one's, +3 the products,
# +4 the epilogue with its barriers; 61 / 59 CTAs, 62 / 60 tiles (items).
_WIDE_LOOP_END = """
    const long long T4 = clock64();
    if (threadIdx.x == 0) {{
      PRB({b} + 3, T3 - T2);
      PRB({b} + 4, T4 - T3);
      PRB({n}, 1);
    }}
  }}"""
SINGLE += [
    ("  // Each unit's offset (elements) from a pixel's first staged position: row",
     "  const long long S0 = clock64();\n"
     "  // Each unit's offset (elements) from a pixel's first staged position: row"),
    ("  float acc[2][NT][4], acc2[2][NT][4];\n  for (int q = 0; q < d.bufs - 1; ++q) {",
     "  float acc[2][NT][4], acc2[2][NT][4];\n"
     "  if (threadIdx.x == 0) {\n    PRB(8, clock64() - S0);\n    PRB(61, 1);\n  }\n"
     "  for (int q = 0; q < d.bufs - 1; ++q) {"),
    ("    if (q + d.bufs - 1 < my_tiles) load_tile(q + d.bufs - 1);",
     "    const long long T0 = clock64();\n"
     "    if (q + d.bufs - 1 < my_tiles) load_tile(q + d.bufs - 1);\n"
     "    const long long T1 = clock64();"),
    ("    __syncthreads();  // (everyone's; the weights and table too, at q = 0)",
     "    __syncthreads();\n    const long long T2 = clock64();\n"
     "    if (threadIdx.x == 0) {\n      PRB(9, T1 - T0);\n      PRB(10, T2 - T1);\n    }"),
    ("    // Epilogue: the fragments (rows g, g + 8 of each m16 tile, columns",
     "    const long long T3 = clock64();\n"
     "    // Epilogue: the fragments (rows g, g + 8 of each m16 tile, columns"),
    ("    __syncthreads();  // the slot and the output tile are free again\n  }",
     "    __syncthreads();" + _WIDE_LOOP_END.format(b=8, n=62)),
    ("  constexpr int WROW = KW * OBP;  // floats of one (group, dy, c)",
     "  const long long S0 = clock64();\n"
     "  constexpr int WROW = KW * OBP;  // floats of one (group, dy, c)"),
    ("  float acc[PX][OB];\n  for (int q = 0; q < d.bufs - 1; ++q) {",
     "  float acc[PX][OB];\n"
     "  if (threadIdx.x == 0) {\n    PRB(16, clock64() - S0);\n    PRB(59, 1);\n  }\n"
     "  for (int q = 0; q < d.bufs - 1; ++q) {"),
    ("    if (q + d.bufs - 1 < items) load_item(q + d.bufs - 1);\n    cp_async_commit();\n"
     "    if (d.bufs > 1) {\n      cp_async_wait<1>();  // item q has landed",
     "    const long long T0 = clock64();\n"
     "    if (q + d.bufs - 1 < items) load_item(q + d.bufs - 1);\n"
     "    const long long T1 = clock64();\n    cp_async_commit();\n"
     "    if (d.bufs > 1) {\n      cp_async_wait<1>();  // item q has landed"),
    ("    __syncthreads();  // (everyone's; the weights too, at q = 0)",
     "    __syncthreads();\n    const long long T2 = clock64();\n"
     "    if (threadIdx.x == 0) {\n      PRB(17, T1 - T0);\n      PRB(18, T2 - T1);\n    }"),
    ("    if (ci == d.chunks - 1) {\n      // Epilogue: the lane's row segment",
     "    const long long T3 = clock64();\n"
     "    if (ci == d.chunks - 1) {\n      // Epilogue: the lane's row segment"),
    ("    __syncthreads();  // the slot of item q is free for item q + bufs\n  }",
     "    __syncthreads();" + _WIDE_LOOP_END.format(b=16, n=60)),
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
    _patch(os.path.join(src, "conv_single.cu"), SINGLE, READ.format(name="single"))
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
    ops = chain.prepare(ops, specs, torch.float32)
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
    _measure_single(lib, emit, probe)
    for dt in (torch.bfloat16, torch.float32):
        xx = torch.from_numpy(rng.standard_normal((8, 540, 960, 8)).astype(np.float32)).to(dev, dt)
        w = torch.from_numpy((rng.standard_normal((3, 3, 8, 16)) / 5).astype(np.float32)).to(dev, dt)
        ops8 = conv_igemm.prepare(w, torch.ones(16, device=dev), torch.zeros(16, device=dev), dt)
        v = probe(lambda: conv_igemm.run(xx, ops8, stride=1, pads=(1, 1, 1, 1),
                                         activation="relu"),
                  "snn_probe_igemm")
        items = max(1, v[62])
        emit(f"igemm {'bf16' if dt == torch.bfloat16 else 'fp32'} two-input 8x540x960 8->16 k3: "
             f"{v[63]} CTAs, {v[62]} items; per item issuing copies {v[0] / items:.0f}, waiting "
             f"{v[1] / items:.0f}, products {v[2] / items:.0f}, epilogue to its barrier "
             f"{v[3] / items:.0f}, epilogue {v[4] / items:.0f}, closing barrier {v[5] / items:.0f}")


# StyleTransfer 512x512 b4's two 9x9 convs: (name, x shape, HWIO weight).
K9_CONVS = [("stem", (4, 512, 512, 3), (9, 9, 3, 32)), ("head", (4, 512, 512, 32), (9, 9, 32, 3))]


def _measure_single(lib, emit, probe) -> None:
    """The single-conv kernel's stamps at StyleTransfer's k9 launches, bf16
    and fp32 (the engines' inputs: bf16 under BF16, f32 under FP32), in
    each body that can run them: the tile body (the parent's launch) and
    the wrapper's choice, the wide body on the tensor cores (bf16) or its
    form on the CUDA cores (fp32)."""
    import numpy as np
    import torch

    from shadernn_tpu_torch.kernels import conv

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geometry = conv.launch_geometry
    try:
        for dt in (torch.bfloat16, torch.float32):
            prec = "bf16" if dt == torch.bfloat16 else "fp32"
            bodies = [("tile", conv.tile_geometry)]
            if dt == torch.bfloat16:
                bodies.append(("wide", lambda *a: conv.wide_geometry(*a[:8], a[9])))
            else:
                bodies.append(("wide f32 CUDA cores", lambda *a: conv.fma_geometry(*a[:8], a[9])))
            for name, xs, ws in K9_CONVS:
                x = torch.from_numpy(rng.random(xs, dtype=np.float32)).to(dev, dt)
                w = torch.from_numpy((rng.standard_normal(ws) / np.sqrt(np.prod(ws[:3])))
                                     .astype(np.float32)).to(dev, dt)
                ops = conv.prepare(w, torch.ones(ws[3], device=dev),
                                   torch.zeros(ws[3], device=dev), dt)
                pads = (4, 4, 4, 4)
                for body, fn in bodies:
                    geo = fn(*xs, ws[0], ws[1], ws[3], pads, dt == torch.bfloat16, sms)
                    conv.launch_geometry = lambda *_a, geo=geo: geo
                    v = probe(lambda: conv.run(x, ops, pads, "linear"), "snn_probe_single")
                    head = (f"single {prec} styletransfer {name} {xs} -> {ws[3]} k9, {body} body "
                            f"(tile {geo.tile_h}x{geo.tile_w}, nb {geo.nb}, smem {geo.smem} B")
                    if geo.body == 0:
                        ctas = max(1, v[63])
                        emit(f"{head}): {v[63]} CTAs; per CTA issuing the input "
                             f"{v[0] / ctas:.0f}, issuing the weights {v[1] / ctas:.0f}, waiting "
                             f"{v[2] / ctas:.0f}, products {v[3] / ctas:.0f}, epilogue "
                             f"{v[4] / ctas:.0f}")
                        continue
                    b, ctas_slot, tiles_slot = (8, 61, 62) if geo.body == 1 else (16, 59, 60)
                    ctas, tiles = max(1, v[ctas_slot]), max(1, v[tiles_slot])
                    unit = "tile" if geo.body == 1 else "item (a chunk of a tile)"
                    emit(f"{head}, grid {geo.grid}): {v[ctas_slot]} CTAs, {v[tiles_slot]} "
                         f"{unit}s; per CTA staging the weight {v[b] / ctas:.0f}; per {unit} "
                         f"issuing the next one's input {v[b + 1] / tiles:.0f}, waiting "
                         f"{v[b + 2] / tiles:.0f}, products {v[b + 3] / tiles:.0f}, epilogue "
                         f"{v[b + 4] / tiles:.0f}")
    finally:
        conv.launch_geometry = geometry


if __name__ == "__main__":
    sys.exit(main())
