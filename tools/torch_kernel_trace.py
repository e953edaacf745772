#!/usr/bin/env python3
"""Where the time goes inside the port's two CUDA kernels (one CUDA GPU).

    python3 tools/torch_kernel_trace.py

Nsight tools may be unavailable where the card is, so this builds
instrumented copies of `spsvo_tpu_torch/csrc/match_nn.cu` and
`fused_solve.cu`: timer stamps are inserted at fixed anchor lines of the
sources (the script stops if an anchor is missing: update it with the
kernel). The copies go to the kernel cache, never to `csrc/`. Then:

  match_nn     bf16, K0=K1=512, D=256, the query broadcast, B=2 and B=63:
               per CTA, %globaltimer (ns) at entry, after the last tile has
               landed and every wgmma is issued, after the product, after
               the key atomics, and in the last CTA at the start and end of
               the mutual pass; printed as [min, median, max] us after the
               first CTA's entry;
  fused_solve  S=256, L=128, flagship parameters, without and with the GLS
               pass: clock64 cycles of the frame's leading CTA at each stage
               boundary, and per LM iteration the Cholesky, the boxplus and
               the lane pass (degree 1 = polish, degree 4 = LM/GLS), and per
               lane pass the pose-to-matrix, the lanes and the 28-wide sum.

The stamps cost a few instructions each; compare stages, not totals, with
the uninstrumented times.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_SLOTS = 4096 * 16
HDR = r'''
__device__ unsigned long long g_trace[%d];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define TR(k, id) do { if (threadIdx.x == 0) \
  g_trace[(id) * 16 + (k)] = (USE_CLOCK ? clock64() : gtime()); } while (0)
#define ACC(o, v) do { if (threadIdx.x == 0 && blockIdx.x == 0) \
  g_trace[(o)] += (v); } while (0)
extern "C" int get_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
extern "C" int clear_trace() {
  static unsigned long long z[%d];
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
''' % (N_SLOTS, N_SLOTS)

CTA = "(blockIdx.z * gridDim.y * gridDim.x + blockIdx.y * gridDim.x + blockIdx.x)"
LM = N_SLOTS - 16     # per-iteration sums: [deg1 | deg4] x 4, then passes

# (anchor, text inserted before it, text inserted after it)
STAMPS = {
    "match_nn": [
        ("  const int b = blockIdx.z;\n", "", f"  TR(0, {CTA});\n"),
        ('  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");\n',
         "", f"  TR(1, {CTA});\n"),
        ("  fence_acc(acc);\n  __syncthreads();\n", "", f"  TR(2, {CTA});\n"),
        ("  // ---- last CTA of batch entry b", f"  TR(3, {CTA});\n", ""),
        ("  if (!sh.last) return;\n", "", f"  TR(4, {CTA});\n"),
        ("  if (tid == 0) ticket[b] = 0u;\n", "", f"  TR(5, {CTA});\n"),
    ],
    "fused_solve": [
        ("  for (int i = tid; i < 16 * p.Lp; i += NT) sh.pts",
         "  TR(0, blockIdx.x);\n", ""),
        ("  // ---- this CTA's share of the S hypotheses", "  TR(1, blockIdx.x);\n",
         ""),
        ("  if (lane == 0) { sh.wc[warp] = best_c;", "  TR(2, blockIdx.x);\n",
         ""),
        ("  if (rank != 0 || tid >= WG) return;", "  TR(3, blockIdx.x);\n", ""),
        ("  // ---- refit (2x weighted Horn) + polish", "  TR(4, blockIdx.x);\n",
         ""),
        ("  float q_raw[4], t_raw[3];\n", "  TR(5, blockIdx.x);\n", ""),
        ("  float sums[2] = {0.f, 0.f};", "  TR(6, blockIdx.x);\n", ""),
        ("    if (!weighted) lm_improved = improved && do_opt;\n", "",
         "    TR(8 + pass, blockIdx.x);\n"),
        ("  if (tid == 0) {\n    for (int i = 0; i < 4; ++i) { out[i]",
         "  TR(7, blockIdx.x);\n", ""),
        # one LM iteration: Cholesky, boxplus, lane pass
        ("    float A[21], g[6];\n", "    const long long c_0 = clock64();\n",
         ""),
        ("    chol_solve6(A, g, step);\n", "",
         "    const long long c_1 = clock64();\n"),
        ("    quat_boxplus(q, dr, q_new);\n", "",
         "    const long long c_2 = clock64();\n"),
        ("    lm_pass(ch, q_new, t_new, Pl, Pr, degree, delta, mask_scale, "
         "use_lw, Sn);\n", "",
         "    { const long long c_3 = clock64();\n"
         f"      const int o = {LM} + 4 * (degree >= 3);\n"
         "      ACC(o, c_1 - c_0); ACC(o + 1, c_2 - c_1);\n"
         "      ACC(o + 2, c_3 - c_2); ACC(o + 3, 1); }\n"),
        # one lane pass: pose to matrix, lanes, the 28-wide sum
        ("  float R[9];\n  quat_to_R(q, R);\n  const float d2 = delta * delta;\n",
         "  const long long p_0 = clock64();\n",
         "  const long long p_1 = clock64();\n"),
        ("  wg_sum<28>(acc, ch);\n}", "  const long long p_2 = clock64();\n",
         ""),
        ("  wg_sum<28>(acc, ch);\n", "",
         "  { const long long p_3 = clock64();\n"
         f"    const int o = {LM + 8} + 4 * (degree >= 3);\n"
         "    ACC(o, p_1 - p_0); ACC(o + 1, p_2 - p_1);\n"
         "    ACC(o + 2, p_3 - p_2); ACC(o + 3, 1); }\n"),
    ],
}
K1_NAMES = ["entry", "tiles landed", "product done", "atomics done",
            "last CTA start", "last CTA end"]
K2_STAGES = [(1, "cluster sync 1"), (2, "scored"), (3, "cluster sync 2"),
             (4, "prior + winner"), (5, "refit"), (6, "polish"),
             (8, "LM"), (9, "GLS"), (7, "end")]


def instrumented(name: str, use_clock: int):
    from spsvo_tpu_torch import _build
    src = open(os.path.join(_build.CSRC, f"{name}.cu")).read()
    src = src.replace("namespace {", f"#define USE_CLOCK {use_clock}\n" + HDR
                      + "\nnamespace {", 1)
    for anchor, before, after in STAMPS[name]:
        if src.count(anchor) != 1:
            sys.exit(f"{name}: anchor not found once: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    os.makedirs(_build.CACHE, exist_ok=True)
    path = os.path.join(_build.CACHE, f"{name}_trace.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = _build.load(f"{name}_trace", src=path)
    lib.get_trace.argtypes = [ctypes.c_void_p]
    return lib


def read(lib) -> np.ndarray:
    import torch
    torch.cuda.synchronize()
    buf = np.zeros(N_SLOTS, np.uint64)
    if lib.get_trace(buf.ctypes.data) != 0:
        sys.exit("get_trace failed")
    return buf.astype(np.int64)


def main() -> None:
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import (DEFAULT_BASELINE_FX,
                                                DEFAULT_P_L,
                                                prepared_from_frame,
                                                solver_frame)
    from spsvo_tpu_torch.ops import matching_cuda, solver_cuda
    from spsvo_tpu_torch.presets import flagship_tpu
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    k1 = instrumented("match_nn", 0)
    k2 = instrumented("fused_solve", 1)
    plain_load = _build.load
    _build.load = lambda name, src="": plain_load(
        name if name.endswith("_trace") else name + "_trace")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rng = np.random.default_rng(0)
    out = {"gpu": gpu, "match_nn": {}, "fused_solve": {}}

    for B in (2, 63):
        d = rng.normal(size=(B + 1, 512, 256)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        desc = torch.as_tensor(d, device=dev).to(torch.bfloat16)
        valid = torch.as_tensor(rng.random((B + 1, 512)) > 0.2, device=dev)
        args = (desc[0][None].expand(B, 512, 256),
                valid[0][None].expand(B, 512), desc[1:].contiguous(),
                valid[1:].contiguous())
        for _ in range(4):            # the last call's stamps are kept
            k1.clear_trace()
            matching_cuda.match_nn_batched(*args)
        t = read(k1)[: 64 * B * 16].reshape(64 * B, 16)
        t0 = t[:, 0].min()
        rows = {}
        for k, name in enumerate(K1_NAMES):
            col = (t[:, k][t[:, k] > 0] - t0) / 1e3
            rows[name] = [round(float(col.min()), 2),
                          round(float(np.median(col)), 2),
                          round(float(col.max()), 2), int(len(col))]
        out["match_nn"][f"B={B}"] = rows

    cfg = flagship_tpu()
    data, _, _ = solver_frame(rng, n=110, outlier_frac=0.15, k_pad=128)
    prep = prepared_from_frame(data, dev)
    hyp = solver_cuda.precompute_hypotheses(
        prep, cfg, generator=torch.Generator(dev).manual_seed(7))[None]
    P_r = DEFAULT_P_L.copy()
    P_r[0, 3] = DEFAULT_BASELINE_FX
    scal = solver_cuda.pack_scalars(
        torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
        torch.zeros(3, device=dev), 5,
        torch.as_tensor(DEFAULT_P_L, dtype=torch.float32, device=dev),
        torch.as_tensor(P_r, dtype=torch.float32, device=dev))[None]
    for weighted in (False, True):
        lw = torch.full((128,), 3.0, device=dev) if weighted else None
        pts = solver_cuda.pack_points(prep, lw)[None]
        p = solver_cuda.solve_params(cfg, weighted_lm=weighted)
        for _ in range(4):
            k2.clear_trace()
            solver_cuda.fused_solve_packed(pts, hyp, scal, p)
        t = read(k2)
        lead = t[:16]
        stages = {name: int(lead[k] - lead[0]) for k, name in K2_STAGES
                  if lead[k]}
        per = {}
        for deg, o in (("degree1", LM), ("degree4", LM + 4)):
            n = max(int(t[o + 3]), 1)
            per[f"LM iteration {deg}"] = {
                "cholesky": round(t[o] / n), "boxplus": round(t[o + 1] / n),
                "lane pass": round(t[o + 2] / n), "n": int(t[o + 3])}
        for deg, o in (("degree1", LM + 8), ("degree4", LM + 12)):
            n = max(int(t[o + 3]), 1)
            per[f"lane pass {deg}"] = {
                "quat_to_R": round(t[o] / n), "lanes": round(t[o + 1] / n),
                "sum28": round(t[o + 2] / n), "n": int(t[o + 3])}
        out["fused_solve"]["gls" if weighted else "no_gls"] = {
            "leader_cycles": stages, **per}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
