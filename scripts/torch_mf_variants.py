#!/usr/bin/env python3
"""Design variants of the `moments_fused` CUDA kernel on one card.

    python3 scripts/torch_mf_variants.py [--parent ROOT] [--reps 2] [--out FILE]

Each variant is a text edit of this checkout's `icpx_torch/csrc/blocknn.cu`
("committed" is the source unedited; "parent" is ROOT's source, when
given). All are built with `nvcc` in parallel into a temporary directory,
loaded with ctypes and launched through their C entry on the same inputs:
chip_smoke.py's 1M covariance index (the `_gt_pair` flagship target's KD
index of 128-point tiles, each its own query tile, `_cov_radius(target,
15)`, k 8, groups of 4, unions of 32). Each is held to the plain version's
counts and timed by chip_smoke.py's timers (device: a CUDA graph of 20
calls; event: one call), in turns, the order reversed every pass. The
"count" variant adds warp-level counters to the row loop: the row steps a
warp makes and those in which it takes the hit branch. Prints each
variant's ptxas report, every reading, and one JSON line (also written to
FILE).
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEST = "(s1[0] <= nc[0]) | (s1[1] <= nc[1]) | (s1[2] <= nc[2]) | (s1[3] <= nc[3])"
BOUNDS = "__launch_bounds__(kMFThreads, 3)"
THREADS = "constexpr int kMFThreads = 256;"
UNROLL = "#pragma unroll 4\n      for (int u = 1; u < n_u; ++u) {"
READ_AHEAD = """      float4 r = rl[1];  // prefetched a row ahead
      mf_row<true>(rl[0], ax, ay, az, nc, m, mult0);  // slot 0, weighted
#pragma unroll 4
      for (int u = 1; u < n_u; ++u) {
        const float4 next = rl[u + 1];
        mf_row<false>(r, ax, ay, az, nc, m, 1.f);
        r = next;
      }"""
NO_READ_AHEAD = """      mf_row<true>(rl[0], ax, ay, az, nc, m, mult0);  // slot 0, weighted
#pragma unroll 4
      for (int u = 1; u < n_u; ++u) mf_row<false>(rl[u], ax, ay, az, nc, m, 1.f);"""
FMA_BODY = """    for (int k = 0; k < kMFQ; ++k) {
      const float h = s1[k] <= nc[k] ? (kWeighted ? w : 1.f) : 0.f;
      m[k][0] += h;
#pragma unroll
      for (int i = 0; i < 9; ++i) m[k][i + 1] = fmaf(h, f[i], m[k][i + 1]);
    }"""
BRANCH_BODY = """    for (int k = 0; k < kMFQ; ++k) {
      if (s1[k] <= nc[k]) {
        m[k][0] += kWeighted ? w : 1.f;
#pragma unroll
        for (int i = 0; i < 9; ++i)
          m[k][i + 1] = kWeighted ? fmaf(w, f[i], m[k][i + 1]) : m[k][i + 1] + f[i];
      }
    }"""
COUNTERS = """
extern "C" int mf_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_mf_count, sizeof(unsigned long long) * 2);
}
"""
# The screen: t = fma(ax, rx, fma(ay, ry, fma(az, rz, rr (1 - 2^-20)))) against
# thr = -c + 2^-20 (|q_c|^2 + r^2) + 2^-126, rounded up. With s1 the rounded
# score, |s1 - E| <= gamma_4 T and |t - E'| <= gamma_3 T (E, E' the exact sums,
# T the sum of the terms' magnitudes <= |q_c|^2 + 2 rr (1 + 3u)), and rr
# lowered by >= 15u rr: s1 <= -c implies t <= thr. A row that passes for one
# of the four queries computes the rounded score and its exact test.
SCREEN_ROW = """template <bool kWeighted>
__device__ __forceinline__ void mf_row(const float4 r, const float (&ax)[kMFQ],
                                       const float (&ay)[kMFQ], const float (&az)[kMFQ],
                                       const float (&nc)[kMFQ], float (&m)[kMFQ][10], float w,
                                       float r2) {
  const float rs = __fmul_rn(r.w, 0x1.ffffep-1f);
  float t[kMFQ];
#pragma unroll
  for (int k = 0; k < kMFQ; ++k)
    t[k] = __fmaf_rn(ax[k], r.x, __fmaf_rn(ay[k], r.y, __fmaf_rn(az[k], r.z, rs)));
  if ((t[0] <= nc[0]) | (t[1] <= nc[1]) | (t[2] <= nc[2]) | (t[3] <= nc[3])) {
    const float f[9] = {r.x, r.y, r.z, r.x * r.x, r.y * r.y, r.z * r.z,
                        r.x * r.y, r.x * r.z, r.y * r.z};
#pragma unroll
    for (int k = 0; k < kMFQ; ++k) {
      const float qx = -0.5f * ax[k], qy = -0.5f * ay[k], qz = -0.5f * az[k];
      const float mc = -__fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz)), r2);
      const float s1 = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ax[k], r.x), __fmul_rn(ay[k], r.y)), __fmul_rn(az[k], r.z)),
          r.w);
      const float h = s1 <= mc ? (kWeighted ? w : 1.f) : 0.f;
      m[k][0] += h;
#pragma unroll
      for (int i = 0; i < 9; ++i) m[k][i + 1] = fmaf(h, f[i], m[k][i + 1]);
    }
  }
}

"""


def _replace(text, old, new):
    if old not in text:
        raise SystemExit(f"edit does not apply: {old[:70]!r}")
    return text.replace(old, new, 1)


def _edits(*pairs):
    def edit(text):
        for old, new in pairs:
            text = _replace(text, old, new)
        return text
    return edit


def _screen(text):
    start = text.index("template <bool kWeighted>\n__device__ __forceinline__ void mf_row(")
    end = text.index("__global__ void " + BOUNDS)
    text = text[:start] + SCREEN_ROW + text[end:]
    text = _replace(text, "    nc[k] = in ? -c : -__int_as_float(0x7f800000);",
                    "    const float qq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), "
                    "__fmul_rn(qz, qz));\n"
                    "    nc[k] = in ? __fadd_ru(-c, __fadd_ru(__fmul_ru(__fadd_ru(qq, r2), 0x1p-20f), "
                    "0x1p-126f)) : -__int_as_float(0x7f800000);")
    text = _replace(text, "mf_row<true>(rl[0], ax, ay, az, nc, m, mult0);",
                    "mf_row<true>(rl[0], ax, ay, az, nc, m, mult0, r2);")
    return _replace(text, "mf_row<false>(r, ax, ay, az, nc, m, 1.f);",
                    "mf_row<false>(r, ax, ay, az, nc, m, 1.f, r2);")


def _count(text):
    hook = ("  {\n    const unsigned act = __activemask();\n"
            f"    const bool wany = __any_sync(act, {TEST});\n"
            "    if ((threadIdx.x & 31) == __ffs(act) - 1) {\n"
            "      atomicAdd(&g_mf_count[0], 1ull);\n"
            "      if (wany) atomicAdd(&g_mf_count[1], 1ull);\n    }\n  }\n")
    text = _replace(text, "namespace {\n", "namespace {\n__device__ unsigned long long g_mf_count[2];\n")
    return _replace(text, f"  if ({TEST}) {{", hook + f"  if ({TEST}) {{") + COUNTERS


VARIANTS = {
    "committed": _edits(),
    "uncapped": _edits((BOUNDS, "__launch_bounds__(kMFThreads)")),
    "4 blocks an SM": _edits((BOUNDS, "__launch_bounds__(kMFThreads, 4)")),
    "no read-ahead": _edits((READ_AHEAD, NO_READ_AHEAD)),
    "unroll 8": _edits((UNROLL, UNROLL.replace("4", "8", 1))),
    "unroll 2": _edits((UNROLL, UNROLL.replace("4", "2", 1))),
    "__any_sync branch": _edits((f"  if ({TEST}) {{", f"  if (__any_sync(0xffffffffu, {TEST})) {{")),
    "a branch a query": _edits((FMA_BODY, BRANCH_BODY)),
    "128 threads, 5 blocks": _edits((THREADS, THREADS.replace("256", "128")),
                                    (BOUNDS, "__launch_bounds__(kMFThreads, 5)")),
    "128 threads, 6 blocks": _edits((THREADS, THREADS.replace("256", "128")),
                                    (BOUNDS, "__launch_bounds__(kMFThreads, 6)")),
    "512 threads": _edits((THREADS, THREADS.replace("256", "512")),
                          (BOUNDS, "__launch_bounds__(kMFThreads, 1)")),
    "screen": _screen,
    "screen, uncapped": lambda text: _screen(text).replace(BOUNDS, "__launch_bounds__(kMFThreads)", 1),
    "count": _count,
}


def main(parent, reps, out_path):
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from icpx_torch.kernels import blocknn_cuda, cuda_build
    from icpx_torch.kernels.blocknn import _candidate_tiles, build_kd_index

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    src = cuda_build.source_path("blocknn").read_text()
    texts = {name: edit(src) for name, edit in VARIANTS.items()}
    if parent:
        with open(os.path.join(parent, "icpx_torch", "csrc", "blocknn.cu")) as f:
            texts = {"parent": f.read(), **texts}
    tmp = tempfile.mkdtemp(prefix="mf_variants_")
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        path = os.path.join(tmp, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (path[:-3] + ".so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        report = re.search(r"moments_fused_kernel[^\n]*\n([^\n]*stack frame[^\n]*)\n([^\n]*registers[^\n]*)", log)
        ptxas[name] = " ".join(x.strip() for x in report.groups())
        print(f"{name}: {ptxas[name]}")
        lib = ctypes.CDLL(so)
        lib.icpx_moments_fused_forward.argtypes = [p, p, p, p, p, i, i, i, i, p, i, p]
        libs[name] = lib

    dev = torch.device("cuda", 0)
    _, f_tgt, _ = smoke._gt_pair(smoke.N_FLAG, 0, dev)
    idx = build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128)
    radius = smoke._cov_radius(f_tgt, 15)
    unions = blocknn_cuda.group_unions(_candidate_tiles(idx.tiles, idx, 8)[0], 4, 32)
    q_cent = blocknn_cuda.group_centroids(idx.tiles, 4)
    r2 = (radius * radius).reshape(1).to(torch.float32)
    want = blocknn_cuda.moments_fused_reference(idx.tiles, idx.tiles, unions, q_cent, r2[0], 4)
    g, u_max = unions.shape
    gq = 4 * idx.tile_size
    out = torch.empty((10, g * gq), device=dev)

    def launch(lib):
        rc = lib.icpx_moments_fused_forward(
            idx.tiles.data_ptr(), idx.tiles.data_ptr(), unions.data_ptr(), q_cent.data_ptr(),
            r2.data_ptr(), g, gq, idx.tile_size, u_max, out.data_ptr(), 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")

    readings = {name: [] for name in libs}
    equal = {}
    names = list(libs)
    for rep in range(reps):
        for name in names if rep % 2 == 0 else names[::-1]:
            launch(libs[name])
            torch.cuda.synchronize()
            equal[name] = bool(torch.equal(out[0], want[0]))
            if not equal[name]:
                raise SystemExit(f"{name}: counts differ from the plain version's")
            device_ms = smoke._graph_ms(lambda: launch(libs[name]))
            event_ms = smoke._event_ms(lambda: launch(libs[name]))
            readings[name].append((device_ms, event_ms))
            print(f"{name}: counts equal, device {device_ms:.4f} ms, event {event_ms:.4f} ms")
    lib = libs["count"]
    lib.mf_counts.argtypes = [ctypes.c_void_p]
    before, after = (ctypes.c_ulonglong * 2)(), (ctypes.c_ulonglong * 2)()
    lib.mf_counts(ctypes.addressof(before))
    launch(lib)
    torch.cuda.synchronize()
    lib.mf_counts(ctypes.addressof(after))
    steps, taken = (after[j] - before[j] for j in range(2))
    hits = float(want[0].sum())
    print(f"warp row steps {steps}, hit branch taken in {taken} ({taken / steps:.4f}); "
          f"pairs inside the radius {hits:.6g} (slot 0 weighted)")
    result = {"card": card, "ptxas": ptxas, "readings": readings,
              "row_steps": steps, "branch_taken": taken, "pairs_inside": hits}
    line = json.dumps(result)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/blocknn.cu to time beside the variants")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    main(args.parent, args.reps, args.out)
