#!/usr/bin/env python3
"""Design variants of one CUDA kernel of `icpx_torch/csrc/blocknn.cu` on one card.

    python3 scripts/torch_variants.py {moments6,moments6_k8,fold6,fold7,moments_fused} [--parent ROOT]
        [--reps 2] [--out FILE]

Each variant is a text edit of this checkout's `icpx_torch/csrc/blocknn.cu`
("committed" is the source unedited; "parent" is ROOT's source, when
given, launched through its own C entry). All are built with `nvcc` in
parallel into a temporary directory, loaded with ctypes and launched
through their C entry on the same inputs. Each variant that keeps the
contract is held to the plain version; the diagnostic ones, which drop
work the result needs, are only timed. All are timed by chip_smoke.py's
timers (device: a CUDA graph of 20 calls; event: one call), in turns, the
order reversed every pass. The "count" variant adds counters (atomics read
back by `cudaMemcpyFromSymbol`). Prints each variant's ptxas report, every
reading, and one JSON line (also written to FILE).

The kernels (`KERNELS`):

* moments6: chip_smoke.py's 1M normals shape (the `_gt_pair` flagship
  target's trimmed KD index of 128-point tiles, each its own query tile,
  k 2, the registration's radius); moments6_k8: GICP's covariance shape
  (the target's covariance index, k 8, `_cov_radius(target, 15)`). Each
  variant with the plan `moments6_plan` makes from the shape its own
  library reports (the parent's one-query-a-thread kernel takes none);
  held to `moments6_reference`'s counts, and its means within 1e-5.
  "count" counts a warp's rows screened, those with a bit in some lane
  (the row steps a branch a row would take), the pairs with a bit and in
  the band, the walk's passes, and the warp stages and words skipped as far
  or by their boxes.
* fold6: chip_smoke.py's 1M refine shape (`_refine_operands` of the
  `_gt_pair` flagship, 16,384 x 64 queries, k 6 candidate tiles of 128
  lanes, the 6-wide payload table), each variant with the plan
  `fold6_plan` makes from the shape its own library reports; held to
  `fold6_reference` bit for bit in d2 and payload. "count" counts the
  queries resolved from one screened group, from two, and sent to the
  direct scan (and of those, for a third group within the margin).
* fold7: the same refine shape, operands centred on the query tiles'
  centroids, each variant with the plan `fold7_plan` makes from the shape
  its own library reports (the parent's one-query-a-thread kernel before
  it takes the (Tq, k, S, 4) bf16 operands, made here by
  `fold7_operands`); held to `fold7_reference` bit for bit. "count" counts
  the queries resolved from their best group and by the direct scan.
* moments_fused: chip_smoke.py's 1M covariance index (the `_gt_pair`
  flagship target's KD index of 128-point tiles, each its own query tile,
  `_cov_radius(target, 15)`, k 8, groups of 4, unions of 32); held to the
  plain version's counts. "count" counts the row steps a warp makes and
  those in which it takes the hit branch.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, I = ctypes.c_void_p, ctypes.c_int


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


def _counters(name, n):
    """The C entry that reads a variant's n counters back."""
    return (f'\nextern "C" int {name}_counts(unsigned long long* out) {{\n'
            f"  return (int)cudaMemcpyFromSymbol(out, g_{name}_count, "
            f"sizeof(unsigned long long) * {n});\n}}\n")


class Case(NamedTuple):
    """A kernel's inputs on the card: `launch(name, lib)` runs a variant's C
    entry, `equal()` holds the last launch's outputs to the plain version,
    `report(counts)` turns the "count" variant's counters into a line and
    JSON fields."""
    launch: Callable
    equal: Callable
    report: Callable


class Kernel(NamedTuple):
    symbol: str  # the kernel's name in the ptxas report
    variants: Dict[str, Tuple[Callable, bool]]  # name -> (edit, held to the plain version)
    n_counts: int  # counters of the "count" variant
    counts_entry: str  # its C entry that reads them back
    setup: Callable  # (chip_smoke module, device, libs) -> Case


# ---- fold6 ----------------------------------------------------------------------------

F6_BOUNDS = "__global__ void __launch_bounds__(kF6Threads)\nfold6_kernel("
F6_THREADS = "constexpr int kF6Threads = 128;"
F6_STAGE = "constexpr int kF6StageRows = 1024;"
F6_QUERIES = "constexpr int kF6Q = 4; "
F6_GROUP = "constexpr int kF6Group = 8;"
F6_SCREEN_START = "    const float4* rs = rows + br * lcp;\n"
F6_SCREEN_END = "  }\n\n  // Each query: the least key"
F6_EXACT_START = "    if (fmaxf(fabsf(x), fmaxf(fabsf(y), fabsf(z))) < kF6FarAbs && m1[q]"
F6_NEED = "    if (!(__uint_as_float(static_cast<unsigned>(key[q] >> 32)) < kF6DirectD2)) need |= 1u << q;\n"
F6_PAIR = ("      if (m2[q] <= thr) key[q] = min(key[q], f6_group(x, y, z, tiles, ids, s, k, lc, chunks, ng, "
           "g2[q]));\n")


def _f6_no_exact(text):
    """Diagnostic: the screen alone; every winner is row 0, d2 0."""
    a, b = text.index(F6_EXACT_START), text.index(F6_NEED) + len(F6_NEED)
    return text[:a] + "    key[q] = 0;\n" + text[b:]


def _f6_no_screen(text):
    """Diagnostic: staging, packing and the epilogue's copies alone."""
    a, b = text.index(F6_SCREEN_START), text.index(F6_SCREEN_END)
    return _f6_no_exact(text[:a] + text[b:])


def _f6_count(text):
    """Counters: queries resolved by one group, by two, sent to the direct
    scan by a third group within the margin, and sent to it in all."""
    text = _replace(text, "namespace {\n", "namespace {\n__device__ unsigned long long g_f6_count[4];\n")
    text = _replace(text, F6_PAIR, "      if (m2[q] <= thr) {\n"
                    + F6_PAIR.replace("      if (m2[q] <= thr) ", "        ")
                    + "        atomicAdd(&g_f6_count[1], 1ull);\n"
                    "      } else {\n        atomicAdd(&g_f6_count[0], 1ull);\n      }\n")
    text = _replace(text, F6_NEED, F6_NEED + "    if (need >> q & 1u) {\n"
                    "      atomicAdd(&g_f6_count[3], 1ull);\n"
                    "      if (m3[q] <= thr) atomicAdd(&g_f6_count[2], 1ull);\n    }\n")
    return text + _counters("f6", 4)


F6_TRACK_VOTE = """      bool enters = false;  // a group minimum below m3 enters the three least
#pragma unroll
      for (int q = 0; q < kF6Q; ++q) enters |= gmin[q] < m3[q];
      if (__any_sync(0xffffffffu, enters)) {  // warp-uniform, and rare once near rows are known
        const int gid = st * ng + g;
"""
F6_TRACK_BRANCH = """      {
        const int gid = st * ng + g;
"""
F6_NEXT_STAGE = """    if (st + 1 < n_st) {  // into the raw buffer, now packed, while st is screened
      const int c1 = (st + 1) / chunks;
      stage_chunk<kF6Threads>(raw, tiles, cand_b + c1, n_live, s, lc, st + 1 - c1 * chunks, by16, k);
    }
"""
# Two raw stage buffers: the next stage is issued before packing, into the
# other buffer (12 bytes a staged row more).
F6_TWO_BUFFERS = (("constexpr int kF6Smem = kF6StageRows * 12",
                   "constexpr int kF6Smem = 2 * kF6StageRows * 12"),
                  ("  float4* rows = f6_smem + kF6StageRows * 3 / 4;",
                   "  float4* rows = f6_smem + 2 * kF6StageRows * 3 / 4;"),
                  (F6_NEXT_STAGE, ""),
                  ("    const int ci = st / chunks, nl = min(lc, s - (st - ci * chunks) * lc);\n",
                   F6_NEXT_STAGE.replace("raw, tiles", "raw + ((st + 1) & 1) * kF6StageRows * 3, tiles")
                   + "    const int ci = st / chunks, nl = min(lc, s - (st - ci * chunks) * lc);\n"),
                  ("        const float* r = raw + 3 * (u * lc + l);",
                   "        const float* r = raw + (st & 1) * kF6StageRows * 3 + 3 * (u * lc + l);"))


def _f6_config(queries=4, threads=128, stage=1024, two_buffers=False, blocks=None):
    """The kernel's constants: queries a thread, threads a block, packed rows
    a stage; two raw stage buffers; a register cap for `blocks` blocks an
    SM."""
    edits = [(F6_QUERIES, F6_QUERIES.replace("4", str(queries))),
             (F6_THREADS, F6_THREADS.replace("128", str(threads))),
             (F6_STAGE, F6_STAGE.replace("1024", str(stage)))]
    if two_buffers:
        edits += F6_TWO_BUFFERS
    if blocks:
        edits.append((F6_BOUNDS, F6_BOUNDS.replace("(kF6Threads)", f"(kF6Threads, {blocks})")))
    return _edits(*edits)


F6_GMIN = """#pragma unroll
      for (int q = 0; q < kF6Q; ++q) gmin[q] = __int_as_float(0x7f800000);
#pragma unroll
      for (int e = 0; e < kF6Group; ++e) {
        const float4 r = rs[g * kF6Group + e];  // a broadcast over the tile's threads
#pragma unroll
        for (int q = 0; q < kF6Q; ++q) gmin[q] = fminf(gmin[q], f6_screen(ax[q], ay[q], az[q], r));
      }
"""
F6_MIN_TREE = """#pragma unroll
      for (int q = 0; q < kF6Q; ++q) {
        float sc[kF6Group];
#pragma unroll
        for (int e = 0; e < kF6Group; ++e) sc[e] = f6_screen(ax[q], ay[q], az[q], rs[g * kF6Group + e]);
#pragma unroll
        for (int w = kF6Group / 2; w > 0; w /= 2) {
#pragma unroll
          for (int e = 0; e < w; ++e) sc[e] = fminf(sc[e], sc[e + w]);
        }
        gmin[q] = sc[0];
      }
"""
F6_GROUP_LOOP = "    for (int g = 0; g < ng; ++g) {\n      float gmin[kF6Q];\n"
F6_UNROLL = "#pragma unroll 2  // two groups' loads and chains in flight: 5% faster\n"


def _f6_branch_tracking(text):
    """Each query's top-three update behind its own branch, no warp vote."""
    text = _replace(text, F6_TRACK_VOTE, F6_TRACK_BRANCH)
    return _replace(text, "          if (m < m2[q]) {", "          if (m < m2[q]) {  // rare")


def _f6_screen_kept(text):
    """Diagnostic: no rescoring and no direct scan, but the winner's index
    still depends on the tracked minima and groups, so the screen stays."""
    a, b = text.index(F6_EXACT_START), text.index(F6_NEED) + len(F6_NEED)
    return text[:a] + ("    key[q] = (__float_as_uint(m1[q]) ^ __float_as_uint(m2[q]) ^ "
                       "__float_as_uint(m3[q]) ^ g1[q] ^ g2[q] ^ __float_as_uint(x)) & 7u;\n") + text[b:]


F6_VARIANTS = {
    "a branch a query": (_f6_branch_tracking, True),
    "groups of 16": (_edits((F6_GROUP, F6_GROUP.replace("8", "16"))), True),
    "two raw buffers": (_f6_config(two_buffers=True), True),
    "7 blocks an SM": (_f6_config(blocks=7), True),
    "8 queries, 2048 rows": (_f6_config(queries=8, stage=2048), True),
    "8 queries, 2048 rows, 4 blocks an SM": (_f6_config(queries=8, stage=2048, blocks=4), True),
    "8 queries, 64 threads": (_f6_config(queries=8, threads=64), True),
    "8 queries, 64 threads, 8 blocks an SM": (_f6_config(queries=8, threads=64, blocks=8), True),
    "min tree": (_edits((F6_GMIN, F6_MIN_TREE)), True),
    "no unroll": (_edits((F6_UNROLL + F6_GROUP_LOOP, F6_GROUP_LOOP)), True),
    "unroll 4": (_edits((F6_UNROLL + F6_GROUP_LOOP, F6_UNROLL.replace("2", "4", 1) + F6_GROUP_LOOP)), True),
    "screen kept, no exact": (_f6_screen_kept, False),
    "no exact": (_f6_no_exact, False),
    "no screen": (_f6_no_screen, False),
    "count": (_f6_count, True),
}


def _f6_setup(smoke, dev, libs):
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import build_kd_index, fused_payload_table, trim_index

    f_src, f_tgt, f_gt = smoke._gt_pair(smoke.N_FLAG, 0, dev)
    tgt_index = trim_index(build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128),
                           f_tgt.capacity, multiple=64)
    query, cand, _ = smoke._refine_operands(f_src, tgt_index, f_gt)
    aux = torch.as_tensor(np.random.default_rng(2).normal(size=(smoke.N_FLAG, 3)).astype(np.float32),
                          device=dev)
    ops = blocknn_cuda.fold6_prepare(cand, tgt_index, fused_payload_table(tgt_index, aux))
    want = blocknn_cuda.fold6_reference(query, ops)
    tq, sq, _ = query.shape
    s, k, d_pl = ops.tiles.shape[1], ops.cand.shape[1], ops.payload.shape[1]
    out_d = torch.empty((tq * sq,), device=dev)
    out_pl = torch.empty((tq * sq, d_pl), device=dev)
    plans = {}
    for name, lib in libs.items():
        if hasattr(lib, "icpx_fold6_shape"):  # the screening kernel: plans from its shape
            shape = blocknn_cuda._read_shape(lib, "icpx_fold6_shape", blocknn_cuda.Fold6Shape)
            plans[name] = blocknn_cuda.fold6_plan(tq, sq, s, k, shape)
            lib.icpx_fold6_forward.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, P, P, I, P]
        else:  # the direct-form kernel before it
            lib.icpx_fold6_forward.argtypes = [P, P, P, P, I, I, I, I, I, P, P, I, P]
    print(f"plans: {json.dumps(plans)}")

    def launch(name, lib):
        st = torch.cuda.current_stream().cuda_stream
        if name in plans:
            return lib.icpx_fold6_forward(
                query.data_ptr(), ops.tiles.data_ptr(), ops.cand.data_ptr(), ops.box_lo.data_ptr(),
                ops.box_hi.data_ptr(), ops.payload.data_ptr(), tq, sq, s, k, d_pl,
                plans[name]["tiles_per_block"], plans[name]["lanes_per_stage"], out_d.data_ptr(),
                out_pl.data_ptr(), 0, st)
        return lib.icpx_fold6_forward(
            query.data_ptr(), ops.tiles.data_ptr(), ops.cand.data_ptr(), ops.payload.data_ptr(),
            tq, sq, s, k, d_pl, out_d.data_ptr(), out_pl.data_ptr(), 0, st)

    def report(counts):
        one, two, third, direct = counts
        return (f"of {tq * sq} queries: resolved from one group {one}, from two {two}; the direct "
                f"scan {direct}, of them {third} for a third group within the margin",
                {"plans": plans, "one_group": one, "two_groups": two, "direct": direct,
                 "direct_third_group": third})

    return Case(launch, lambda: torch.equal(out_d, want[0]) and torch.equal(out_pl, want[1]), report)


# ---- fold7 ----------------------------------------------------------------------------

F7_BOUNDS = "__global__ void __launch_bounds__(kF7Threads, 6)\nfold7_kernel("
F7_STAGE = "constexpr int kF7StageRows = 1024;"
F7_QUERIES = "constexpr int kF7Q = 4; "
F7_UNROLL = "#pragma unroll 2\n    for (int g = 0; g < ng; ++g) {"
F7_SELECTS = """#pragma unroll
      for (int q = 0; q < kF7Q; ++q) {  // a strict '<': the earlier group keeps a tie
        bj[q] = gmin[q] < best[q] ? j0 + g * kF7Group : bj[q];
        best[q] = fminf(best[q], gmin[q]);
      }
"""
F7_VOTE = """      bool enters = false;
#pragma unroll
      for (int q = 0; q < kF7Q; ++q) enters |= gmin[q] < best[q];
      if (__any_sync(0xffffffffu, enters)) {  // warp-uniform
#pragma unroll
        for (int q = 0; q < kF7Q; ++q) {
          if (gmin[q] < best[q]) {
            best[q] = gmin[q];
            bj[q] = j0 + g * kF7Group;
          }
        }
      }
"""
F7_RANGE = "        if (f7_outside3(v, kF7LoB, kF7HiB)) outside[u] = 1;\n"
F7_RESCORE_START = "    float r[3 * kF7Group];  // the group's rows"
F7_RESCORE_END = "    bj[q] = win;\n"
F7_NEED = "      need |= 1u << q;\n      continue;\n"


def _f7_count(text):
    """Counters: the queries resolved from their best group, and by the
    direct scan."""
    text = _replace(text, "namespace {\n", "namespace {\n__device__ unsigned long long g_f7_count[2];\n")
    text = _replace(text, F7_RESCORE_END, F7_RESCORE_END + "    atomicAdd(&g_f7_count[0], 1ull);\n")
    text = _replace(text, F7_NEED, "      atomicAdd(&g_f7_count[1], 1ull);\n" + F7_NEED)
    return text + _counters("f7", 2)


def _f7_no_rescore(text):
    """Diagnostic: no rescoring; the winner is its group's first row."""
    a, b = text.index(F7_RESCORE_START), text.index(F7_RESCORE_END) + len(F7_RESCORE_END)
    return text[:a] + text[b:]


def _f7_config(queries=4, stage=1024, blocks=None):
    edits = [(F7_QUERIES, F7_QUERIES.replace("4", str(queries))),
             (F7_STAGE, F7_STAGE.replace("1024", str(stage)))]
    if blocks:
        edits.append((F7_BOUNDS, F7_BOUNDS.replace("(kF7Threads, 6)", f"(kF7Threads, {blocks})")))
    return _edits(*edits)


F7_VARIANTS = {
    "a warp vote a group": (_edits((F7_SELECTS, F7_VOTE)), True),
    "no unroll": (_edits((F7_UNROLL, F7_UNROLL.replace("#pragma unroll 2\n", ""))), True),
    "unroll 4": (_edits((F7_UNROLL, F7_UNROLL.replace("2", "4", 1))), True),
    "896 rows, 7 blocks an SM": (_f7_config(stage=896, blocks=7), True),
    "uncapped registers": (_edits((F7_BOUNDS, F7_BOUNDS.replace(", 6)", ")"))), True),
    "8 queries, 2048 rows, 3 blocks an SM": (_f7_config(queries=8, stage=2048, blocks=3), True),
    "no range check (diagnostic)": (_edits((F7_RANGE, "")), True),
    "no rescoring": (_f7_no_rescore, False),
    "count": (_f7_count, True),
}


def _f7_setup(smoke, dev, libs):
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import build_kd_index, fused_payload_table, trim_index

    f_src, f_tgt, f_gt = smoke._gt_pair(smoke.N_FLAG, 0, dev)
    tgt_index = trim_index(build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128),
                           f_tgt.capacity, multiple=64)
    query, cand, q_cent = smoke._refine_operands(f_src, tgt_index, f_gt)
    aux = torch.as_tensor(np.random.default_rng(2).normal(size=(smoke.N_FLAG, 3)).astype(np.float32),
                          device=dev)
    ops = blocknn_cuda.fold7_prepare(cand, q_cent, tgt_index, fused_payload_table(tgt_index, aux))
    want = blocknn_cuda.fold7_reference(query, ops)
    tq, sq, _ = query.shape
    s, k, d_pl = ops.tiles.shape[1], ops.cand.shape[1], ops.payload.shape[1]
    out_d = torch.empty((tq * sq,), device=dev)
    out_pl = torch.empty((tq * sq, d_pl), device=dev)
    plans, b_ops = {}, None
    for name, lib in libs.items():
        if hasattr(lib, "icpx_fold7_shape"):  # the staged kernel: plans from its shape
            shape = blocknn_cuda._read_shape(lib, "icpx_fold7_shape", blocknn_cuda.Fold6Shape)
            plans[name] = blocknn_cuda.fold7_plan(tq, sq, s, k, shape)
            lib.icpx_fold7_forward.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P, P, I, P]
        else:  # the one-query-a-thread kernel before it, on a (Tq, k, S, 4) bf16 copy
            b_ops = blocknn_cuda.fold7_operands(ops, 0, tq).contiguous()
            lib.icpx_fold7_forward.argtypes = [P, P, P, P, P, I, I, I, I, I, P, P, I, P]
    print(f"plans: {json.dumps(plans)}")

    def launch(name, lib):
        st = torch.cuda.current_stream().cuda_stream
        if name in plans:
            return lib.icpx_fold7_forward(
                query.data_ptr(), ops.tiles.data_ptr(), ops.cand.data_ptr(), ops.q_cent.data_ptr(),
                ops.payload.data_ptr(), tq, sq, s, k, d_pl, plans[name]["tiles_per_block"],
                plans[name]["lanes_per_stage"], out_d.data_ptr(), out_pl.data_ptr(), 0, st)
        return lib.icpx_fold7_forward(
            query.data_ptr(), b_ops.data_ptr(), ops.cand.data_ptr(), ops.q_cent.data_ptr(),
            ops.payload.data_ptr(), tq, sq, s, k, d_pl, out_d.data_ptr(), out_pl.data_ptr(), 0, st)

    def report(counts):
        group, direct = counts
        return (f"of {tq * sq} queries: from their best group {group}, by the direct scan {direct}",
                {"plans": plans, "best_group": group, "direct": direct})

    return Case(launch, lambda: torch.equal(out_d.view(torch.int32), want[0].view(torch.int32))
                and torch.equal(out_pl, want[1]), report)


# ---- moments6 -------------------------------------------------------------------------

M6_BOUNDS = "__global__ void __launch_bounds__(kM6Threads, 8)\nmoments6_kernel("
M6_QUERIES = "constexpr int kM6Q = 2; "
M6_SKIP = "    if (__all_sync(0xffffffffu, skip_all)) continue;  // warp-uniform\n"
M6_SCREEN_START = "    // the screen: a bit a pair, the sign of t = fma(ax, x, fma(ay, y, fma(az, z,\n"
M6_WORDS = "      for (int q = 0; q < kM6Q; ++q) hit_s[w][q][threadIdx.x] = bits[q];\n"
M6_HITS_START = "    // the hits: each pass takes the next set bit of every query of the\n"
M6_HITS_END = "  // count, mean (de-centred), c00, c01, c02, c11, c12, c22 a query\n"
M6_BAND = "          if (!h)  // the band: the contract's direct form decides\n"
M6_BEYOND = "      if (!__all_sync(0xffffffffu, beyond)) {  // warp-uniform\n"
M6_PASS = "    for (bool more = true; more;) {\n      more = false;\n"
# The first screen: FSETP on s <= thr_hi and a select and an add a pair.
M6_FSETP_EDITS = (
    ("            const float t =\n                m6_screen(ax[q], ay[q], az[q], make_float4(r.x, r.y, r.z, "
     "__fsub_rn(r.w, hi[q])));\n            bits[q] = __funnelshift_l(__float_as_uint(t), bits[q], 1);\n",
     "            bits[q] |= m6_screen(ax[q], ay[q], az[q], r) <= hi[q] ? 0x80000000u >> e : 0u;\n"),
)
# A branch a row step: the compares of a row branch once; inside, each
# query adds h in {0, 1} times the row's features by FMA (moments_fused's
# mf_row), against the same thresholds.
M6_ROW_BRANCH = """    for (int j = 0; j < lcp; ++j) {
      const float4 r = rs[j];  // a broadcast over the tile's threads
      float sc[kM6Q];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kM6Q; ++q) {
        sc[q] = m6_screen(ax[q], ay[q], az[q], r);
        any |= sc[q] <= hi[q];
      }
      if (any) {
        const float f[9] = {r.x, r.y, r.z, r.x * r.x, r.x * r.y, r.x * r.z, r.y * r.y, r.y * r.z,
                            r.z * r.z};
#pragma unroll
        for (int q = 0; q < kM6Q; ++q) {
          bool h = sc[q] <= lo[q];
          if (!h && sc[q] <= hi[q])
            h = sqdist_rn(-0.5f * ax[q], -0.5f * ay[q], -0.5f * az[q], r.x, r.y, r.z) <= r2;
          const float wt = h ? 1.f : 0.f;
          m[q][0] += wt;
#pragma unroll
          for (int i = 0; i < 9; ++i) m[q][i + 1] = __fmaf_rn(wt, f[i], m[q][i + 1]);
        }
      }
    }
  }

"""
# The first walk: one query at a time, so a warp makes as many passes as its
# lanes' most hits, summed over the queries.
M6_PER_QUERY = """    // the hits, a query at a time
#pragma unroll
    for (int q = 0; q < kM6Q; ++q) {
      int w = 0;
      unsigned bits = hit_s[0][q][threadIdx.x];
      for (;;) {
        while (bits == 0u && ++w < nw) bits = hit_s[w][q][threadIdx.x];
        if (bits == 0u) break;
        const int e = __clz(bits);
        bits &= ~(0x80000000u >> e);
        const float4 r = rs[w * kM6Group + e];
        bool h = m6_screen(ax[q], ay[q], az[q], r) <= lo[q];
        if (!h) h = sqdist_rn(-0.5f * ax[q], -0.5f * ay[q], -0.5f * az[q], r.x, r.y, r.z) <= r2;
        if (h) {
          m[q][0] += 1.f;
          m[q][1] += r.x;
          m[q][2] += r.y;
          m[q][3] += r.z;
          m[q][4] = __fmaf_rn(r.x, r.x, m[q][4]);
          m[q][5] = __fmaf_rn(r.x, r.y, m[q][5]);
          m[q][6] = __fmaf_rn(r.x, r.z, m[q][6]);
          m[q][7] = __fmaf_rn(r.y, r.y, m[q][7]);
          m[q][8] = __fmaf_rn(r.y, r.z, m[q][8]);
          m[q][9] = __fmaf_rn(r.z, r.z, m[q][9]);
        }
      }
    }
  }

"""
def _m6_between(start, end, new):
    def edit(text):
        a, b = text.index(start), text.index(end)
        return text[:a] + new + text[b:]
    return edit


def _m6_no_hits(text):
    """Diagnostic: the screen alone; each query's count is its bits."""
    return _m6_between(M6_HITS_START, M6_HITS_END, """#pragma unroll
    for (int q = 0; q < kM6Q; ++q)
      for (int w = 0; w < nw; ++w) m[q][0] += __popc(hit_s[w][q][threadIdx.x]);
  }

""")(text)


def _m6_count(text):
    """Counters: a warp's rows screened, those with a bit in some lane (the
    row steps a branch a row would take), the pairs with a bit, the pairs in
    the band, the walk's passes (a warp's), and the warp stages skipped as
    far, and the warp words skipped by their boxes."""
    text = _replace(text, "namespace {\n", "namespace {\n__device__ unsigned long long g_m6_count[7];\n")
    text = _replace(text, M6_BEYOND, "      if (__all_sync(0xffffffffu, beyond) && (threadIdx.x & 31) == 0)\n"
                    "        atomicAdd(&g_m6_count[6], 1ull);\n" + M6_BEYOND)
    text = _replace(text, M6_WORDS, M6_WORDS + """      {
        unsigned any = 0u, set = 0u;
#pragma unroll
        for (int q = 0; q < kM6Q; ++q) {
          any |= bits[q];
          set += __popc(bits[q]);
        }
        any = __reduce_or_sync(0xffffffffu, any);
        set = __reduce_add_sync(0xffffffffu, set);
        if ((threadIdx.x & 31) == 0) {
          atomicAdd(&g_m6_count[0], 32ull);
          atomicAdd(&g_m6_count[1], static_cast<unsigned long long>(__popc(any)));
          atomicAdd(&g_m6_count[2], static_cast<unsigned long long>(set));
        }
      }
""")
    text = _replace(text, M6_BAND, "          if (!h) atomicAdd(&g_m6_count[3], 1ull);\n" + M6_BAND)
    text = _replace(text, M6_PASS, M6_PASS + "      if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) "
                    "atomicAdd(&g_m6_count[4], 1ull);\n")
    text = _replace(text, M6_SKIP, "    if (__all_sync(0xffffffffu, skip_all)) {\n"
                    "      if ((threadIdx.x & 31) == 0) atomicAdd(&g_m6_count[5], 1ull);\n"
                    "      continue;\n    }\n")
    return text + _counters("m6", 7)


def _m6_config(queries=2, blocks=8):
    """queries a thread; a register cap for `blocks` blocks an SM (None: uncapped)."""
    bound = f", {blocks})" if blocks else ")"
    return _edits((M6_QUERIES, M6_QUERIES.replace("2", str(queries))),
                  (M6_BOUNDS, M6_BOUNDS.replace(", 8)", bound)))


def _m6_then(*edits):
    def edit(text):
        for e in edits:
            text = e(text)
        return text
    return edit


M6_VARIANTS = {
    "uncapped": (_m6_config(blocks=None), True),
    "6 blocks an SM": (_m6_config(blocks=6), True),
    "4 queries a thread, 6 blocks an SM": (_m6_config(queries=4, blocks=6), True),
    "FSETP screen": (_edits(*M6_FSETP_EDITS), True),
    "no word boxes": (_edits((M6_BEYOND, "      if (true) {\n")), True),
    "a walk a query": (_m6_between(M6_HITS_START, M6_HITS_END, M6_PER_QUERY), True),
    "a branch a row": (_m6_between(M6_SCREEN_START, M6_HITS_END, M6_ROW_BRANCH), True),
    "a branch a row, 4 queries a thread, 6 blocks an SM":
        (_m6_then(_m6_between(M6_SCREEN_START, M6_HITS_END, M6_ROW_BRANCH),
                  _m6_config(queries=4, blocks=6)), True),
    "no hits (diagnostic)": (_m6_no_hits, False),
    "no screen, no hits (diagnostic)": (_m6_then(_edits((M6_BEYOND, "      if (false) {\n")), _m6_no_hits),
                                        False),
    "count": (_m6_count, True),
}


def _m6_setup(smoke, dev, libs, k=2):
    """The 1M normals shape (the target index's 8,192 x 128 self-query, the
    registration's radius) at k = 2, or GICP's covariance shape (the
    covariance index, the radius for k = 15) at k = 8."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import _candidate_tiles, build_kd_index, trim_index
    from icpx_torch.kernels.voxel import auto_cell_size

    _, f_tgt, _ = smoke._gt_pair(smoke.N_FLAG, 0, dev)
    if k == 2:
        idx = trim_index(build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128), f_tgt.capacity, multiple=64)
        radius = auto_cell_size(idx.tiles.reshape(-1, 3), idx.order >= 0, scale=3.0)
    else:
        idx = build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128)
        radius = smoke._cov_radius(f_tgt, 15)
    cand, q_cent = _candidate_tiles(idx.tiles, idx, k)
    cand32 = cand.to(torch.int32)
    r2 = (radius * radius).reshape(1).to(torch.float32)
    want = blocknn_cuda.moments6_reference(idx.tiles, idx.tiles, cand, q_cent, r2[0])
    tq, sq, _ = idx.tiles.shape
    s = idx.tile_size
    out = torch.empty((10, tq * sq), device=dev)
    plans = {}
    for name, lib in libs.items():
        if hasattr(lib, "icpx_moments6_shape"):  # the staged kernel: plans from its shape
            shape = blocknn_cuda._read_shape(lib, "icpx_moments6_shape", blocknn_cuda.Moments6Shape)
            plans[name] = blocknn_cuda.moments6_plan(tq, sq, s, k, shape)
            lib.icpx_moments6_forward.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P, I, P]
        else:  # the one-query-a-thread kernel before it
            lib.icpx_moments6_forward.argtypes = [P, P, P, P, P, I, I, I, I, P, I, P]
    print(f"plans: {json.dumps(plans)}")

    def launch(name, lib):
        st = torch.cuda.current_stream().cuda_stream
        args = (idx.tiles.data_ptr(), idx.tiles.data_ptr(), cand32.data_ptr(), q_cent.data_ptr(),
                r2.data_ptr(), tq, sq, s, k)
        if name in plans:
            return lib.icpx_moments6_forward(*args, plans[name]["tiles_per_block"],
                                             plans[name]["lanes_per_stage"], out.data_ptr(), 0, st)
        return lib.icpx_moments6_forward(*args, out.data_ptr(), 0, st)

    def report(counts):
        rows, branch, bits, band, passes, far, boxed = counts
        pairs = tq * sq * k * s
        return (f"k={k}: warp rows screened {rows}, with a bit in some lane {branch} "
                f"({branch / max(rows, 1):.4f}: the row steps a branch a row would take); pairs with "
                f"a bit {bits} ({bits / pairs:.5f} of {pairs}), in the band {band} "
                f"({band / pairs:.3g}); the walk's warp passes {passes} "
                f"({passes / (tq * sq / 128):.1f} a 128-query tile); warp stages skipped as far {far}; "
                f"warp words skipped by their boxes {boxed} ({boxed * 32 / max(rows, 1):.4f} "
                "of the warp rows)",
                {"plans": plans, "rows": rows, "rows_with_a_bit": branch, "bits": bits, "band": band,
                 "walk_passes": passes, "far_warp_stages": far, "boxed_warp_words": boxed,
                 "pairs": pairs})

    def equal():
        return torch.equal(out[0], want[0]) and bool((out[1:4] - want[1:4]).abs().max() <= 1e-5)

    return Case(launch, equal, report)


# ---- moments_fused --------------------------------------------------------------------

MF_TEST = "(s1[0] <= nc[0]) | (s1[1] <= nc[1]) | (s1[2] <= nc[2]) | (s1[3] <= nc[3])"
MF_BOUNDS = "__launch_bounds__(kMFThreads, 3)"
MF_THREADS = "constexpr int kMFThreads = 256;"
MF_UNROLL = "#pragma unroll 4\n      for (int u = 1; u < n_u; ++u) {"
MF_READ_AHEAD = """      float4 r = rl[1];  // prefetched a row ahead
      mf_row<true>(rl[0], ax, ay, az, nc, m, mult0);  // slot 0, weighted
#pragma unroll 4
      for (int u = 1; u < n_u; ++u) {
        const float4 next = rl[u + 1];
        mf_row<false>(r, ax, ay, az, nc, m, 1.f);
        r = next;
      }"""
MF_NO_READ_AHEAD = """      mf_row<true>(rl[0], ax, ay, az, nc, m, mult0);  // slot 0, weighted
#pragma unroll 4
      for (int u = 1; u < n_u; ++u) mf_row<false>(rl[u], ax, ay, az, nc, m, 1.f);"""
MF_FMA_BODY = """    for (int k = 0; k < kMFQ; ++k) {
      const float h = s1[k] <= nc[k] ? (kWeighted ? w : 1.f) : 0.f;
      m[k][0] += h;
#pragma unroll
      for (int i = 0; i < 9; ++i) m[k][i + 1] = fmaf(h, f[i], m[k][i + 1]);
    }"""
MF_BRANCH_BODY = """    for (int k = 0; k < kMFQ; ++k) {
      if (s1[k] <= nc[k]) {
        m[k][0] += kWeighted ? w : 1.f;
#pragma unroll
        for (int i = 0; i < 9; ++i)
          m[k][i + 1] = kWeighted ? fmaf(w, f[i], m[k][i + 1]) : m[k][i + 1] + f[i];
      }
    }"""
# The screen: t = fma(ax, rx, fma(ay, ry, fma(az, rz, rr (1 - 2^-20)))) against
# thr = -c + 2^-20 (|q_c|^2 + r^2) + 2^-126, rounded up. With s1 the rounded
# score, |s1 - E| <= gamma_4 T and |t - E'| <= gamma_3 T (E, E' the exact sums,
# T the sum of the terms' magnitudes <= |q_c|^2 + 2 rr (1 + 3u)), and rr
# lowered by >= 15u rr: s1 <= -c implies t <= thr. A row that passes for one
# of the four queries computes the rounded score and its exact test.
MF_SCREEN_ROW = """template <bool kWeighted>
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


def _mf_screen(text):
    start = text.index("template <bool kWeighted>\n__device__ __forceinline__ void mf_row(")
    end = text.index("__global__ void " + MF_BOUNDS)
    text = text[:start] + MF_SCREEN_ROW + text[end:]
    text = _replace(text, "    nc[k] = in ? -c : -__int_as_float(0x7f800000);",
                    "    const float qq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), "
                    "__fmul_rn(qz, qz));\n"
                    "    nc[k] = in ? __fadd_ru(-c, __fadd_ru(__fmul_ru(__fadd_ru(qq, r2), 0x1p-20f), "
                    "0x1p-126f)) : -__int_as_float(0x7f800000);")
    text = _replace(text, "mf_row<true>(rl[0], ax, ay, az, nc, m, mult0);",
                    "mf_row<true>(rl[0], ax, ay, az, nc, m, mult0, r2);")
    return _replace(text, "mf_row<false>(r, ax, ay, az, nc, m, 1.f);",
                    "mf_row<false>(r, ax, ay, az, nc, m, 1.f, r2);")


def _mf_count(text):
    """Counters: the row steps a warp makes, and those in which it takes
    the hit branch."""
    hook = ("  {\n    const unsigned act = __activemask();\n"
            f"    const bool wany = __any_sync(act, {MF_TEST});\n"
            "    if ((threadIdx.x & 31) == __ffs(act) - 1) {\n"
            "      atomicAdd(&g_mf_count[0], 1ull);\n"
            "      if (wany) atomicAdd(&g_mf_count[1], 1ull);\n    }\n  }\n")
    text = _replace(text, "namespace {\n", "namespace {\n__device__ unsigned long long g_mf_count[2];\n")
    return _replace(text, f"  if ({MF_TEST}) {{", hook + f"  if ({MF_TEST}) {{") + _counters("mf", 2)


MF_VARIANTS = {
    "uncapped": (_edits((MF_BOUNDS, "__launch_bounds__(kMFThreads)")), True),
    "4 blocks an SM": (_edits((MF_BOUNDS, "__launch_bounds__(kMFThreads, 4)")), True),
    "no read-ahead": (_edits((MF_READ_AHEAD, MF_NO_READ_AHEAD)), True),
    "unroll 8": (_edits((MF_UNROLL, MF_UNROLL.replace("4", "8", 1))), True),
    "unroll 2": (_edits((MF_UNROLL, MF_UNROLL.replace("4", "2", 1))), True),
    "__any_sync branch": (_edits((f"  if ({MF_TEST}) {{", f"  if (__any_sync(0xffffffffu, {MF_TEST})) {{")),
                          True),
    "a branch a query": (_edits((MF_FMA_BODY, MF_BRANCH_BODY)), True),
    "128 threads, 5 blocks": (_edits((MF_THREADS, MF_THREADS.replace("256", "128")),
                                     (MF_BOUNDS, "__launch_bounds__(kMFThreads, 5)")), True),
    "128 threads, 6 blocks": (_edits((MF_THREADS, MF_THREADS.replace("256", "128")),
                                     (MF_BOUNDS, "__launch_bounds__(kMFThreads, 6)")), True),
    "512 threads": (_edits((MF_THREADS, MF_THREADS.replace("256", "512")),
                           (MF_BOUNDS, "__launch_bounds__(kMFThreads, 1)")), True),
    "screen": (_mf_screen, True),
    "screen, uncapped": (lambda text: _mf_screen(text).replace(MF_BOUNDS, "__launch_bounds__(kMFThreads)", 1),
                         True),
    "count": (_mf_count, True),
}


def _mf_setup(smoke, dev, libs):
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import _candidate_tiles, build_kd_index

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
    for lib in libs.values():
        lib.icpx_moments_fused_forward.argtypes = [P, P, P, P, P, I, I, I, I, P, I, P]

    def launch(name, lib):
        return lib.icpx_moments_fused_forward(
            idx.tiles.data_ptr(), idx.tiles.data_ptr(), unions.data_ptr(), q_cent.data_ptr(),
            r2.data_ptr(), g, gq, idx.tile_size, u_max, out.data_ptr(), 0,
            torch.cuda.current_stream().cuda_stream)

    def report(counts):
        steps, taken = counts
        hits = float(want[0].sum())
        return (f"warp row steps {steps}, hit branch taken in {taken} ({taken / steps:.4f}); "
                f"pairs inside the radius {hits:.6g} (slot 0 weighted)",
                {"row_steps": steps, "branch_taken": taken, "pairs_inside": hits})

    return Case(launch, lambda: torch.equal(out[0], want[0]), report)


KERNELS = {
    "moments6": Kernel("moments6_kernel", M6_VARIANTS, 7, "m6_counts", _m6_setup),
    "moments6_k8": Kernel("moments6_kernel", M6_VARIANTS, 7, "m6_counts",
                          lambda smoke, dev, libs: _m6_setup(smoke, dev, libs, k=8)),
    "fold6": Kernel("fold6_kernel", F6_VARIANTS, 4, "f6_counts", _f6_setup),
    "fold7": Kernel("fold7_kernel", F7_VARIANTS, 2, "f7_counts", _f7_setup),
    "moments_fused": Kernel("moments_fused_kernel", MF_VARIANTS, 2, "mf_counts", _mf_setup),
}


def _build(texts, symbol):
    """Every text with nvcc, in parallel, into a temporary directory:
    (libraries, ptxas reports of `symbol`), by name."""
    from icpx_torch.kernels import cuda_build

    tmp = tempfile.mkdtemp(prefix="variants_")
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        path = os.path.join(tmp, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (path[:-3] + ".so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        report = re.search(symbol + r"[^\n]*\n([^\n]*stack frame[^\n]*)\n([^\n]*registers[^\n]*)", log)
        ptxas[name] = " ".join(x.strip() for x in report.groups())
        print(f"{name}: {ptxas[name]}")
        libs[name] = ctypes.CDLL(so)
    return libs, ptxas


def main(kernel, parent, reps, out_path):
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from icpx_torch.kernels import cuda_build

    spec = KERNELS[kernel]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    src = cuda_build.source_path("blocknn").read_text()
    variants = {"committed": (_edits(), True), **spec.variants}
    texts = {name: edit(src) for name, (edit, _) in variants.items()}
    held = {name: h for name, (_, h) in variants.items()}
    if parent:
        with open(os.path.join(parent, "icpx_torch", "csrc", "blocknn.cu")) as f:
            texts = {"parent": f.read(), **texts}
        held["parent"] = True
    libs, ptxas = _build(texts, spec.symbol)
    case = spec.setup(smoke, torch.device("cuda", 0), libs)

    def launch(name):
        rc = case.launch(name, libs[name])
        if rc:
            raise SystemExit(f"{name}: launch failed: CUDA error {rc}")

    readings = {name: [] for name in libs}
    names = list(libs)
    for rep in range(reps):
        for name in names if rep % 2 == 0 else names[::-1]:
            launch(name)
            torch.cuda.synchronize()
            if held[name] and not case.equal():
                raise SystemExit(f"{name}: the outputs differ from the plain version's")
            device_ms = smoke._graph_ms(lambda: launch(name))
            event_ms = smoke._event_ms(lambda: launch(name))
            readings[name].append((device_ms, event_ms))
            print(f"{name}: {'equal to the plain version, ' if held[name] else ''}device "
                  f"{device_ms:.4f} ms, event {event_ms:.4f} ms", flush=True)
    read = getattr(libs["count"], spec.counts_entry)
    read.argtypes = [ctypes.c_void_p]
    before, after = (ctypes.c_ulonglong * spec.n_counts)(), (ctypes.c_ulonglong * spec.n_counts)()
    read(ctypes.addressof(before))
    launch("count")
    torch.cuda.synchronize()
    read(ctypes.addressof(after))
    line, fields = case.report([after[j] - before[j] for j in range(spec.n_counts)])
    print(line)
    result = json.dumps({"kernel": kernel, "card": card, "ptxas": ptxas, "readings": readings, **fields})
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(result + "\n")
    print(result)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--parent", help="a checkout whose csrc/blocknn.cu to time beside the variants")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    main(args.kernel, args.parent, args.reps, args.out)
