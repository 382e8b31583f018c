#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`icpx_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's six CUDA kernels from the sources in this checkout
(one `nvcc` per source, started together), holds each against its plain
PyTorch version at the shapes the main path gives it, then drives the
main paths through `register()` and checks each result against its ground
truth:

* the brute-force path: the cat fixture pair and a 65,536-point synthetic
  pair (normals on the card);
* the block path: `bench.py`'s 1,048,576-point flagship pair with normals
  estimated inside the registration, under each way the block path
  delivers correspondences: the fold6 kernel ("auto"), the plain torch
  path ("gather"), the fold7 kernel (payload_mode "vmem7"), the plain fold
  with the select kernel ("select"), the plain in-fold selection
  ("infold") and the fused4 kernel (block_fused "on"); and a 16,384-point
  pair on the card against the same pair on the CPU under "vmem",
  "vmem7", "select" and block_fused "on".

Launch counters are set to 0 just before each path and read just after.
Every phase prints one line (or a few); any failure raises, so the exit
code is non-zero. The last two lines are a JSON object per kernel and the
verdict ``{"ok": true, "device": {...}}``. Without a CUDA device it refuses
to run.

    python3 chip_smoke.py --profile [--n 1048576]

runs none of that: it profiles one flagship registration under each of
those block paths (`torch.profiler`) and prints where the device time goes.
"""

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_PAIR = 65536  # one rotating-LiDAR sweep; the round-1 `bench.py --n 65536` point
N_FLAG = 1048576  # bench.py's flagship pair
N_SMALL = 16384  # the block pair run on the card and on the CPU

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit): the
# bound of a kernel is the larger of its bytes over the memory rate and its
# fp32 operations (an FMA counts 2) over the non-tensor-core fp32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def _fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def _sync_time(fn, reps: int, warmup: int = 1):
    """Host wall seconds per call, torch.cuda.synchronize() fences, median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def _event_ms(fn, reps: int = 5) -> float:
    """Device milliseconds per call from CUDA events: warm, median of reps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(bytes_moved: float, flops: float):
    """(bound ms, "bytes" or "operations")."""
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def _max_err(a, b) -> float:
    """max |a - b| over the rows where b is finite (0 where there are none)."""
    fin = torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def _transform_diff(a, b):
    """(rotation angle, translation distance) between two nearby transforms,
    in float64 on the host. The angle comes from the skew part of Ra^T Rb
    (its norm is sin(angle)): the trace form arccos((tr - 1) / 2) cannot
    resolve angles below ~5e-4 rad, because an fp32 rotation matrix is
    orthonormal only to ~1e-7."""
    Ra, Rb = a.R.detach().cpu().double(), b.R.detach().cpu().double()
    M = Ra.T @ Rb
    w = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2.0
    t = a.t.detach().cpu().double() - b.t.detach().cpu().double()
    return float(torch.arcsin(torch.clamp(w.norm(), max=1.0))), float(t.norm())


def _duplicate_fixture():
    """Integer coordinates with exact duplicates: the nearest copy with the
    lowest index must win (distances are exact in fp32)."""
    base = np.array([[0, 0, 0], [3, 1, 2], [-2, 4, 1], [5, -3, 0]], np.float32)
    ref = np.concatenate([base[[1, 2]], base, base[[0, 1]], base], axis=0)
    query = np.concatenate([base, base + np.float32([0, 0, 1])], axis=0)
    expect = ((query[:, None, :] - ref[None]) ** 2).sum(-1).argmin(1)
    return query, ref, np.ones(len(ref), bool), expect


def _gt_pair(n, seed, dev, angle=0.2, translation=(0.12, -0.06, 0.03)):
    """bench.py's construction: a synthetic surface, its rigid image under
    the GT, shuffled with default_rng(1)."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.geometry.transforms import make_rigid_perturbation
    from icpx_torch.io.loaders import synthetic_surface

    src = PointCloud.create(synthetic_surface(n, seed=seed), capacity=n, device=dev)
    gt = make_rigid_perturbation(angle=angle, translation=translation, device=dev)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(n), device=dev)
    tgt = PointCloud.create(gt.apply(src.xyz)[perm], capacity=n, device=dev)
    return src, tgt.replace(mask=src.mask[perm]), gt


def _flag_configs():
    """bench.py's flagship config, through the kernels ("auto" resolves to
    them on a CUDA device), on the plain torch path, and under the block
    path's other ways of delivering correspondences (normals through the
    moments kernel in each)."""
    from icpx_torch.registration.icp import ICPConfig

    cfg = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=0.0,
                    rmse_change_tol=1e-6, k_normals=10, tile_q=2048, tile_r=8192)
    return {"kernels": cfg,
            "plain": dataclasses.replace(cfg, payload_mode="gather", moments_mode="xla"),
            "vmem7": dataclasses.replace(cfg, payload_mode="vmem7"),
            "select": dataclasses.replace(cfg, payload_mode="select"),
            "infold": dataclasses.replace(cfg, payload_mode="infold"),
            "fused": dataclasses.replace(cfg, block_fused="on")}


# What each flagship path must launch: {kernel: "refine" (once a refine
# iteration), "all" (once an iteration of both phases), "some" (at least
# twice: the normals of both clouds)}; every kernel not named stays at 0.
_FLAG_LAUNCHES = {
    "kernels": {"moments6": "some", "fold6": "refine"},
    "plain": {},
    "vmem7": {"moments6": "some", "fold7": "refine"},
    "select": {"moments6": "some", "select": "refine"},
    "infold": {"moments6": "some"},
    "fused": {"moments6": "some", "fused4": "all"},
}
# The flagship path whose launches the kernels line reports for each kernel.
_LAUNCHES_FROM = {"moments6": "kernels", "fold6": "kernels", "fold7": "vmem7",
                  "select": "select", "fused4": "fused"}


def _block_fixtures(dev):
    """Small inputs for the block kernels: two query tiles over 4 index
    tiles of 8 rows, integer coordinates (exact d2) with exact duplicates
    (fold tie rule: least d2, lowest lane, earliest candidate), a fifth,
    all-sentinel tile (a query tile whose candidates are all sentinel; its
    candidate list [4, 4, 4, 4] names that tile four times, which select
    sums four times), and padded query rows."""
    from icpx_torch.cloud import PAD_COORD
    from icpx_torch.kernels.blocknn import TileIndex

    tiles = np.arange(5 * 8 * 3, dtype=np.float32).reshape(5, 8, 3) * 10.0 + 100.0
    p, p2 = np.float32([1, 2, 3]), np.float32([-4, 5, -6])
    tiles[0, 3] = tiles[1, 1] = p
    tiles[2, 2] = tiles[3, 2] = p2
    tiles[4] = PAD_COORD
    query = np.full((2, 8, 3), 50.0, np.float32)
    query[0, 0], query[0, 1] = p, p2
    query[:, 6:] = PAD_COORD  # padded query rows
    t = torch.as_tensor(tiles, device=dev)
    order = torch.arange(40, dtype=torch.int32, device=dev)
    order[32:] = -1
    index = TileIndex(tiles=t, box_lo=t.amin(1), box_hi=t.amax(1), centroids=t.mean(1), order=order)
    cand = torch.tensor([[0, 1, 2, 3], [4, 4, 4, 4]], device=dev)
    payload = torch.arange(40, dtype=torch.float32, device=dev)[:, None].repeat(1, 6)
    payload[32:, 3:] = 0.0
    return torch.as_tensor(query, device=dev), index, cand, payload


def _phase_nn(dev, n_pair, rng):
    """Kernel #1 against its plain version; returns its JSON fields."""
    from icpx_torch.cloud import PAD_COORD
    from icpx_torch.kernels import nn_cuda
    from icpx_torch.kernels.knn import knn, nearest_neighbor_reference

    # d2: rtol 1e-5 plus atol 1e-6 |q|^2 per row (same formula, fp32 rounding
    # and FMA contraction only); indices equal wherever the best and second
    # best distances differ by more than 1e-4 relative.
    def uniform(n):
        return rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)

    def padded(n_real, cap):
        x = np.full((cap, 3), PAD_COORD, np.float32)
        x[:n_real] = uniform(n_real)
        return x, np.arange(cap) < n_real

    q_cat, m_cat = padded(3400, 3456)
    r_cat, _ = padded(3400, 3456)
    half = rng.uniform(size=70001) < 0.5
    big = f"{n_pair}x{n_pair}"
    cases = {
        big: (uniform(n_pair), uniform(n_pair), np.ones(n_pair, bool), None),
        "3456x3456 (56 masked)": (q_cat, r_cat, m_cat, None),
        "1000x70001 (half masked)": (uniform(1000), uniform(70001), half, None),
        "duplicates": _duplicate_fixture(),
    }
    max_abs_err = 0.0
    fields = {}
    for name, (q, r, m, expect) in cases.items():
        qc, rc, mc = (torch.as_tensor(x, device=dev) for x in (q, r, m))
        d_k, i_k = nn_cuda.nn_cuda(qc, rc, mc)
        d_p, i_p = nearest_neighbor_reference(qc, rc, ref_mask=mc)
        torch.cuda.synchronize()
        qq = (qc.double() ** 2).sum(1)
        fin = torch.isfinite(d_p)
        if not torch.equal(fin, torch.isfinite(d_k)):
            _fail(f"{name}: kernel and plain disagree on which rows have a neighbour")
        err = (d_k.double() - d_p.double()).abs()
        tol = 1e-5 * d_p.double().abs() + 1e-6 * qq
        if bool((err[fin] > tol[fin]).any()):
            _fail(f"{name}: d2 off by up to {float(err[fin].max()):.3e}")
        real = fin & (qq < 1e6)  # rows of real points (sentinel rows excluded)
        if bool(real.any()):
            max_abs_err = max(max_abs_err, float(err[real].max()))
        if expect is not None:
            if not np.array_equal(i_k.cpu().numpy(), expect):
                _fail(f"{name}: tie rule broken (lowest index must win)")
            sep = torch.ones_like(fin)
        else:
            d2, _ = knn(qc, rc, 2, ref_mask=mc)
            sep = (d2[:, 1] - d2[:, 0]) > 1e-4 * d2[:, 1]
        mism = int(((i_k != i_p) & sep & fin).sum())
        if mism:
            _fail(f"{name}: {mism} indices differ on well-separated rows")
        line = (f"nn kernel vs plain {name}: max|dd2|={float(err[fin].max()) if bool(fin.any()) else 0.0:.3e}, "
                f"index checked on {int((sep & fin).sum())}/{len(q)} rows")
        if name == big:
            ms = _event_ms(lambda: nn_cuda.nn_cuda(qc, rc, mc))
            plain_ms = _event_ms(lambda: nearest_neighbor_reference(qc, rc, ref_mask=mc))

            def library():  # one PyTorch call for the same function, chunked over queries
                for q0 in range(0, len(q), 4096):
                    torch.cdist(qc[q0:q0 + 4096], rc,
                                compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)

            library_ms = _event_ms(library)
            nq, nr = len(q), len(r)
            bound_ms, bound_by = _bound((nq + nr) * 12 + nr + nq * 8, nq * nr * 8.0)
            fields = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.cdist+min "
                     f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
                     "(CUDA events, median of 5)")
        print(line)
        del qc, rc, mc, d_k, d_p
    return dict(fields, max_abs_err=max_abs_err)


def _phase_moments6(dev, index, radius, fixtures):
    """Kernel #2 against its plain version at the shapes of one flagship
    normals launch (the target index's 8,192 x 128 self-query, k_tiles = 2),
    plus the fixtures; returns its JSON fields."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import _candidate_tiles

    def compare(name, query, tiles, cand, q_cent, r2):
        out_k = blocknn_cuda.moments6_cuda(query, tiles, cand.to(torch.int32), q_cent, r2.reshape(1))
        out_p = blocknn_cuda.moments6_reference(query, tiles, cand, q_cent, r2)
        torch.cuda.synchronize()
        # the same d2 bits decide the radius test: counts equal on every
        # row; means and covariances differ only by the order of the sums
        if not torch.equal(out_k[0], out_p[0]):
            _fail(f"moments6 {name}: counts differ on {int((out_k[0] != out_p[0]).sum())} rows")
        if not bool(torch.isfinite(out_k).all()):
            _fail(f"moments6 {name}: moments not finite")
        mean_err = float((out_k[1:4] - out_p[1:4]).abs().max())
        if mean_err > 1e-5:
            _fail(f"moments6 {name}: means off by {mean_err:.3e}")
        # The covariances are ~r^2/4 in the plane and far less along the
        # normal, below any fixed atol, so each row is held to 1e-4 of its
        # trace, plus 1e-5 of |mean - q_cent|^2 for the fp32 cancellation in
        # E[rr^T] - m m^T, which grows with the mean's offset from the
        # centring point. A zero or swapped component fails this.
        q_rows = q_cent.repeat_interleave(query.shape[1], 0).T
        tol = 1e-4 * (out_p[4] + out_p[7] + out_p[9]) + 1e-5 * ((out_p[1:4] - q_rows) ** 2).sum(0)
        cov_err = (out_k[4:] - out_p[4:]).abs()
        over = float(torch.where(cov_err == 0, 0.0, cov_err / tol).max())
        if over > 1.0:
            _fail(f"moments6 {name}: a covariance is off by {over:.3g} x its tolerance")
        return out_k, mean_err, float(cov_err.max()), over

    cand, q_cent = _candidate_tiles(index.tiles, index, 2)
    r2 = (radius * radius).reshape(())
    args = (index.tiles, index.tiles, cand, q_cent, r2)
    out, mean_err, cov_err, over = compare(f"{tuple(index.tiles.shape)} k=2", *args)
    query, fx_index, fx_cand, _ = fixtures
    _, fq_cent = _candidate_tiles(query, fx_index, 4)
    fx, *fx_errs = compare("fixtures", query, fx_index.tiles, fx_cand, fq_cent,
                           torch.tensor(4.0, device=dev))
    mean_err, cov_err, over = (max(a, b) for a, b in zip((mean_err, cov_err, over), fx_errs))
    if float(fx[0, 8:].max()) != 0.0 or float(fx[0, 6:8].max()) != 0.0:
        _fail("moments6 fixtures: sentinel rows or padded query rows were counted")
    ms = _event_ms(lambda: blocknn_cuda.moments6_cuda(*args[:2], cand.to(torch.int32), q_cent, r2.reshape(1)))
    plain_ms = _event_ms(lambda: blocknn_cuda.moments6_reference(*args))
    tq, sq, _ = index.tiles.shape
    n = tq * sq
    pairs = n * cand.shape[1] * index.tile_size
    inside = float(out[0].sum())  # pairs within the radius: 16 more flops each
    bytes_moved = n * 12 + index.tiles.numel() * 4 + cand.numel() * 4 + tq * 12 + 4 + n * 40
    bound_ms, bound_by = _bound(bytes_moved, pairs * 8.0 + inside * 16.0)
    print(f"moments6 kernel vs plain {tuple(index.tiles.shape)} k=2: counts equal on all "
          f"{n} rows (mean {float(out[0].mean()):.2f}), means within {mean_err:.3e}, "
          f"covariances within {cov_err:.3e} = {over:.3g} x their tolerance "
          f"(median trace {float((out[4] + out[7] + out[9]).median()):.3e}); fixtures ok; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
          "(CUDA events, median of 5)")
    return dict(max_abs_err=max(mean_err, cov_err), cov_max_abs_err=cov_err, cov_err_over_tol=over,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _refine_operands(src, tgt_index, gt):
    """The operands of one flagship refine iteration: the source's 16,384 x
    64 query tiles at the GT pose, their k = 6 candidate tiles and the
    query-tile centroids."""
    from icpx_torch.kernels.blocknn import _candidate_tiles, build_kd_index, trim_index

    src_idx = trim_index(build_kd_index(src.xyz, src.mask, tile_size=64), src.capacity, multiple=4)
    query = gt.apply(src_idx.tiles.reshape(-1, 3)).reshape(src_idx.tiles.shape).contiguous()
    cand, q_cent = _candidate_tiles(query, tgt_index, 6)
    return query, cand, q_cent


def _phase_fold6(dev, query, cand, tgt_index, table, fixtures):
    """Kernel #3 against its plain version at the shapes of one flagship
    refine iteration (16,384 x 64 queries, k = 6 frozen candidates, the
    fused (T*S, 6) table), plus the fixtures; returns its JSON fields."""
    from icpx_torch.kernels import blocknn_cuda

    def compare(name, query, ops):
        d_k, pl_k = blocknn_cuda.fold6_cuda(query, ops)
        d_p, pl_p = blocknn_cuda.fold6_reference(query, ops)
        torch.cuda.synchronize()
        # the same d2 bits and scan order: the same winner on every row
        if not (torch.equal(d_k, d_p) and torch.equal(pl_k, pl_p)):
            _fail(f"fold6 {name}: kernel and plain differ on "
                  f"{int(((d_k != d_p) | (pl_k != pl_p).any(1)).sum())} rows")
        return d_k, pl_k, _max_err(d_k, d_p)

    ops = blocknn_cuda.fold6_prepare(cand, tgt_index, table)
    d, _, err = compare(f"{tuple(query.shape)} k=6", query, ops)
    fq, f_index, f_cand, f_payload = fixtures
    f_ops = blocknn_cuda.fold6_prepare(f_cand, f_index, f_payload)
    fd, fpl, fx_err = compare("fixtures", fq, f_ops)
    if [float(fpl[0, 0]), float(fpl[1, 0])] != [9.0, 18.0] or float(fd[0]) != 0.0:
        _fail("fold6 fixtures: tie rule broken (least d2, lowest lane, earliest candidate)")
    if not (bool(torch.isinf(fd[8:14]).all()) and float(fpl[8, 0]) == 32.0):
        _fail("fold6 fixtures: a tile of all-sentinel candidates must miss onto its first sentinel row")
    ms = _event_ms(lambda: blocknn_cuda.fold6_cuda(query, ops))
    plain_ms = _event_ms(lambda: blocknn_cuda.fold6_reference(query, ops))
    tq, sq, _ = query.shape
    n, k = tq * sq, cand.shape[1]
    bytes_moved = n * 12 + tgt_index.tiles.numel() * 4 + tq * k * 4 + table.numel() * 4 + n * 28
    bound_ms, bound_by = _bound(bytes_moved, n * k * tgt_index.tile_size * 8.0)
    print(f"fold6 kernel vs plain {tuple(query.shape)} k=6: d2 and payload equal on all {n} rows "
          f"({int(torch.isfinite(d).sum())} hits); fixtures ok (ties, misses, padded rows); "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
          "(CUDA events, median of 5)")
    return dict(max_abs_err=max(err, fx_err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _phase_fold7(dev, query, cand, q_cent, tgt_index, table, fixtures):
    """Kernel #4 against its plain version at the flagship's refine shapes
    (operands centred on the query tiles' own centroids, as the frozen
    phase gives them), plus the fixtures; returns its JSON fields."""
    from icpx_torch.kernels import blocknn_cuda

    def compare(name, query, ops):
        d_k, pl_k = blocknn_cuda.fold7_cuda(query, ops)
        d_p, pl_p = blocknn_cuda.fold7_reference(query, ops)
        torch.cuda.synchronize()
        # the same bf16 operands, product order and scan order: bit equality
        if not (torch.equal(d_k, d_p) and torch.equal(pl_k, pl_p)):
            _fail(f"fold7 {name}: kernel and plain differ on "
                  f"{int(((d_k != d_p) | (pl_k != pl_p).any(1)).sum())} rows")
        return d_k, pl_k, _max_err(d_k, d_p)

    ops = blocknn_cuda.fold7_prepare(cand, q_cent, tgt_index, table)
    d, _, err = compare(f"{tuple(query.shape)} k=6", query, ops)
    fq, f_index, f_cand, f_payload = fixtures
    f_ops = blocknn_cuda.fold7_prepare(f_cand, torch.zeros((2, 3), device=dev), f_index, f_payload)
    fd, fpl, fx_err = compare("fixtures", fq, f_ops)
    if [float(fpl[0, 0]), float(fpl[1, 0])] != [9.0, 18.0] or float(fd[0]) != 0.0:
        _fail("fold7 fixtures: tie rule broken (least score, lowest lane, earliest candidate)")
    if not (bool(torch.isinf(fd[8:14]).all()) and float(fpl[8, 0]) == 32.0):
        _fail("fold7 fixtures: a tile of all-sentinel candidates must miss onto its first sentinel row")
    ms = _event_ms(lambda: blocknn_cuda.fold7_cuda(query, ops))
    plain_ms = _event_ms(lambda: blocknn_cuda.fold7_reference(query, ops))
    tq, sq, _ = query.shape
    n, k = tq * sq, cand.shape[1]
    s = tgt_index.tile_size
    bytes_moved = n * 12 + ops.b.numel() * 2 + tq * k * 4 + tq * 12 + table.numel() * 4 + n * 28
    # a pair: 3 FMUL + 3 FADD (the fourth product is 1 x B3)
    bound_ms, bound_by = _bound(bytes_moved, n * k * s * 6.0)
    print(f"fold7 kernel vs plain {tuple(query.shape)} k=6: d2 and payload equal on all {n} rows "
          f"({int(torch.isfinite(d).sum())} hits); fixtures ok (ties, misses, padded rows); "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
          "(CUDA events, median of 5)")
    return dict(max_abs_err=max(err, fx_err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _phase_select(dev, query, cand, tgt_index, table, fixtures):
    """Kernel #5 against its plain version and against the row gather
    `table[pos]` (one PyTorch call for the same function on hits, the
    library yardstick) at the flagship's refine shapes, with the positions
    the plain frozen-candidate fold gives, plus the fixtures (a candidate
    tile listed four times quadruples its row)."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import block_nn

    tq, sq, _ = query.shape
    _, pos = block_nn(query, tgt_index, return_pos=True, cand_tiles=cand)
    pos = pos.reshape(tq, sq)
    cand32 = cand.to(torch.int32)
    s = tgt_index.tile_size
    out_k = blocknn_cuda.select_cuda(pos, cand32, table, s)
    out_p = blocknn_cuda.select_reference(pos, cand, table, s)
    gathered = table[pos.reshape(-1).long()]
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_p) and torch.equal(out_k, gathered)):
        _fail("select: kernel, plain version and row gather differ on "
              f"{int(((out_k != out_p) | (out_k != gathered)).any(1).sum())} rows")
    fq, f_index, f_cand, f_payload = fixtures
    f_pos = torch.tensor([[9, 3, 17, 30, 0, 0, 0, 0], [32, 33, 39, 9, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    fx_k = blocknn_cuda.select_cuda(f_pos, f_cand.to(torch.int32), f_payload, 8)
    fx_p = blocknn_cuda.select_reference(f_pos, f_cand, f_payload, 8)
    want = f_payload[f_pos.reshape(-1).long()] * torch.tensor(
        [1, 1, 1, 1, 1, 1, 1, 1, 4, 4, 4, 0, 0, 0, 0, 0], dtype=torch.float32, device=dev)[:, None]
    if not (torch.equal(fx_k, fx_p) and torch.equal(fx_k, want)):
        _fail("select fixtures: hits, misses or a quadrupled candidate tile came out wrong")
    err = max(_max_err(out_k, out_p), _max_err(fx_k, fx_p))
    ms = _event_ms(lambda: blocknn_cuda.select_cuda(pos, cand32, table, s))
    plain_ms = _event_ms(lambda: blocknn_cuda.select_reference(pos, cand, table, s))
    flat = pos.reshape(-1).long()
    library_ms = _event_ms(lambda: table[flat])
    n, k = tq * sq, cand.shape[1]
    bytes_moved = n * 4 + tq * k * 4 + table.numel() * 4 + n * table.shape[1] * 4
    bound_ms, bound_by = _bound(bytes_moved, float(n * k))  # one compare a candidate slot
    print(f"select kernel vs plain {tuple(pos.shape)} k=6: payload equal on all {n} rows and "
          f"equal to table[pos]; fixtures ok (misses, a tile listed 4 times); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, table[pos] {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}) (CUDA events, median of 5)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def _phase_fused4(dev, query, tgt_index, fixtures, group=4, u_max=32):
    """Kernel #6 against its plain version at the flagship's refine shapes
    (groups of 4 query tiles, k = 6, unions of up to 32 tiles), plus the
    fixtures; returns its JSON fields with the union sizes."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import _candidate_tiles

    def compare(name, query, tiles, unions, group):
        d_k, pos_k = blocknn_cuda.fused4_cuda(query, tiles, unions.to(torch.int32), group)
        d_p, pos_p = blocknn_cuda.fused4_reference(query, tiles, unions, group)
        torch.cuda.synchronize()
        if not (torch.equal(d_k, d_p) and torch.equal(pos_k, pos_p)):
            _fail(f"fused4 {name}: kernel and plain differ on "
                  f"{int(((d_k != d_p) | (pos_k != pos_p)).sum())} rows")
        return d_k, pos_k, _max_err(d_k, d_p)

    cand, _ = _candidate_tiles(query, tgt_index, 6)
    unions = blocknn_cuda.group_unions(cand, group, u_max)
    d, _, err = compare(f"{tuple(query.shape)} k=6", query, tgt_index.tiles, unions, group)
    # slots in use: padding repeats slot 0's id
    sizes = ((unions[:, 1:] != unions[:, :1]).sum(1) + 1).to(torch.float32)
    fq, f_index, f_cand, _ = fixtures
    f_unions = blocknn_cuda.group_unions(f_cand, 1, 8)  # [0, 1, 2, 3, 0, ...], [4, 4, ...]
    fd, fpos, fx_err = compare("fixtures", fq, f_index.tiles, f_unions, 1)
    if [int(fpos[0]), int(fpos[1])] != [9, 18] or float(fd[0]) != 0.0:
        _fail("fused4 fixtures: tie rule broken (earliest slot in a lane, then the largest u*S + lane)")
    if not (bool(torch.isinf(fd[8:14]).all()) and bool((fpos[8:] == 39).all())):
        _fail("fused4 fixtures: a union of one all-sentinel tile must miss onto its last lane")
    # p again at lane 1 of tile 0: lane 1 keeps slot 0 (key 1), lane 3 has key 3;
    # the largest key wins (fold6's lowest lane would give 1, a flat argmax 9)
    tiles2 = f_index.tiles.clone()
    tiles2[0, 1] = tiles2[0, 3]
    _, fpos2, _ = compare("fixtures, one lane tied twice", fq, tiles2, f_unions, 1)
    if int(fpos2[0]) != 3:
        _fail(f"fused4 fixtures: lane tie rule broken (got {int(fpos2[0])}, want 3)")
    unions32 = unions.to(torch.int32)
    ms = _event_ms(lambda: blocknn_cuda.fused4_cuda(query, tgt_index.tiles, unions32, group))
    plain_ms = _event_ms(lambda: blocknn_cuda.fused4_reference(query, tgt_index.tiles, unions, group))
    tq, sq, _ = query.shape
    n, s = tq * sq, tgt_index.tile_size
    pairs = float(sizes.sum()) * s * group * sq  # the union slots in use, as scored
    bytes_moved = n * 12 + tgt_index.tiles.numel() * 4 + unions.numel() * 4 + n * 8
    # a pair: 4 FMUL (the x2 included) + 2 FADD + 1 FSUB
    bound_ms, bound_by = _bound(bytes_moved, pairs * 7.0)
    print(f"fused4 kernel vs plain {tuple(query.shape)} k=6 group={group}: d2 and pos equal on "
          f"all {n} rows ({int(torch.isfinite(d).sum())} hits); unions of {float(sizes.mean()):.2f} "
          f"tiles on average, {int(sizes.max())} at most (of {u_max}); fixtures ok (ties, "
          f"padded union, misses); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}) (CUDA events, median of 5)")
    return dict(max_abs_err=max(err, fx_err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, union_mean=float(sizes.mean()), union_max=int(sizes.max()))


def _counted(fn):
    """Run fn with every launch counter at 0; (result, {kernel: launches})."""
    from icpx_torch.kernels import blocknn_cuda, nn_cuda

    nn_cuda.LAUNCHES = 0
    for name in blocknn_cuda.LAUNCHES:
        blocknn_cuda.LAUNCHES[name] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(nn=nn_cuda.LAUNCHES, **blocknn_cuda.LAUNCHES)


def _refine_iters(res) -> int:
    return int(torch.isfinite(res.rmse_history).sum())


def main(dev=None, n_pair: int = N_PAIR, n_flag: int = N_FLAG, n_small: int = N_SMALL) -> None:
    """`dev` and the sizes exist for rehearsing the script's control flow off
    the card; run as a program it always takes the first CUDA device."""
    if dev is None:
        if not torch.cuda.is_available():
            _fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
        dev = torch.device("cuda", 0)

    import icpx_torch  # noqa: F401  (sets the fp32 matmul policy)
    from icpx_torch.cloud import PointCloud
    from icpx_torch.geometry.transforms import make_rigid_perturbation
    from icpx_torch.io.loaders import load_cat_pair
    from icpx_torch.kernels import blocknn_cuda, cuda_build, nn_cuda
    from icpx_torch.kernels.blocknn import build_kd_index, fused_payload_table, trim_index
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.kernels.voxel import auto_cell_size
    from icpx_torch.registration.icp import ICPConfig, register

    # 1. Device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible")
    print(smi)

    # 2. Build: one nvcc per source, started together ------------------------------
    t0 = time.perf_counter()
    cuda_build.compile_all()
    nn_cuda.build()
    blocknn_cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{nn_cuda.library_path().name}, {blocknn_cuda.library_path().name}")
    for stem, log in cuda_build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                print(f"  ptxas {stem}: {line.strip()}")

    # 3. Kernels against their plain versions -----------------------------------
    rng = np.random.default_rng(0)
    kernels = {"nn": _phase_nn(dev, n_pair, rng)}
    f_src, f_tgt, f_gt = _gt_pair(n_flag, 0, dev)
    tgt_index = trim_index(build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128),
                           f_tgt.capacity, multiple=64)
    flat = tgt_index.tiles.reshape(-1, 3)
    radius = auto_cell_size(flat, tgt_index.order >= 0, scale=3.0)
    fixtures = _block_fixtures(dev)
    kernels["moments6"] = _phase_moments6(dev, tgt_index, radius, fixtures)
    aux = torch.as_tensor(np.random.default_rng(2).normal(size=(n_flag, 3)).astype(np.float32),
                          device=dev)
    table = fused_payload_table(tgt_index, aux)
    query, cand, q_cent = _refine_operands(f_src, tgt_index, f_gt)
    kernels["fold6"] = _phase_fold6(dev, query, cand, tgt_index, table, fixtures)
    kernels["fold7"] = _phase_fold7(dev, query, cand, q_cent, tgt_index, table, fixtures)
    kernels["select"] = _phase_select(dev, query, cand, tgt_index, table, fixtures)
    kernels["fused4"] = _phase_fused4(dev, query, tgt_index, fixtures)
    del tgt_index, flat, table, aux, query, cand, q_cent

    cfg_cat = ICPConfig(objective="symmetric", max_iters=20, diff_threshold=1.0,
                        max_corr_dist=50.0, robust="huber")
    cfg_pair = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=0.0,
                         rmse_change_tol=1e-6, k_normals=10, nn_method="brute",
                         tile_q=2048, tile_r=8192)
    flag_cfgs = _flag_configs()

    # 4. Cat pair (brute path) --------------------------------------------------------
    src, tgt = load_cat_pair(device=dev)
    tgt_np = tgt.to_numpy()
    tgt_sh = PointCloud.create(tgt_np[np.random.default_rng(0).permutation(len(tgt_np))],
                               device=dev)
    gt_cat = make_rigid_perturbation(device=dev)
    res, counts = _counted(lambda: register(src, tgt_sh, cfg_cat))
    cat_launches = counts["nn"]
    rot, terr = (float(x) for x in res.transform.distance_to(gt_cat))
    pred = res.transform.apply(src.xyz)[src.mask].cpu().numpy()
    true_rmse = float(np.sqrt(((pred - tgt_np) ** 2).sum(1).mean()))
    if not (rot < 5e-3 and terr < 0.5 and true_rmse < 0.5):
        _fail(f"cat: GT not recovered (rot {rot:.3e}, t {terr:.3e}, rmse {true_rmse:.3e})")
    if res.iters < 1 or cat_launches < res.iters:
        _fail(f"cat: {cat_launches} kernel launches for {res.iters} iterations")
    # the same registration on the CPU (plain NN): the reference on a small input
    res_cpu = register(src.to("cpu"), tgt_sh.to("cpu"), cfg_cat)
    d_rot, d_t = _transform_diff(res.transform, res_cpu.transform)
    if res_cpu.iters != res.iters or d_rot > 1e-4 or d_t > 1e-3:
        _fail(f"cat: card and CPU runs differ (iters {res.iters} vs {res_cpu.iters}, "
              f"rot {d_rot:.2e}, t {d_t:.2e})")
    wall_cat, _ = _sync_time(lambda: register(src, tgt_sh, cfg_cat), reps=3)
    print(f"cat: iters={res.iters} converged={bool(res.converged)} "
          f"rmse={float(res.final_rmse):.3e} rot_err={rot:.3e} t_err={terr:.3e} "
          f"launches={cat_launches}; matches CPU run (drot {d_rot:.1e}, dt {d_t:.1e}); "
          f"wall {wall_cat * 1e3:.2f} ms (median of 3)")

    # 5. 65,536-point pair (bench.py's brute configuration) ----------------------
    src, tgt, gt = _gt_pair(n_pair, 0, dev)

    def run_pair():
        # normals up front with the brute method (auto would pick the block
        # radius path at this size); register() then finds them present
        s = estimate_normals(src, k=cfg_pair.k_normals, method="brute")
        t = estimate_normals(tgt, k=cfg_pair.k_normals, method="brute")
        return register(s, t, cfg_pair)

    res, counts = _counted(run_pair)
    pair_launches = counts["nn"]
    kernels["nn"]["launches"] = cat_launches + pair_launches
    rot, terr = (float(x) for x in res.transform.distance_to(gt))
    if not (math.isfinite(float(res.final_rmse)) and rot < 5e-3 and terr < 5e-3):
        _fail(f"65k pair: GT not recovered (rot {rot:.3e}, t {terr:.3e})")
    if res.iters < 1 or pair_launches < res.iters:
        _fail(f"65k pair: {pair_launches} kernel launches for {res.iters} iterations")
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _sync_time(run_pair, reps=3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    s_n = estimate_normals(src, k=10, method="brute")
    t_n = estimate_normals(tgt, k=10, method="brute")
    wall_normals, _ = _sync_time(
        lambda: (estimate_normals(src, k=10, method="brute"),
                 estimate_normals(tgt, k=10, method="brute")), reps=3)
    wall_reg, _ = _sync_time(lambda: register(s_n, t_n, cfg_pair), reps=3)
    print(f"65k pair: iters={res.iters} rmse={float(res.final_rmse):.3e} "
          f"rot_err={rot:.3e} t_err={terr:.3e} launches={pair_launches}; "
          f"wall {wall * 1e3:.2f} ms (median of 3, normals included) = "
          f"{n_pair / wall:.4g} points/s; normals (both clouds) {wall_normals * 1e3:.2f} ms, "
          f"register {wall_reg * 1e3:.2f} ms; peak {peak:.0f} MiB")
    del src, tgt, s_n, t_n

    # 6. The 1M flagship through register(), under each block path -------------------
    walls = {}
    for label, cfg in flag_cfgs.items():
        res, counts = _counted(lambda: register(f_src, f_tgt, cfg))
        rot, terr = (float(x) for x in res.transform.distance_to(f_gt))
        if not (math.isfinite(float(res.final_rmse)) and rot < 5e-3 and terr < 5e-3):
            _fail(f"flagship ({label}): GT not recovered (rot {rot:.3e}, t {terr:.3e})")
        refine = _refine_iters(res)
        want = {"refine": refine, "all": res.iters}
        for name, n in counts.items():
            rule = _FLAG_LAUNCHES[label].get(name)
            ok = n >= 2 if rule == "some" else n == want.get(rule, 0)
            if not ok:
                _fail(f"flagship ({label}): {name} launched {n} times "
                      f"({refine} refine of {res.iters} iterations; {counts})")
        for name, path in _LAUNCHES_FROM.items():
            if path == label:
                kernels[name]["launches"] = counts[name]
        torch.cuda.reset_peak_memory_stats()
        wall, _ = _sync_time(lambda: register(f_src, f_tgt, cfg), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        walls[label] = wall
        print(f"flagship 1M ({label}): iters={res.iters} (coarse {res.iters - refine}, refine "
              f"{refine}) rmse={float(res.final_rmse):.3e} rot_err={rot:.3e} t_err={terr:.3e} "
              f"launches={counts}; wall {wall * 1e3:.2f} ms (median of 3, normals included) = "
              f"{n_flag / wall:.4g} points/s; peak {peak:.0f} MiB")
    print("flagship 1M walls: " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in walls.items()))
    del f_src, f_tgt

    # 7. A 16,384-point block pair: the kernels on the card, their plain
    #    versions on the CPU, under each kernel-served mode -------------------------
    #    The new modes run a fixed 3 refine iterations: on this pair their
    #    converged RMSE moves by ~1e-6 from one iteration to the next (the
    #    plain fold's expansion score under "select", near-tie winners under
    #    block_fused "on"), which is rmse_change_tol itself, so where the
    #    stop rule fires would depend on the device's fp32 rounding.
    src, tgt, gt = _gt_pair(n_small, 3, dev, angle=0.15, translation=(0.1, -0.05, 0.02))
    fixed = dict(max_iters=3, rmse_change_tol=0.0)
    small = {"vmem": ("fold6", dict(payload_mode="vmem")),
             "vmem7": ("fold7", dict(payload_mode="vmem7", **fixed)),
             "select": ("select", dict(payload_mode="select", **fixed)),
             "fused": ("fused4", dict(block_fused="on", **fixed))}
    for label, (name, change) in small.items():
        cfg_small = dataclasses.replace(flag_cfgs["kernels"], moments_mode="vmem", **change)
        res, counts = _counted(lambda: register(src, tgt, cfg_small))
        if counts["moments6"] < 2 or counts[name] < 1:
            _fail(f"16k pair ({label}): the kernels were not launched ({counts})")
        res_cpu = register(src.to("cpu"), tgt.to("cpu"), cfg_small)
        d_rot, d_t = _transform_diff(res.transform, res_cpu.transform)
        rot, terr = (float(x) for x in res.transform.distance_to(gt))
        if (abs(res.iters - res_cpu.iters) > 1 or d_rot > 1e-4 or d_t > 1e-3
                or rot > 5e-3 or terr > 5e-3):
            _fail(f"16k pair ({label}): card and CPU runs differ (iters {res.iters} vs "
                  f"{res_cpu.iters}, rot {d_rot:.2e}, t {d_t:.2e}; GT rot {rot:.2e}, t {terr:.2e})")
        print(f"16k block pair ({label}): iters={res.iters} on the card, {res_cpu.iters} on "
              f"the CPU; transforms within rot {d_rot:.1e}, t {d_t:.1e}; GT rot {rot:.2e}, "
              f"t {terr:.2e}; launches={counts}")

    cu = "icpx_torch/csrc/blocknn.cu"
    sources = {"nn": "icpx_torch/csrc/nn.cu", "moments6": cu, "fold6": cu, "fold7": cu,
               "select": cu, "fused4": cu}
    replaces = {"nn": "icpx/kernels/knn_pallas.py:37",
                "moments6": "icpx/kernels/blocknn_pallas.py:890",
                "fold6": "icpx/kernels/blocknn_pallas.py:497",
                "fold7": "icpx/kernels/blocknn_pallas.py:694",
                "select": "icpx/kernels/blocknn_pallas.py:358",
                "fused4": "icpx/kernels/blocknn_pallas.py:101"}
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
         **{k: kernels[name][k] for k in keys}, **kernels[name]}  # then a kernel's own extras
        for name in sources
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_flagship(n: int = N_FLAG, top: int = 12) -> None:
    """Where the flagship's time goes: for each block path of
    `_flag_configs` the unprofiled wall (median of 3 after 2 warm calls),
    then one call under `torch.profiler` (CPU and CUDA activity): its device
    time, that time's share of the wall (the device-busy share), and the
    kernels and aten ops with the most device time."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    from icpx_torch.kernels import cuda_build
    from icpx_torch.registration.icp import register

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    cuda_build.compile_all()
    src, tgt, gt = _gt_pair(n, 0, dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, cfg in _flag_configs().items():
        wall, _ = _sync_time(lambda: register(src, tgt, cfg), reps=3, warmup=2)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = register(src, tgt, cfg)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        rot, terr = (float(x) for x in res.transform.distance_to(gt))
        avgs = [e for e in prof.key_averages() if _device_us(e) > 0]
        # device kernels (and copies) alone; the CPU ops that launched them
        # report the same time again
        kernels = [e for e in avgs if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        ops = [e for e in avgs if e.key.startswith("aten::")]
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3
        print(f"\n{label}: wall {wall * 1e3:.2f} ms (median of 3, unprofiled); device time "
              f"{busy_ms:.2f} ms = {100 * busy_ms / (wall * 1e3):.1f}% busy; profiled call "
              f"{prof_ms:.2f} ms; iters {res.iters}, rot {rot:.2e}, t {terr:.2e}")
        for title, rows in (("kernels", kernels), ("ops", ops)):
            print(f"  {title} by device time:")
            for e in sorted(rows, key=_device_us, reverse=True)[:top]:
                print(f"  {_device_us(e) / 1e3:9.3f} ms {100 * _device_us(e) / 1e3 / max(busy_ms, 1e-9):5.1f}% "
                      f"x{e.count:<5d} {e.key[:90]}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="only profile the 1M flagship under each block path (torch.profiler) and exit")
    ap.add_argument("--n", type=int, default=N_FLAG, help="points per cloud under --profile")
    args = ap.parse_args()
    if args.profile:
        profile_flagship(args.n)
    else:
        main()
    sys.stdout.flush()
