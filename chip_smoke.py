#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`icpx_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's eight CUDA kernels from the sources in this checkout
(one `nvcc` per source, started together), holds each against its plain
PyTorch version at the shapes the main path gives it (the flagship's KD
indexes built through the sort kernel must equal the plain builds bit for
bit), then drives the main paths through `register()` and checks each
result against its ground truth:

* the brute-force path: the cat fixture pair and a 65,536-point synthetic
  pair (normals on the card);
* the block path: `bench.py`'s 1,048,576-point flagship pair with normals
  estimated inside the registration, under each way the block path
  delivers correspondences: the fold6 kernel ("auto"), the plain torch
  path ("gather"), the fold7 kernel (payload_mode "vmem7"), the plain fold
  with the select kernel ("select"), the plain in-fold selection
  ("infold") and the fused4 kernel (block_fused "on");
* GICP at the same flagship, covariances estimated inside the
  registration (3 reps, each held to the GT gate), then with covariances
  taken through the union moments kernel;
* the rest of the registration layer at that size: the refine-stride mid
  phase (stride 2 under "auto" and "vmem7", stride 4 under "auto"), the
  feature-augmented metric (an intensity channel; then the degenerate
  plane of 131,072 points, with and without it), NDT ("p2d" and "d2d",
  cells of 64), `horn_align` on the source and its GT image, and
  `voxel_nn` against the nn kernel's exact NN;
* a 16,384-point pair on the card against the same pair on the CPU under
  "vmem", "vmem7", "select" and block_fused "on", symmetric and GICP, and
  the mid phase under "vmem" and "select";
* batched pairs: `register_batch` on 8 scan-size pairs of 8,000 points and
  `register_batch_block` on 4 pairs of 65,536, and `register_pyramid` on a
  65,536-point pair at 0.9 rad (levels of 4,096, 16,384 and 65,536
  points);
* odometry, each run held to `bench.py`'s ATE gate (< 0.5 m): the compiled
  whole-sequence path on `bench.py --odometry --scan-points 65536`'s 20
  scans (the block path; one run profiled) and on 4,096-point scans (the
  brute path), the same 8,192 x 10 sequence on the card and on the CPU,
  the host frontend `run_odometry` at 8,192 points (scan_to_keyframe with
  the stall watchdog on and off; scan_to_map with the sliding window; a
  resume from a checkpoint equal bit for bit), and tests/test_slam.py's
  loop at 2,048 and 8,192 points through loop closure and both pose-graph
  solvers;
* the command line, `icpx_torch.cli`, over files (`_phase_cli`): the
  native IO library on the 1M pair as binary_compressed PCD, the cat pair
  through binary PLY, .xyz and compressed PCD (`info`, `convert`,
  `register` at the golden gate, `perturb` then `horn`), `register` of the
  1M files (the "auto" path's gate and launches, against a direct
  `register()`), `odometry --compiled` over the 65k sequence written as a
  KITTI velodyne directory (against a direct `run_odometry_compiled`),
  `prefetch_kitti` against the serial load, `odometry --synthetic` with
  loop closure, a checkpoint resume, and one `python3 -m icpx_torch.cli`
  process;
* the distributed layer, `icpx_torch.distributed` (`_phase_distributed`):
  at one rank over NCCL, `sharded_register` brute (the 65k pair, against
  `register()`), block and GICP (the 1M flagship), replicated and ring;
  `sharded_register_pairs` (8 x 8,000, and as GICP pairs);
  `parallel_odometry` on the 65k sequence; `sharded_map_register` of a
  scan against the bench world; `pipelined_pyramid_register` (6 x 8,000);
  `optimize_pose_graph_sharded` on 1,000 keyframes, bit-equal to the
  dense solver. Then two ranks spawned over gloo on the same card (the
  flagship ring, 2 map blocks, 2 stages, 2 edge shards), each against the
  one-rank result; the line `distributed phase: T s` gives its seconds.

Before the paths, fold6, fold7 and select are also held to their plain
versions and timed at the mid phase's query tiles (16,384 x 32 and x 16),
and nn on a pair of the 65k odometry scans (LiDAR rings, pad rows).
The odometry phases hold the kernels of their path bit for bit at their
own shapes: the sort kernel in the 65k frames' KD builds (source at
tiles of 256, keyframe at 128), nn on a brute frame's and on a loop
closure's operands, fold6 on a host-frontend frame's query tiles.

The port gives the same bits on every run: every path timed over repeated
runs (`_sync_time`) must return the same bits each time, the SLAM loop's
closures and pose-graph solves are run twice and held bit for bit, and
the one-rank sharded pose graph equals the dense solver bit for bit. The
1M flagship under "auto" and "gather" is held to the JAX package's own
result on the same pair (`tests/data/jax_flagship_1m.json`, written on
the CPU by `scripts/torch_jax_flagship_ref.py`): the same coarse and
refine iterations, the transform and rmse within `FLAG_JAX_TOL`.

Every path's KD builds sort through the sort kernel. Launch counters are
set to 0 just before each path and read just after, and each path is held
to the launches it must make (per pyramid level and per pair where it runs
several registrations). Every phase prints one line (or a few) with its
GT errors, launches, wall (median of 3) and peak memory; any failure
raises, so the exit code is non-zero. The SM
clock is sampled before and after the kernel phases. The last two lines
are a JSON object per kernel and the verdict ``{"ok": true, "device":
{...}}``. Without a CUDA device it refuses to run.

    python3 chip_smoke.py --profile [--n 1048576] [--paths new]

runs none of that: it profiles one flagship registration under each of
those block paths and GICP (`torch.profiler`) and prints where the device
time goes; with `--paths new`, the mid phase, feat_nn, NDT, the batched
paths and the pyramid instead.
"""

import argparse
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

N_PAIR = 65536  # one rotating-LiDAR sweep; the round-1 `bench.py --n 65536` point
N_FLAG = 1048576  # bench.py's flagship pair
N_SMALL = 16384  # the block pair run on the card and on the CPU
N_BATCH = 8000  # register_batch's scan-size pairs, just under block_auto_threshold
N_PLANE = 131072  # the degenerate plane of the feature phase



def _fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def _sync_time(fn, reps: int, warmup: int = 1):
    """Host wall seconds per call, torch.cuda.synchronize() fences, median;
    and the last output. Every run's output, the warm-up's included, must
    equal the first's bit for bit (`_check_repeats`, naming the calling
    function and line): the port gives the same bits on every run. No
    output a timed path returns holds a timing, so no leaf is exempt."""
    caller = sys._getframe(1)
    label = (f"{caller.f_code.co_name} ({caller.f_code.co_filename.rsplit('/', 1)[-1]}:"
             f"{caller.f_lineno})")
    outs = [fn() for _ in range(warmup)]
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    _check_repeats(label, outs)
    return statistics.median(times), outs[-1]


def _leaves(tree, path=""):
    """(path, leaf) of every value in a result: dataclasses by field,
    dicts by key, lists and tuples by position, other objects by their
    attributes; tensors, arrays, numbers, strings and None are leaves."""
    if tree is None or torch.is_tensor(tree) or isinstance(
            tree, (bool, int, float, str, bytes, np.ndarray, np.generic, torch.device, torch.dtype)):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif hasattr(tree, "__dict__"):
        for k, v in vars(tree).items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


def _raw(x):
    """A tensor's or array's bytes: NaN pads compare equal, -0.0 and 0.0 do not."""
    if torch.is_tensor(x):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _leaf_diff(a, b):
    """None where two leaves are the same bits, else what differs."""
    if torch.is_tensor(a) or isinstance(a, np.ndarray):
        if type(a) is not type(b) or tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            return f"{type(a).__name__} {tuple(a.shape)} {a.dtype} vs {type(b).__name__} " \
                   f"{tuple(getattr(b, 'shape', ()))} {getattr(b, 'dtype', None)}"
        ra, rb = _raw(a), _raw(b)
        if np.array_equal(ra, rb):
            return None
        x, y = (np.asarray(v.detach().cpu() if torch.is_tensor(v) else v) for v in (a, b))
        bad = int((ra != rb).reshape(x.size, -1).any(1).sum())
        err = (float(np.nanmax(np.abs(x.astype(np.float64) - y.astype(np.float64))))
               if x.dtype.kind in "fiu" else math.nan)
        return f"{bad} of {x.size} elements differ (max |diff| {err:.3e})"
    if isinstance(a, float) and isinstance(b, float):
        return None if np.float64(a).tobytes() == np.float64(b).tobytes() else f"{a!r} vs {b!r}"
    return None if type(a) is type(b) and a == b else f"{a!r} vs {b!r}"


def _check_repeats(label, outs):
    """Fail unless every output in `outs` equals the first bit for bit,
    naming `label` and the first leaf that differs."""
    first = list(_leaves(outs[0]))
    for k, out in enumerate(outs[1:], start=1):
        other = list(_leaves(out))
        if [p for p, _ in other] != [p for p, _ in first]:
            _fail(f"{label}: run {k} returned another structure than run 0")
        for (path, a), (_, b) in zip(first, other):
            diff = _leaf_diff(a, b)
            if diff is not None:
                _fail(f"{label}: run {k} differs from run 0 at leaf `{path or '.'}`: {diff}")


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


def _graph_ms(fn, inner: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call: `inner` calls captured in one CUDA graph,
    replayed between CUDA events (median of reps), so the host's launch
    cost, which a single call's event time includes, drops out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return statistics.median(times)


def _bound(bytes_moved: float, flops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the fp32 operations (an FMA counts 2) over the
    non-tensor-core fp32 rate, one H100 SXM's at 700 W
    (`icpx_torch.utils.profiling`)."""
    from icpx_torch.utils.profiling import FP32_FLOPS, HBM_BYTES_PER_S

    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def _input_bytes(*tensors) -> int:
    """Bytes of 4-byte inputs, each read once: a tensor passed twice (tiles
    that query themselves) counts once."""
    return 4 * sum({(t.data_ptr(), t.numel()): t.numel() for t in tensors}.values())


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


def _gt_pair(n, seed, dev, angle=0.2, translation=(0.12, -0.06, 0.03), axis=(0.0, 0.0, 1.0)):
    """bench.py's construction: a synthetic surface, its rigid image under
    the GT, shuffled with default_rng(1) (`_pair_perm`)."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.geometry.transforms import make_rigid_perturbation
    from icpx_torch.io.loaders import synthetic_surface

    src = PointCloud.create(synthetic_surface(n, seed=seed), capacity=n, device=dev)
    gt = make_rigid_perturbation(axis=axis, angle=angle, translation=translation, device=dev)
    perm = _pair_perm(n, dev)
    tgt = PointCloud.create(gt.apply(src.xyz)[perm], capacity=n, device=dev)
    return src, tgt.replace(mask=src.mask[perm]), gt


def _pair_perm(n, dev):
    """The target's row order in `_gt_pair`: row i of the target is the
    image of source row perm[i]."""
    return torch.as_tensor(np.random.default_rng(1).permutation(n), device=dev)


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
# iteration), "all" (once an iteration of both phases), "builds" (the level sorts of the
# source's KD index at tiles of 64 and the target's at 128: 5 + 4 at 1M),
# "gicp builds" (those and, where the covariances take the block method,
# the two covariance indexes at 128: 17 at 1M), or
# a number (moments6: 2, the normals of both clouds)}; every kernel not
# named stays at 0. "gicp fused" takes the covariances through the union
# moments kernel, once a cloud.
_FLAG_LAUNCHES = {
    "kernels": {"moments6": 2, "fold6": "refine", "sort": "builds"},
    "plain": {"sort": "builds"},
    "vmem7": {"moments6": 2, "fold7": "refine", "sort": "builds"},
    "select": {"moments6": 2, "select": "refine", "sort": "builds"},
    "infold": {"moments6": 2, "sort": "builds"},
    "fused": {"moments6": 2, "fused4": "all", "sort": "builds"},
    "gicp": {"fold6": "refine", "sort": "gicp builds"},
    "gicp fused": {"fold6": "refine", "sort": "gicp builds", "moments_fused": 2},
    # the refine-stride mid phase: the fold once an iteration of the mid
    # phase and of the full-resolution tail ("refine" counts both)
    "mid2": {"moments6": 2, "fold6": "refine", "sort": "builds"},
    "mid2 vmem7": {"moments6": 2, "fold7": "refine", "sort": "builds"},
    "mid4": {"moments6": 2, "fold6": "refine", "sort": "builds"},
    # a feature channel: the plain fold and a row gather in both phases, no
    # fold kernel, as in the reference
    "feat": {"moments6": 2, "sort": "builds"},
}
# The flagship path whose launches the kernels line reports for each kernel.
_LAUNCHES_FROM = {"moments6": "kernels", "fold6": "kernels", "fold7": "vmem7",
                  "select": "select", "fused4": "fused", "sort": "gicp",
                  "moments_fused": "gicp fused"}


def _check_launches(label, counts, res, shapes):
    """Fail unless the flagship path `label` launched what _FLAG_LAUNCHES
    says (`shapes`: the level sorts of a KD build by tile size); returns the
    refine iterations."""
    from icpx_torch.kernels.normals import _resolve_method

    refine = _refine_iters(res)
    builds = len(shapes[64]) + len(shapes[128])
    cov_builds = 2 * len(shapes[128]) if _resolve_method("auto", shapes["n"]) == "block" else 0
    want = {"refine": refine, "all": res.iters, "builds": builds,
            "gicp builds": builds + cov_builds}
    for name, n in counts.items():
        rule = _FLAG_LAUNCHES[label].get(name)
        if n != (rule if isinstance(rule, int) else want.get(rule, 0)):
            _fail(f"flagship ({label}): {name} launched {n} times "
                  f"({refine} refine of {res.iters} iterations; {counts})")
    return refine


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


def _nn_cases(n_pair, rng, lidar=None):
    """`_phase_nn`'s inputs, numpy: (big, cat, cases), cases a dict name ->
    (query, ref, ref_mask, expected index or None), big and cat the names
    of the two timed shapes, n_pair^2 uniform and the cat pair's 3,456^2
    with its 56 pad rows on both sides. `lidar` (`_lidar_pair`'s query,
    ref and mask) adds a third timed case, named by `_lidar_name`."""
    from icpx_torch.cloud import PAD_COORD

    def uniform(n):
        return rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)

    def padded(n_real, cap):
        x = np.full((cap, 3), PAD_COORD, np.float32)
        x[:n_real] = uniform(n_real)
        return x, np.arange(cap) < n_real

    q_cat, m_cat = padded(3400, 3456)
    r_cat, _ = padded(3400, 3456)
    half = rng.uniform(size=70001) < 0.5
    big, cat = f"{n_pair}x{n_pair}", "3456x3456 (56 pad rows)"
    cases = {
        big: (uniform(n_pair), uniform(n_pair), np.ones(n_pair, bool), None),
        cat: (q_cat, r_cat, m_cat, None),
        "1000x70001 (half masked)": (uniform(1000), uniform(70001), half, None),
        "300x700 (all masked)": (uniform(300), uniform(700), np.zeros(700, bool), None),
        "duplicates": _duplicate_fixture(),
    }
    if lidar is not None:
        cases[_lidar_name(len(lidar[0]))] = (*lidar, None)
    return big, cat, cases


def _lidar_name(n):
    """The nn case name of an n-point LiDAR pair."""
    return f"{n}x{n} LiDAR scans"


def _lidar_pair(n, dev):
    """One pair of `_phase_distributed` (e)'s scans (bench.py --odometry's
    sequence at n points a scan), as `parallel_odometry` first hands it to
    the nn kernel: scan 1 (the source) against scan 0 and its mask, both in
    scan 0's centroid coordinates, at the initial pose (identity); pad rows
    stay where they are. Numpy (query, ref, ref mask)."""
    from icpx_torch.odometry.compiled import _masked_center

    scans, _ = _odo_sequence(n, 2, dev)
    center = _masked_center(scans[0].xyz, scans[0].mask)
    query, ref = (torch.where(f.mask[:, None], f.xyz - center[None, :], f.xyz) for f in scans[::-1])
    return query.cpu().numpy(), ref.cpu().numpy(), scans[0].mask.cpu().numpy()


def _nn_equal(name, qc, rc, mc):
    """The nn kernel against its plain version on (query, ref, ref mask):
    fail unless d2 and index are bit-equal and the call adds to
    `profiling.nn_counters` what `nn_cuda.path_counts` expects; (kernel d2,
    kernel index, the plain version's finite rows, max |dd2|, (far rows,
    empty tiles) as the kernel counted them in this call)."""
    from icpx_torch.kernels import nn_cuda
    from icpx_torch.kernels.knn import nearest_neighbor_reference
    from icpx_torch.utils import profiling

    before = profiling.nn_counters(qc.device)
    d_k, i_k = nn_cuda.nn_cuda(qc, rc, mc)
    d_p, i_p = nearest_neighbor_reference(qc, rc, ref_mask=mc)
    torch.cuda.synchronize()
    after = profiling.nn_counters(qc.device)
    counted = tuple(after[k] - before[k] for k in profiling.NN_COUNTERS)
    want = nn_cuda.path_counts(qc, rc, mc, nn_cuda.kernel_shape())
    if counted != want:
        _fail(f"nn {name}: the kernel counted (far rows, empty tiles) {counted}, expected {want}")
    fin = torch.isfinite(d_p)
    err = _max_err(d_k, d_p) if torch.equal(fin, torch.isfinite(d_k)) else math.inf
    # the same direct-form d2 bits and the lowest index among ties
    if not (torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)) and torch.equal(i_k, i_p)):
        _fail(f"nn {name}: kernel and plain version differ on "
              f"{int(((d_k != d_p) | (i_k != i_p)).sum())} rows (max |dd2| {err:.3e})")
    return d_k, i_k, fin, err, counted


def _phase_nn(dev, n_pair, rng, lidar=None):
    """Kernel #1 against its plain version: d2 and index bit-equal on every
    case; times at n_pair^2, at the cat shape 3,456^2 and on the LiDAR pair
    `lidar` (`_lidar_pair`); returns its JSON fields (times at n_pair^2, the
    cat shape's under *_3456, the LiDAR pair's under *_lidar)."""
    from icpx_torch.kernels import nn_cuda
    from icpx_torch.kernels.knn import nearest_neighbor_reference

    big, cat, cases = _nn_cases(n_pair, rng, lidar)
    scans = _lidar_name(len(lidar[0])) if lidar is not None else None
    max_abs_err = 0.0
    fields = {}
    for name, (q, r, m, expect) in cases.items():
        qc, rc, mc = (torch.as_tensor(x, device=dev) for x in (q, r, m))
        d_k, i_k, fin, err, (far, empty) = _nn_equal(name, qc, rc, mc)
        max_abs_err = max(max_abs_err, err)
        if expect is not None and not np.array_equal(i_k.cpu().numpy(), expect):
            _fail(f"nn {name}: tie rule broken (lowest index must win)")
        if not bool(fin.any()) and not (bool((i_k == 0).all()) and bool(torch.isinf(d_k).all())):
            _fail(f"nn {name}: a query with no valid reference must get (inf, 0)")
        line = f"nn kernel vs plain {name}: d2 and index bit-equal on all {len(q)} rows"
        if name in (big, cat, scans):
            nq, nr = len(q), len(r)
            plan = nn_cuda.launch_plan(nq, nr, dev)
            ms = _event_ms(lambda: nn_cuda.nn_cuda(qc, rc, mc))
            plain_ms = _event_ms(lambda: nearest_neighbor_reference(qc, rc, ref_mask=mc))
            device_ms = _graph_ms(lambda: nn_cuda.nn_cuda(qc, rc, mc))
            # the operations of the kernel's method on this data: every query
            # against every valid reference screened (3 FFMA = 6, and a min),
            # and at least one group of 8 rows a query rescored in the direct
            # form (8 a row)
            bound_ms, bound_by = _bound((nq + nr) * 12 + nr + nq * 8,
                                        nq * int(m.sum()) * 7.0 + nq * 8 * 8.0)
            suffix = {big: "", cat: "_3456", scans: "_lidar"}[name]
            fields.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                           f"bound_ms{suffix}": bound_ms, f"device_ms{suffix}": device_ms,
                           f"splits{suffix}": plan["splits"]})
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (CUDA events around one "
                     f"call, median of 5); device time (CUDA graph replay) kernel {device_ms:.4f} "
                     f"ms; bound {bound_ms:.4f} ms ({bound_by})")
            if name != scans:

                def library():  # one PyTorch call for the same function, chunked over queries
                    for q0 in range(0, nq, 4096):
                        torch.cdist(qc[q0:q0 + 4096], rc,
                                    compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)

                library_ms = _event_ms(library)
                # beside cdist's ~5 s at 65,536^2 the host's launch cost is nothing
                library_device_ms = library_ms if name == big else _graph_ms(library)
                fields[f"library_ms{suffix}"] = library_ms
                line += (f"; torch.cdist+min {library_ms:.3f} ms (events), {library_device_ms:.3f} "
                         f"ms (device)")
            if name == cat:
                fields["library_device_ms_3456"] = library_device_ms
            if name == big:
                fields["bound_by"] = bound_by
            fields.update({f"far_rows{suffix}": far, f"empty_tiles{suffix}": empty})
            if name == scans:
                fields["valid_refs_lidar"] = int(m.sum())
            line += (f"; counted by the kernel: {far} far rows, {empty} empty tiles skipped; "
                     f"near items {plan['q_blocks']} query blocks x {plan['splits']} splits of "
                     f"the non-empty tiles of {plan['tile_r']} rows, "
                     f"Q={plan['queries_per_thread']} queries a thread, G={plan['group']}, grid "
                     f"{plan['grid']} = {plan['blocks_per_sm']} blocks an SM x {plan['sms']} SMs")
        print(line)
        del qc, rc, mc, d_k
    return dict(fields, max_abs_err=max_abs_err)


MOMENTS6_FIXTURES = ("random", "exact ties", "on the radius", "near the radius", "mixed sentinel",
                     "all sentinel", "pad queries", "all miss", "far queries", "far tile")
# (tq, sq, s, k) of the moments6 fixtures, one for each kind of moments6_plan:
# the 1M normals plan (2 tiles a block, stages of 128 lanes); GICP's k = 8
# with a block that is not full; 11 threads a tile, 11 tiles a block; 3
# queries a tile (the last thread's second query past the tile's end) over
# S = 8 (a stage padded to a mask word); a tile over three blocks with S
# over three stages (the last of 44 lanes); S not a multiple of 4 (4-byte
# copies, padded lanes); Sq 5 with a last stage of 2 lanes
MOMENTS6_FIXTURE_SHAPES = ((4, 128, 128, 2), (6, 128, 128, 8), (5, 22, 32, 4), (3, 3, 8, 3),
                           (2, 600, 300, 2), (7, 64, 100, 3), (9, 5, 130, 2))


def moments6_fixture(name, tq=4, sq=20, s=32, k=2, n_tiles=12, device="cpu"):
    """One moments6 fixture, made with numpy from a seed: (query tiles (tq,
    sq, 3), tiles (n_tiles, s, 3), cand (tq, k), q_cent (tq, 3), r2 ()), on
    `device`. Tiles are uniform in [-1, 1]^3; each query lies within 0.05 of
    a row of its tile's candidates; q_cent is each query tile's valid-query
    centroid; the radius is 0.2. "exact ties": coordinates and centroids on
    small integers, r2 = 2, so rows repeat and many d2 tie exactly, on the
    radius among them. "on the radius": the same with r2 = 5, and a row at
    d2 = 5 exactly for every query. "near the radius": each query's rows
    at the radius and one ulp inside and outside it in x (direct d2 within
    a few ulps of r2: the screen's band). "mixed sentinel": a third of the
    rows at PAD_COORD. "all sentinel": query tile 0's candidates are
    all-sentinel tiles. "pad queries": a quarter of the queries at
    PAD_COORD. "all miss": queries 3 units off the rows in z. "far
    queries": queries 50 units off the rows, centred on the origin (the
    kernel's far test). "far tile": each centroid 4 units off its queries
    in every axis (|qc| and R ~7: a band ~1e4 times the 1M shape's, where
    the direct form decides more pairs)."""
    from icpx_torch.cloud import PAD_COORD

    rng = np.random.default_rng(sum(map(ord, name)) + 7 * s + k + 3 * sq)
    cand = rng.integers(0, n_tiles, (tq, k))
    integer = name in ("exact ties", "on the radius")
    if integer:
        tiles = rng.integers(-2, 3, (n_tiles, s, 3)).astype(np.float32)
        near = tiles[cand[:, rng.integers(0, k, sq)], rng.integers(0, s, (tq, sq))]
        query = near + rng.integers(-1, 2, (tq, sq, 3)).astype(np.float32)
    else:
        tiles = rng.uniform(-1, 1, (n_tiles, s, 3)).astype(np.float32)
        near = tiles[cand[:, rng.integers(0, k, sq)], rng.integers(0, s, (tq, sq))]
        query = (near + rng.uniform(-0.05, 0.05, (tq, sq, 3))).astype(np.float32)
    r2 = {"exact ties": 2.0, "on the radius": 5.0}.get(name, 0.04)
    if name == "on the radius":
        flat = tiles.reshape(-1, 3)
        for t in range(tq):
            for i in range(sq):  # a row at offset (1, 2, 0) from the query: d2 = 5
                flat[cand[t, rng.integers(k)] * s + rng.integers(s)] = query[t, i] + np.float32([1, 2, 0])
    elif name == "near the radius":
        flat = tiles.reshape(-1, 3)
        for t in range(tq):
            for i in range(sq):
                r1 = query[t, i] + np.float32([0.2, 0.0, 0.0])
                for step in (0.0, -np.inf, np.inf):
                    r = r1.copy()
                    if step:
                        r[0] = np.nextafter(r1[0], np.float32(step))
                    flat[cand[t, rng.integers(k)] * s + rng.integers(s)] = r
    elif name == "mixed sentinel":
        tiles[rng.uniform(size=(n_tiles, s)) < 0.33] = PAD_COORD
    elif name == "all sentinel":
        tiles[-2:] = PAD_COORD
        cand[0] = [n_tiles - 1 - (c % 2) for c in range(k)]
    elif name == "pad queries":
        query[rng.uniform(size=(tq, sq)) < 0.25] = PAD_COORD
    elif name == "all miss":
        query[..., 2] += np.float32(3.0)
    elif name == "far queries":
        query += np.float32(50.0)
    elif name not in ("random", "exact ties", "far tile"):
        raise KeyError(name)
    valid = (np.abs(query) < 1e6).all(-1)
    q_cent = (np.where(valid[..., None], query, 0).sum(1)
              / np.maximum(valid.sum(1), 1)[:, None]).astype(np.float32)
    if integer:
        q_cent = np.round(q_cent)
    elif name == "far queries":
        q_cent[:] = 0.0
    elif name == "far tile":
        q_cent += np.float32(4.0)
    return tuple(torch.as_tensor(x, device=device) for x in
                 (query, tiles, cand, q_cent, np.float32(r2)))


def _moments6_work(query, tiles, cand, q_cent, r2, chunk=256):
    """The moments6 kernel's work on these inputs, from float64 distances:
    (pairs screened, pairs in the screen's band, pad queries). A query
    screens the rows of each mask word (32 rows of a candidate tile) whose
    box of valid rows lies within its reach r2 + delta (the kernel skips a
    word only when every query of a warp is beyond it: a lower bound); a
    pair is in the band when its d2 lies within delta of r2, delta from
    `moments6_screen_margin` with R the largest valid |rc| of its candidate
    tile; a query at or beyond kValidAbs (a pad row) is far and screens
    nothing. S must be a whole number of words no longer than a stage."""
    from icpx_torch.kernels import blocknn_cuda

    k, s = cand.shape[1], tiles.shape[1]
    if s % 32 or s > 128:
        raise ValueError(f"S = {s}: not whole words of one stage")
    screened = band = 0
    pad = int((query.abs().amax(-1) >= 1e6).sum())
    r2 = r2.reshape(()).double()
    for t0 in range(0, query.shape[0], chunk):
        c = q_cent[t0:t0 + chunk].double()
        raw = tiles[cand[t0:t0 + chunk].long()].double()  # (c, k, S, 3)
        valid = raw.abs().amax(-1) < 1e6
        rc = raw - c[:, None, None, :]
        big_r = torch.where(valid, (rc * rc).sum(-1), 0.0).amax(-1).sqrt()  # (c, k)
        qc = query[t0:t0 + chunk].double() - c[:, None, :]
        live = (query[t0:t0 + chunk].abs().amax(-1) < 1e6)[..., None]  # (c, Sq, 1)
        delta = blocknn_cuda.moments6_screen_margin((qc * qc).sum(-1)[..., None], big_r[:, None, :],
                                                    r2).double()  # (c, Sq, k)
        words = rc.reshape(rc.shape[0], k, s // 32, 32, 3)
        wv = valid.reshape(rc.shape[0], k, s // 32, 32, 1)
        lo = torch.where(wv, words, math.inf).amin(3)[:, None]  # (c, 1, k, W, 3)
        hi = torch.where(wv, words, -math.inf).amax(3)[:, None]
        q5 = qc[:, :, None, None, :]
        gap = torch.maximum(torch.maximum(lo - q5, q5 - hi), torch.zeros((), dtype=torch.float64,
                                                                         device=qc.device))
        within = (gap * gap).sum(-1) <= (r2 + delta)[..., None]  # (c, Sq, k, W)
        screened += 32 * int((within & live[..., None]).sum())
        d = ((qc[:, :, None, None, :] - rc[:, None]) ** 2).sum(-1)  # (c, Sq, k, S)
        near = ((d - r2).abs() <= delta[..., None]) & valid[:, None] & live[..., None]
        band += int(near.sum())
    return screened, band, pad


def _phase_moments6(dev, index, radius, fixtures, f_tgt):
    """Kernel #2 against its plain version at the shapes of one flagship
    normals launch (the target index's 8,192 x 128 self-query, k_tiles = 2)
    and of GICP's covariances (the target's covariance index of 128-point
    tiles, k_tiles = 8, the radius for k = 15), plus the tie and sentinel
    fixtures and each moments6 fixture (`moments6_fixture`) at each of
    MOMENTS6_FIXTURE_SHAPES: counts equal on every row, means within 1e-5,
    covariances within `_cov_tol`'s per-row tolerance. Times at both 1M
    shapes (k = 8's under *_k8); returns its JSON fields."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import _candidate_tiles, build_kd_index

    def compare(name, query, tiles, cand, q_cent, r2):
        out_k = blocknn_cuda.moments6_cuda(query, tiles, cand.to(torch.int32), q_cent, r2.reshape(1))
        out_p = blocknn_cuda.moments6_reference(query, tiles, cand, q_cent, r2)
        torch.cuda.synchronize()
        # the same verdicts on every pair: counts equal on every row; means
        # and covariances differ only by the order of the sums
        if not torch.equal(out_k[0], out_p[0]):
            _fail(f"moments6 {name}: counts differ on {int((out_k[0] != out_p[0]).sum())} rows")
        if not bool(torch.isfinite(out_k).all()):
            _fail(f"moments6 {name}: moments not finite")
        none = out_p[0] == 0  # no row counts: count 0, the centroid and zeros, exactly
        if not torch.equal(out_k[:, none], out_p[:, none]):
            _fail(f"moments6 {name}: rows without neighbours differ from the plain version's")
        mean_err = float((out_k[1:4] - out_p[1:4]).abs().max()) if out_k.numel() else 0.0
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
        over = float(torch.where(cov_err == 0, 0.0, cov_err / tol).max()) if out_k.numel() else 0.0
        if over > 1.0:
            _fail(f"moments6 {name}: a covariance is off by {over:.3g} x its tolerance")
        return out_k, mean_err, float(cov_err.max()) if out_k.numel() else 0.0, over

    cov_index = build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128)
    shapes = {"": (index, radius, 2), "_k8": (cov_index, _cov_radius(f_tgt, 15), 8)}
    errs, timed, cases = [], {}, {}
    for suffix, (idx, rad, k) in shapes.items():
        cand, q_cent = _candidate_tiles(idx.tiles, idx, k)
        r2 = (rad * rad).reshape(()).to(torch.float32)
        out, *e = compare(f"{tuple(idx.tiles.shape)} k={k}", idx.tiles, idx.tiles, cand, q_cent, r2)
        errs.append(e)
        cases[suffix] = (idx, cand, q_cent, r2, out)
    query, fx_index, fx_cand, _ = fixtures
    _, fq_cent = _candidate_tiles(query, fx_index, 4)
    fx, *e = compare("fixtures", query, fx_index.tiles, fx_cand, fq_cent, torch.tensor(4.0, device=dev))
    errs.append(e)
    if float(fx[0, 8:].max()) != 0.0 or float(fx[0, 6:8].max()) != 0.0:
        _fail("moments6 fixtures: sentinel rows or padded query rows were counted")
    for shape in MOMENTS6_FIXTURE_SHAPES:
        for name in MOMENTS6_FIXTURES:
            x = moments6_fixture(name, *shape, n_tiles=max(12, shape[3] + 2), device=dev)
            out, *e = compare(f"fixture {name} {shape}", *x)
            errs.append(e)
            if name in ("all sentinel", "pad queries", "all miss", "far queries"):
                dead = (x[0].abs().amax(-1) >= 1e6).reshape(-1)
                if name == "all sentinel":
                    dead[:shape[1]] = True
                elif name in ("all miss", "far queries"):
                    dead[:] = True
                if bool((out[0][dead] != 0).any()):
                    _fail(f"moments6 fixture {name} {shape}: a sentinel row or a far query counted")
    mean_err, cov_err, over = (max(col) for col in zip(*errs))
    lines = []
    for suffix, (idx, cand, q_cent, r2, out) in cases.items():
        cand32 = cand.to(torch.int32)
        tq, sq, _ = idx.tiles.shape
        n, k, s = tq * sq, cand.shape[1], idx.tile_size

        def run():
            return blocknn_cuda.moments6_cuda(idx.tiles, idx.tiles, cand32, q_cent, r2.reshape(1))

        ms, device_ms = _event_ms(run), _graph_ms(run)
        plain_ms = _event_ms(lambda: blocknn_cuda.moments6_reference(idx.tiles, idx.tiles, cand, q_cent, r2),
                             reps=3)
        # The operations of the kernel's method on this run's data: each
        # staged row packed (8 a row a query tile); each pair of a word
        # within a query's reach screened (FADD and 3 FFMA = 7); each pair
        # within delta of the radius decided in the direct form (8); each
        # pair inside the radius added to its query's sums (16). The pad
        # queries are far and screen nothing.
        screened, band, pad = _moments6_work(idx.tiles, idx.tiles, cand, q_cent, r2)
        inside = float(out[0].sum())
        n_ops = tq * k * s * 8.0 + screened * 7.0 + band * 8.0 + inside * 16.0
        bytes_moved = _input_bytes(idx.tiles, idx.tiles, cand32, q_cent, r2) + n * 40
        bound_ms, bound_by = _bound(bytes_moved, n_ops)
        timed.update({f"ms{suffix}": ms, f"device_ms{suffix}": device_ms, f"plain_ms{suffix}": plain_ms,
                      f"bound_ms{suffix}": bound_ms, f"bytes_ms{suffix}": _bound(bytes_moved, 0.0)[0],
                      f"band_pairs{suffix}": band, f"screened_pairs{suffix}": screened,
                      f"mean_count{suffix}": float(out[0].mean())})
        if not suffix:
            timed["bound_by"] = bound_by
        lines.append(f"{tuple(idx.tiles.shape)} k={k}: counts equal on all {n} rows (mean "
                     f"{float(out[0].mean()):.2f}, {pad} pad queries); kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.3f} ms (CUDA events around one call, median of 5; plain of 3), device "
                     f"time (CUDA graph replay) kernel {device_ms:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}: {n_ops:.6g} operations, {screened} pairs screened, {band} in the "
                     f"band; bytes alone "
                     f"{timed[f'bytes_ms{suffix}']:.4f} ms)")
    if dev.type == "cuda":  # the kernel's shape lives in the built library
        shape = blocknn_cuda.moments6_shape()
        tq, sq, _ = index.tiles.shape
        plan = blocknn_cuda.moments6_plan(tq, sq, index.tile_size, 2, shape)
        shape_text = (f"{shape.threads} threads, {shape.queries_per_thread} queries a thread, mask "
                      f"words of {shape.group} rows, stages of {shape.stage_lanes} lanes and "
                      f"{shape.stage_rows} rows; plan: {plan['tiles_per_block']} query tiles a block, "
                      f"{plan['stages']} stages of {plan['lanes_per_stage']} lanes, grid {plan['blocks']}")
    else:
        shape_text = "no kernel shape (no CUDA device)"
    print(f"moments6 kernel vs plain: " + "; ".join(lines) + f"; means within {mean_err:.3e}, "
          f"covariances within {cov_err:.3e} = {over:.3g} x their tolerance; fixtures ok (ties, "
          f"sentinel rows, padded rows; {', '.join(MOMENTS6_FIXTURES)} at (tq, sq, s, k) "
          f"{', '.join(map(str, MOMENTS6_FIXTURE_SHAPES))}); {shape_text}")
    return dict(max_abs_err=max(mean_err, cov_err), cov_max_abs_err=cov_err, cov_err_over_tol=over,
                library_ms=None, **timed)


def _refine_operands(src, tgt_index, gt, q_tile=64, k=6):
    """The operands of one refine iteration: the source's query tiles of
    q_tile rows at the GT pose (16,384 x 64 on the flagship), their k
    candidate tiles and the query-tile centroids."""
    from icpx_torch.kernels.blocknn import _candidate_tiles, build_kd_index, trim_index

    src_idx = trim_index(build_kd_index(src.xyz, src.mask, tile_size=q_tile), src.capacity,
                         multiple=4)
    query = gt.apply(src_idx.tiles.reshape(-1, 3)).reshape(src_idx.tiles.shape).contiguous()
    cand, q_cent = _candidate_tiles(query, tgt_index, k)
    return query, cand, q_cent


FOLD6_FIXTURES = ("random", "exact ties", "near ties", "mixed sentinel", "all sentinel",
                  "pad queries", "far queries", "rows beyond R")
# (tq, sq, s, k) of the fixtures on the card: query tiles that do not fill a
# block (sq 3 and 20), S not a multiple of the group (100), a tile over two
# blocks with S over two stages (600, 2000), whole blocks of one and of
# eight tiles (128 and 64 queries)
FOLD6_FIXTURE_SHAPES = ((6, 20, 32, 4), (3, 64, 100, 6), (9, 3, 8, 2), (5, 600, 2000, 1),
                        (4, 128, 128, 6), (8, 64, 128, 6), (8, 32, 128, 6), (8, 16, 128, 6))


def fold6_fixture(name, tq=6, sq=20, s=32, k=4, n_tiles=12, device="cpu"):
    """One fold6 screen fixture, made with numpy from a seed: (query tiles
    (tq, sq, 3), TileIndex, cand (tq, k), payload (n_tiles * s, 6)), on
    `device`. "random": uniform tiles and queries. "exact ties": small
    integer coordinates, so rows repeat across lanes and candidate tiles
    and many d2 tie exactly. "near ties": each query's near row r1 and two
    copies of it one ulp off in x or y, in other lanes and tiles (direct d2
    an ulp or so apart; some pairs screen in the reverse order). "mixed
    sentinel": a third of the rows at PAD_COORD. "all sentinel": query tile
    0's candidates are all-sentinel tiles. "pad queries": a quarter of the
    query rows at PAD_COORD. "far queries": queries 2e5 units from their
    candidates (a wide margin: two groups or the direct scan). "rows beyond
    R": tile boxes that miss the rows (the kernel's radius check sends every
    tile to the direct scan)."""
    from icpx_torch.cloud import PAD_COORD
    from icpx_torch.kernels.blocknn import TileIndex, _finish_index

    base = "random" if name == "rows beyond R" else name
    rng = np.random.default_rng(sum(map(ord, name)) + 7 * s + k)
    tiles = rng.uniform(-1, 1, (n_tiles, s, 3)).astype(np.float32)
    query = rng.uniform(-1, 1, (tq, sq, 3)).astype(np.float32)
    cand = rng.integers(0, n_tiles, (tq, k))
    if base == "exact ties":
        tiles = rng.integers(-2, 3, (n_tiles, s, 3)).astype(np.float32)
        query = rng.integers(-2, 3, (tq, sq, 3)).astype(np.float32)
    elif base == "near ties":
        flat = tiles.reshape(-1, 3)
        for qi, q in enumerate(query.reshape(-1, 3)):
            t = cand[qi // sq]
            r1 = (q + rng.normal(scale=1e-3, size=3)).astype(np.float32)
            r2, r3 = r1.copy(), r1.copy()
            r2[0] = np.nextafter(r1[0], np.float32(np.inf))
            r3[1] = np.nextafter(r1[1], np.float32(-np.inf))
            slots = rng.permutation(k)[:3] if k > 1 else (0, 0, 0)  # k = 1: one tile, three lanes
            for r, c in zip((r1, r2, r3), slots):
                flat[t[c] * s + rng.integers(s)] = r
    elif base == "mixed sentinel":
        tiles[rng.uniform(size=(n_tiles, s)) < 0.33] = PAD_COORD
    elif base == "all sentinel":
        tiles[-2:] = PAD_COORD
        cand[0] = [n_tiles - 1 - (c % 2) for c in range(k)]
    elif base == "pad queries":
        query[rng.uniform(size=(tq, sq)) < 0.25] = PAD_COORD
    elif base == "far queries":
        query += np.float32(2e5)
    elif base != "random":
        raise KeyError(name)
    order = np.where((np.abs(tiles) < 1e6).all(2), np.arange(n_tiles * s).reshape(n_tiles, s), -1)
    index = _finish_index(torch.as_tensor(tiles, device=device),
                          torch.as_tensor(order.reshape(-1), dtype=torch.int32, device=device))
    if name == "rows beyond R":
        mid = index.tiles.mean(1)
        index = TileIndex(tiles=index.tiles, box_lo=mid, box_hi=mid, centroids=mid, order=index.order)
    payload = rng.normal(size=(n_tiles * s, 6)).astype(np.float32)
    return (torch.as_tensor(query, device=device), index, torch.as_tensor(cand, device=device),
            torch.as_tensor(payload, device=device))


def _fold6_bound(query, o):
    """(bound ms, "bytes" or "operations", operations, far queries) of one
    fold6 call on `query` with operands `o`. The operations this run's data
    needs of the kernel's method: each staged row packed (8 a row a query
    tile); for a query below the far limit, every pair screened (3 FFMA =
    6, and a min) and at least its least group of 8 rows rescored in the
    direct form (8 a row); for a far (pad) query, the direct scan (8 a
    pair). The second groups (<1% of the queries) and the other direct
    scans are left out: a lower bound. The bytes: queries, index tiles,
    candidates and boxes read once, d2 and payload rows written once."""
    tq, sq, _ = query.shape
    n, k, s = tq * sq, o.cand.shape[1], o.tiles.shape[1]
    far = int((query.abs().amax(-1) >= 5e5).sum())
    n_ops = tq * k * s * 8.0 + (n - far) * (k * s * 7.0 + 8 * 8.0) + far * k * s * 8.0
    bytes_moved = (n * 12 + o.tiles.numel() * 4 + tq * k * 4 + o.box_lo.numel() * 8
                   + o.payload.numel() * 4 + n * (4 + 4 * o.payload.shape[1]))
    return (*_bound(bytes_moved, n_ops), n_ops, far)


def _fold7_bound(query, o):
    """(bound ms, "bytes" or "operations", operations) of one fold7 call:
    every pair scored (FMUL, 2 FFMA and FADD = 6, and a min), each staged
    row's operands made (3 FSUB, 3 FMUL and 2 FADD for rr, 3 doublings:
    11), and each query's winning group of 8 rows made and scored again (8
    x 17). The direct scans are left out: a lower bound."""
    tq, sq, _ = query.shape
    n, k, s = tq * sq, o.cand.shape[1], o.tiles.shape[1]
    n_ops = n * k * s * 7.0 + tq * k * s * 11.0 + n * 8 * 17.0
    bytes_moved = (n * 12 + o.tiles.numel() * 4 + tq * k * 4 + tq * 12
                   + o.payload.numel() * 4 + n * (4 + 4 * o.payload.shape[1]))
    return (*_bound(bytes_moved, n_ops), n_ops)


def _select_bound(pos, cand, table):
    """(bound ms, "bytes" or "operations") of one select call: positions and
    candidates read once, each table row the positions name read once (the
    rest of the table is not needed), the rows written once; one compare a
    candidate slot."""
    n, (tq, k), d_pl = pos.numel(), cand.shape, table.shape[1]
    rows = torch.unique(pos).numel()
    return _bound(n * 4 + tq * k * 4 + rows * d_pl * 4 + n * d_pl * 4, float(n * k))


# the refine-stride mid phase's strides (`_mid_configs`): every 2nd and every
# 4th row of each query tile
MID_STRIDES = (2, 4)


def _mid_views(query):
    """The refine-stride mid phase's query tiles: every MID_STRIDES-th row
    of each tile of `query` (16,384 x 32 and x 16 on the 1M flagship), keyed
    by the JSON suffix of their times (_sq32, _sq16)."""
    return {f"_sq{query.shape[1] // st}": query[:, ::st].contiguous() for st in MID_STRIDES}


def _mid_text(timed, views, library=False):
    """The mid phase's shapes' times for a kernel's line."""
    parts = []
    for sfx, q in views.items():
        lib = f", table[pos] device {timed['library_device_ms' + sfx]:.4f}" if library else ""
        parts.append(f"{tuple(q.shape)}: device {timed['device_ms' + sfx]:.4f} ms, event "
                     f"{timed['ms' + sfx]:.4f}, plain {timed['plain_ms' + sfx]:.3f}{lib}, bound "
                     f"{timed['bound_ms' + sfx]:.4f}")
    return "; ".join(parts)


def _fold6_equal(name, query, ops):
    """fold6 against its plain version on `query` with prepared operands
    `ops`: fail unless d2 and payload are bit-equal on every row; (kernel
    d2, kernel payload, max |dd2|)."""
    from icpx_torch.kernels import blocknn_cuda

    d_k, pl_k = blocknn_cuda.fold6_cuda(query, ops)
    d_p, pl_p = blocknn_cuda.fold6_reference(query, ops)
    torch.cuda.synchronize()
    # the same d2 bits and the same winner on every row
    if not (torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)) and torch.equal(pl_k, pl_p)):
        _fail(f"fold6 {name}: kernel and plain differ on "
              f"{int(((d_k != d_p) | (pl_k != pl_p).any(1)).sum())} rows")
    return d_k, pl_k, _max_err(d_k, d_p)


def _phase_fold6(dev, query, cand, tgt_index, table, table12, fixtures):
    """Kernel #3 against its plain version at the shapes of one flagship
    refine iteration (16,384 x 64 queries, k = 6 frozen candidates, the
    fused (T*S, 6) table of the symmetric objective and GICP's (T*S, 12)
    one) and at the mid phase's strided query tiles (`_mid_views`, the
    same candidates), bit for bit on every row, plus the tie and miss
    fixtures and each screen fixture (`fold6_fixture`) at each of
    FOLD6_FIXTURE_SHAPES; times at D = 6, at D = 12 (under *_d12) and at
    the mid phase's shapes (under *_sq32, *_sq16); returns its JSON
    fields."""
    from icpx_torch.kernels import blocknn_cuda

    ops = blocknn_cuda.fold6_prepare(cand, tgt_index, table)
    ops12 = blocknn_cuda.fold6_prepare(cand, tgt_index, table12)
    d, _, err = _fold6_equal(f"{tuple(query.shape)} k=6", query, ops)
    _, _, err12 = _fold6_equal(f"{tuple(query.shape)} k=6 D=12", query, ops12)
    views = _mid_views(query)
    for q in views.values():
        err = max(err, _fold6_equal(f"{tuple(q.shape)} k=6", q, ops)[2])
    fq, f_index, f_cand, f_payload = fixtures
    f_ops = blocknn_cuda.fold6_prepare(f_cand, f_index, f_payload)
    fd, fpl, fx_err = _fold6_equal("fixtures", fq, f_ops)
    if [float(fpl[0, 0]), float(fpl[1, 0])] != [9.0, 18.0] or float(fd[0]) != 0.0:
        _fail("fold6 fixtures: tie rule broken (least d2, lowest lane, earliest candidate)")
    if not (bool(torch.isinf(fd[8:14]).all()) and float(fpl[8, 0]) == 32.0):
        _fail("fold6 fixtures: a tile of all-sentinel candidates must miss onto its first sentinel row")
    for shape in FOLD6_FIXTURE_SHAPES:
        for name in FOLD6_FIXTURES:
            x_query, x_index, x_cand, x_payload = fold6_fixture(name, *shape, n_tiles=max(12, shape[3] + 2),
                                                                device=dev)
            _, _, e = _fold6_equal(f"fixture {name} {shape}", x_query,
                              blocknn_cuda.fold6_prepare(x_cand, x_index, x_payload))
            fx_err = max(fx_err, e)
    tq, sq, _ = query.shape
    n, k, s = tq * sq, cand.shape[1], tgt_index.tile_size
    timed, bounds = {}, {}
    for suffix, q, o in (("", query, ops), ("_d12", query, ops12), *((x, q, ops) for x, q in views.items())):
        bounds[suffix] = _fold6_bound(q, o)
        timed.update({f"ms{suffix}": _event_ms(lambda: blocknn_cuda.fold6_cuda(q, o)),
                      f"device_ms{suffix}": _graph_ms(lambda: blocknn_cuda.fold6_cuda(q, o)),
                      f"plain_ms{suffix}": _event_ms(lambda: blocknn_cuda.fold6_reference(q, o)),
                      f"bound_ms{suffix}": bounds[suffix][0]})
    _, bound_by, n_ops, far = bounds[""]
    prepare_ms = _event_ms(lambda: blocknn_cuda.fold6_prepare(cand, tgt_index, table))
    # the kernel's shape lives in the built library; a rehearsal off the card has none
    if dev.type == "cuda":
        shape = blocknn_cuda.fold6_shape()
        plan = blocknn_cuda.fold6_plan(tq, sq, s, k, shape)
        shape_text = (f"{shape.threads} threads, {shape.queries_per_thread} queries a thread, groups "
                      f"of {shape.group} rows, stages of {shape.stage_rows} rows; plan: "
                      f"{plan['tiles_per_block']} query tiles a block, {plan['stages']} stages of "
                      f"{plan['lanes_per_stage']} lanes, grid {plan['blocks']}")
    else:
        shape_text = "no kernel shape (no CUDA device)"
    print(f"fold6 kernel vs plain {tuple(query.shape)} k=6: d2 and payload bit-equal on all {n} rows "
          f"({int(torch.isfinite(d).sum())} hits), with the 6- and the 12-wide table; fixtures ok "
          f"(ties, misses, padded rows; {', '.join(FOLD6_FIXTURES)} at (tq, sq, s, k) "
          f"{', '.join(map(str, FOLD6_FIXTURE_SHAPES))}); D=6: kernel {timed['ms']:.4f} ms, plain "
          f"{timed['plain_ms']:.3f} ms (CUDA "
          f"events around one call, median of 5), device time (CUDA graph replay) kernel "
          f"{timed['device_ms']:.4f} ms, bound {timed['bound_ms']:.4f} ms ({bound_by}: {n_ops:.6g} "
          f"operations, {far} far queries); D=12: kernel "
          f"{timed['ms_d12']:.4f} ms, plain {timed['plain_ms_d12']:.3f} ms, device time kernel "
          f"{timed['device_ms_d12']:.4f} ms, bound {timed['bound_ms_d12']:.4f} ms; the mid phase's "
          f"shapes, D=6, bit-equal too: {_mid_text(timed, views)}; fold6_prepare "
          f"{prepare_ms:.4f} ms (events, once a phase); {shape_text}")
    return dict(max_abs_err=max(err, err12, fx_err), bound_by=bound_by, library_ms=None,
                prepare_ms=prepare_ms, **timed)


FOLD7_FIXTURES = ("random", "exact ties", "near ties", "mixed sentinel", "all sentinel",
                  "pad queries", "far queries", "tiny products")
# (tq, sq, s, k) of the fold7 fixtures on the card, one for each kind of
# fold7_plan: the 1M refine plan (8 tiles a block, 7 stages of 20 lanes)
# with a block that is not full; a block short of its 25 tiles; Sq not a
# multiple of 4 with S over 13 stages; k x S above 3,072 rows (32 stages);
# a tile over two blocks with S over two stages; one query a tile, S not a
# multiple of 4 (4-byte copies) and stages of 2 lanes; k = 200, which caps a
# block at 5 tiles of one lane a stage; 4 tiles a block of 40 lanes a stage;
# and the refine-stride mid phase's query tiles (32 and 16 queries, blocks
# of 16 and 32 tiles that these 8 do not fill)
FOLD7_FIXTURE_SHAPES = ((12, 64, 128, 6), (9, 20, 32, 4), (3, 30, 100, 6), (2, 64, 512, 8),
                        (5, 600, 2000, 1), (9, 3, 13, 3), (4, 8, 8, 200), (4, 128, 128, 6),
                        (8, 32, 128, 6), (8, 16, 128, 6))


def fold7_fixture(name, tq=6, sq=20, s=32, k=4, n_tiles=12, device="cpu"):
    """One fold7 fixture, made with numpy from a seed: (query tiles (tq, sq,
    3), TileIndex, cand (tq, k), q_cent (tq, 3), payload (n_tiles * s, 6)),
    on `device`. The kinds of `fold6_fixture` but its "rows beyond R" (a
    test of fold6's screen alone), with each query tile's valid-query
    centroid as q_cent, as the frozen phase gives it ("exact ties": rounded
    to integers, so that every operand and score is exact and ties stay
    ties), and "tiny products": coordinates of magnitude 2^-76 to 2^-63, so
    that products a B are subnormal and some lose bits; there the kernel's
    4-instruction score is not the contract's, and it must take its direct
    scan."""
    from icpx_torch.kernels.blocknn import _finish_index, _query_boxes

    if name == "tiny products":
        rng = np.random.default_rng(7 * s + k + 1)

        def tiny(shape):
            mag = rng.uniform(1, 2, shape) * np.exp2(-rng.integers(64, 77, shape).astype(np.float64))
            return (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)

        tiles = torch.as_tensor(tiny((n_tiles, s, 3)), device=device)
        index = _finish_index(tiles, torch.arange(n_tiles * s, dtype=torch.int32, device=device))
        query = torch.as_tensor(tiny((tq, sq, 3)), device=device)
        cand = torch.as_tensor(rng.integers(0, n_tiles, (tq, k)), device=device)
        payload = torch.as_tensor(rng.normal(size=(n_tiles * s, 6)).astype(np.float32), device=device)
    else:
        query, index, cand, payload = fold6_fixture(name, tq, sq, s, k, n_tiles, device)
    q_cent = _query_boxes(query)[2]
    if name == "exact ties":
        q_cent = torch.round(q_cent)
    return query, index, cand, q_cent, payload


def _phase_fold7(dev, query, cand, q_cent, tgt_index, table, table12, fixtures):
    """Kernel #4 against its plain version at the shapes of one flagship
    refine iteration (operands centred on the query tiles' own centroids, as
    the frozen phase gives them; the fused (T*S, 6) table of the symmetric
    objective and GICP's (T*S, 12) one) and at the mid phase's strided
    query tiles (`_mid_views`, centred on the full tiles' centroids as the
    mid phase runs them), bit for bit on every row, plus the tie and miss
    fixtures and each fold7 fixture (`fold7_fixture`) at each of
    FOLD7_FIXTURE_SHAPES, which reach every kind of plan; times at D = 6,
    at D = 12 (under *_d12) and at the mid phase's shapes (under *_sq32,
    *_sq16); returns its JSON fields."""
    from icpx_torch.kernels import blocknn_cuda

    def compare(name, query, ops):
        d_k, pl_k = blocknn_cuda.fold7_cuda(query, ops)
        d_p, pl_p = blocknn_cuda.fold7_reference(query, ops)
        torch.cuda.synchronize()
        # the same bf16 operands, product order and scan order: the same d2 bits and winner
        if not (torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)) and torch.equal(pl_k, pl_p)):
            _fail(f"fold7 {name}: kernel and plain differ on "
                  f"{int(((d_k != d_p) | (pl_k != pl_p).any(1)).sum())} rows")
        return d_k, pl_k, _max_err(d_k, d_p)

    ops = blocknn_cuda.fold7_prepare(cand, q_cent, tgt_index, table)
    ops12 = blocknn_cuda.fold7_prepare(cand, q_cent, tgt_index, table12)
    d, _, err = compare(f"{tuple(query.shape)} k=6", query, ops)
    _, _, err12 = compare(f"{tuple(query.shape)} k=6 D=12", query, ops12)
    views = _mid_views(query)
    for q in views.values():
        err = max(err, compare(f"{tuple(q.shape)} k=6", q, ops)[2])
    fq, f_index, f_cand, f_payload = fixtures
    f_ops = blocknn_cuda.fold7_prepare(f_cand, torch.zeros((2, 3), device=dev), f_index, f_payload)
    fd, fpl, fx_err = compare("fixtures", fq, f_ops)
    if [float(fpl[0, 0]), float(fpl[1, 0])] != [9.0, 18.0] or float(fd[0]) != 0.0:
        _fail("fold7 fixtures: tie rule broken (least score, lowest lane, earliest candidate)")
    if not (bool(torch.isinf(fd[8:14]).all()) and float(fpl[8, 0]) == 32.0):
        _fail("fold7 fixtures: a tile of all-sentinel candidates must miss onto its first sentinel row")
    for shape in FOLD7_FIXTURE_SHAPES:
        for name in FOLD7_FIXTURES:
            x_query, x_index, x_cand, x_cent, x_payload = fold7_fixture(
                name, *shape, n_tiles=max(12, shape[3] + 2), device=dev)
            _, _, e = compare(f"fixture {name} {shape}", x_query,
                              blocknn_cuda.fold7_prepare(x_cand, x_cent, x_index, x_payload))
            fx_err = max(fx_err, e)
    tq, sq, _ = query.shape
    n, k, s = tq * sq, cand.shape[1], tgt_index.tile_size
    timed, bounds = {}, {}
    for suffix, q, o in (("", query, ops), ("_d12", query, ops12), *((x, q, ops) for x, q in views.items())):
        bounds[suffix] = _fold7_bound(q, o)
        timed.update({f"ms{suffix}": _event_ms(lambda: blocknn_cuda.fold7_cuda(q, o)),
                      f"device_ms{suffix}": _graph_ms(lambda: blocknn_cuda.fold7_cuda(q, o)),
                      f"plain_ms{suffix}": _event_ms(lambda: blocknn_cuda.fold7_reference(q, o)),
                      f"bound_ms{suffix}": bounds[suffix][0]})
    _, bound_by, n_ops = bounds[""]
    prepare_ms = _event_ms(lambda: blocknn_cuda.fold7_prepare(cand, q_cent, tgt_index, table))
    # the kernel's shape lives in the built library; a rehearsal off the card has none
    if dev.type == "cuda":
        shape = blocknn_cuda.fold7_shape()
        plan = blocknn_cuda.fold7_plan(tq, sq, s, k, shape)
        shape_text = (f"{shape.threads} threads, {shape.queries_per_thread} queries a thread, groups "
                      f"of {shape.group} rows, stages of {shape.stage_rows} rows; plan: "
                      f"{plan['tiles_per_block']} query tiles a block, {plan['stages']} stages of "
                      f"{plan['lanes_per_stage']} lanes, grid {plan['blocks']}")
    else:
        shape_text = "no kernel shape (no CUDA device)"
    print(f"fold7 kernel vs plain {tuple(query.shape)} k=6: d2 and payload bit-equal on all {n} rows "
          f"({int(torch.isfinite(d).sum())} hits), with the 6- and the 12-wide table; fixtures ok "
          f"(ties, misses, padded rows; {', '.join(FOLD7_FIXTURES)} at (tq, sq, s, k) "
          f"{', '.join(map(str, FOLD7_FIXTURE_SHAPES))}); D=6: kernel {timed['ms']:.4f} ms, plain "
          f"{timed['plain_ms']:.3f} ms (CUDA events around one call, median of 5), device time "
          f"(CUDA graph replay) kernel {timed['device_ms']:.4f} ms, bound {timed['bound_ms']:.4f} ms "
          f"({bound_by}: {n_ops:.6g} operations); D=12: kernel {timed['ms_d12']:.4f} ms, plain "
          f"{timed['plain_ms_d12']:.3f} ms, device time kernel {timed['device_ms_d12']:.4f} ms, bound "
          f"{timed['bound_ms_d12']:.4f} ms; the mid phase's shapes, D=6, bit-equal too: "
          f"{_mid_text(timed, views)}; fold7_prepare {prepare_ms:.4f} ms (events, once a phase); "
          f"{shape_text}")
    return dict(max_abs_err=max(err, err12, fx_err), bound_by=bound_by, library_ms=None,
                prepare_ms=prepare_ms, **timed)


def _phase_select(dev, query, cand, tgt_index, table, table12, fixtures):
    """Kernel #5 against its plain version and against the row gather
    `table[pos]` (one PyTorch call for the same function on hits, the
    library yardstick) at the flagship's refine shapes, with the positions
    the plain frozen-candidate fold gives, at every chunk width: the 6-wide
    table (float2), GICP's 12-wide one (float4), a 7-wide one and a 12-wide
    view 4 bytes off 16-byte alignment (both scalar), and with the 6-wide
    table at the mid phase's strided query tiles (`_mid_views`); times at D
    = 6, at D = 12 and at the mid phase's shapes (under *_sq32, *_sq16);
    plus the fixtures (a candidate tile listed four times quadruples its
    row)."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import block_nn

    def positions(q):
        _, p = block_nn(q, tgt_index, return_pos=True, cand_tiles=cand)
        return p.reshape(q.shape[0], q.shape[1])

    tq, sq, _ = query.shape
    pos = positions(query)
    views = _mid_views(query)
    mids = {sfx: positions(q) for sfx, q in views.items()}
    cand32 = cand.to(torch.int32)
    s = tgt_index.tile_size
    n_rows = table.shape[0]
    shifted = torch.empty(n_rows * 12 + 1, dtype=torch.float32, device=dev)[1:].view(n_rows, 12)
    shifted.copy_(table12)
    tables = {"D=6": (pos, table, 2), "D=12": (pos, table12, 4),
              "D=7": (pos, table12[:, :7].contiguous(), 1), "D=12, 4 bytes off alignment": (pos, shifted, 1)}
    tables.update({f"D=6, {tuple(p.shape)}": (p, table, 2) for p in mids.values()})
    err = 0.0
    for label, (p, t, width) in tables.items():
        if blocknn_cuda.select_width(t) != width:
            _fail(f"select ({label}): chunks of {blocknn_cuda.select_width(t)} floats, want {width}")
        out_k = blocknn_cuda.select_cuda(p, cand32, t, s)
        out_p = blocknn_cuda.select_reference(p, cand, t, s)
        gathered = t[p.reshape(-1).long()]
        torch.cuda.synchronize()
        if not (torch.equal(out_k, out_p) and torch.equal(out_k, gathered)):
            _fail(f"select ({label}): kernel, plain version and row gather differ on "
                  f"{int(((out_k != out_p) | (out_k != gathered)).any(1).sum())} rows")
        err = max(err, _max_err(out_k, out_p))
    del shifted, tables
    fq, f_index, f_cand, f_payload = fixtures
    f_pos = torch.tensor([[9, 3, 17, 30, 0, 0, 0, 0], [32, 33, 39, 9, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    fx_k = blocknn_cuda.select_cuda(f_pos, f_cand.to(torch.int32), f_payload, 8)
    fx_p = blocknn_cuda.select_reference(f_pos, f_cand, f_payload, 8)
    want = f_payload[f_pos.reshape(-1).long()] * torch.tensor(
        [1, 1, 1, 1, 1, 1, 1, 1, 4, 4, 4, 0, 0, 0, 0, 0], dtype=torch.float32, device=dev)[:, None]
    if not (torch.equal(fx_k, fx_p) and torch.equal(fx_k, want)):
        _fail("select fixtures: hits, misses or a quadrupled candidate tile came out wrong")
    err = max(err, _max_err(fx_k, fx_p))
    n = tq * sq
    timed, bounds = {}, {}
    for suffix, p, t in (("", pos, table), ("_d12", pos, table12), *((x, p, table) for x, p in mids.items())):
        flat = p.reshape(-1).long()
        bounds[suffix] = _select_bound(p, cand, t)
        timed.update({f"ms{suffix}": _event_ms(lambda: blocknn_cuda.select_cuda(p, cand32, t, s)),
                      f"plain_ms{suffix}": _event_ms(lambda: blocknn_cuda.select_reference(p, cand, t, s)),
                      f"library_ms{suffix}": _event_ms(lambda: t[flat]),
                      f"device_ms{suffix}": _graph_ms(lambda: blocknn_cuda.select_cuda(p, cand32, t, s)),
                      f"library_device_ms{suffix}": _graph_ms(lambda: t[flat]),
                      f"bound_ms{suffix}": bounds[suffix][0]})
    bound_by = bounds[""][1]
    print(f"select kernel vs plain {tuple(pos.shape)} k=6: payload equal on all {n} rows and "
          "equal to table[pos] with the 6-wide (float2), 12-wide (float4), 7-wide and misaligned "
          "12-wide (scalar) tables; fixtures ok (misses, a tile listed 4 times); "
          f"D=6: kernel {timed['ms']:.4f} ms, plain {timed['plain_ms']:.3f} ms, table[pos] "
          f"{timed['library_ms']:.4f} ms (CUDA events around one call, median of 5), device time "
          f"(CUDA graph replay) kernel {timed['device_ms']:.4f} ms, table[pos] "
          f"{timed['library_device_ms']:.4f} ms, bound {timed['bound_ms']:.4f} ms ({bound_by}); "
          f"D=12: kernel {timed['ms_d12']:.4f} ms, plain {timed['plain_ms_d12']:.3f} ms, table[pos] "
          f"{timed['library_ms_d12']:.4f} ms, device time kernel {timed['device_ms_d12']:.4f} ms, "
          f"table[pos] {timed['library_device_ms_d12']:.4f} ms, bound {timed['bound_ms_d12']:.4f} ms; "
          f"the mid phase's shapes, D=6, equal too: "
          f"{_mid_text(timed, views, library=True)}")
    return dict(max_abs_err=err, bound_by=bound_by, **timed)


def _phase_fused4(dev, query, tgt_index, fixtures, group=4, u_max=32):
    """Kernel #6 against its plain version at the flagship's refine shapes
    (groups of 4 query tiles, k = 6, unions of up to 32 tiles), plus the
    fixtures; returns its JSON fields with the union sizes."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import _candidate_tiles

    def compare(name, query, tiles, unions, group):
        d_k, pos_k = blocknn_cuda.fused4_cuda(query, tiles, unions, group)
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
    ms = _event_ms(lambda: blocknn_cuda.fused4_cuda(query, tgt_index.tiles, unions, group))
    device_ms = _graph_ms(lambda: blocknn_cuda.fused4_cuda(query, tgt_index.tiles, unions, group))
    plain_ms = _event_ms(lambda: blocknn_cuda.fused4_reference(query, tgt_index.tiles, unions, group))
    tq, sq, _ = query.shape
    n, s = tq * sq, tgt_index.tile_size
    shape = blocknn_cuda.fused4_shape()
    plan = blocknn_cuda.fused4_plan(group * sq, s, int(sizes.max()), shape)
    pairs = float(sizes.sum()) * s * group * sq  # the union slots in use, as scored
    bytes_moved = n * 12 + tgt_index.tiles.numel() * 4 + unions.numel() * 4 + n * 8
    # a pair: 4 FMUL (the x2 included) + 2 FADD + 1 FSUB
    bound_ms, bound_by = _bound(bytes_moved, pairs * 7.0)
    print(f"fused4 kernel vs plain {tuple(query.shape)} k=6 group={group}: d2 and pos equal on "
          f"all {n} rows ({int(torch.isfinite(d).sum())} hits); unions of {float(sizes.mean()):.2f} "
          f"tiles on average, {int(sizes.max())} at most (of {u_max}); fixtures ok (ties, "
          f"padded union, misses); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events around "
          f"one call, median of 5), device time (CUDA graph replay) kernel {device_ms:.4f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}); {pairs:.4g} pairs, {shape.queries_per_thread} "
          f"queries a thread, {shape.lane_threads} threads a quad's lanes, chunks of "
          f"{shape.chunk_rows} rows ({plan['lanes_per_chunk']} lanes at the largest union)")
    return dict(max_abs_err=max(err, fx_err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, device_ms=device_ms,
                union_mean=float(sizes.mean()), union_max=int(sizes.max()))


def _level_shapes(build):
    """Run build() with the KD build's level sort recorded: (its result, the
    (c, m) key shapes in launch order)."""
    from icpx_torch.kernels import blocknn

    shapes, real = [], blocknn.sort_segments

    def recording(key, payloads=()):
        shapes.append(tuple(key.shape))
        return real(key, payloads)

    blocknn.sort_segments = recording
    try:
        out = build()
    finally:
        blocknn.sort_segments = real
    return out, shapes


def _plain_build(build):
    """build() with the KD build's level sorts on the sort kernel's plain
    version (`torch.sort(stable=True)` + `take_along_dim`)."""
    from icpx_torch.kernels import blocknn, sort_cuda

    real = blocknn.sort_segments
    blocknn.sort_segments = sort_cuda.sort_segments_reference
    try:
        return build()
    finally:
        blocknn.sort_segments = real


def _kd_equal(label, xyz, mask, s):
    """Build the KD index of (xyz, mask) at tiles of s through the sort
    kernel, once a level, and fail unless it equals the plain build bit for
    bit: (the build, its index, the level shapes)."""
    from icpx_torch.kernels.blocknn import build_kd_index
    from icpx_torch.utils.profiling import LAUNCHES

    def build():
        return build_kd_index(xyz, mask, tile_size=s)

    before = LAUNCHES["sort"]
    got, shapes = _level_shapes(build)
    if LAUNCHES["sort"] - before != len(shapes):
        _fail(f"{label} (tiles of {s}): {len(shapes)} level sorts but "
              f"{LAUNCHES['sort'] - before} kernel launches")
    want = _plain_build(build)
    torch.cuda.synchronize()
    for f in ("tiles", "order", "box_lo", "box_hi", "centroids"):
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b):
            _fail(f"{label} (tiles of {s}): {f} differs from the plain build")
    return build, got, shapes


def _phase_kd(dev, f_src, f_tgt):
    """The flagship's KD indexes (the target's at tiles of 128, the
    source's at 64) built through the sort kernel must equal the plain
    builds bit for bit; returns {tile size: level shapes, "n": points}."""
    shapes = {"n": f_tgt.capacity}
    for s, cloud in ((128, f_tgt), (64, f_src)):
        build, got, shapes[s] = _kd_equal("KD build", cloud.xyz, cloud.mask, s)
        ms_k = _event_ms(build, reps=3)
        ms_p = _event_ms(lambda: _plain_build(build), reps=3)
        print(f"KD index {tuple(got.tiles.shape)}: equal to the plain build bit for bit (tiles, "
              f"order, boxes, centroids); level sorts {shapes[s]}; build {ms_k:.3f} ms through "
              f"the kernel, {ms_p:.3f} ms plain (CUDA events, median of 3)")
    return shapes


def _sort_fixture(dev):
    """Duplicate-heavy keys (stability), PAD_COORD keys in every other
    segment (they sink to the tail in order) and signed zeros (equal keys
    that keep their own bits), (c, m) = (8, 256)."""
    from icpx_torch.cloud import PAD_COORD

    rng = np.random.default_rng(5)
    key = (rng.integers(-8, 8, size=(8, 256)) * 0.5).astype(np.float32)
    key[rng.uniform(size=key.shape) < 0.1] = -0.0
    key[::2, ::3] = PAD_COORD
    return torch.as_tensor(key, device=dev)


def _sort_operands(dev, c, m, seed):
    """A KD level sort's operands at (c, m): duplicate-heavy keys, a (c, m,
    3) f32 coordinate payload and a (c, m) i32 index payload."""
    g = torch.Generator(device=dev).manual_seed(seed)
    key = torch.randint(-m // 8 - 1, m // 8 + 1, (c, m), generator=g, device=dev).float() * 0.5
    xyz = torch.randn((c, m, 3), generator=g, device=dev)
    orig = torch.randperm(c * m, generator=g, device=dev).to(torch.int32).reshape(c, m)
    return key, xyz, orig


def _phase_sort(dev, shapes):
    """Kernel #8 against its plain version (which is also the library call:
    `torch.sort(stable=True)` + `take_along_dim`) on KD-build payloads
    ((c, m, 3) f32 coordinates, (c, m) i32 indices), bit for bit, at every
    level shape of the flagship's builds, at 16 x 65,536 (the largest
    segment a build sorts), (3, 2), and on the fixture; times the tile-128
    build's levels summed."""
    from icpx_torch.kernels import sort_cuda

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    err = 0.0

    def compare(name, key, xyz, orig):
        nonlocal err
        got = sort_cuda.sort_cuda(key, [xyz, orig])
        want = sort_cuda.sort_segments_reference(key, [xyz, orig])
        torch.cuda.synchronize()
        # the largest |difference| over the key and both payloads (the index
        # as float64, exact); bit equality also tells -0.0 from +0.0
        case_err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
        err = max(err, case_err)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            _fail(f"sort {name}: kernel and plain version differ (max |diff| {case_err:.3e})")
        return got[0]

    from icpx_torch.cloud import PAD_COORD

    key = _sort_fixture(dev)
    c, m = key.shape
    sk = compare("fixture", key, torch.randn((c, m, 3), device=dev),
                 torch.arange(c * m, dtype=torch.int32, device=dev).reshape(c, m))
    if not bool((sk[::2, -(m // 3):] == PAD_COORD).all()):
        _fail("sort fixture: sentinel keys did not sink to the tail")
    if not bool((torch.signbit(sk) & (sk == 0)).any()):
        _fail("sort fixture: -0.0 keys lost their sign bit")
    cases = sorted(set(shapes[128]) | set(shapes[64]) | {(16, 65536), (3, 2)})
    timed = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0, "library_device_ms": 0.0}
    k_shape = sort_cuda.kernel_shape()
    for i, (c, m) in enumerate(cases):
        key, xyz, orig = _sort_operands(dev, c, m, i)
        compare(f"{c}x{m}", key, xyz, orig)
        if (c, m) in shapes[128]:
            ms = _event_ms(lambda: sort_cuda.sort_cuda(key, [xyz, orig]))
            plain_ms = _event_ms(lambda: sort_cuda.sort_segments_reference(key, [xyz, orig]))
            device_ms = _graph_ms(lambda: sort_cuda.sort_cuda(key, [xyz, orig]))
            plain_device_ms = _graph_ms(lambda: sort_cuda.sort_segments_reference(key, [xyz, orig]))
            bound, _ = _bound(c * m * 2 * (4 + 12 + 4), 0.0)
            for name, t in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                            ("device_ms", device_ms), ("library_device_ms", plain_device_ms)):
                timed[name] += t
            plan = sort_cuda.plan(c, m, k_shape)
            print(f"sort kernel vs plain {c}x{m}: bit-equal; kernel {ms:.4f} ms, plain = torch.sort "
                  f"+ take_along_dim {plain_ms:.4f} ms (CUDA events around one call, median of 5); "
                  f"device time (CUDA graph replay) kernel {device_ms:.4f} ms, plain "
                  f"{plain_device_ms:.4f} ms; bound {bound:.4f} ms (bytes); {plan['path']} path, "
                  f"{plan['blocks']} blocks of {k_shape.block_elems} keys")
    print(f"sort kernel vs plain: bit-equal at {cases} and on the fixture (duplicates, "
          f"sentinels, +-0); the tile-128 build's {len(shapes[128])} levels: kernel "
          f"{timed['ms']:.4f} ms, plain {timed['plain_ms']:.4f} ms (events), device time kernel "
          f"{timed['device_ms']:.4f} ms, plain {timed['library_device_ms']:.4f} ms, bound "
          f"{timed['bound_ms']:.4f} ms")
    # key, coordinates and index read once and written once; a few
    # compare-exchanges an element are far below the bytes' time
    return dict(max_abs_err=err, library_ms=timed["plain_ms"], bound_by="bytes", **timed)


def _cov_radius(cloud, k):
    """The covariance radius of `normals._block_radius_cov` for k neighbours."""
    from icpx_torch.kernels.voxel import auto_cell_size

    return auto_cell_size(cloud.xyz, cloud.mask, scale=3.0 * math.sqrt(max(k, 1) / 10.0))


def _score_margin(off_g: torch.Tensor, off_t: torch.Tensor) -> torch.Tensor:
    """Per query row, the relative radius growth that covers the fp32
    rounding of both radius tests on a border pair (d ~ r): the union
    kernel's score (((ax rx + ay ry) + az rz) + rr) + c, 5 roundings deep on
    every term, and the fold's 4-term product + qq, 7 deep, each off by at
    most gamma_n (|q| + |r|)^2 (+ r'^2 <= 4 r^2 for the kernel's c at a
    grown radius r'), plus 2 u d (|q| + |r|) from rounding the centred
    coordinates; on the border |r| <= |q| + 1.01 r. `off_g` and `off_t` are
    the row's offsets |q| from its group's and its tile's centroid, in
    radii. Returns delta with (1 + delta)^2 (1 - u) - 1 = (E_union +
    E_fold) / r^2 (float64)."""
    u = 2.0 ** -24

    def gamma(n):
        return n * u / (1 - n * u)

    b_g, b_t = 2 * off_g.double() + 1.01, 2 * off_t.double() + 1.01  # (|q| + |r|) / r
    e = gamma(5) * (b_g ** 2 + 4) + gamma(7) * b_t ** 2 + 2.02 * u * (b_g + b_t)
    return torch.sqrt((1 + e) / (1 - u)) - 1


def _phase_moments_fused(dev, f_tgt, group=4, u_max=32, k_tiles=8):
    """Kernel #7 against its plain version at the 1M covariance index (the
    flagship target's KD index of 128-point tiles, each its own query tile,
    GICP's radius for k = 15): counts equal on every row, means within
    1e-5, covariances within `_cov_tol`. Each group's union must hold
    every candidate tile of its query tiles, so its counts are at or above
    the plain XLA-style fold's (`block_radius_moments`) on every row, up to
    radius-border rows: both test an fp32 expansion score, centred on the
    group's centroid here and on the tile's there. At a radius larger by
    twice a row's `_score_margin` bound on that rounding (tried on a grid
    of growths, 1e-6 doubling) the row must count at or above. On the
    8,000-point fixture of the CPU tests, counts must also be equal at u_max
    8 (overflowing unions) and at the kernel's largest union. Returns its
    JSON fields with the union sizes."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import _candidate_tiles, block_radius_moments, build_kd_index

    # the kernel's shape lives in the built library; a rehearsal off the card
    # (main(dev=cpu), the plain version standing in) has none
    shape = blocknn_cuda.moments_fused_shape() if dev.type == "cuda" else None
    tile = 128  # both indexes' tile size
    gq = group * tile
    largest = blocknn_cuda.fused4_plan(gq, tile, 1, shape)["max_union"] if shape else u_max
    r = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (8000, 3)).astype(np.float32), device=dev)
    small = build_kd_index(r, tile_size=tile)
    s_cand, _ = _candidate_tiles(small.tiles, small, k_tiles)
    s_cent = blocknn_cuda.group_centroids(small.tiles, group)
    s_r2 = torch.tensor([0.15 ** 2], dtype=torch.float32, device=dev)
    for um in (8, largest):
        s_unions = blocknn_cuda.group_unions(s_cand, group, um)
        c_k = blocknn_cuda.moments_fused_cuda(small.tiles, small.tiles, s_unions, s_cent, s_r2, group)[0]
        c_p = blocknn_cuda.moments_fused_reference(small.tiles, small.tiles, s_unions, s_cent,
                                                   s_r2[0], group)[0]
        if not torch.equal(c_k, c_p):
            _fail(f"moments_fused 8,000-point fixture, u_max {um}: counts differ on "
                  f"{int((c_k != c_p).sum())} rows")
    del r, small, s_cand, s_cent

    idx = build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=tile)
    radius = _cov_radius(f_tgt, 15)
    cand, _ = _candidate_tiles(idx.tiles, idx, k_tiles)
    unions = blocknn_cuda.group_unions(cand, group, u_max)
    q_cent = blocknn_cuda.group_centroids(idx.tiles, group)
    r2 = (radius * radius).reshape(1).to(torch.float32)
    out_k = blocknn_cuda.moments_fused_cuda(idx.tiles, idx.tiles, unions, q_cent, r2, group)
    out_p = blocknn_cuda.moments_fused_reference(idx.tiles, idx.tiles, unions, q_cent, r2[0], group)
    torch.cuda.synchronize()
    if not torch.equal(out_k[0], out_p[0]):
        _fail(f"moments_fused: counts differ on {int((out_k[0] != out_p[0]).sum())} rows")
    if not bool(torch.isfinite(out_k).all()):
        _fail("moments_fused: moments not finite")
    (cnt, mean_k, cov_k), (_, mean_p, cov_p) = (
        blocknn_cuda.finish_union_moments(o, q_cent, gq) for o in (out_k, out_p))
    valid = idx.order >= 0
    mean_err = float((mean_k - mean_p)[valid].abs().max())
    if mean_err > 1e-5:
        _fail(f"moments_fused: means off by {mean_err:.3e}")
    comps = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    p6 = torch.stack([cov_p[:, i, j] for i, j in comps])
    k6 = torch.stack([cov_k[:, i, j] for i, j in comps])
    q_rows = q_cent.repeat_interleave(gq, 0)
    tol = 1e-4 * (p6[0] + p6[3] + p6[5]) + 1e-5 * ((mean_p - q_rows) ** 2).sum(1)
    cov_err = (k6 - p6).abs()[:, valid]
    over = float(torch.where(cov_err == 0, 0.0, cov_err / tol[valid]).max())
    if over > 1.0:
        _fail(f"moments_fused: a covariance is off by {over:.3g} x its tolerance")
    held = (cand[:, :, None] == unions.repeat_interleave(group, 0)[:, None, :]).any(2)
    if not bool(held.all()):
        _fail(f"moments_fused: {int((~held).sum())} candidate tiles missing from their unions")
    cnt_x, _, _ = block_radius_moments(idx.tiles, idx, radius, k_tiles=k_tiles)
    q = idx.tiles.reshape(-1, 3)
    _, t_cent = _candidate_tiles(idx.tiles, idx, k_tiles)  # the fold's centring points
    off_g, off_t = ((q - c.repeat_interleave(len(q) // len(c), 0)).norm(dim=1) / radius
                    for c in (q_cent, t_cent))
    margin = 2 * _score_margin(off_g, off_t)  # per row: twice its bound
    below0 = (cnt < cnt_x) & valid
    need = torch.where(below0, math.inf, 0.0).double()  # growth each row below needed
    growth = 1e-6
    while growth <= 2 * float(margin[valid].max()):
        c_g = blocknn_cuda.moments_fused_cuda(idx.tiles, idx.tiles, unions, q_cent,
                                              r2 * (1.0 + growth) ** 2, group)[0]
        below_g = (c_g < cnt_x) & valid
        fault = below_g & (margin <= growth)
        if bool(fault.any()):
            _fail(f"moments_fused: {int(fault.sum())} rows count fewer neighbours than "
                  f"block_radius_moments at a radius larger by {growth:.3e}, twice their "
                  "rounding bound or more")
        need = torch.where(below0 & ~below_g & (need > growth), growth, need)
        growth *= 2
    used = float((need / margin)[below0].max()) if bool(below0.any()) else 0.0
    below = int(below0.sum())
    above = int(((cnt > cnt_x) & valid).sum())
    sizes = ((unions[:, 1:] != unions[:, :1]).sum(1) + 1).to(torch.float32)
    padded = 1.0 - float(sizes.sum()) / unions.numel()
    if shape:
        plan = blocknn_cuda.fused4_plan(gq, idx.tile_size, int(sizes.max()), shape)
        shape_text = (f"{shape.threads} threads, {shape.queries_per_thread} queries a thread, "
                      f"{shape.lane_threads} threads a quad's lanes, chunks of {shape.chunk_rows} "
                      f"rows ({plan['lanes_per_chunk']} lanes at the largest union), unions of up "
                      f"to {largest} slots")
    else:
        shape_text = "no kernel shape (no CUDA device)"
    ms = _event_ms(lambda: blocknn_cuda.moments_fused_cuda(idx.tiles, idx.tiles, unions, q_cent, r2, group))
    device_ms = _graph_ms(lambda: blocknn_cuda.moments_fused_cuda(idx.tiles, idx.tiles, unions, q_cent,
                                                                  r2, group))
    plain_ms = _event_ms(lambda: blocknn_cuda.moments_fused_reference(
        idx.tiles, idx.tiles, unions, q_cent, r2[0], group), reps=3)
    n = idx.tiles.shape[0] * idx.tile_size
    pairs = float(sizes.sum()) * idx.tile_size * gq  # the distinct union rows, as scored
    inside = float(out_k[0].sum())  # pairs within the radius (slot 0 weighted): 20 more flops each
    bytes_moved = _input_bytes(idx.tiles, idx.tiles, unions, q_cent) + n * 40
    bound_ms, bound_by = _bound(bytes_moved, pairs * 8.0 + inside * 20.0)
    print(f"moments_fused kernel vs plain {tuple(idx.tiles.shape)} k={k_tiles} group={group} "
          f"radius {float(radius):.4e}: counts equal on all {n} rows (mean {float(cnt[valid].mean()):.2f}), "
          f"means within {mean_err:.3e}, covariances {over:.3g} x their tolerance; unions of "
          f"{float(sizes.mean()):.2f} distinct tiles on average, {int(sizes.max())} at most, "
          f"{100 * padded:.1f}% of the {u_max} slots padded; counts above block_radius_moments' "
          f"on {above} rows, below on {below} (radius-border rows); per-row margin (twice the "
          f"score rounding bound) {float(margin[valid].median()):.3e} of the radius at the median, "
          f"{float(margin[valid].max()):.3e} at most (query offsets {float(off_g[valid].median()):.2f} "
          f"r from the group's centroid at the median, {float(off_g[valid].max()):.2f} at most); "
          f"the rows below: margins {float(margin[below0].min()) if below else 0.0:.3e} to "
          f"{float(margin[below0].max()) if below else 0.0:.3e}, each at or above the fold's count "
          f"from a growth of at most {used:.3g} x its margin (1e-6 doubling grid); "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events around one call, median of "
          f"5; plain of 3), device time (CUDA graph replay) kernel {device_ms:.4f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}); 8,000-point fixture: counts equal at u_max 8 and "
          f"{largest}; {shape_text}")
    return dict(max_abs_err=max(mean_err, float(cov_err.max())), cov_err_over_tol=over, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                device_ms=device_ms,
                union_mean=float(sizes.mean()), union_max=int(sizes.max()), padded_share=padded,
                rows_below_xla=below, margin_used=used)


def _check_counts(label, counts, want):
    """Fail unless each kernel launched `want[kernel]` times (0 where not
    named)."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            _fail(f"{label}: {name} launched {n} times, want {want.get(name, 0)} ({counts})")


def _register_launches(cfg, res, n_src, n_tgt, normals=True, fold="fold6", extra_sorts=0):
    """What one register() call launches: on the block path the level
    sorts of its two KD builds (and `extra_sorts` from builds around it),
    moments6 twice where it estimates both clouds' normals and the fold
    `fold` once a refine iteration; on the brute path the nn kernel once an
    iteration."""
    from icpx_torch.kernels.blocknn import kd_level_sorts

    if cfg.resolve_nn(n_tgt) != "block":
        return {"nn": res.iters, "sort": extra_sorts}
    want = {"sort": extra_sorts + kd_level_sorts(n_src, cfg.resolve_q_tile(n_src))
            + kd_level_sorts(n_tgt, cfg.block_tile)}
    if normals:
        want["moments6"] = 2
    if fold:
        want[fold] = _refine_iters(res)
    return want


def _gated(label, fn, gt, rot_tol=5e-3, t_tol=5e-3):
    """Run fn (a registration) counted, hold it to the GT gate, then time it:
    (result, launches, rot, t, wall s (median of 3), peak MiB)."""
    res, counts = _counted(fn)
    rot, terr = (float(x) for x in res.transform.distance_to(gt))
    if not (math.isfinite(float(res.final_rmse)) and rot < rot_tol and terr < t_tol):
        _fail(f"{label}: GT not recovered (rot {rot:.3e}, t {terr:.3e})")
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _sync_time(fn, reps=3)
    return res, counts, rot, terr, wall, torch.cuda.max_memory_allocated() / 2**20


JAX_FLAGSHIP = "tests/data/jax_flagship_1m.json"
# The 1M flagship against the JAX package's result (rad, m, relative rmse).
# The witness `_hold_flagship_to_jax` prints beside the gaps: the port's
# "auto" run moves by rot 2.05e-6, t 1.83e-6 and rmse 7.7e-7 when every
# coordinate is scaled by 1 + 1e-7 (H100 80GB HBM3, 700 W); rot and t are
# held to ~5x that. The rmse also differs by design: the fold kernel's d2
# of a winner is the direct form, the plain fold's (and the JAX package's
# off the TPU) the expansion ||r||^2 - 2 q.r: 1.2e-5 apart on this pair
# (the line's "auto against gather"), "auto" 1.39e-5 from the JAX
# package's; held to ~3.5x that
FLAG_JAX_TOL = {"rot": 1e-5, "t": 1e-5, "rmse": 5e-5}


def _gaps(res, R, t, rmse):
    """(rot, t, relative rmse) of a registration from a transform and rmse."""
    from icpx_torch.geometry.se3 import SE3

    other = SE3(R=torch.as_tensor(R, dtype=torch.float64), t=torch.as_tensor(t, dtype=torch.float64))
    rot, dt = _transform_diff(res.transform, other)
    return {"rot": rot, "t": dt, "rmse": abs(float(res.final_rmse) - rmse) / rmse}


def _hold_flagship_to_jax(f_src, f_tgt, cfgs, results):
    """The flagship under "auto" (the kernels) and "gather" (plain torch)
    held to the JAX package's result on the same pair (`JAX_FLAGSHIP`):
    the same coarse and refine iterations, the transform and the final
    rmse within FLAG_JAX_TOL. Beside it the witness: how far the port's
    own "auto" run moves when every coordinate is scaled by 1 + 1e-7. Held
    where the pair is the file's (1,048,576 points); at other sizes only
    said so."""
    import os

    from icpx_torch.registration.icp import register

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), JAX_FLAGSHIP)) as f:
        ref = json.load(f)
    n = f_src.capacity
    if n != ref["n"]:
        print(f"flagship {n} against the JAX package: not held (its result is for {ref['n']} points)")
        return
    scale = 1.0 + 1e-7
    moved = register(f_src.with_xyz(f_src.xyz * scale), f_tgt.with_xyz(f_tgt.xyz * scale),
                     cfgs["kernels"])
    base = results["kernels"]
    witness = _gaps(moved, base.transform.R.cpu().double(), base.transform.t.cpu().double() * scale,
                    float(base.final_rmse) * scale)
    parts = []
    modes = _gaps(results["kernels"], results["plain"].transform.R.cpu().double(),
                  results["plain"].transform.t.cpu().double(), float(results["plain"].final_rmse))
    for label in ("kernels", "plain"):
        res = results[label]
        gaps = _gaps(res, ref["R"], ref["t"], ref["final_rmse"])
        iters = (int(res.iters) - _refine_iters(res), _refine_iters(res))
        if iters != (ref["coarse_iters"], ref["refine_iters"]) or any(
                gaps[k] > FLAG_JAX_TOL[k] for k in gaps):
            _fail(f"flagship ({label}) against the JAX package: iterations {iters} vs "
                  f"({ref['coarse_iters']}, {ref['refine_iters']}), gaps {gaps} (tolerance "
                  f"{FLAG_JAX_TOL})")
        parts.append(f"{label}: iterations {iters[0]} + {iters[1]} equal, rot {gaps['rot']:.2e}, "
                     f"t {gaps['t']:.2e}, rmse {gaps['rmse']:.2e} relative")
    print(f"flagship 1M against the JAX package ({JAX_FLAGSHIP}: JAX {ref['jax_version']} on the "
          f"{ref['platform']}, rmse {ref['final_rmse']:.7e}): " + "; ".join(parts)
          + f" (tolerance {FLAG_JAX_TOL}); witness, the port's 'kernels' run with every coordinate "
          f"x (1 + 1e-7): rot {witness['rot']:.2e}, t {witness['t']:.2e}, rmse "
          f"{witness['rmse']:.2e} relative, iterations {moved.iters} vs {base.iters}; 'kernels' "
          f"against 'plain' (auto against gather): rot {modes['rot']:.2e}, t {modes['t']:.2e}, "
          f"rmse {modes['rmse']:.2e} relative")


def _mid_configs():
    """The flagship config with the refine-stride mid phase: stride 2
    through fold6 and through fold7, stride 4 through fold6."""
    base = _flag_configs()
    return {"mid2": dataclasses.replace(base["kernels"], refine_stride=2),
            "mid2 vmem7": dataclasses.replace(base["vmem7"], refine_stride=2),
            "mid4": dataclasses.replace(base["kernels"], refine_stride=4)}


def _phase_mid(f_src, f_tgt, f_gt, shapes, kernels):
    """The 1M flagship with the refine-stride mid phase: stride 2 under
    "auto" (fold6 at 16,384 x 32) and "vmem7" (fold7), stride 4 under "auto"
    (Sq 16). Each run passes the GT gate, launches the fold once an
    iteration of the mid phase and of the tail, counts no more refine
    iterations than max_iters, and its histories hold their finite entries
    first."""
    from icpx_torch.registration.icp import register

    launches = {"fold6": 0, "fold7": 0}
    for label, cfg in _mid_configs().items():
        res, counts, rot, terr, wall, peak = _gated(
            f"flagship ({label})", lambda: register(f_src, f_tgt, cfg), f_gt)
        refine = _check_launches(label, counts, res, shapes)
        if refine > cfg.max_iters or refine <= cfg.refine_full_iters:
            _fail(f"flagship ({label}): {refine} refine iterations of max_iters {cfg.max_iters}")
        for h in (res.diff_history, res.rmse_history):
            fin = torch.isfinite(h)
            if not bool(fin[: int(fin.sum())].all()):
                _fail(f"flagship ({label}): a history's finite entries are not contiguous from the "
                      f"front ({h.tolist()})")
        for name in launches:
            launches[name] += counts[name]
        print(f"flagship 1M ({label}): refine_stride {cfg.refine_stride}, iters={res.iters} "
              f"(coarse {res.iters - refine}, mid and tail {refine}) rmse={float(res.final_rmse):.3e} "
              f"rot_err={rot:.3e} t_err={terr:.3e} launches={counts}; wall {wall * 1e3:.2f} ms "
              f"(median of 3, normals included); peak {peak:.0f} MiB")
    for name, n in launches.items():
        kernels[name]["launches_mid"] = n


def _intensity(xyz):
    """A smooth payload channel of a point's position: sin(3x) + y / 2."""
    return torch.sin(3.0 * xyz[:, 0]) + 0.5 * xyz[:, 1]


def _feature_run(f_src, f_tgt):
    """(src, tgt, config) of the flagship with an "intensity" channel: each
    source point's `_intensity`, carried to its image in the target."""
    f = _intensity(f_src.xyz)
    src = f_src.replace(feats=f[:, None], feat_names=("intensity",))
    tgt = f_tgt.replace(feats=f[_pair_perm(f_src.capacity, f_src.device)][:, None],
                        feat_names=("intensity",))
    cfg = dataclasses.replace(_flag_configs()["kernels"], feat_nn="intensity", feat_nn_weight=1.0)
    return src, tgt, cfg


def _plane_pair(n, dev):
    """tests/test_registration.py::test_feature_matching_pins_degenerate_plane
    at n points: a flat square with an intensity gradient along x, shifted
    0.15 along x (an in-plane motion geometry cannot observe)."""
    from icpx_torch.cloud import PointCloud

    rng = np.random.default_rng(11)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    xyz = np.concatenate([xy, np.zeros((n, 1), np.float32)], 1)
    inten = 3.0 * xy[:, 0]
    shift = np.asarray([0.15, 0.0, 0.0], np.float32)
    make = lambda x: PointCloud.create(x, feats=inten, feat_names=("intensity",), device=dev)  # noqa: E731
    return make(xyz), make(xyz + shift), shift


def _phase_features(dev, f_src, f_tgt, f_gt, shapes, n_plane):
    """Feature-augmented matching. The 1M flagship with an "intensity"
    channel carried from each source point to its image (feat_nn weight 1):
    the GT gate, moments6 twice and the KD builds' sorts, no fold kernel
    (the plain fold in both phases, as in the reference). Then the
    degenerate plane at n_plane points: the in-plane shift recovered to
    0.02 with the feature, and geometry alone more than 3x off that."""
    from icpx_torch.registration.icp import ICPConfig, register

    src, tgt, cfg = _feature_run(f_src, f_tgt)
    res, counts, rot, terr, wall, peak = _gated("flagship (feat)", lambda: register(src, tgt, cfg), f_gt)
    refine = _check_launches("feat", counts, res, shapes)
    print(f"flagship 1M (feat): feat_nn intensity, weight 1; iters={res.iters} (coarse "
          f"{res.iters - refine}, refine {refine}) rmse={float(res.final_rmse):.3e} rot_err={rot:.3e} "
          f"t_err={terr:.3e} launches={counts}; wall {wall * 1e3:.2f} ms (median of 3); peak "
          f"{peak:.0f} MiB")
    p_src, p_tgt, shift = _plane_pair(n_plane, dev)
    base = ICPConfig(objective="p2p", max_iters=25, diff_threshold=0.0, rmse_change_tol=1e-7,
                     nn_method="block")
    cfg_f = dataclasses.replace(base, feat_nn="intensity", feat_nn_weight=1.0)
    out = {}
    for label, c in (("geometry", base), ("feature", cfg_f)):
        r, counts = _counted(lambda: register(p_src, p_tgt, c))
        _check_counts(f"plane ({label})", counts, _register_launches(
            c, r, n_plane, n_plane, normals=False, fold=None if c.feat_nn else "fold6"))
        torch.cuda.reset_peak_memory_stats()
        wall, _ = _sync_time(lambda: register(p_src, p_tgt, c), reps=3)
        t_err = float(torch.linalg.vector_norm(r.transform.t.cpu() - torch.as_tensor(shift)))
        out[label] = t_err
        print(f"plane {n_plane} ({label}): iters={r.iters} t_err={t_err:.3e} launches={counts}; wall "
              f"{wall * 1e3:.2f} ms (median of 3); peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not (out["feature"] < 0.02 and out["geometry"] > 3.0 * out["feature"]):
        _fail(f"plane: the feature must pin the in-plane shift (t {out['feature']:.3e} with it, "
              f"{out['geometry']:.3e} without)")


# NDT's source covariance in "p2d": sigma 1 mm, half the 1M cloud's point
# spacing. register_ndt's default 1e-4 (sigma 1 cm) fits the ~20,000-point
# clouds of the reference's tests, where it is a tenth of a cell; at 1M it
# is five spacings and swamps the cells' shape (a nearly isotropic metric
# to the cell means), and 30 iterations leave rot ~1e-2. The JAX package
# loses accuracy the same way as a cloud gets denser at a fixed point_cov
# (`python tests/test_torch_pyramid_ndt.py N POINT_COV` runs both).
NDT_POINT_COV = 1e-6


def _ndt_run(src, tgt, mode):
    """register_ndt on cells of 64 with its default config, "p2d" at
    NDT_POINT_COV: (config, a callable)."""
    from icpx_torch.registration.icp import ICPConfig
    from icpx_torch.registration.ndt import register_ndt

    cfg = ICPConfig(max_iters=30, diff_threshold=0.0, rmse_change_tol=1e-6, robust="huber")
    return cfg, lambda: register_ndt(src, tgt, cfg, cell_size=64, mode=mode, point_cov=NDT_POINT_COV)


def _phase_ndt(f_src, f_tgt, f_gt):
    """NDT on the 1M flagship, cells of 64 points (its target's 16,384 cell
    means), point-to-distribution (at NDT_POINT_COV) then distribution-to-
    distribution: the reference's NDT gate (rot < 5e-3, t < 2e-2), fold6
    on the 12-wide GICP table once a refine iteration, and the sorts of
    every KD build (the cells' and register()'s)."""
    from icpx_torch.kernels.blocknn import _kd_tile_count, kd_level_sorts

    n = f_tgt.capacity
    n_cells = _kd_tile_count(n, 64)[1]  # a cell a KD tile
    for mode in ("p2d", "d2d"):
        cfg, run = _ndt_run(f_src, f_tgt, mode)
        res, counts, rot, terr, wall, peak = _gated(f"ndt ({mode})", run, f_gt, t_tol=2e-2)
        cell_builds = 2 if mode == "d2d" else 1
        n_src = n_cells if mode == "d2d" else n
        _check_counts(f"ndt ({mode})", counts, _register_launches(
            cfg, res, n_src, n_cells, normals=False, extra_sorts=cell_builds * kd_level_sorts(n, 64)))
        print(f"ndt 1M ({mode}): {n_cells} cells of 64{', point_cov %g' % NDT_POINT_COV if mode == 'p2d' else ''}; iters={res.iters} rmse={float(res.final_rmse):.3e} "
              f"rot_err={rot:.3e} t_err={terr:.3e} launches={counts}; wall {wall * 1e3:.2f} ms "
              f"(median of 3, cells included); peak {peak:.0f} MiB")


def _phase_horn_voxel(f_src, f_tgt, f_gt, n_q):
    """`horn_align` on the flagship's source and its GT image (within 1e-5
    of the GT, the angle from the float64 skew part), then `voxel_nn` over
    the flagship's target at `auto_cell_size` for n_q queries near it
    (source points at the GT pose, moved by a tenth of a cell): recall of
    at least 99.9% against the nn kernel's exact NN, and the same d2 bits
    wherever both return the same row."""
    from icpx_torch.kernels.knn import nearest_neighbor
    from icpx_torch.kernels.voxel import auto_cell_size, build_voxel_grid, voxel_nn
    from icpx_torch.registration.horn import horn_align

    src = f_src.xyz[f_src.mask]
    dst = f_gt.apply(src)
    est = horn_align(src, dst)
    d_rot, d_t = _transform_diff(est, f_gt)
    det = float(torch.linalg.det(est.R.double()))
    if not (d_rot < 1e-5 and d_t < 1e-5 and abs(det - 1.0) < 1e-5):
        _fail(f"horn: {d_rot:.2e} rad, {d_t:.2e} from the GT (det {det:.6f})")
    wall_horn, _ = _sync_time(lambda: horn_align(src, dst), reps=3)
    print(f"horn_align {src.shape[0]} points: rot {d_rot:.2e}, t {d_t:.2e} from the GT; wall "
          f"{wall_horn * 1e3:.3f} ms (median of 3)")

    cell = auto_cell_size(f_tgt.xyz, f_tgt.mask)
    grid = build_voxel_grid(f_tgt.xyz, cell, f_tgt.mask)
    gen = torch.Generator(device=src.device).manual_seed(5)
    q = dst[:n_q] + 0.1 * cell * torch.randn(dst[:n_q].shape, generator=gen, device=src.device)
    d_v, i_v = voxel_nn(q, grid)
    d_n, i_n = nearest_neighbor(q, f_tgt.xyz, ref_mask=f_tgt.mask)
    torch.cuda.synchronize()
    recall = float(((i_v == i_n) | (d_v <= d_n)).float().mean())
    same = i_v == i_n
    if recall < 0.999 or not torch.equal(d_v[same].view(torch.int32), d_n[same].view(torch.int32)):
        _fail(f"voxel_nn: recall {recall:.5f}, d2 differs on "
              f"{int((d_v[same] != d_n[same]).sum())} rows with the same index")
    build_ms = _event_ms(lambda: build_voxel_grid(f_tgt.xyz, cell, f_tgt.mask), reps=3)
    query_ms = _event_ms(lambda: voxel_nn(q, grid), reps=3)
    print(f"voxel_nn {n_q} queries over {f_tgt.capacity} points (cell {float(cell):.4g}, "
          f"{grid.n_buckets} buckets of {grid.bucket_size}): recall {100 * recall:.3f}% against the nn "
          f"kernel, d2 bit-equal on the {int(same.sum())} rows with the same index; build "
          f"{build_ms:.3f} ms, query {query_ms:.3f} ms (CUDA events, median of 3)")


def _batch_run(dev, n, b):
    """b pairs of n points with normals (brute kNN), stacked for
    `register_batch`: (pairs, its tensor arguments, config)."""
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.registration.icp import ICPConfig

    pairs = [_gt_pair(n, 40 + i, dev, angle=0.1 + 0.02 * i, translation=(0.05, -0.01 * i, 0.02))
             for i in range(b)]
    pairs = [(estimate_normals(s, k=10), estimate_normals(t, k=10), g) for s, t, g in pairs]
    cfg = ICPConfig(objective="symmetric", max_iters=15, diff_threshold=0.0, rmse_change_tol=1e-6,
                    nn_method="brute")
    stack = lambda i, f: torch.stack([getattr(p[i], f) for p in pairs])  # noqa: E731
    return pairs, [stack(i, f) for i in (0, 1) for f in ("xyz", "mask", "normals")], cfg


def _phase_batch(dev, n, b):
    """`register_batch` on b pairs of n points, scan-size clouds as
    loop-closure verification batches them, normals estimated first: each
    pair's GT gate, each pair within 1e-6 of register() on that pair with
    the same normals, and the nn kernel once a pair's iteration."""
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.registration.icp import register, register_batch

    pairs, args, cfg = _batch_run(dev, n, b)
    res, counts = _counted(lambda: register_batch(*args, cfg))
    _check_counts("register_batch", counts, {"nn": int(res.iters.sum())})
    worst = [0.0, 0.0, 0.0]
    for i, (s, t, g) in enumerate(pairs):
        one = SE3(R=res.transform.R[i], t=res.transform.t[i])
        rot, terr = (float(x) for x in one.distance_to(g))
        alone = register(s, t, cfg)
        d_rot, d_t = _transform_diff(one, alone.transform)
        if not (rot < 5e-3 and terr < 5e-3) or d_rot > 1e-6 or d_t > 1e-6 or alone.iters != int(res.iters[i]):
            _fail(f"register_batch pair {i}: GT rot {rot:.2e}, t {terr:.2e}; against register() "
                  f"rot {d_rot:.2e}, t {d_t:.2e}, iters {int(res.iters[i])} vs {alone.iters}")
        worst = [max(worst[0], rot), max(worst[1], terr), max(worst[2], d_rot, d_t)]
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _sync_time(lambda: register_batch(*args, cfg), reps=3)
    print(f"register_batch {b} x {n}: iters {res.iters.tolist()}; GT rot <= {worst[0]:.2e}, t <= "
          f"{worst[1]:.2e}; each pair within {worst[2]:.1e} of register() alone; launches={counts}; "
          f"wall {wall * 1e3:.2f} ms (median of 3) = {b * n / wall:.4g} points/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")


def _summed_launches(wants):
    """The launches of several register() calls: {kernel: the sum of each
    call's `_register_launches`}."""
    total = {}
    for want in wants:
        for name, n in want.items():
            total[name] = total.get(name, 0) + n
    return total


def _pair_result(res, i):
    """Pair i of a batched ICPResult, with the fields `_register_launches`
    reads."""
    return types.SimpleNamespace(iters=int(res.iters[i]), rmse_history=res.rmse_history[i])


def _batch_block_run(dev, n, b):
    """b pairs of n points stacked for `register_batch_block`, the
    flagship's config: (pairs, its tensor arguments, config)."""
    pairs = [_gt_pair(n, 50 + i, dev, angle=0.12 + 0.02 * i, translation=(0.06, 0.02 * i, -0.03))
             for i in range(b)]
    stack = lambda i, f: torch.stack([getattr(p[i], f) for p in pairs])  # noqa: E731
    return pairs, [stack(i, f) for i in (0, 1) for f in ("xyz", "mask")], _flag_configs()["kernels"]


def _phase_batch_block(dev, n, b):
    """`register_batch_block` on b pairs of n points (the reference's "B x
    65k" batch): each pair's GT gate, and the launches of b register()
    calls: for each pair moments6 twice, the fold once a refine iteration
    (its row of the batched histories) and its two KD builds' sorts."""
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.registration import icp

    pairs, args, cfg = _batch_block_run(dev, n, b)
    res, counts = _counted(lambda: icp.register_batch_block(*args, cfg))
    per_pair = [_register_launches(cfg, _pair_result(res, i), n, n) for i in range(b)]
    _check_counts("register_batch_block", counts, _summed_launches(per_pair))
    worst = [0.0, 0.0]
    for i, (_, _, g) in enumerate(pairs):
        est = SE3(R=res.transform.R[i], t=res.transform.t[i])
        rot, terr = (float(x) for x in est.distance_to(g))
        if not (rot < 5e-3 and terr < 5e-3):
            _fail(f"register_batch_block pair {i}: GT not recovered (rot {rot:.3e}, t {terr:.3e})")
        worst = [max(worst[0], rot), max(worst[1], terr)]
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _sync_time(lambda: icp.register_batch_block(*args, cfg), reps=3)
    print(f"register_batch_block {b} x {n}: iters {res.iters.tolist()}; GT rot <= {worst[0]:.2e}, "
          f"t <= {worst[1]:.2e}; launches={counts} (a pair {per_pair}); wall {wall * 1e3:.2f} ms "
          f"(median of 3, normals included) = {b * n / wall:.4g} points/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")


def _pyramid_run(dev, n):
    """tests/test_pyramid.py's case at n points: (src, tgt, gt, config)."""
    from icpx_torch.registration.icp import ICPConfig
    from icpx_torch.registration.pyramid import PyramidConfig

    src, tgt, gt = _gt_pair(n, 0, dev, angle=0.9, translation=(0.8, -0.5, 0.3), axis=(0.2, -0.1, 0.97))
    cfg = PyramidConfig(levels=3, subsample=4, base=ICPConfig(
        objective="symmetric", max_iters=15, diff_threshold=1e-5, robust="tukey"))
    return src, tgt, gt, cfg


def _phase_pyramid(dev, n):
    """`register_pyramid` on an n-point pair at 0.9 rad and (0.8, -0.5, 0.3)
    (tests/test_pyramid.py's case), 3 levels, subsample 4: the GT gate and
    the launches of one register() call a level, from the levels' results
    (the nn kernel on a brute level, moments6, fold6 and the sorts on a
    block level)."""
    from icpx_torch.registration import pyramid

    src, tgt, gt, cfg = _pyramid_run(dev, n)
    caps = [(pyramid.morton_stratified_subsample(src, cfg.subsample ** (cfg.levels - 1 - lvl)).capacity,
             pyramid.morton_stratified_subsample(tgt, cfg.subsample ** (cfg.levels - 1 - lvl)).capacity)
            for lvl in range(cfg.levels)]
    (res, levels), counts = _counted(lambda: pyramid.register_pyramid(src, tgt, cfg))
    rot, terr = (float(x) for x in res.transform.distance_to(gt))
    if not (rot < 5e-3 and terr < 5e-3):
        _fail(f"pyramid: GT not recovered (rot {rot:.3e}, t {terr:.3e})")
    # a level's config differs from the base only in its iterations, gate
    # and robust kernel, none of which picks a path or a tile size
    per_level = [_register_launches(cfg.base, r, cap_s, cap_t) for r, (cap_s, cap_t) in zip(levels, caps)]
    _check_counts("pyramid", counts, _summed_launches(per_level))
    text = [f"level {lvl}: {cap_t} points, {cfg.base.resolve_nn(cap_t)}, iters {r.iters}, launches {want}"
            for lvl, (r, (_, cap_t), want) in enumerate(zip(levels, caps, per_level))]
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _sync_time(lambda: pyramid.register_pyramid(src, tgt, cfg), reps=3)
    print(f"register_pyramid {n} points, 0.9 rad: rot_err={rot:.3e} t_err={terr:.3e}; "
          + "; ".join(text) + f"; launches={counts}; wall {wall * 1e3:.2f} ms (median of 3); peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")


# ---- odometry ----------------------------------------------------------------------------

N_ODO = 65536  # bench.py --odometry --scan-points 65536: a 64-beam-class sweep
N_ODO_BRUTE = 4096  # a scan under block_auto_threshold: the brute nn path
N_ODO_SMALL = 8192  # the sequence run on the card and on the CPU, and the host frontend's scans
ODO_FRAMES = 20  # bench.py's --frames
ODO_ATE_BOUND = 0.5  # bench.py's gate, metres, unaligned


def _odo_sequence(n, frames, dev):
    """bench.py's odometry construction at n points a scan, on `dev`: (the
    scans, the ground truth relative to the first pose)."""
    from icpx_torch.odometry.kitti import make_trajectory, make_world, simulate_scans

    world = make_world(n_points=300000, extent=50.0, seed=0, n_posts=300, ground_frac=0.5)
    gt = make_trajectory(frames, speed=0.6, turn=0.02, device=dev)
    scans = simulate_scans(world, gt, max_range=25.0, points_per_scan=n, noise=0.01, seed=1,
                           device=dev)
    return scans, [gt[0].inverse() @ g for g in gt]


def _odo_config(nn_method="auto"):
    from icpx_torch.registration.icp import ICPConfig

    return ICPConfig(objective="symmetric", max_iters=10, diff_threshold=0.0, rmse_change_tol=1e-6,
                     robust="huber", max_corr_dist=2.0, nn_method=nn_method)


def _stacked(scans):
    """The scans with normals (k = 10), stacked: (xyz, mask, normals)."""
    from icpx_torch.kernels.normals import estimate_normals

    with_n = [estimate_normals(f, k=10) for f in scans]
    return tuple(torch.stack([getattr(f, a) for f in with_n]) for a in ("xyz", "mask", "normals"))


def _pose_list(poses):
    from icpx_torch.geometry.se3 import SE3

    return [SE3(R=poses.R[i], t=poses.t[i]) for i in range(poses.t.shape[0])]


def _device_profile(run):
    """One call of `run` under torch.profiler, CUDA activity only (the
    device's kernels and copies; CPU op rows would only add events for it
    to read): (its output, the profiled wall ms, device ms, the kernel
    rows, seconds the profiler took beyond the call)."""
    t_all = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = [e for e in avgs if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    overhead_s = time.perf_counter() - t_all - wall_ms / 1e3
    return out, wall_ms, busy_ms, sorted(kernels, key=_device_us, reverse=True), overhead_s


def _odo_report(label, res, gt, wall, n, counts, extra="", reps=3):
    """Gate the trajectory (ATE < ODO_ATE_BOUND, unaligned) and print the
    phase's line (`wall`: the median of `reps` runs); returns the ATE."""
    from icpx_torch.odometry.evaluate import ate_rmse, rpe

    poses = res.poses if isinstance(res.poses, list) else _pose_list(res.poses)
    ate = ate_rmse(poses, gt, align=False)
    rpe_t, rpe_r = rpe(poses, gt)
    kf = (res.is_keyframe if isinstance(res.is_keyframe, list)
          else res.is_keyframe.cpu().tolist())
    if not (math.isfinite(ate) and ate < ODO_ATE_BOUND):
        _fail(f"{label}: ATE {ate:.4f} m (gate {ODO_ATE_BOUND} m)")
    f = len(poses)
    print(f"{label}: ATE {ate:.4f} m (unaligned, gate {ODO_ATE_BOUND}), RPE {rpe_t:.4f} m / "
          f"{rpe_r:.2e} rad; keyframes {sum(kf)} of {f}; launches={counts}; wall "
          f"{wall * 1e3:.2f} ms (median of {reps}) = {wall * 1e3 / f:.3f} ms a frame = "
          f"{f / wall:.2f} frames/s = {f * n / wall:.4g} points/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB{extra}")
    return ate


def _phase_compiled_odometry(dev, n, frames, kernels):
    """`run_odometry_compiled` on bench.py's sequence of `frames` scans of n
    points (the block path at 65,536: per-frame KD source indexes at the
    q-tile ladder's 256, the keyframe's at 128 on each spawn, frozen
    candidates and the refine-stride mid phase): the ATE gate, and the sort
    kernel launched exactly as the frames' normals and both kinds of KD
    build need (`kd_level_sorts`); no other kernel. Frame 1's source index
    (tiles of the q-tile) and the first keyframe's (tiles of block_tile),
    built from the run's own operands, equal the plain builds bit for bit.
    The same scans pushed one at a time through `OdometryStream`, each a
    copy of its own, give the direct call's result bit for bit. Then the
    device time and busy share of one profiled run."""
    from icpx_torch.kernels.blocknn import kd_level_sorts
    from icpx_torch.odometry.compiled import (OdometryStream, _masked_center, resolve_odo_freeze,
                                              resolve_odo_q_tile, resolve_odo_refine_stride,
                                              run_odometry_compiled)

    cfg = _odo_config()
    t0 = time.perf_counter()
    scans, gt = _odo_sequence(n, frames, dev)
    t_sim = time.perf_counter() - t0
    kw = dict(velocity_damping=0.7)
    stacked = {}

    def run_all():
        t0 = time.perf_counter()
        stacked["fx"] = _stacked(scans)
        torch.cuda.synchronize()
        stacked["normals_s"] = time.perf_counter() - t0
        return run_odometry_compiled(*stacked["fx"], cfg, **kw)

    t0 = time.perf_counter()
    res, counts = _counted(run_all)
    t_first = time.perf_counter() - t0
    spawns = int(res.is_keyframe[1:].sum())
    q_tile = resolve_odo_q_tile(cfg, n)
    want = {"sort": frames * kd_level_sorts(n, 128) + (frames - 1) * kd_level_sorts(n, q_tile)
            + (1 + spawns) * kd_level_sorts(n, cfg.block_tile)}
    _check_counts(f"compiled odometry {n} x {frames}", counts, want)
    stream = OdometryStream(n, dev, cfg, **kw)
    for k in range(frames):
        stream.push(*(x[k].clone() for x in stacked["fx"]))
    _check_repeats(f"compiled odometry {n} x {frames}: OdometryStream against the direct call",
                   [res, stream.result()])
    print(f"compiled odometry {n} x {frames}: the scans pushed one at a time through "
          f"OdometryStream equal the direct call bit for bit ({spawns} spawns, "
          f"{int(res.rejections)} gate rejections)")
    # the builds of frame 1 against keyframe 0, in the keyframe's centroid
    # coordinates, as run_odometry_compiled makes them
    xyz, mask, _ = stacked["fx"]
    center = _masked_center(xyz[0], mask[0])
    levels = {}
    for label, k, s in (("source", 1, q_tile), ("keyframe", 0, cfg.block_tile)):
        centred = torch.where(mask[k][:, None], xyz[k] - center[None, :], xyz[k])
        _, got, levels[label] = _kd_equal(f"compiled odometry {label} KD build", centred, mask[k], s)
        if len(levels[label]) != kd_level_sorts(n, s):
            _fail(f"compiled odometry {label} KD build: levels {levels[label]}, want "
                  f"{kd_level_sorts(n, s)}")
    print(f"compiled odometry {n} x {frames} KD builds through the sort kernel equal the plain "
          f"builds bit for bit: frame 1's source index at tiles of {q_tile} (level sorts "
          f"{levels['source']}), keyframe 0's at {cfg.block_tile} ({levels['keyframe']})")
    torch.cuda.reset_peak_memory_stats()
    # the counted run warmed every path: no warm-up call before the timed ones
    wall, _ = _sync_time(lambda: run_odometry_compiled(*stacked["fx"], cfg, **kw), reps=3, warmup=0)
    extra = (f"; the simulator {t_sim:.2f} s; the counted (first) run {t_first:.2f} s, the "
             f"normals of the {frames} scans {stacked['normals_s'] * 1e3:.2f} ms of it; ladders: q_tile "
             f"{q_tile}, freeze {resolve_odo_freeze(n)}, refine stride "
             f"{resolve_odo_refine_stride(cfg, n)}; ICP iterations {res.iters.tolist()}")
    ate = _odo_report(f"compiled odometry {n} x {frames}", res, gt, wall, n, counts, extra)
    kernels["sort"]["launches_odometry"] = counts["sort"]
    _, prof_ms, busy_ms, rows, prof_s = _device_profile(
        lambda: run_odometry_compiled(*stacked["fx"], cfg, **kw))
    top = "; ".join(f"{_device_us(e) / 1e3:.3f} ms x{e.count} {e.key[:60]}" for e in rows[:6])
    print(f"compiled odometry {n} x {frames} profiled: device time {busy_ms:.2f} ms = "
          f"{100 * busy_ms / (wall * 1e3):.1f}% of the unprofiled wall ({prof_ms:.2f} ms "
          f"profiled; the profiler took {prof_s:.2f} s more to start, stop and read its "
          f"trace); largest device items: {top}")
    return {"scans": scans, "gt": gt, "ate": ate}


def _phase_compiled_brute(dev, n, frames, kernels):
    """The brute path of `run_odometry_compiled` (scans under
    block_auto_threshold): the ATE gate, and the nn kernel once an ICP
    iteration of every frame (the frames' `iters`), no other kernel. The
    kernel equals its plain version bit for bit on frame 1's first
    iteration's operands: the frame against keyframe 0 and its mask, in
    the keyframe's centroid coordinates, at the initial pose (identity)."""
    from icpx_torch.odometry.compiled import _masked_center, run_odometry_compiled

    cfg = _odo_config()
    scans, gt = _odo_sequence(n, frames, dev)
    fx = _stacked(scans)
    kw = dict(velocity_damping=0.7)
    res, counts = _counted(lambda: run_odometry_compiled(*fx, cfg, **kw))
    _check_counts(f"compiled odometry {n} x {frames} (brute)", counts,
                  {"nn": int(res.iters.sum())})
    xyz, mask, _ = fx
    center = _masked_center(xyz[0], mask[0])
    query, ref = (torch.where(mask[k][:, None], xyz[k] - center[None, :], xyz[k]) for k in (1, 0))
    _, _, fin, _, _ = _nn_equal(f"compiled odometry {n} (brute) frame 1", query, ref, mask[0])
    print(f"compiled odometry {n} x {frames} (brute): nn kernel vs plain on frame 1's operands "
          f"({n} x {n}, {int(mask[0].sum())} valid reference rows): d2 and index bit-equal "
          f"({int(fin.sum())} finite)")
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _sync_time(lambda: run_odometry_compiled(*fx, cfg, **kw), reps=3, warmup=0)
    ate = _odo_report(f"compiled odometry {n} x {frames} (brute)", res, gt, wall, n, counts,
                      f"; ICP iterations {res.iters.tolist()}")
    kernels["nn"]["launches_odometry"] = counts["nn"]
    return {"scans": scans, "gt": gt, "ate": ate}


# m and rad. Not the block path's 1e-4 of the CPU parity tests: on this
# sequence the card's own run moves 2.56e-4 m when every input coordinate
# is scaled by 1 + 1e-7 (the witness `_phase_compiled_card_vs_cpu` prints
# beside the gap; H100 80GB HBM3, 700 W), so a card-against-CPU gap below
# that is fp32 rounding carried through the frames; 1e-3 is ~4x the witness
ODO_POSE_TOL = 1e-3


def _worst_pose_gap(a, b):
    """The largest (rotation, translation) gap between two runs' poses."""
    worst = [0.0, 0.0]
    for p, q in zip(_pose_list(a.poses), _pose_list(b.poses)):
        d_rot, d_t = _transform_diff(p, q)
        worst = [max(worst[0], d_rot), max(worst[1], d_t)]
    return worst


def _phase_compiled_card_vs_cpu(dev, n, frames):
    """The same sequence through the port on the card and on the CPU (the
    same normals, made on the card): equal keyframe flags and sources,
    poses within ODO_POSE_TOL. Beside it, how far the card's own run moves
    when every coordinate is scaled by 1 + 1e-7: registrations of these
    scans are discontinuous at fp32 rounding (ROADMAP queue 3)."""
    from icpx_torch.odometry.compiled import run_odometry_compiled

    cfg = _odo_config()
    scans, _ = _odo_sequence(n, frames, dev)
    fx = _stacked(scans)
    card = run_odometry_compiled(*fx, cfg, velocity_damping=0.7)
    cpu = run_odometry_compiled(*(x.cpu() for x in fx), cfg, velocity_damping=0.7)
    scaled = run_odometry_compiled(fx[0] * (1.0 + 1e-7), *fx[1:], cfg, velocity_damping=0.7)
    same = (torch.equal(card.is_keyframe.cpu(), cpu.is_keyframe)
            and torch.equal(card.edge_src.cpu(), cpu.edge_src))
    worst = _worst_pose_gap(card, cpu)
    own = _worst_pose_gap(card, scaled)
    if not same or max(worst) > ODO_POSE_TOL:
        _fail(f"compiled odometry {n} x {frames}: card and CPU differ (keyframes "
              f"{card.is_keyframe.cpu().tolist()} vs {cpu.is_keyframe.tolist()}; rot "
              f"{worst[0]:.2e}, t {worst[1]:.2e}, tolerance {ODO_POSE_TOL})")
    print(f"compiled odometry {n} x {frames} card vs CPU: keyframes equal "
          f"({int(card.is_keyframe.sum())}), poses within rot {worst[0]:.2e}, t {worst[1]:.2e} "
          f"(tolerance {ODO_POSE_TOL}); the card's run against itself with coordinates x "
          f"(1 + 1e-7): rot {own[0]:.2e}, t {own[1]:.2e}; ICP iterations card "
          f"{card.iters.tolist()}, CPU {cpu.iters.tolist()}")


def _host_launches(cfg_icp, n, tgt_capacity, regs):
    """What `regs` register() calls of n-point scans against a target of
    `tgt_capacity` rows launch on the block path with normals given: their
    KD builds' sorts exactly; the fold once a refine iteration, so at least
    once a call."""
    from icpx_torch.kernels.blocknn import kd_level_sorts

    return regs * (kd_level_sorts(n, cfg_icp.resolve_q_tile(n))
                   + kd_level_sorts(tgt_capacity, cfg_icp.block_tile))


# on/off pairs of the stall watchdog's A/B on the host frontend, run in ABBA
# order; scalar fetches a reading of its per-fetch A/B
WATCHDOG_PAIRS = 5
FETCHES = 100


def _ab_walls(a, b, pairs):
    """Host walls (s) of a() and b(), `pairs` runs of each in ABBA order (a
    then b, b then a, ...), each between synchronize fences: (a's, b's)."""
    walls = ([], [])
    for i in range(pairs):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (a, b)[j]()
            torch.cuda.synchronize()
            walls[j].append(time.perf_counter() - t0)
    return walls


def _frontend_fold6_operands(scans, gt, icp):
    """The fold6 operands of one host-frontend frame (scan 1 registered
    onto scan 0, with normals): the source's query tiles at the q-tile of
    `icp` under the GT pose, the target's tiles of block_tile, k =
    block_k_refine frozen candidates and the fused (xyz || normal) table,
    built as `register()` builds them; (query, prepared operands)."""
    from icpx_torch.kernels import blocknn_cuda
    from icpx_torch.kernels.blocknn import build_kd_index, fused_payload_table, trim_index

    src, tgt = scans[1], scans[0]
    tgt_index = trim_index(build_kd_index(tgt.xyz, tgt.mask, tile_size=icp.block_tile),
                           tgt.capacity, multiple=64)
    query, cand, _ = _refine_operands(src, tgt_index, gt[1], q_tile=icp.resolve_q_tile(src.capacity),
                                      k=icp.block_k_refine)
    return query, blocknn_cuda.fold6_prepare(cand, tgt_index, fused_payload_table(tgt_index, tgt.normals))


def _phase_host_odometry(dev, n, frames, kernels, map_capacity=65536):
    """`run_odometry` on 8,192-point scans (the block path with fold6 in
    every refine iteration): fold6 against its plain version bit for bit
    on one frame's query tiles and frozen candidates (the same shapes in
    both modes); scan_to_keyframe, then scan_to_map with the sliding-window
    back end, each held to the ATE gate and its launches; scan_to_keyframe
    timed with the stall watchdog on and off (WATCHDOG_PAIRS pairs, ABBA),
    and one guarded scalar fetch against a plain one;
    then a run resumed from an `OdometryCheckpoint` saved after frame
    frames // 2 equals the uninterrupted scan_to_keyframe run bit for bit."""
    from pathlib import Path

    from icpx_torch.distributed.fault import guarded_call
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.odometry.frontend import OdometryConfig, run_odometry
    from icpx_torch.utils.checkpoint import OdometryCheckpoint

    scans, gt = _odo_sequence(n, frames, dev)
    scans = [estimate_normals(f, k=10) for f in scans]
    icp = _odo_config()
    query, ops = _frontend_fold6_operands(scans, gt, icp)
    d, _, _ = _fold6_equal(f"host odometry {tuple(query.shape)}", query, ops)
    print(f"host odometry {n}: fold6 kernel vs plain on frame 1's query tiles "
          f"{tuple(query.shape)}, k={ops.cand.shape[1]}, tiles of {ops.tiles.shape[1]}: d2 and "
          f"payload bit-equal ({int(torch.isfinite(d).sum())} hits)")
    runs = {"scan_to_keyframe": OdometryConfig(icp=icp, keyframe_trans=1.0, keyframe_rot=0.2,
                                               velocity_damping=0.7),
            "scan_to_map, sliding_window": OdometryConfig(
                icp=icp, keyframe_trans=1.0, keyframe_rot=0.2, velocity_damping=0.7,
                mode="scan_to_map", map_capacity=map_capacity, map_cell=0.1,
                backend="sliding_window", window=5)}
    results = {}
    for label, cfg in runs.items():
        res, counts = _counted(lambda: run_odometry(scans, cfg))
        tgt = n if cfg.mode == "scan_to_keyframe" else map_capacity
        sorts = _host_launches(icp, n, tgt, frames - 1)
        if counts["sort"] != sorts or not (frames - 1 <= counts["fold6"] <= (frames - 1) * icp.max_iters) \
                or any(counts[k] for k in counts if k not in ("sort", "fold6")):
            _fail(f"host odometry ({label}): launches {counts}, want sort {sorts} and fold6 once "
                  f"to {icp.max_iters} times a frame")
        torch.cuda.reset_peak_memory_stats()
        if label == "scan_to_keyframe":
            # the card's default (600 s) against the watchdog off; the
            # counted run warmed the path
            on, off = _ab_walls(
                lambda: run_odometry(scans, dataclasses.replace(cfg, stall_timeout_s=600.0)),
                lambda: run_odometry(scans, dataclasses.replace(cfg, stall_timeout_s=0.0)),
                WATCHDOG_PAIRS)
            wall, reps = statistics.median(on), len(on)
            kernels["fold6"]["launches_odometry"] = counts["fold6"]
        else:
            (wall, _), reps = _sync_time(lambda: run_odometry(scans, cfg), reps=3, warmup=0), 3
        _odo_report(f"host odometry {n} x {frames} ({label})", res, gt, wall, n, counts, reps=reps)
        results[label] = res
    gap = (statistics.median(on) - statistics.median(off)) / frames
    # the fetch alone, away from the frames' host spread: a scalar fetch of
    # a ready tensor, FETCHES of them a reading, guarded against plain
    ready = torch.ones((), device=dev)
    f_on, f_off = _ab_walls(
        lambda: [guarded_call(lambda: float(ready), 600.0) for _ in range(FETCHES)],
        lambda: [float(ready) for _ in range(FETCHES)], WATCHDOG_PAIRS)
    per_fetch = [statistics.median(w) / FETCHES for w in (f_on, f_off)]
    print(f"host odometry {n} x {frames} stall watchdog (2 guarded fetches a frame, each "
          f"starting 2 threads: the monitor and the fence's worker): median "
          f"{statistics.median(on) * 1e3:.2f} ms on, {statistics.median(off) * 1e3:.2f} ms off "
          f"= {gap * 1e3:+.3f} ms a frame; every reading (ms, ABBA order) on "
          f"{[round(t * 1e3, 2) for t in on]}, off {[round(t * 1e3, 2) for t in off]}; one "
          f"fetch of a ready scalar {per_fetch[0] * 1e6:.1f} us guarded, {per_fetch[1] * 1e6:.1f} "
          f"us plain (median of {WATCHDOG_PAIRS} readings of {FETCHES}, ABBA) = "
          f"{2 * (per_fetch[0] - per_fetch[1]) * 1e3:+.3f} ms a frame")

    cfg = runs["scan_to_keyframe"]
    full = results["scan_to_keyframe"]
    path = Path(__file__).resolve().parent / "tests" / "_artifacts" / "odometry_checkpoint.npz"
    OdometryCheckpoint.from_result(run_odometry(scans[: frames // 2], cfg)).save(path)
    resumed = run_odometry(scans, cfg, resume=OdometryCheckpoint.load(path))
    exact = (resumed.is_keyframe == full.is_keyframe and all(
        torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
        for a, b in zip(full.poses + [e[2] for e in full.edges],
                        resumed.poses + [e[2] for e in resumed.edges])))
    if not exact:
        _fail("host odometry: the run resumed from its checkpoint differs from the uninterrupted one")
    print(f"host odometry resume: saved after frame {frames // 2 - 1}, resumed run equals the "
          f"uninterrupted one bit for bit ({len(full.poses)} poses, {len(full.edges)} edges)")


# ---- the command line and file IO -----------------------------------------------------


def _cli(argv):
    """Run `icpx_torch.cli.main(argv)` in this process: (its stdout, wall s).
    Fails unless it returns 0."""
    import contextlib
    import io

    from icpx_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    if rc != 0:
        _fail(f"icpx-torch {' '.join(map(str, argv))}: exit {rc}\n{buf.getvalue()}")
    return buf.getvalue(), wall


def _cli_rows(out, title, rows):
    """The `rows` matrix rows the CLI printed under `title`."""
    lines = out.splitlines()
    i = lines.index(title)
    return np.array([[float(v) for v in line.split()] for line in lines[i + 1:i + 1 + rows]])


def _cli_transform(out, dev):
    """The CLI's printed 4x4 transform as an SE3 on `dev` (6 decimals)."""
    from icpx_torch.interop import se3_from_numpy

    m = _cli_rows(out, "transform:", 4).astype(np.float32)
    return se3_from_numpy(m[:3, :3], m[:3, 3], device=dev)


def _cli_line(out, prefix):
    return next(line for line in out.splitlines() if line.startswith(prefix))


def _phase_cli(dev, n_flag, n_odo, odo_frames, n_synth, shapes):
    """`icpx_torch.cli` (in this process, and once as `python3 -m
    icpx_torch.cli`) over files of every format, each run held to what the
    same work gives through the entry points:

    1. the native IO library loaded; bench.py's flagship pair (n_flag
       points) written and read back as binary_compressed PCD with an
       intensity column, bit for bit, through native LZF;
    2. the golden cat pair as binary PLY, .xyz and binary_compressed PCD:
       `info` and `convert` of each (the same bits from every format),
       `register` with the golden config (GT gate; nn launches equal a
       direct register()'s), `perturb` then `horn` (the perturbation back);
    3. `register` of the flagship files with `_flag_configs()["kernels"]`
       as flags and `--config`: the GT gate, `_FLAG_LAUNCHES["kernels"]`,
       its transform against a direct register() of the same loaded clouds;
    4. bench.py --odometry's sequence (n_odo points, odo_frames scans) as a
       KITTI velodyne directory and poses file: `odometry --compiled`, the
       ATE gate, sort launches equal to its KD builds, its poses within
       ODO_POSE_TOL of a direct run_odometry_compiled with the config the
       CLI builds; prefetch_kitti against the serial load;
    5. `odometry --synthetic` (the CLI's default, host frontend, n_synth
       points) with --checkpoint and --loop-closure, and a resume from a
       checkpoint equal to the uninterrupted run;
    6. a fresh process, `python3 -m icpx_torch.cli --device ... info`."""
    from pathlib import Path

    from icpx_torch import cli
    from icpx_torch.cloud import round_up
    from icpx_torch.geometry.transforms import make_rigid_perturbation
    from icpx_torch.io import load_cloud, native, prefetch_kitti, save_cloud
    from icpx_torch.io.loaders import reference_data_dir
    from icpx_torch.io.pcd import write_pcd
    from icpx_torch.kernels.blocknn import kd_level_sorts
    from icpx_torch.odometry.compiled import resolve_odo_q_tile, run_odometry_compiled
    from icpx_torch.odometry.evaluate import ate_rmse
    from icpx_torch.odometry.kitti import (load_kitti_poses, load_kitti_scan, load_kitti_sequence,
                                           write_kitti_sequence)
    from icpx_torch.registration.icp import ICPConfig, register
    from icpx_torch.utils.checkpoint import OdometryCheckpoint

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    work = root / "tests" / "_artifacts" / "cli"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    base = ["--device", str(dev)]

    # 1. the native reader: the flagship pair through LZF both ways ------------------
    if native.get_lib() is None:
        _fail("cli: the native IO library did not load (g++ -O3 -fPIC -shared of native/icpx_io.cpp)")
    f_src, f_tgt, f_gt = _gt_pair(n_flag, 0, dev)
    flag = {}
    native.reset_counts()
    t0 = time.perf_counter()
    for name, cloud in (("src", f_src), ("tgt", f_tgt)):
        flag[name] = work / f"flag_{name}.pcd"
        write_pcd(flag[name], cloud.to_numpy(), compressed=True,
                  extra_fields={"intensity": _intensity(cloud.xyz)[cloud.mask].cpu().numpy()})
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = {name: load_cloud(path, device=dev) for name, path in flag.items()}
    read_s = time.perf_counter() - t0
    calls, falls = dict(native.CALLS), dict(native.FALLBACKS)
    for name, cloud in (("src", f_src), ("tgt", f_tgt)):
        got = loaded[name]
        if not (torch.equal(got.xyz[got.mask], cloud.xyz[cloud.mask]) and got.feat_names == ("intensity",)):
            _fail(f"cli: the flagship {name} read back from binary_compressed PCD differs")
    if calls["lzf_compress"] != 2 or calls["lzf_decompress"] != 2 or any(falls.values()):
        _fail(f"cli: LZF did not go through the native library (calls {calls}, fallbacks {falls})")
    mb = sum(p.stat().st_size for p in flag.values()) / 2**20
    print(f"cli native reader: {native.library_path().name}; the flagship pair ({n_flag} points "
          f"a cloud, xyz + intensity) as binary_compressed PCD, {mb:.1f} MiB: written "
          f"{write_s * 1e3:.2f} ms, read {read_s * 1e3:.2f} ms (both clouds, host clock, to the "
          f"device), bit-equal; native calls {({k: v for k, v in calls.items() if v})}, python "
          f"fallbacks {sum(falls.values())}")

    # 2. the golden cat pair through every format -------------------------------------
    data = reference_data_dir()
    src_np = load_cloud(data / "cat.pcd", device="cpu").to_numpy()
    tgt_np = load_cloud(data / "cat_out.pcd", device="cpu").to_numpy()
    tgt_sh = tgt_np[np.random.default_rng(0).permutation(len(tgt_np))]
    from icpx_torch.cloud import PointCloud

    files = {}
    for name, pts in (("cat", src_np), ("cat_out", tgt_sh)):
        cloud = PointCloud.create(pts, device="cpu")
        for ext, kw in ((".ply", {"binary": True}), (".xyz", {})):
            files[name, ext] = work / f"{name}{ext}"
            save_cloud(files[name, ext], cloud, **kw)
        files[name, ".pcd"] = work / f"{name}.pcd"
        write_pcd(files[name, ".pcd"], pts, compressed=True)
    formats = []
    for (name, ext), path in files.items():
        out, _ = _cli(base + ["info", path])
        if f"{len(src_np)} points" not in out:
            _fail(f"cli info {path.name}: {out}")
        conv = work / f"{name}{ext.replace('.', '_')}.pcd"
        _cli(base + ["convert", path, conv, "--binary"])
        want = src_np if name == "cat" else tgt_sh
        for p in (path, conv):
            if not np.array_equal(load_cloud(p, device=dev).to_numpy(), want):
                _fail(f"cli convert: {p.name}'s xyz differ from the original's")
        formats.append(path.name)
    print(f"cli cat pair: info and convert of {', '.join(formats)}: every file and its converted "
          f"PCD hold the original xyz bit for bit")
    cfg_cat = ICPConfig(objective="symmetric", max_iters=20, diff_threshold=1.0,
                        max_corr_dist=50.0, robust="huber")
    argv = base + ["register", files["cat", ".ply"], files["cat_out", ".ply"], "--max-iters", 20,
                   "--diff-threshold", 1.0, "--max-corr-dist", 50, "--robust", "huber",
                   "--metrics", work / "cat.jsonl", "--out", work / "cat_aligned.pcd"]
    if cli._icp_config(cli.build_parser().parse_args([str(a) for a in argv])) != cfg_cat:
        _fail("cli register: its flags do not build the golden config")
    (out, wall_cli), counts = _counted(lambda: _cli(argv))
    src, tgt = (load_cloud(files[n, ".ply"], device=dev) for n in ("cat", "cat_out"))
    res, direct = _counted(lambda: register(src, tgt, cfg_cat))
    rot, terr = _transform_diff(_cli_transform(out, dev), make_rigid_perturbation(device=dev))
    aligned = load_cloud(work / "cat_aligned.pcd", device="cpu").to_numpy()
    true_rmse = float(np.sqrt(((aligned - tgt_np) ** 2).sum(1).mean()))
    recs = [json.loads(line) for line in (work / "cat.jsonl").read_text().splitlines()]
    if not (rot < 5e-3 and terr < 0.5 and true_rmse < 0.5):
        _fail(f"cli cat register: GT not recovered (rot {rot:.3e}, t {terr:.3e}, rmse {true_rmse:.3e})")
    if counts != direct or counts["nn"] < 1:
        _fail(f"cli cat register: launches {counts}, a direct register() {direct}")
    if recs[-1]["event"] != "icp_done" or len(recs) != int(res.iters) + 1:
        _fail(f"cli cat register: {len(recs)} metrics records for {int(res.iters)} iterations")
    print(f"cli cat register ({files['cat', '.ply'].name} onto {files['cat_out', '.ply'].name}, the "
          f"golden config): rot_err={rot:.3e} t_err={terr:.3e} (printed to 6 decimals), aligned "
          f"output's rmse to cat_out {true_rmse:.3e}; launches {counts} = a direct register()'s; "
          f"{len(recs)} metrics records; wall {wall_cli * 1e3:.2f} ms (files read included)")
    pert = dict(axis=(0.0, 0.6, 0.8), angle=0.4, translation=(0.3, -1.2, 2.0))
    _cli(base + ["perturb", files["cat", ".pcd"], work / "cat_perturbed.pcd", "--angle", pert["angle"],
                 "--axis", *pert["axis"], "--translate", *pert["translation"]])
    out, _ = _cli(base + ["horn", files["cat", ".pcd"], work / "cat_perturbed.pcd"])
    from icpx_torch.interop import se3_from_numpy

    t_line = _cli_line(out, "t: ")
    horn = se3_from_numpy(_cli_rows(out, "R:", 3).astype(np.float32),
                          np.array(t_line.split()[1:], np.float32), device=dev)
    h_rot, h_t = _transform_diff(horn, make_rigid_perturbation(**pert, device=dev))
    if not (h_rot < 1e-4 and h_t < 1e-3):
        _fail(f"cli perturb + horn: rot {h_rot:.3e}, t {h_t:.3e} from the perturbation")
    print(f"cli perturb + horn: the perturbation ({pert['angle']} rad about {pert['axis']}, "
          f"t={pert['translation']}) recovered within rot {h_rot:.2e}, t {h_t:.2e}")

    # 3. the flagship through binary_compressed PCD files ------------------------------
    cfg = _flag_configs()["kernels"]
    cfg_file = work / "flag_config.json"
    cfg_file.write_text(json.dumps({"rmse_change_tol": cfg.rmse_change_tol, "tile_q": cfg.tile_q,
                                    "tile_r": cfg.tile_r}))
    argv = base + ["register", flag["src"], flag["tgt"], "--objective", cfg.objective, "--max-iters",
                   cfg.max_iters, "--diff-threshold", cfg.diff_threshold, "--k-normals",
                   cfg.k_normals, "--config", cfg_file]
    if cli._icp_config(cli.build_parser().parse_args([str(a) for a in argv])) != cfg:
        _fail("cli flagship: its flags and --config do not build _flag_configs()['kernels']")
    (out, wall_cli), counts = _counted(lambda: _cli(argv))
    t_cli = _cli_transform(out, dev)
    src, tgt = loaded["src"], loaded["tgt"]
    res, direct = _counted(lambda: register(src, tgt, cfg))
    refine = _check_launches("kernels", counts, res, shapes)
    rot, terr = _transform_diff(t_cli, f_gt)
    if not (rot < 5e-3 and terr < 5e-3):
        _fail(f"cli flagship: GT not recovered (rot {rot:.3e}, t {terr:.3e})")
    if counts != direct or f"iters={int(res.iters)} " not in out:
        _fail(f"cli flagship: launches {counts} and trace {out.splitlines()[-6:]}; a direct "
              f"register() {direct}, {int(res.iters)} iterations")
    g_rot, g_t = _transform_diff(t_cli, res.transform)
    wall_direct, _ = _sync_time(lambda: register(src, tgt, cfg), reps=3)
    wall_cli2 = statistics.median([wall_cli] + [_cli(argv)[1] for _ in range(2)])
    print(f"cli flagship {n_flag} (binary_compressed PCD with intensity, the 'kernels' config as "
          f"flags and --config): rot_err={rot:.3e} t_err={terr:.3e}; iters={int(res.iters)} "
          f"(refine {refine}); launches {counts} = a direct register()'s; its printed transform "
          f"within rot {g_rot:.1e}, t {g_t:.1e} of the direct call's (6 printed decimals); wall "
          f"{wall_cli2 * 1e3:.2f} ms through the CLI (median of 3, both files read), "
          f"{wall_direct * 1e3:.2f} ms a direct register() of the loaded clouds (median of 3)")
    del f_src, f_tgt, loaded, src, tgt

    # 4. compiled odometry from a KITTI velodyne directory ----------------------------
    scans, gt = _odo_sequence(n_odo, odo_frames, dev)
    vel, poses_txt = work / "velodyne", work / "poses.txt"
    write_kitti_sequence(vel, scans, gt, poses_path=poses_txt)
    del scans
    paths = sorted(vel.glob("*.bin"))
    cap = round_up(max(p.stat().st_size // 16 for p in paths))  # load_kitti_sequence's capacity
    argv = base + ["odometry", "--velodyne-dir", vel, "--poses", poses_txt, "--frames", odo_frames,
                   "--compiled", "--max-iters", 10, "--max-corr-dist", 2, "--checkpoint",
                   work / "odo.npz"]
    args = cli.build_parser().parse_args([str(a) for a in argv])
    icp = cli.odometry_icp_config(args)
    if icp != _odo_config():
        _fail(f"cli odometry: {icp} is not the sequence's ICP config")
    native.reset_counts()
    (out, wall_cli), counts = _counted(lambda: _cli(argv))
    if native.CALLS["kitti_xyz"] != odo_frames or any(native.FALLBACKS.values()):
        _fail(f"cli odometry: the .bin scans did not go through the native reader ({native.CALLS})")
    ck = OdometryCheckpoint.load(work / "odo.npz")
    poses = ck.poses(device=dev)
    gt_file = load_kitti_poses(poses_txt, device=dev)
    ate = ate_rmse(poses, gt_file, align=False)
    spawns = int(ck.is_keyframe[1:].sum())
    want = {"sort": odo_frames * kd_level_sorts(cap, 128)
            + (odo_frames - 1) * kd_level_sorts(cap, resolve_odo_q_tile(icp, cap))
            + (1 + spawns) * kd_level_sorts(cap, icp.block_tile)}
    _check_counts("cli odometry --compiled", counts, want)
    if not (math.isfinite(ate) and ate < ODO_ATE_BOUND):
        _fail(f"cli odometry --compiled: ATE {ate:.4f} m (gate {ODO_ATE_BOUND} m)")
    frames = load_kitti_sequence(vel, max_frames=odo_frames, device=dev)
    kw = cli.compiled_kwargs(args)
    comp = run_odometry_compiled(*cli.compiled_inputs(frames, icp), icp, **kw)
    gaps = [_transform_diff(p, q) for p, q in zip(poses, _pose_list(comp.poses))]
    gap = [max(g[0] for g in gaps), max(g[1] for g in gaps)]
    kf_equal = comp.is_keyframe.cpu().tolist() == [bool(v) for v in ck.is_keyframe]
    if not (kf_equal and max(gap) <= ODO_POSE_TOL):
        _fail(f"cli odometry --compiled: keyframes equal {kf_equal}, poses within rot {gap[0]:.2e}, "
              f"t {gap[1]:.2e} of a direct run_odometry_compiled (tolerance {ODO_POSE_TOL})")
    wall_direct, _ = _sync_time(
        lambda: run_odometry_compiled(*cli.compiled_inputs(frames, icp), icp, **kw), reps=3, warmup=0)
    print(f"cli odometry --compiled ({odo_frames} x {n_odo}-point .bin scans and poses.txt): "
          f"ATE {ate:.4f} m (unaligned, gate {ODO_ATE_BOUND}); printed: {_cli_line(out, 'ATE ')} "
          f"(aligned); keyframes {1 + spawns}; launches {counts} = the KD builds'; a direct "
          f"run_odometry_compiled on the loaded frames with the CLI's config and arguments: "
          f"keyframes equal, poses within rot {gap[0]:.2e}, t {gap[1]:.2e}; wall {wall_cli:.3f} s "
          f"through the CLI (files read, normals, odometry, ATE), {wall_direct:.3f} s direct "
          f"(normals and odometry, median of 3)")
    def load_serial():
        return [PointCloud.create(load_kitti_scan(p)[:cap], capacity=cap, device=dev) for p in paths]

    def load_prefetched():
        return list(prefetch_kitti(vel, capacity=cap, depth=3, device=dev))

    serial, streamed = load_serial(), load_prefetched()  # warm: the first of each is cold
    if len(streamed) != len(serial) or not all(
            torch.equal(a.xyz, b.xyz) and torch.equal(a.mask, b.mask) for a, b in zip(streamed, serial)):
        _fail("cli prefetch_kitti: its clouds differ from the serial load's")
    w_serial, w_pref = _ab_walls(load_serial, load_prefetched, 3)
    print(f"cli prefetch_kitti: {len(paths)} scans in order, equal to the serial load bit for bit; "
          f"{statistics.median(w_pref) * 1e3:.2f} ms with 3 loads in flight, "
          f"{statistics.median(w_serial) * 1e3:.2f} ms serial (host clock to the device, median of "
          f"3 after a warm call of each, ABBA; readings {[round(t * 1e3, 2) for t in w_pref]}, "
          f"{[round(t * 1e3, 2) for t in w_serial]})")
    del frames, serial, streamed, comp

    # 5. the CLI's own odometry default: synthetic, host frontend, loop closure,
    #    checkpoint and resume ------------------------------------------------------------
    synth = base + ["odometry", "--synthetic", "--points-per-scan", n_synth]
    (out, wall_cli), counts = _counted(lambda: _cli(
        synth + ["--frames", odo_frames, "--loop-closure", "--checkpoint", work / "synth.npz"]))
    ck = OdometryCheckpoint.load(work / "synth.npz")
    if len(ck.poses_t) != odo_frames or not np.isfinite(ck.poses_t).all() or counts["fold6"] < 1:
        _fail(f"cli odometry --synthetic: {len(ck.poses_t)} poses, launches {counts}")
    lines = [line for line in out.splitlines() if line.startswith(("ATE", "loop", "pose graph"))]
    print(f"cli odometry --synthetic ({odo_frames} x {n_synth}, host frontend, --loop-closure): "
          f"{_cli_line(out, f'{odo_frames} frames')}; {'; '.join(lines)}; launches {counts}; "
          f"wall {wall_cli:.3f} s")
    full_n, part_n = min(8, odo_frames), min(5, odo_frames - 1)
    _cli(synth + ["--frames", full_n, "--checkpoint", work / "full.npz"])
    _cli(synth + ["--frames", part_n, "--checkpoint", work / "part.npz"])
    out, _ = _cli(synth + ["--frames", full_n, "--resume", work / "part.npz", "--checkpoint",
                           work / "resumed.npz"])
    full, resumed = (OdometryCheckpoint.load(work / f"{n}.npz") for n in ("full", "resumed"))
    same = (np.allclose(resumed.poses_t, full.poses_t, atol=1e-6, rtol=0)
            and np.allclose(resumed.poses_R, full.poses_R, atol=1e-6, rtol=0)
            and [e[:2] for e in resumed.edges] == [e[:2] for e in full.edges])
    if "resuming from" not in out or not same:
        _fail("cli odometry --resume: the resumed run differs from the uninterrupted one")
    print(f"cli odometry --resume: {part_n} frames checkpointed, resumed to {full_n}: equal to the "
          f"uninterrupted run (poses within 1e-6, {len(full.edges)} edges)")

    # 6. a fresh process through the module entry ----------------------------------------
    fresh = ["--device", "cuda" if dev.type == "cuda" else str(dev), "info", files["cat", ".pcd"]]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "icpx_torch.cli", *map(str, fresh)], cwd=root,
                          capture_output=True, text=True, timeout=300)
    fresh_s = time.perf_counter() - t0
    if proc.returncode != 0 or f"{len(src_np)} points" not in proc.stdout:
        _fail(f"cli fresh process: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr[-2000:]}")
    print(f"cli fresh process: python3 -m icpx_torch.cli {' '.join(fresh[:2])} info "
          f"{files['cat', '.pcd'].name} -> {proc.stdout.strip()} ({fresh_s:.2f} s)")
    shutil.rmtree(work)
    print(f"cli phase: {time.perf_counter() - t_phase:.1f} s")


def _loop_poses(n_frames, dev, radius=6.0, laps=2.0):
    """tests/test_slam.py's two laps of a circle."""
    from icpx_torch.geometry.se3 import SE3

    out = []
    for k in range(n_frames):
        th = laps * 2 * np.pi * k / (n_frames - 1)
        c, s = np.cos(th), np.sin(th)
        out.append(SE3(R=torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=torch.float32,
                                      device=dev),
                       t=torch.tensor([radius * np.sin(th), radius * (1 - np.cos(th)), 1.2],
                                      dtype=torch.float32, device=dev)))
    return out


SLAM_REF_POINTS = 2048  # tests/test_slam.py's scans


def _phase_slam(dev, n, frames=30, factor=0.7):
    """tests/test_slam.py::test_loop_closure_pose_graph_reduces_ate at n
    points a scan: scan_to_keyframe odometry around two laps, loop closures
    verified among its keyframes (`register_batch`: the nn kernel), then
    the odometry chain plus the closures through both pose-graph solvers,
    each of which must bring the keyframes' ATE below `factor` x the
    drifted one: the test's 0.7 at its own 2,048 points. At 8,192 points
    the odometry drifts less and the JAX package itself verifies one
    closure and cuts the ATE to 0.767 x (`python tests/test_torch_slam.py
    8192 jax` on the CPU), so there the phase holds a closure found and
    both solvers lowering the ATE (factor 1)."""
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.odometry.evaluate import ate_rmse
    from icpx_torch.odometry.frontend import OdometryConfig, run_odometry
    from icpx_torch.odometry.kitti import make_world, simulate_scans
    from icpx_torch.odometry.loopclosure import LoopClosureConfig, detect_loop_closures
    from icpx_torch.odometry.posegraph import (PoseGraph, optimize_pose_graph,
                                              optimize_pose_graph_sparse)
    from icpx_torch.registration.icp import ICPConfig

    world = make_world(n_points=80000, extent=25.0, seed=2)
    gt = _loop_poses(frames, dev)
    scans = simulate_scans(world, gt, max_range=14.0, points_per_scan=n, noise=0.02, seed=3,
                           device=dev)
    gt = [gt[0].inverse() @ g for g in gt]
    icp = dict(objective="symmetric", max_iters=15, diff_threshold=0.0, rmse_change_tol=1e-6,
               robust="huber")
    t0 = time.perf_counter()
    res = run_odometry(scans, OdometryConfig(icp=ICPConfig(max_corr_dist=3.0, **icp),
                                             keyframe_trans=1.5, keyframe_rot=0.3, pyramid_levels=2))
    t_odo = time.perf_counter() - t0
    kf = res.keyframe_indices
    kf_poses = [res.poses[i] for i in kf]
    lc_cfg = LoopClosureConfig(min_separation=4, max_candidate_dist=4.0, accept_rmse=0.12,
                               icp=ICPConfig(max_corr_dist=2.0, **icp))
    closures, counts = _counted(lambda: detect_loop_closures(kf_poses, [scans[i] for i in kf],
                                                             lc_cfg))
    if not closures or counts["nn"] < 1:
        _fail(f"slam: no loop closure found on a closed loop (launches {counts})")
    # the same closures, bit for bit, a second time
    _check_repeats(f"slam {n} detect_loop_closures", [
        closures, detect_loop_closures(kf_poses, [scans[i] for i in kf], lc_cfg)])
    # the nn kernel on a verification's operands: the first closure's source
    # keyframe under its accepted transform against its target and mask
    i, j, T, _ = closures[0]
    src, tgt = scans[kf[j]], scans[kf[i]]
    _nn_equal(f"slam {n} closure {(i, j)}", T.apply(src.xyz).contiguous(), tgt.xyz, tgt.mask)
    remap = {f: i for i, f in enumerate(kf)}
    edges = [(remap[i], remap[j], T) for (i, j, T) in res.edges if i in remap and j in remap]
    edges += [(i, j, T) for (i, j, T, _) in closures]
    graph = PoseGraph.from_edge_list(SE3(R=torch.stack([p.R for p in kf_poses]),
                                         t=torch.stack([p.t for p in kf_poses])), edges)
    gt_kf = [gt[i] for i in kf]
    before = ate_rmse(kf_poses, gt_kf, align=False)
    after = {}
    for solve in (optimize_pose_graph, optimize_pose_graph_sparse):
        t0 = time.perf_counter()
        opt, chi2 = solve(graph, iters=10)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # a second solve of the same graph: the same bits (fixed-order sums)
        _check_repeats(f"slam {n} {solve.__name__}", [(opt, chi2), solve(graph, iters=10)])
        after[solve.__name__] = (ate_rmse(_pose_list(opt), gt_kf, align=False), ms)
        if not after[solve.__name__][0] < factor * before:
            _fail(f"slam {n}: {solve.__name__} did not cut the ATE below {factor} x ({before:.4f} "
                  f"-> {after[solve.__name__][0]:.4f} m)")
    print(f"slam {n} x {frames} (two laps): odometry {t_odo * 1e3:.2f} ms, {len(kf)} keyframes, "
          f"keyframe ATE {before:.4f} m; {len(closures)} closures "
          f"{[(a, b) for a, b, _, _ in closures]} (launches {counts}; the nn kernel bit-equal "
          f"to its plain version on closure {(i, j)}'s operands, {n} x {n}; found again bit for "
          f"bit); after " + ", ".join(f"{k} {v[0]:.4f} m = {v[0] / before:.3f} x ({v[1]:.2f} ms, "
                                      f"one call; a second call bit-equal)"
                                      for k, v in after.items()) + f" (gate {factor} x)")


def _gicp_config():
    """The flagship config with the GICP objective; payload "auto" is fold6
    on the card, its table 12 wide (xyz and the flattened covariance)."""
    return dataclasses.replace(_flag_configs()["kernels"], objective="gicp")


def _fused_covariances(cloud, k, fused=True):
    """The cloud with GICP covariances estimated through the fused branch of
    `_block_radius_cov` (the union moments kernel on the card), as
    `register()` would estimate them were `use_fused_default()` true; with
    `fused=False` through the default branch (the plain radius moments)."""
    from icpx_torch.kernels.normals import _covariances_xyz

    covs, _ = _covariances_xyz(cloud.xyz, cloud.mask, k=k, epsilon=1e-3, method="block", fused=fused)
    return cloud.replace(covs=covs)


# ---- the distributed layer ---------------------------------------------------------------

N_GRAPH = 1000  # the pose graph's keyframes (tests/test_posegraph.py's scale test)
N_PIPE = 8000  # the pipeline's pairs, scan-size clouds
B_PIPE = 6
N_MAP = 300000  # the bench world, one map block a rank
DIST_TOL = 1e-5  # a distributed result against its single-device or W = 1 counterpart
DIST_TOL_HIST = 1e-4  # ... where histogram quantiles decide the weights


def _dist_open(rank: int, world: int, tmp: str, backend: str) -> None:
    """Join a process group of `world` ranks over a FileStore in `tmp`."""
    import datetime
    import os

    import torch.distributed as dist

    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))


def _dist_counted(fn):
    """`_counted` with its seconds: (result, {kernel: launches}, seconds)."""
    t0 = time.perf_counter()
    out, counts = _counted(fn)
    return out, counts, time.perf_counter() - t0


def _pose_chain(m, dev, seed=0):
    """tests/test_posegraph.py's scale graph from numpy: m keyframes 0.3 m
    apart with small turns, a loop edge every 100 nodes, the start poses
    noised; (graph, GT translations (m, 3))."""
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.odometry.posegraph import PoseGraph

    rng = np.random.default_rng(seed)
    tw = np.concatenate([0.05 * rng.normal(size=(m - 1, 3)), 0.3 * np.ones((m - 1, 1)),
                         np.zeros((m - 1, 2))], axis=1).astype(np.float32)
    deltas = SE3.exp(torch.as_tensor(tw, device=dev))
    poses = [SE3.identity(device=dev)]
    for k in range(m - 1):
        poses.append(poses[-1] @ SE3(R=deltas.R[k], t=deltas.t[k]))
    gt = SE3(R=torch.stack([p.R for p in poses]), t=torch.stack([p.t for p in poses]))
    edges = [(k, k + 1, SE3(R=deltas.R[k], t=deltas.t[k])) for k in range(m - 1)]
    for a in range(0, m - 200, 100):
        edges.append((a, a + 150, poses[a].inverse() @ poses[a + 150]))
    noise = SE3.exp(torch.as_tensor(0.02 * rng.normal(size=(m, 6)).astype(np.float32), device=dev))
    init = SE3(R=torch.cat([gt.R[:1], (gt.R @ noise.R)[1:]]),
               t=torch.cat([gt.t[:1], (gt.t + noise.t)[1:]]))
    return PoseGraph.from_edge_list(init, edges), gt.t


def _map_case(dev, n_map, n_scan):
    """(f)'s inputs: the bench world of n_map points with normals as one
    cloud, and its first simulated scan of n_scan points (bench.py
    --odometry's frame 0) at its pose, moved by the inverse of a small
    rigid motion `delta`: (world cloud, scan cloud with normals, delta)."""
    from icpx_torch.cloud import PointCloud
    from icpx_torch.geometry.transforms import make_rigid_perturbation
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.odometry.kitti import make_trajectory, make_world, simulate_scans

    world = make_world(n_points=n_map, extent=50.0, seed=0, n_posts=300, ground_frac=0.5)
    pose = make_trajectory(1, speed=0.6, turn=0.02, device=dev)[0]
    scan = simulate_scans(world, [pose], max_range=25.0, points_per_scan=n_scan, noise=0.01,
                          seed=1, device=dev)[0]
    delta = make_rigid_perturbation(axis=(0.0, 0.0, 1.0), angle=0.04,
                                    translation=(0.08, -0.05, 0.02), device=dev)
    xyz = delta.inverse().apply(pose.apply(scan.xyz))
    src = estimate_normals(PointCloud.create(xyz[scan.mask], capacity=scan.capacity, device=dev),
                           k=10)
    world_c = estimate_normals(PointCloud.create(world, device=dev), k=10)
    return world_c, src, delta


def _map_config():
    from icpx_torch.registration.icp import ICPConfig

    return ICPConfig(objective="p2plane", max_iters=15, diff_threshold=0.0, rmse_change_tol=1e-6,
                     max_corr_dist=1.0, robust="huber")


def _pipe_pairs(dev, n, b):
    """(g)'s batch: b pairs of n points, tests/test_pipeline.py's GT, with
    normals (brute kNN): (stacked tensors, GTs, config)."""
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.registration.icp import ICPConfig

    pairs = [_gt_pair(n, 60 + i, dev, angle=0.25, translation=(0.12, -0.08, 0.05),
                      axis=(0.1, 0.15, 0.98)) for i in range(b)]
    pairs = [(estimate_normals(s, k=10), estimate_normals(t, k=10), g) for s, t, g in pairs]
    stack = lambda i, f: torch.stack([getattr(p[i], f) for p in pairs])  # noqa: E731
    args = [stack(i, f) for i in (0, 1) for f in ("xyz", "mask", "normals")]
    cfg = ICPConfig(objective="symmetric", max_iters=6, diff_threshold=0.0, robust="huber")
    return args, [p[2] for p in pairs], cfg


PIPE_KW = dict(iters_per_level=8, subsample=4)


def _flag_block_config():
    """The flagship config on the sharded block path: every iteration a
    full tile-index NN (no coarse phase, nothing frozen, as the
    reference's sharded block path), so 20 iterations from the GT's
    0.2 rad."""
    return dataclasses.replace(_flag_configs()["kernels"], nn_method="block", max_iters=20)


def _busy(run, wall):
    """One profiled call of `run`: its device time and that time's share of
    the unprofiled wall, as a line's tail."""
    _, prof_ms, busy_ms, rows, _ = _device_profile(run)
    top = ", ".join(f"{e.key[:40]} {_device_us(e) / 1e3:.2f} ms" for e in rows[:3])
    return (f"; profiled: device {busy_ms:.2f} ms = {100 * busy_ms / (wall * 1e3):.1f}% of the "
            f"wall (profiled call {prof_ms:.2f} ms; largest: {top})")


def _dist_items(mesh_of, flag, map_in, pipe_in, graph):
    """The items both the one-rank and the two-rank runs make, on whatever
    group is open: {label: (result, launches, seconds)}. `mesh_of(names)`
    builds a mesh over every rank of it."""
    from icpx_torch.distributed.map_ep import partition_map, sharded_map_register
    from icpx_torch.distributed.pipeline import pipelined_pyramid_register
    from icpx_torch.distributed.sharded_icp import sharded_register
    from icpx_torch.odometry.posegraph import optimize_pose_graph_sharded, pad_edges

    out = {}
    src, tgt = flag
    cfg_b = _flag_block_config()
    mesh = mesh_of(("points",))
    out["b ring"] = _dist_counted(lambda: sharded_register(src, tgt, cfg_b, mesh, ring=True))
    world, scan = map_in
    blocks_mesh = mesh_of(("blocks",))
    w = len(blocks_mesh.mesh.reshape(-1))
    mb = partition_map(world.xyz, world.normals, world.mask, n_blocks=w)
    out["f"] = _dist_counted(
        lambda: sharded_map_register(scan, mb, _map_config(), blocks_mesh, nn="block"))
    args, cfg_p = pipe_in
    out["g"] = _dist_counted(
        lambda: pipelined_pyramid_register(*args, cfg_p, mesh_of(("stages",)), **PIPE_KW))
    out["h"] = _dist_counted(
        lambda: optimize_pose_graph_sharded(pad_edges(graph, w), mesh, iters=8))
    return out


def _dist_rank(rank, world, tmp, dev_type):
    """One rank of the two-rank check (spawned): gloo over a FileStore in
    `tmp`, both ranks on the same device; reads the inputs the parent saved
    and saves its results (numpy) and launches."""
    import os

    import torch.distributed as dist

    from icpx_torch.cloud import PointCloud
    from icpx_torch.distributed.mesh import make_mesh

    torch.set_num_threads(2)
    dev = torch.device("cuda", 0) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    _dist_open(rank, world, tmp, "gloo")
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)

        def cloud(d):
            return PointCloud(**{k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in d.items()})

        def mesh_of(names):
            return make_mesh(None, names, device=dev.type)

        from icpx_torch.odometry.posegraph import PoseGraph
        from icpx_torch.geometry.se3 import SE3

        g = inp["graph"]
        graph = PoseGraph(poses=SE3(R=g["pR"].to(dev), t=g["pt"].to(dev)),
                          edge_i=g["i"].to(dev), edge_j=g["j"].to(dev),
                          edge_meas=SE3(R=g["mR"].to(dev), t=g["mt"].to(dev)),
                          edge_weight=g["w"].to(dev))
        t0 = time.perf_counter()
        items = _dist_items(mesh_of, (cloud(inp["src"]), cloud(inp["tgt"])),
                            (cloud(inp["world"]), cloud(inp["scan"])),
                            ([a.to(dev) for a in inp["pipe_args"]], inp["pipe_cfg"]), graph)
        res = {}
        for label, (r, counts, secs) in items.items():
            T = r[0] if isinstance(r, tuple) else (r.transform if hasattr(r, "transform") else r)
            res[label] = {"R": T.R.detach().cpu().numpy(), "t": T.t.detach().cpu().numpy(),
                          "launches": counts, "secs": secs}
        res["secs"] = time.perf_counter() - t0
        torch.save(res, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _host_dict(cloud):
    return {f.name: (getattr(cloud, f.name).cpu() if torch.is_tensor(getattr(cloud, f.name))
                     else getattr(cloud, f.name)) for f in dataclasses.fields(cloud)}


def _two_ranks(dev, inputs):
    """Spawn two ranks (gloo, both on `dev`) running `_dist_items` on
    `inputs`; their results, rank 0's first, and the seconds it took."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="icpx_dist_")
    try:
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        mp.start_processes(_dist_rank, args=(2, tmp, dev.type), nprocs=2, join=True,
                           start_method="spawn")
        secs = time.perf_counter() - t0
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(2)], secs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_distributed(dev, n_pair, n_flag, n_batch, b_batch, odo, kernels, n_map=N_MAP,
                       n_scan=N_ODO, n_graph=N_GRAPH, n_pipe=N_PIPE, b_pipe=B_PIPE):
    """The distributed layer (`icpx_torch.distributed`) through its entry
    points, at one rank over NCCL (gloo off the card), then at two ranks.

    One rank, each item held to its GT gate, its launches counted around
    it (a distributed path launches the kernels of its shards: the nn
    kernel once an NN pass, the sort kernel once a KD level) and its wall
    printed (median of 3): (a) `sharded_register` brute, replicated and
    ring, on the 65,536-point pair against `register()` (exact robust
    settings: 1e-5); (b) the block path, replicated and ring, on the 1M
    flagship; (c) GICP there; (d) `sharded_register_pairs` on
    `_phase_batch`'s 8 x 8,000 pairs against `register_batch`, and as GICP
    pairs against `register()` pair by pair (neither package's
    register_batch takes covariances); (e) `parallel_odometry` on the
    compiled odometry phase's 65,536-point scans (`odo`) at max_iters 30,
    its unaligned ATE gated at max(2 x that phase's sequential ATE, 0.08)
    and 0.5 m; (f) `sharded_map_register` (nn="block") of a scan against
    the bench world as one block; (g) `pipelined_pyramid_register` on 6
    pairs of 8,000; (h) `optimize_pose_graph_sharded` on a 1,000-keyframe
    chain, bit-equal to the dense `optimize_pose_graph` (one rank sums the
    same edges in the same fixed order).

    Two ranks (spawned, gloo, both on the same card): (b) ring at 524,288
    source points a rank, (f) at 2 blocks, (g) at 2 stages, (h) at 2 edge
    shards, each against the one-rank result (1e-5, 1e-4 for (f), whose
    MAD scale comes from histogram quantiles, and for (h) 1e-5 of the
    chain's extent) and its GT gate."""
    import os
    import tempfile

    import torch.distributed as dist

    from icpx_torch.distributed.mesh import make_mesh
    from icpx_torch.distributed.sharded_icp import sharded_register, sharded_register_pairs
    from icpx_torch.geometry.se3 import SE3
    from icpx_torch.kernels.blocknn import kd_level_sorts
    from icpx_torch.kernels.normals import estimate_covariances, estimate_normals
    from icpx_torch.odometry.evaluate import ate_rmse
    from icpx_torch.odometry.parallel import parallel_odometry
    from icpx_torch.odometry.posegraph import optimize_pose_graph
    from icpx_torch.registration.icp import ICPConfig, register, register_batch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="icpx_dist_")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    _dist_open(0, 1, tmp, backend)
    launches = {"nn": 0, "sort": 0}
    try:
        if dev.type == "cuda":
            print(f"distributed: one rank over {dist.get_backend()} (torch {torch.__version__})")

        def mesh_of(names, shape=None):
            return make_mesh(shape, names, device=dev.type)

        t_item = [time.perf_counter()]

        def line(label, res_ok, counts, wall, extra=""):
            for k in launches:
                launches[k] += counts.get(k, 0)
            now = time.perf_counter()
            print(f"distributed {label}: {res_ok}; launches={counts}; wall {wall * 1e3:.2f} ms "
                  f"(median of 3){extra}; item {now - t_item[0]:.2f} s")
            t_item[0] = now

        def gated(label, res, gt, tol=5e-3):
            rot, terr = (float(x) for x in res.transform.distance_to(gt))
            if not (math.isfinite(float(res.final_rmse)) and rot < tol and terr < tol):
                _fail(f"distributed {label}: GT not recovered (rot {rot:.3e}, t {terr:.3e})")
            return f"iters={res.iters} rot_err={rot:.3e} t_err={terr:.3e}"

        mesh = mesh_of(("points",))
        # (a) brute, on the 65k pair with normals given
        src, tgt, gt = _gt_pair(n_pair, 0, dev)
        cfg_pair = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=0.0,
                             rmse_change_tol=1e-6, k_normals=10, nn_method="brute",
                             tile_q=2048, tile_r=8192)
        s_n = estimate_normals(src, k=10, method="brute")
        t_n = estimate_normals(tgt, k=10, method="brute")
        single = register(s_n, t_n, cfg_pair)
        for ring in (False, True):
            run = lambda: sharded_register(s_n, t_n, cfg_pair, mesh, ring=ring)  # noqa: E731
            res, counts = _counted(run)
            ok = gated(f"(a) brute {'ring' if ring else 'replicated'}", res, gt)
            _check_counts(f"distributed (a) ring={ring}", counts, {"nn": res.iters})
            d_rot, d_t = _transform_diff(res.transform, single.transform)
            if max(d_rot, d_t) > DIST_TOL:
                _fail(f"distributed (a) ring={ring}: {d_rot:.2e} rad, {d_t:.2e} from register()")
            wall, _ = _sync_time(run, reps=3)
            line(f"(a) sharded_register {n_pair} brute {'ring' if ring else 'replicated'}", ok,
                 counts, wall, f"; against register() rot {d_rot:.1e}, t {d_t:.1e}")
        del src, tgt, s_n, t_n

        # (b), (c): the 1M flagship on the block path, normals (covariances) first
        f_src, f_tgt, f_gt = _gt_pair(n_flag, 0, dev)
        t0 = time.perf_counter()
        f_src, f_tgt = estimate_normals(f_src, k=10), estimate_normals(f_tgt, k=10)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        normals_s = time.perf_counter() - t0
        cfg_b = _flag_block_config()
        q_tile = cfg_b.resolve_q_tile(n_flag)
        sorts = kd_level_sorts(n_flag, q_tile) + kd_level_sorts(n_flag, cfg_b.block_tile)
        flag_w1 = {}
        for ring in (False, True):
            run = lambda: sharded_register(f_src, f_tgt, cfg_b, mesh, ring=ring)  # noqa: E731
            res, counts = _counted(run)
            flag_w1[ring] = res
            ok = gated(f"(b) ring={ring}", res, f_gt)
            _check_counts(f"distributed (b) ring={ring}", counts, {"sort": sorts})
            wall, _ = _sync_time(run, reps=3)
            line(f"(b) sharded_register {n_flag} block {'ring' if ring else 'replicated'}", ok,
                 counts, wall, f"; normals (both clouds, before) {normals_s * 1e3:.2f} ms"
                 + _busy(run, wall))
        cfg_c = dataclasses.replace(cfg_b, objective="gicp")
        g_src = estimate_covariances(f_src.replace(normals=None), k=15)
        g_tgt = estimate_covariances(f_tgt.replace(normals=None), k=15)
        run = lambda: sharded_register(g_src, g_tgt, cfg_c, mesh)  # noqa: E731
        res, counts = _counted(run)
        ok = gated("(c) gicp", res, f_gt)
        _check_counts("distributed (c)", counts, {"sort": sorts})
        wall, _ = _sync_time(run, reps=3)
        line(f"(c) sharded_register {n_flag} gicp", ok, counts, wall)
        del g_src, g_tgt

        # (d) DP pairs: the batch phase's pairs, then as GICP pairs
        pmesh = mesh_of(("pairs", "points"), (1, 1))
        pairs, args, cfg_d = _batch_run(dev, n_batch, b_batch)
        res, counts = _counted(lambda: sharded_register_pairs(*args, cfg_d, pmesh))
        _check_counts("distributed (d)", counts, {"nn": int(res.iters.sum())})
        ref = register_batch(*args, cfg_d)
        gap = max(float((res.transform.R - ref.transform.R).abs().max()),
                  float((res.transform.t - ref.transform.t).abs().max()))
        worst = 0.0
        for i, (_, _, g) in enumerate(pairs):
            one = SE3(R=res.transform.R[i], t=res.transform.t[i])
            rot, terr = (float(x) for x in one.distance_to(g))
            worst = max(worst, rot, terr)
        if gap > 1e-6 or worst > 5e-3:
            _fail(f"distributed (d): {gap:.2e} from register_batch, GT worst {worst:.2e}")
        wall, _ = _sync_time(lambda: sharded_register_pairs(*args, cfg_d, pmesh), reps=3)
        line(f"(d) sharded_register_pairs {b_batch} x {n_batch}", f"iters {res.iters.tolist()}, "
             f"GT worst {worst:.2e}, within {gap:.1e} of register_batch", counts, wall)
        cov = [(estimate_covariances(s, k=15), estimate_covariances(t, k=15)) for s, t, _ in pairs]
        cfg_dg = dataclasses.replace(cfg_d, objective="gicp")
        g_args = [torch.stack([getattr(c[i], f) for c in cov]) for i in (0, 1)
                  for f in ("xyz", "mask", "covs")]
        g_args = [a.reshape(a.shape[0], a.shape[1], 9) if a.ndim == 4 else a for a in g_args]
        res, counts = _counted(lambda: sharded_register_pairs(*g_args, cfg_dg, pmesh))
        _check_counts("distributed (d) gicp", counts, {"nn": int(res.iters.sum())})
        gap, worst = 0.0, 0.0
        for i, ((s, t), (_, _, g)) in enumerate(zip(cov, pairs)):
            one = SE3(R=res.transform.R[i], t=res.transform.t[i])
            alone = register(s, t, cfg_dg)
            gap = max(gap, *_transform_diff(one, alone.transform))
            worst = max(worst, *(float(x) for x in one.distance_to(g)))
        if gap > 1e-6 or worst > 5e-3:
            _fail(f"distributed (d) gicp: {gap:.2e} from register(), GT worst {worst:.2e}")
        wall, _ = _sync_time(lambda: sharded_register_pairs(*g_args, cfg_dg, pmesh), reps=3)
        line(f"(d) sharded_register_pairs {b_batch} x {n_batch} gicp", f"iters "
             f"{res.iters.tolist()}, GT worst {worst:.2e}, each within {gap:.1e} of register()",
             counts, wall)
        del pairs, args, cov, g_args

        # (e) parallel odometry on the compiled phase's scans
        scans, gt_odo, ate_seq = odo["scans"], odo["gt"], odo["ate"]
        t0 = time.perf_counter()
        with_n = [estimate_normals(f, k=10) for f in scans]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        normals_s = time.perf_counter() - t0
        cfg_e = dataclasses.replace(_odo_config(), max_iters=30)
        # the pairs' iterations, read off the batch call parallel_odometry makes
        from icpx_torch.distributed import sharded_icp

        calls = []

        def spy(*a, **kw):
            calls.append(sharded_register_pairs(*a, **kw))
            return calls[-1]

        sharded_icp.sharded_register_pairs = spy
        try:
            (poses, edges, rmse), counts = _counted(
                lambda: parallel_odometry(with_n, cfg_e, pmesh))
        finally:
            sharded_icp.sharded_register_pairs = sharded_register_pairs
        iters = calls[0].iters
        _check_counts("distributed (e)", counts, {"nn": int(iters.sum())})
        ate = ate_rmse(poses, gt_odo, align=False)
        gate = max(2.0 * ate_seq, 0.08)
        if not (math.isfinite(ate) and ate < gate and ate < ODO_ATE_BOUND):
            _fail(f"distributed (e): ATE {ate:.4f} m (gate {gate:.4f}, {ODO_ATE_BOUND})")
        wall, _ = _sync_time(lambda: parallel_odometry(with_n, cfg_e, pmesh), reps=3)
        busy_e = _busy(lambda: parallel_odometry(with_n, cfg_e, pmesh), wall)
        line(f"(e) parallel_odometry {len(scans)} x {scans[0].capacity}",
             f"ATE {ate:.4f} m (unaligned; gate {gate:.4f}: the sequential {ate_seq:.4f} m x 2, "
             f"at least 0.08), final RMSE <= {float(rmse.max()):.3e}", counts, wall,
             f"; registrations only, the normals of the {len(scans)} scans "
             f"{normals_s * 1e3:.2f} ms before; ICP iterations {iters.tolist()}{busy_e}")
        del with_n

        # (f) scan-to-map, one block
        world, scan, delta = _map_case(dev, n_map, n_scan)
        from icpx_torch.distributed.map_ep import partition_map, sharded_map_register

        bmesh = mesh_of(("blocks",))
        mb = partition_map(world.xyz, world.normals, world.mask, n_blocks=1)
        run = lambda: sharded_map_register(scan, mb, _map_config(), bmesh, nn="block")  # noqa: E731
        res_f, counts = _counted(run)
        ok = gated("(f) map", res_f, delta)
        _check_counts("distributed (f)", counts,
                      {"sort": kd_level_sorts(mb.block_size, _map_config().block_tile)})
        wall, _ = _sync_time(run, reps=3)
        line(f"(f) sharded_map_register {scan.capacity} scan against {mb.block_size} map points",
             ok, counts, wall)

        # (g) the stage pipeline
        p_args, p_gts, cfg_g = _pipe_pairs(dev, n_pipe, b_pipe)
        from icpx_torch.distributed.pipeline import pipelined_pyramid_register

        smesh = mesh_of(("stages",))
        run = lambda: pipelined_pyramid_register(*p_args, cfg_g, smesh, **PIPE_KW)  # noqa: E731
        out_g, counts = _counted(run)
        _check_counts("distributed (g)", counts, {"nn": b_pipe * PIPE_KW["iters_per_level"]})
        worst = max(max(float(x) for x in SE3(R=out_g.R[i], t=out_g.t[i]).distance_to(g))
                    for i, g in enumerate(p_gts))
        if worst > 8e-3:
            _fail(f"distributed (g): GT worst {worst:.2e} (gate 8e-3)")
        wall, _ = _sync_time(run, reps=3)
        line(f"(g) pipelined_pyramid_register {b_pipe} x {n_pipe}, 1 stage",
             f"GT worst {worst:.2e}", counts, wall)

        # (h) the edge-sharded pose graph against the dense solver
        graph, gt_t = _pose_chain(n_graph, dev)
        from icpx_torch.odometry.posegraph import optimize_pose_graph_sharded

        run = lambda: optimize_pose_graph_sharded(graph, mesh, iters=8)  # noqa: E731
        (opt_h, chi2), counts = _counted(run)
        _check_counts("distributed (h)", counts, {})
        dense, chi2_d = optimize_pose_graph(graph, iters=8)
        # one rank sums the same edges in the same fixed order as the dense
        # solver, and an all-reduce over one rank adds nothing: the same bits
        _check_repeats("distributed (h) against optimize_pose_graph", [(dense, chi2_d), (opt_h, chi2)])
        if not float(chi2[-1]) < float(chi2[0]) * 1e-2:
            _fail(f"distributed (h): chi2 {chi2.tolist()}")
        wall, _ = _sync_time(run, reps=3)
        line(f"(h) optimize_pose_graph_sharded {n_graph} keyframes, {graph.n_edges} edges",
             f"bit-equal to optimize_pose_graph, chi2 {float(chi2[0]):.3e} -> "
             f"{float(chi2[-1]):.3e}", counts, wall)
        one = {"b ring": flag_w1[True].transform, "f": res_f.transform, "g": out_g, "h": opt_h}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    kernels["nn"]["launches_distributed"] = launches["nn"]
    kernels["sort"]["launches_distributed"] = launches["sort"]
    secs_one = time.perf_counter() - t_phase

    # two ranks, gloo, both on this device
    g = graph
    inputs = {"src": _host_dict(f_src), "tgt": _host_dict(f_tgt), "world": _host_dict(world),
              "scan": _host_dict(scan), "pipe_args": [a.cpu() for a in p_args], "pipe_cfg": cfg_g,
              "graph": {"pR": g.poses.R.cpu(), "pt": g.poses.t.cpu(), "i": g.edge_i.cpu(),
                        "j": g.edge_j.cpu(), "mR": g.edge_meas.R.cpu(), "mt": g.edge_meas.t.cpu(),
                        "w": g.edge_weight.cpu()}}
    (r0, r1), secs_two = _two_ranks(dev, inputs)
    tols = {"b ring": DIST_TOL, "f": DIST_TOL_HIST, "g": DIST_TOL, "h": DIST_TOL}
    gts = {"b ring": f_gt, "f": delta}
    parts = []
    for label, tol in tols.items():
        for k in ("R", "t"):
            if not np.array_equal(r0[label][k], r1[label][k]):
                _fail(f"distributed 2 ranks ({label}): the ranks' results differ")
        gap = max(float(np.abs(r0[label]["R"] - one[label].R.cpu().numpy()).max()),
                  float(np.abs(r0[label]["t"] - one[label].t.cpu().numpy()).max()))
        if label == "h":
            # two partial systems sum in another order than one: relative to
            # the chain's extent, as fp32 holds a pose 300 m out to 3e-5 m
            tol *= max(1.0, float(one[label].t.abs().max()))
        if gap > tol:
            _fail(f"distributed 2 ranks ({label}): {gap:.2e} from the one-rank result (tol {tol})")
        if label in gts:
            T = SE3(R=torch.as_tensor(r0[label]["R"], device=dev),
                    t=torch.as_tensor(r0[label]["t"], device=dev))
            rot, terr = (float(x) for x in T.distance_to(gts[label]))
            if rot > 5e-3 or terr > 5e-3:
                _fail(f"distributed 2 ranks ({label}): GT rot {rot:.2e}, t {terr:.2e}")
        elif label == "g":
            T = SE3(R=torch.as_tensor(r0[label]["R"], device=dev),
                    t=torch.as_tensor(r0[label]["t"], device=dev))
            worst = max(max(float(x) for x in SE3(R=T.R[i], t=T.t[i]).distance_to(gg))
                        for i, gg in enumerate(p_gts))
            if worst > 8e-3:
                _fail(f"distributed 2 ranks (g): GT worst {worst:.2e}")
        if dev.type == "cuda" and label in ("b ring", "g"):
            kern = "sort" if label == "b ring" else "nn"
            if min(r[label]["launches"][kern] for r in (r0, r1)) < 1:
                _fail(f"distributed 2 ranks ({label}): no {kern} launch on a rank")
        parts.append(f"{label} within {gap:.1e} ({r0[label]['secs']:.2f} s, launches "
                     f"{ {k: v for k, v in r0[label]['launches'].items() if v} })")
    print(f"distributed 2 ranks (gloo, one device): " + "; ".join(parts)
          + f"; the ranks' work {r0['secs']:.1f} s, spawn to join {secs_two:.1f} s")
    print(f"distributed phase: {time.perf_counter() - t_phase:.1f} s (one rank {secs_one:.1f} s, "
          f"two ranks {secs_two:.1f} s)")


def _sample_clocks(when: str) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"clocks {when} (sm, max sm, temperature): {smi}")


def _counted(fn):
    """Run fn with every launch counter at 0; (result, {kernel: launches})."""
    from icpx_torch.utils.profiling import LAUNCHES

    for name in LAUNCHES:
        LAUNCHES[name] = 0
    out = fn()
    if torch.cuda.is_available():  # the spawned ranks of a CPU rehearsal have none
        torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def _refine_iters(res) -> int:
    return int(torch.isfinite(res.rmse_history).sum())


def main(dev=None, n_pair: int = N_PAIR, n_flag: int = N_FLAG, n_small: int = N_SMALL,
         n_batch: int = N_BATCH, n_scan: int = N_PAIR, n_plane: int = N_PLANE, b_batch: int = 8,
         b_block: int = 4, n_odo: int = N_ODO, n_odo_brute: int = N_ODO_BRUTE,
         n_odo_small: int = N_ODO_SMALL, odo_frames: int = ODO_FRAMES, map_capacity: int = 65536,
         n_slam: int = N_ODO_SMALL, n_map: int = N_MAP, n_graph: int = N_GRAPH,
         n_pipe: int = N_PIPE, n_map_scan: int = N_ODO, par_odometry: str = "compiled") -> None:
    """`dev` and the sizes exist for rehearsing the script's control flow off
    the card; run as a program it always takes the first CUDA device.
    n_scan sizes the block-path batch and the pyramid; n_odo the compiled
    odometry's scans (odo_frames of them), n_odo_brute its brute-path
    scans, n_odo_small the card-vs-CPU sequence's and the host frontend's,
    n_slam the loop's second run, after the one at the reference test's
    SLAM_REF_POINTS (held to its 0.7 x); at SLAM_REF_POINTS the loop runs
    once. The distributed phase takes the world of n_map points for its
    map block and a scan of n_map_scan points, a pose graph of n_graph
    keyframes, pipeline pairs of n_pipe points, and `parallel_odometry`
    runs on the scans of the compiled
    odometry phase `par_odometry` ("compiled": n_odo points, "brute":
    n_odo_brute)."""
    if dev is None:
        if not torch.cuda.is_available():
            _fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
        dev = torch.device("cuda", 0)

    import icpx_torch  # noqa: F401  (sets the fp32 matmul policy)
    from icpx_torch.cloud import PointCloud
    from icpx_torch.geometry.transforms import make_rigid_perturbation
    from icpx_torch.io.loaders import load_cat_pair
    from icpx_torch.kernels import blocknn_cuda, cuda_build, nn_cuda, sort_cuda
    from icpx_torch.kernels.blocknn import build_kd_index, fused_payload_table, trim_index
    from icpx_torch.kernels.normals import estimate_covariances, estimate_normals
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
    sort_cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {nn_cuda.library_path().name}, "
          f"{blocknn_cuda.library_path().name}, {sort_cuda.library_path().name}")
    for stem in cuda_build.STEMS:
        for line in cuda_build.build_log(stem).splitlines():
            if any(w in line for w in ("entry function", "Function properties", "registers", "spill",
                                       "smem")):
                print(f"  ptxas {stem}: {line.strip()}")

    # 3. Kernels against their plain versions -----------------------------------
    _sample_clocks("before the kernel phases")
    rng = np.random.default_rng(0)
    kernels = {"nn": _phase_nn(dev, n_pair, rng, _lidar_pair(n_odo, dev))}
    f_src, f_tgt, f_gt = _gt_pair(n_flag, 0, dev)
    shapes = _phase_kd(dev, f_src, f_tgt)
    kernels["sort"] = _phase_sort(dev, shapes)
    kernels["moments_fused"] = _phase_moments_fused(dev, f_tgt)
    tgt_index = trim_index(build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128),
                           f_tgt.capacity, multiple=64)
    flat = tgt_index.tiles.reshape(-1, 3)
    radius = auto_cell_size(flat, tgt_index.order >= 0, scale=3.0)
    fixtures = _block_fixtures(dev)
    kernels["moments6"] = _phase_moments6(dev, tgt_index, radius, fixtures, f_tgt)
    aux = torch.as_tensor(np.random.default_rng(2).normal(size=(n_flag, 3)).astype(np.float32),
                          device=dev)
    table = fused_payload_table(tgt_index, aux)
    # GICP's table: xyz and the flattened 3x3 covariance
    aux12 = torch.as_tensor(np.random.default_rng(3).normal(size=(n_flag, 9)).astype(np.float32),
                            device=dev)
    table12 = fused_payload_table(tgt_index, aux12)
    query, cand, q_cent = _refine_operands(f_src, tgt_index, f_gt)
    kernels["fold6"] = _phase_fold6(dev, query, cand, tgt_index, table, table12, fixtures)
    kernels["fold7"] = _phase_fold7(dev, query, cand, q_cent, tgt_index, table, table12, fixtures)
    kernels["select"] = _phase_select(dev, query, cand, tgt_index, table, table12, fixtures)
    kernels["fused4"] = _phase_fused4(dev, query, tgt_index, fixtures)
    del tgt_index, flat, table, aux, table12, aux12, query, cand, q_cent
    _sample_clocks("after the kernel phases")

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
    walls, flag_res = {}, {}
    for label, cfg in flag_cfgs.items():
        res, counts = _counted(lambda: register(f_src, f_tgt, cfg))
        flag_res[label] = res
        rot, terr = (float(x) for x in res.transform.distance_to(f_gt))
        if not (math.isfinite(float(res.final_rmse)) and rot < 5e-3 and terr < 5e-3):
            _fail(f"flagship ({label}): GT not recovered (rot {rot:.3e}, t {terr:.3e})")
        refine = _check_launches(label, counts, res, shapes)
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
    _hold_flagship_to_jax(f_src, f_tgt, flag_cfgs, flag_res)

    # 7. GICP at the 1M flagship: covariances (k = 15) estimated inside
    #    register() through the plain radius moments, as by default; a warm
    #    call, then 3 reps, each counted and held to the GT gate -----------------
    cfg_gicp = _gicp_config()
    t0 = time.perf_counter()
    register(f_src, f_tgt, cfg_gicp)
    torch.cuda.synchronize()
    print(f"flagship 1M (gicp): first call {(time.perf_counter() - t0) * 1e3:.2f} ms")
    for rep in range(3):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, counts = _counted(lambda: register(f_src, f_tgt, cfg_gicp))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        rot, terr = (float(x) for x in res.transform.distance_to(f_gt))
        if not (math.isfinite(float(res.final_rmse)) and rot < 5e-3 and terr < 5e-3):
            _fail(f"flagship (gicp) rep {rep + 1}: GT not recovered (rot {rot:.3e}, t {terr:.3e})")
        refine = _check_launches("gicp", counts, res, shapes)
        print(f"flagship 1M (gicp) rep {rep + 1}: wall {wall * 1e3:.2f} ms = {n_flag / wall:.4g} "
              f"points/s (covariances included); iters={res.iters} (coarse {res.iters - refine}, "
              f"refine {refine}) rmse={float(res.final_rmse):.3e} rot_err={rot:.3e} "
              f"t_err={terr:.3e}; peak {peak:.0f} MiB; launches={counts}")
    kernels["sort"]["launches"] = counts["sort"]

    #    The same with the covariances through `_block_radius_cov`'s fused
    #    branch (the union moments kernel), then given to register() ----------
    k_cov = max(cfg_gicp.k_normals, 15)
    res, counts = _counted(lambda: register(_fused_covariances(f_src, k_cov),
                                            _fused_covariances(f_tgt, k_cov), cfg_gicp))
    rot, terr = (float(x) for x in res.transform.distance_to(f_gt))
    if not (math.isfinite(float(res.final_rmse)) and rot < 5e-3 and terr < 5e-3):
        _fail(f"flagship (gicp fused): GT not recovered (rot {rot:.3e}, t {terr:.3e})")
    refine = _check_launches("gicp fused", counts, res, shapes)
    kernels["moments_fused"]["launches"] = counts["moments_fused"]
    cov_f = _fused_covariances(f_tgt, k_cov).covs
    cov_x = estimate_covariances(f_tgt, k=k_cov).covs
    close = float(((cov_f - cov_x).abs().amax((1, 2)) <= 1e-3)[f_tgt.mask].float().mean())
    if not (bool(torch.isfinite(cov_f).all()) and close >= 0.9):
        _fail(f"gicp fused: covariances agree with the plain branch's on {close:.4f} of rows")
    wall_cov = {f: _sync_time(lambda: _fused_covariances(f_tgt, k_cov, fused=f), reps=3)[0]
                for f in (False, True)}
    print(f"flagship 1M (gicp fused): covariances through the union moments kernel; "
          f"iters={res.iters} (coarse {res.iters - refine}, refine {refine}) "
          f"rmse={float(res.final_rmse):.3e} rot_err={rot:.3e} t_err={terr:.3e}; "
          f"launches={counts}; the target's covariances within 1e-3 of the default branch's "
          f"on {100 * close:.2f}% of rows; one cloud's covariances {wall_cov[False] * 1e3:.2f} ms "
          f"through the default branch, {wall_cov[True] * 1e3:.2f} ms through the fused one "
          "(median of 3)")
    del cov_f, cov_x

    # 8. The rest of the registration layer at the flagship's size: the
    #    refine-stride mid phase, feature-augmented matching, NDT, Horn and
    #    the voxel-hash NN -------------------------------------------------------
    _phase_mid(f_src, f_tgt, f_gt, shapes, kernels)
    _phase_features(dev, f_src, f_tgt, f_gt, shapes, n_plane)
    _phase_ndt(f_src, f_tgt, f_gt)
    _phase_horn_voxel(f_src, f_tgt, f_gt, min(65536, n_flag))
    del f_src, f_tgt

    # 9. A 16,384-point block pair: the kernels on the card, their plain
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
             "fused": ("fused4", dict(block_fused="on", **fixed)),
             "gicp": ("fold6", dict(payload_mode="vmem", objective="gicp")),
             "gicp vmem7": ("fold7", dict(payload_mode="vmem7", objective="gicp", **fixed)),
             "gicp select": ("select", dict(payload_mode="select", objective="gicp", **fixed)),
             "gicp fused": ("fused4", dict(block_fused="on", objective="gicp", **fixed)),
             # the mid phase (1 iteration at Sq 32 of the 3) through fold6 and select
             "mid vmem": ("fold6", dict(payload_mode="vmem", refine_stride=2, **fixed)),
             "mid select": ("select", dict(payload_mode="select", refine_stride=2, **fixed))}
    for label, (name, change) in small.items():
        cfg_small = dataclasses.replace(flag_cfgs["kernels"], moments_mode="vmem", **change)
        res, counts = _counted(lambda: register(src, tgt, cfg_small))
        # GICP estimates covariances (kNN at this size), no normals
        need = {name: 1, "sort": 1, **({} if cfg_small.objective == "gicp" else {"moments6": 2})}
        if any(counts[k] < n for k, n in need.items()):
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
    del src, tgt

    # 10. Batched pairs and the pyramid at scan size ---------------------------------
    _phase_batch(dev, n_batch, b_batch)
    _phase_batch_block(dev, n_scan, b_block)
    _phase_pyramid(dev, n_scan)

    # 11. Odometry: the compiled whole-sequence path at bench.py's 65,536-point
    #     scans and on the brute path, the card against the CPU, the host
    #     frontend (both modes, the sliding window, resume) and SLAM on a loop
    odo = {}
    odo_phases = {
        "compiled": lambda: odo.setdefault(
            "compiled", _phase_compiled_odometry(dev, n_odo, odo_frames, kernels)),
        "brute": lambda: odo.setdefault(
            "brute", _phase_compiled_brute(dev, n_odo_brute, odo_frames, kernels)),
        "card vs CPU": lambda: _phase_compiled_card_vs_cpu(dev, n_odo_small, max(odo_frames // 2, 3)),
        "host": lambda: _phase_host_odometry(dev, n_odo_small, odo_frames, kernels, map_capacity),
        f"slam {SLAM_REF_POINTS}": lambda: _phase_slam(dev, SLAM_REF_POINTS)}
    if n_slam != SLAM_REF_POINTS:
        odo_phases[f"slam {n_slam}"] = lambda: _phase_slam(dev, n_slam, factor=1.0)
    odo_secs = {}
    for label, phase in odo_phases.items():
        t0 = time.perf_counter()
        phase()
        odo_secs[label] = time.perf_counter() - t0
    print(f"odometry phases: {sum(odo_secs.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in odo_secs.items()) + ")")

    # 12. The command line over files of every format, through the native
    #     reader: the cat pair, the 1M flagship, the 65k KITTI directory and
    #     the CLI's own synthetic odometry ----------------------------------------
    _phase_cli(dev, n_flag, n_odo, odo_frames, n_odo_small, shapes)

    # 13. The distributed layer: one rank over NCCL, then two ranks over gloo
    #     on this card ---------------------------------------------------------------
    _phase_distributed(dev, n_pair, n_flag, n_batch, b_batch, odo[par_odometry], kernels,
                       n_map=n_map, n_scan=n_map_scan, n_graph=n_graph, n_pipe=n_pipe)

    cu = "icpx_torch/csrc/blocknn.cu"
    sources = {"nn": "icpx_torch/csrc/nn.cu", "moments6": cu, "fold6": cu, "fold7": cu,
               "select": cu, "fused4": cu, "moments_fused": cu, "sort": "icpx_torch/csrc/sort.cu"}
    replaces = {"nn": "icpx/kernels/knn_pallas.py:37",
                "moments6": "icpx/kernels/blocknn_pallas.py:890",
                "fold6": "icpx/kernels/blocknn_pallas.py:497",
                "fold7": "icpx/kernels/blocknn_pallas.py:694",
                "select": "icpx/kernels/blocknn_pallas.py:358",
                "fused4": "icpx/kernels/blocknn_pallas.py:101",
                "moments_fused": "icpx/kernels/blocknn_pallas.py:219",
                "sort": "icpx/kernels/sort_pallas.py:86"}
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


def _new_path_runs(dev, n):
    """The paths the rest of the registration layer adds, as chip_smoke's
    phases drive them, for `--profile --paths new`: {label: (callable, GT
    or None)}."""
    from icpx_torch.registration import icp
    from icpx_torch.registration.pyramid import register_pyramid

    src, tgt, gt = _gt_pair(n, 0, dev)
    runs = {label: ((lambda c=cfg: icp.register(src, tgt, c)), gt)
            for label, cfg in _mid_configs().items()}
    f_src, f_tgt, f_cfg = _feature_run(src, tgt)
    runs["feat"] = (lambda: icp.register(f_src, f_tgt, f_cfg), gt)
    for mode in ("p2d", "d2d"):
        runs[f"ndt {mode}"] = (_ndt_run(src, tgt, mode)[1], gt)
    _, args, cfg_b = _batch_run(dev, N_BATCH, 8)
    runs[f"register_batch 8 x {N_BATCH}"] = (lambda: icp.register_batch(*args, cfg_b), None)
    _, args_bb, cfg_bb = _batch_block_run(dev, N_PAIR, 4)
    runs[f"register_batch_block 4 x {N_PAIR}"] = (lambda: icp.register_batch_block(*args_bb, cfg_bb), None)
    p_src, p_tgt, p_gt, cfg_p = _pyramid_run(dev, N_PAIR)
    runs[f"register_pyramid {N_PAIR}"] = (lambda: register_pyramid(p_src, p_tgt, cfg_p)[0], p_gt)
    return runs


def profile_flagship(n: int = N_FLAG, top: int = 12, paths: str = "flagship") -> None:
    """Where the time goes: for each block path of `_flag_configs` and GICP
    (`paths="flagship"`), or each path of `_new_path_runs` (`paths="new"`),
    the unprofiled wall (median of 3 after 2 warm calls), then one call
    under `torch.profiler` (CPU and CUDA activity): its device time, that
    time's share of the wall (the device-busy share), and the kernels and
    aten ops with the most device time."""
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    from icpx_torch.kernels import cuda_build
    from icpx_torch.registration.icp import register

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    cuda_build.compile_all()
    if paths == "new":
        runs = _new_path_runs(dev, n)
    else:
        src, tgt, gt = _gt_pair(n, 0, dev)
        runs = {label: ((lambda c=cfg: register(src, tgt, c)), gt)
                for label, cfg in {**_flag_configs(), "gicp": _gicp_config()}.items()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (run, gt) in runs.items():
        wall, _ = _sync_time(run, reps=3, warmup=2)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        if gt is None:
            result = f"iters {res.iters.tolist()}"
        else:
            rot, terr = (float(x) for x in res.transform.distance_to(gt))
            result = f"iters {res.iters}, rot {rot:.2e}, t {terr:.2e}"
        avgs = [e for e in prof.key_averages() if _device_us(e) > 0]
        # device kernels (and copies) alone; the CPU ops that launched them
        # report the same time again
        kernels = [e for e in avgs if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        ops = [e for e in avgs if e.key.startswith("aten::")]
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3
        print(f"\n{label}: wall {wall * 1e3:.2f} ms (median of 3, unprofiled); device time "
              f"{busy_ms:.2f} ms = {100 * busy_ms / (wall * 1e3):.1f}% busy; profiled call "
              f"{prof_ms:.2f} ms; {result}")
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
    ap.add_argument("--paths", choices=("flagship", "new"), default="flagship",
                    help="under --profile: the flagship's block paths and GICP, or the mid phase, "
                         "feat_nn, NDT, the batched paths and the pyramid")
    args = ap.parse_args()
    if args.profile:
        profile_flagship(args.n, paths=args.paths)
    else:
        main()
    sys.stdout.flush()
