"""Fixtures and kernel shapes shared by the port's tests, JAX-free.

The CPU tests (`test_torch_nn.py`, `test_torch_sort.py`,
`test_torch_blocknn.py`) use them for their emulations and plan checks,
and the card tests (`test_torch_cuda.py`) for the kernels against their
plain versions. Nothing here imports JAX, the JAX package or
`torch_parity.py`, so the card tests run without the suite's conftest.
Inputs are made with numpy from a seed.
"""

from types import SimpleNamespace

import numpy as np
import torch

import chip_smoke
from icpx_torch.cloud import PAD_COORD
from icpx_torch.kernels import blocknn_cuda, nn_cuda, sort_cuda

# ---- the kernels' shapes, as csrc/ defines them -----------------------------------------
# The wrappers read these from the built library; the plan and emulation
# tests run on copies, and the card tests (test_torch_cuda.py) hold the library
# to them.

M6_SHAPE = blocknn_cuda.Moments6Shape(threads=128, queries_per_thread=2, group=32, stage_lanes=128,
                                     stage_rows=512)
CSRC_SHAPE = nn_cuda.KernelShape(threads=256, queries_per_thread=4, group=8, tile_r=256)
SORT_SHAPE = sort_cuda.KernelShape(max_payloads=4, block_elems=8192, threads=512)
F6_SHAPE = blocknn_cuda.Fold6Shape(threads=128, queries_per_thread=4, group=8, stage_rows=1024)
F7_SHAPE = blocknn_cuda.Fold6Shape(threads=128, queries_per_thread=4, group=8, stage_rows=1024)
F4_SHAPE = blocknn_cuda.Fused4Shape(threads=256, queries_per_thread=4, lane_threads=4,
                                    chunk_rows=512)
MF_SHAPE = blocknn_cuda.Fused4Shape(threads=256, queries_per_thread=4, lane_threads=4,
                                    chunk_rows=512)

# chip_smoke's fixture kinds and shapes, (tq, sq, s, k), by test id
M6_FIXTURES = list(chip_smoke.MOMENTS6_FIXTURES)
M6_FIXTURE_SHAPES = dict(zip(["1M plan", "k8", "sq22", "sq3-s8", "sq600-s300", "s100", "sq5-s130"],
                             chip_smoke.MOMENTS6_FIXTURE_SHAPES))
F6_FIXTURES = list(chip_smoke.FOLD6_FIXTURES)
F6_FIXTURE_SHAPES = dict(zip(["sq20", "sq64-s100", "sq3", "sq600-s2000", "sq128", "sq64-8tiles",
                              "mid sq32", "mid sq16"], chip_smoke.FOLD6_FIXTURE_SHAPES))
F7_FIXTURES = list(chip_smoke.FOLD7_FIXTURES)
F7_FIXTURE_SHAPES = dict(zip(["1M plan", "25 a block", "sq30-s100", "k8-s512", "sq600-s2000",
                              "sq3-s13", "k200", "sq128", "mid sq32", "mid sq16"],
                             chip_smoke.FOLD7_FIXTURE_SHAPES))


# ---- brute NN fixtures (kernel #1) --------------------------------------------------------


def _nn_inputs(nq, nr, seed, masked_frac=0.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, size=(nq, 3)).astype(np.float32)
    r = rng.uniform(-1.0, 1.0, size=(nr, 3)).astype(np.float32)
    mask = rng.uniform(size=nr) >= masked_frac
    return q, r, mask


def duplicate_fixture():
    """Refs with exact duplicates at several indices; queries sit exactly on
    some of them. Coordinates are small integers, so every squared distance
    is exact in fp32 under either scoring formula."""
    base = np.array([[0, 0, 0], [3, 1, 2], [-2, 4, 1], [5, -3, 0]], np.float32)
    ref = np.concatenate([base[[1, 2]], base, base[[0, 1]], base], axis=0)
    query = np.concatenate([base, base + np.float32([0, 0, 1])], axis=0)
    # expected: the first occurrence of the exact match / nearest copy
    d = ((query[:, None, :] - ref[None]) ** 2).sum(-1)
    expect = d.argmin(1)  # numpy: first index among ties
    return query, ref, expect


def screen_fixture(name):
    """(query, ref, ref_mask) float32 / bool numpy arrays, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def uniform(n, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)

    if name == "uniform":
        return uniform(2000), uniform(5000), np.ones(5000, bool)
    if name == "coords at 100":  # far from the origin: the expansion cancels
        c = np.float32([100, -100, 100])
        return uniform(500) + c, uniform(2000) + c, np.ones(2000, bool)
    if name == "exact duplicates":  # small integers: many exact copies and exact ties
        r = rng.integers(-3, 4, size=(700, 3)).astype(np.float32)
        q = np.concatenate([r[:200], rng.integers(-6, 7, size=(200, 3)) * np.float32(0.5)])
        return q.astype(np.float32), r, np.ones(len(r), bool)
    if name == "ulp neighbours":  # second neighbours one ulp from the first
        q = uniform(400)
        r1 = q + rng.normal(scale=1e-3, size=q.shape).astype(np.float32)
        r2, r3 = r1.copy(), r1.copy()
        r2[:, 0] = np.nextafter(r1[:, 0], np.float32(np.inf))
        r3[:, 1] = np.nextafter(r1[:, 1], np.float32(-np.inf))
        r = np.concatenate([r1, r2, r3, uniform(1000)])[rng.permutation(2200)]
        return q, r, np.ones(len(r), bool)
    if name == "PAD_COORD queries":  # capacity rows at PAD_COORD on both sides
        q, r = uniform(340), uniform(520)
        q[300:] = PAD_COORD
        r[500:] = PAD_COORD
        return q, r, np.arange(520) < 500
    if name == "half masked":
        return uniform(1000), uniform(3001), rng.uniform(size=3001) < 0.5
    if name == "all masked":
        return uniform(300), uniform(700), np.zeros(700, bool)
    raise KeyError(name)


SCREEN_FIXTURES = ["uniform", "coords at 100", "exact duplicates", "ulp neighbours",
                   "PAD_COORD queries", "half masked"]


def far_fixture(name):
    """(query, ref, ref_mask) float32 / bool numpy arrays for the nn
    kernel's far rows and empty tiles, made from a seed: rows within 25 of
    the origin (a LiDAR scan's range), capacity rows at PAD_COORD."""
    rng = np.random.default_rng(sum(map(ord, name)) + 1)

    def scan(n):
        return rng.uniform(-25.0, 25.0, size=(n, 3)).astype(np.float32)

    if name == "scan layout":  # pad rows at the end of both sides, as PointCloud.create leaves them
        q, r = scan(3000), scan(4000)
        q[2500:] = PAD_COORD
        r[2900:] = PAD_COORD
        return q, r, np.arange(4000) < 2900
    if name == "pad one in 7":
        q = scan(2100)
        q[::7] = PAD_COORD
        return q, scan(3000), np.ones(3000, bool)
    if name == "one far row":  # a single far row in an otherwise clean warp
        q = scan(1024)
        q[37] = -PAD_COORD
        return q, scan(2000), np.ones(2000, bool)
    if name == "all far":
        q = np.where(rng.uniform(size=(1500, 1)) < 0.5, PAD_COORD, -PAD_COORD) * np.ones((1, 3))
        q = (q + rng.uniform(-1e4, 1e4, size=(1500, 3))).astype(np.float32)
        return q, scan(2500), rng.uniform(size=2500) < 0.9
    if name == "none far":
        return scan(2048), scan(3000), np.ones(3000, bool)
    if name == "masked tail":  # the reference's last splits hold no valid row
        return scan(2000), scan(6000), np.arange(6000) < 2500
    if name == "masked interleaved":
        return scan(2000), scan(5000), np.arange(5000) % 5 != 0
    if name == "all masked":
        q = scan(1100)
        q[1000:] = PAD_COORD
        return q, scan(700), np.zeros(700, bool)
    if name == "nq ragged":  # not a multiple of a query block
        q = scan(1029)
        q[1020:] = PAD_COORD
        return q, scan(3000), np.arange(3000) < 2800
    if name == "nr below a tile":
        q = scan(700)
        q[650:] = PAD_COORD
        r = scan(100)
        r[90:] = PAD_COORD
        return q, r, np.arange(100) < 90
    raise KeyError(name)


FAR_FIXTURES = ["scan layout", "pad one in 7", "one far row", "all far", "none far",
                "masked tail", "masked interleaved", "all masked", "nq ragged",
                "nr below a tile"]


# ---- sort fixtures (kernel #8) ------------------------------------------------------------


def _sort_keys(c, m, seed):
    """Duplicate-heavy keys with a PAD_COORD tail in every other segment
    and signed zeros scattered through them; payloads a, b (f32), o (i32)."""
    rng = np.random.default_rng(seed)
    key = (rng.integers(-m // 16, m // 16, size=(c, m)) * 0.5).astype(np.float32)
    zeros = rng.uniform(size=(c, m)) < 0.05
    key[zeros] = np.where(rng.uniform(size=int(zeros.sum())) < 0.5, -0.0, 0.0)
    key[::2, ::3] = PAD_COORD
    a = rng.normal(size=(c, m)).astype(np.float32)
    b = rng.normal(size=(c, m)).astype(np.float32)
    o = rng.permutation(c * m).reshape(c, m).astype(np.int32)
    return key, a, b, o


# ---- block-NN fixtures (kernels #2-#7) -----------------------------------------------------


def _cov_tol(mean, comps, q_cent, sq):
    """Per-row tolerance of the six covariance components: 1e-4 of the row's
    trace (they are ~r^2/4 in the plane and far smaller along the normal,
    below any fixed atol), plus 1e-5 of |mean - q_cent|^2 for the fp32
    cancellation in E[rr^T] - m m^T, which grows with the mean's offset from
    the query tile's centroid. A zero or swapped component fails it."""
    q_rows = np.repeat(np.asarray(q_cent, np.float64), sq, axis=0)
    mean, comps = np.asarray(mean, np.float64), [np.asarray(c, np.float64) for c in comps]
    return 1e-4 * (comps[0] + comps[3] + comps[5]) + 1e-5 * ((mean - q_rows) ** 2).sum(-1)


def _tie_fixture():
    """One query tile over 4 index tiles of 8 rows, integer coordinates (every
    d2 exact under either scoring form). Rows carry their flat position as
    payload. Query 0 sits on a point held at lane 3 of tile 0 and lane 1 of
    tile 1; query 1 on a point at lane 2 of tiles 2 and 3."""
    tiles = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3) * 10.0 + 100.0
    p, p2 = np.float32([1, 2, 3]), np.float32([-4, 5, -6])
    tiles[0, 3] = tiles[1, 1] = p
    tiles[2, 2] = tiles[3, 2] = p2
    query = np.full((1, 8, 3), 50.0, np.float32)
    query[0, 0], query[0, 1] = p, p2
    payload = np.repeat(np.arange(32, dtype=np.float32)[:, None], 6, axis=1)
    fields = SimpleNamespace(tiles=tiles, box_lo=tiles.min(1), box_hi=tiles.max(1),
                             centroids=tiles.mean(1), order=np.arange(32, dtype=np.int32))
    return query, payload, fields


def _table_view(rows, d, offset, device="cpu"):
    """A contiguous (rows, d) float32 view that starts `offset` floats into
    its storage (the storage itself is aligned to 16 bytes or more)."""
    flat = torch.arange(rows * d + offset, dtype=torch.float32, device=device)
    return flat[offset:].view(rows, d)


def _fused4_tie_case(name):
    """Integer coordinates (every score exact) in tiles of 32 lanes, tile 4
    all sentinel. "lanes and slots": the query's point p sits at tile 0
    lane 3, tile 1 lane 1, tile 2 lane 3 again (a later slot of the same
    lane) and tile 3 lane 6, so lane 3 keeps slot 0 and the largest key is
    tile 3's lane 6 (slot 3); the unions are padded (4 of 8 slots). "all
    sentinel": one group's union is tile 4 alone, padded: every score ties,
    the earliest slot in each lane, then the last lane. Returns (query
    tiles (4, 8, 3), tiles (5, 32, 3), unions (2, 8), group 2, wanted
    position of query 0 or None)."""
    rng = np.random.default_rng(33)
    tiles = rng.integers(-20, 21, size=(5, 32, 3)).astype(np.float32)
    tiles[4] = PAD_COORD
    query = rng.integers(-20, 21, size=(4, 8, 3)).astype(np.float32)
    query[3, 5:] = PAD_COORD  # padded query rows
    p = np.float32([50, 50, 50])
    tiles[0, 3] = tiles[1, 1] = tiles[2, 3] = tiles[3, 6] = p
    query[0, 0] = p + np.float32([0, 0, 1])
    cand = torch.tensor([[0, 1], [2, 3], [3, 1], [0, 2]])
    want = 3 * 32 + 6
    if name == "all sentinel":
        cand = torch.tensor([[0, 1], [2, 3], [4, 4], [4, 4]])
    unions = blocknn_cuda.group_unions(cand, 2, 8)
    return query, tiles, unions, 2, want


RADIUS_U = 0.15  # the union moments' radius on 8,000 uniform points


def _slot_weights_fixture():
    """Query tiles (8, 16, 3) in 2 groups of 4, tiles (8, 16, 3) with sentinel
    rows in tile 7 and padded queries in tile 5, and one padded union (3 of
    8 slots) beside a full one."""
    unions = torch.tensor([[1, 2, 5, 1, 1, 1, 1, 1], [3, 0, 4, 6, 2, 7, 5, 1]])
    rng = np.random.default_rng(21)
    tiles = rng.uniform(-1, 1, (8, 16, 3)).astype(np.float32)
    tiles[7, 10:] = PAD_COORD
    query = rng.uniform(-1, 1, (8, 16, 3)).astype(np.float32)
    query[5, 12:] = PAD_COORD
    return query, tiles, unions


# ---- odometry -----------------------------------------------------------------------------


def keyframe_margins(rel_R, rel_t, keyframe_trans, keyframe_rot) -> np.ndarray:
    """Each frame's distance from flipping its keyframe decision, in float64:
    min(| |rel.t| - keyframe_trans |, | angle(rel.R) - keyframe_rot |). A
    decision within fp32 of its threshold could go either way on two
    backends; every fixture must keep it far above that."""
    R = np.asarray(rel_R, np.float64)
    t = np.asarray(rel_t, np.float64)
    cos = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return np.minimum(np.abs(np.linalg.norm(t, axis=-1) - keyframe_trans),
                      np.abs(np.arccos(cos) - keyframe_rot))


def odometry_frames(n_points, n_frames, *, world=(60000, 30.0, 0), speed=0.6, turn=0.04,
                    max_range=18.0, seed=1, device="cpu"):
    """The port's simulated scans of `n_points` with normals (k = 10), the
    reference tests' construction: (frames, ground-truth poses)."""
    from icpx_torch.kernels.normals import estimate_normals
    from icpx_torch.odometry.kitti import make_trajectory, make_world, simulate_scans

    w = make_world(n_points=world[0], extent=world[1], seed=world[2])
    gt = make_trajectory(n_frames, speed=speed, turn=turn, device=device)
    frames = simulate_scans(w, gt, max_range=max_range, points_per_scan=n_points, noise=0.01,
                            seed=seed, device=device)
    return [estimate_normals(f, k=10) for f in frames], gt
