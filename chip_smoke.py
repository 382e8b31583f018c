#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`icpx_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version at the shapes the main path gives it,
then drives the main path — `register()` on the cat fixture pair and on a
65,536-point synthetic pair, brute-force NN, normals estimated on the card
— and checks each result against its ground truth. Every phase prints one
line (or a few); any failure raises, so the exit code is non-zero. The
last two lines are a JSON object per kernel and the verdict
``{"ok": true, "device": {...}}``. Without a CUDA device it refuses to run.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_PAIR = 65536  # one rotating-LiDAR sweep; the round-1 `bench.py --n 65536` point


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


def _duplicate_fixture():
    """Integer coordinates with exact duplicates: the nearest copy with the
    lowest index must win (distances are exact in fp32)."""
    base = np.array([[0, 0, 0], [3, 1, 2], [-2, 4, 1], [5, -3, 0]], np.float32)
    ref = np.concatenate([base[[1, 2]], base, base[[0, 1]], base], axis=0)
    query = np.concatenate([base, base + np.float32([0, 0, 1])], axis=0)
    expect = ((query[:, None, :] - ref[None]) ** 2).sum(-1).argmin(1)
    return query, ref, np.ones(len(ref), bool), expect


def main(dev=None, n_pair: int = N_PAIR) -> None:
    """`dev` and `n_pair` exist for rehearsing the script's control flow off
    the card; run as a program it always takes the first CUDA device."""
    if dev is None:
        if not torch.cuda.is_available():
            _fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
        dev = torch.device("cuda", 0)

    import icpx_torch  # noqa: F401  (sets the fp32 matmul policy)
    from icpx_torch.cloud import PAD_COORD, PointCloud
    from icpx_torch.geometry.transforms import make_rigid_perturbation
    from icpx_torch.io.loaders import load_cat_pair, synthetic_surface
    from icpx_torch.kernels import nn_cuda
    from icpx_torch.kernels.knn import knn, nearest_neighbor_reference
    from icpx_torch.kernels.normals import estimate_normals
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

    # 2. Build ------------------------------------------------------------------
    t0 = time.perf_counter()
    nn_cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {nn_cuda.library_path().name}")
    for line in nn_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. Kernel against its plain version ---------------------------------------
    # d2: rtol 1e-5 plus atol 1e-6 |q|^2 per row (same formula, fp32 rounding
    # and FMA contraction only); indices equal wherever the best and second
    # best distances differ by more than 1e-4 relative.
    rng = np.random.default_rng(0)

    def uniform(n):
        return rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)

    def padded(n_real, cap):
        x = np.full((cap, 3), PAD_COORD, np.float32)
        x[:n_real] = uniform(n_real)
        return x, np.arange(cap) < n_real

    q_cat, m_cat = padded(3400, 3456)
    r_cat, _ = padded(3400, 3456)
    half = rng.uniform(size=70001) < 0.5
    cases = {
        f"{n_pair}x{n_pair}": (uniform(n_pair), uniform(n_pair), np.ones(n_pair, bool), None),
        "3456x3456 (56 masked)": (q_cat, r_cat, m_cat, None),
        "1000x70001 (half masked)": (uniform(1000), uniform(70001), half, None),
        "duplicates": _duplicate_fixture(),
    }
    max_abs_err = 0.0
    timings = {}
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
        line = (f"kernel vs plain {name}: max|dd2|={float(err[fin].max()) if bool(fin.any()) else 0.0:.3e}, "
                f"index checked on {int((sep & fin).sum())}/{len(q)} rows")
        if name.startswith((str(n_pair), "3456")):
            ms = _event_ms(lambda: nn_cuda.nn_cuda(qc, rc, mc))
            plain_ms = _event_ms(lambda: nearest_neighbor_reference(qc, rc, ref_mask=mc))
            timings[name] = (ms, plain_ms)
            line += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events, median of 5)"
        print(line)
        del qc, rc, mc, d_k, d_p

    cfg_cat = ICPConfig(objective="symmetric", max_iters=20, diff_threshold=1.0,
                        max_corr_dist=50.0, robust="huber")
    cfg_pair = ICPConfig(objective="symmetric", max_iters=10, diff_threshold=0.0,
                         rmse_change_tol=1e-6, k_normals=10, nn_method="brute",
                         tile_q=2048, tile_r=8192)

    # The main path, counted: every kernel launch from here to the read below
    # comes from register() / estimate_normals() as a user calls them.
    nn_cuda.LAUNCHES = 0

    # 4. Cat pair ----------------------------------------------------------------
    src, tgt = load_cat_pair(device=dev)
    tgt_np = tgt.to_numpy()
    tgt_sh = PointCloud.create(tgt_np[np.random.default_rng(0).permutation(len(tgt_np))],
                               device=dev)
    gt_cat = make_rigid_perturbation(device=dev)
    res = register(src, tgt_sh, cfg_cat)
    torch.cuda.synchronize()
    cat_launches = nn_cuda.LAUNCHES
    rot, terr = (float(x) for x in res.transform.distance_to(gt_cat))
    pred = res.transform.apply(src.xyz)[src.mask].cpu().numpy()
    true_rmse = float(np.sqrt(((pred - tgt_np) ** 2).sum(1).mean()))
    if not (rot < 5e-3 and terr < 0.5 and true_rmse < 0.5):
        _fail(f"cat: GT not recovered (rot {rot:.3e}, t {terr:.3e}, rmse {true_rmse:.3e})")
    if res.iters < 1 or cat_launches < res.iters:
        _fail(f"cat: {cat_launches} kernel launches for {res.iters} iterations")
    # the same registration on the CPU (plain NN): the reference on a small input
    res_cpu = register(src.to("cpu"), tgt_sh.to("cpu"), cfg_cat)
    d_rot, d_t = (float(x) for x in res.transform.to("cpu").distance_to(res_cpu.transform))
    if res_cpu.iters != res.iters or d_rot > 1e-4 or d_t > 1e-3:
        _fail(f"cat: card and CPU runs differ (iters {res.iters} vs {res_cpu.iters}, "
              f"rot {d_rot:.2e}, t {d_t:.2e})")
    wall_cat, _ = _sync_time(lambda: register(src, tgt_sh, cfg_cat), reps=3)
    print(f"cat: iters={res.iters} converged={bool(res.converged)} "
          f"rmse={float(res.final_rmse):.3e} rot_err={rot:.3e} t_err={terr:.3e} "
          f"launches={cat_launches}; matches CPU run (drot {d_rot:.1e}, dt {d_t:.1e}); "
          f"wall {wall_cat * 1e3:.2f} ms (median of 3)")

    # 5. 65,536-point pair (bench.py's brute configuration) ----------------------
    xyz = synthetic_surface(n_pair, seed=0)
    src = PointCloud.create(xyz, capacity=n_pair, device=dev)
    gt = make_rigid_perturbation(angle=0.2, translation=(0.12, -0.06, 0.03), device=dev)
    perm = np.random.default_rng(1).permutation(n_pair)
    tgt_np = gt.apply(src.xyz).cpu().numpy()
    tgt = PointCloud.create(tgt_np[perm], capacity=n_pair, device=dev)
    tgt = tgt.replace(mask=src.mask[torch.as_tensor(perm, device=dev)])

    def run_pair():
        # normals up front with the brute method (auto would pick the block
        # radius path at this size); register() then finds them present
        s = estimate_normals(src, k=cfg_pair.k_normals, method="brute")
        t = estimate_normals(tgt, k=cfg_pair.k_normals, method="brute")
        return register(s, t, cfg_pair)

    before = nn_cuda.LAUNCHES
    res = run_pair()
    torch.cuda.synchronize()
    pair_launches = nn_cuda.LAUNCHES - before
    main_launches = nn_cuda.LAUNCHES  # the read: cat + 65k main-path runs
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

    if main_launches < 1:
        _fail("the main path never launched the kernel")
    ms, plain_ms = timings[f"{n_pair}x{n_pair}"]
    print(json.dumps({"kernels": [{
        "name": "nn",
        "route": "cuda",
        "source": "icpx_torch/csrc/nn.cu",
        "replaces": "icpx/kernels/knn_pallas.py:37",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
