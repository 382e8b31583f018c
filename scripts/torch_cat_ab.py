#!/usr/bin/env python3
"""A/B of two checkouts of the port on one card: the cat pair's wall, `nn`,
and the `moments6`, `fold6`, `fold7`, `fused4`, `sort` and `moments_fused`
kernels.

    python3 scripts/torch_cat_ab.py PARENT CHANGE [--pairs 12] [--out FILE]

starts one worker process per checkout (`--worker ROOT`), each importing
`icpx_torch` from its ROOT and building its kernels, then asks them for
readings in turn, in ABBA order (parent, change, change, parent, ...), so
that a drift of the card or the host falls on both sides alike. A reading
is the wall of one cat-pair registration (chip_smoke's golden config;
median of 5 after 2 warm calls, host clock around torch.cuda.synchronize()
fences), the event time of one `nn` call at the cat shape (3,456 x 3,456,
56 pad rows on both sides; median of 5), and the device time (a CUDA graph
of 20 calls) and the event time of one `moments6` call at the 1M normals
shape (the flagship target's 8,192 x 128 self-query, k 2) and at GICP's
covariance shape (k 8), of one `fold6` call at the 1M flagship's
refine shape with the 6-wide payload table and with GICP's 12-wide one, of
one `fold7` call likewise (and the event time of one `fold7_prepare`, once
a phase, with the 6-wide table; each checkout makes its own operands
through the public signatures), of one `fused4` call at the same shape, of
the tile-128 KD build's four level sorts (summed) and of one
`moments_fused` call at the 1M covariance index. After the readings each
worker holds `nn` to its plain version bit for bit at the cat shape and at
65,536 x 65,536, `moments6`'s counts at both shapes, and `fold6` and `fold7` (d2 and payload, both tables),
`fused4` and every level sort likewise, and `moments_fused`'s counts; and
times `nn` there. Prints each side's median, min and max of
every reading, and one JSON line with all of it (also written to FILE).
The timers and the inputs are chip_smoke.py's, from the checkout that
holds this script: `fold6`, `fold7` and `fused4` on `_refine_operands` of
the `_gt_pair` flagship (k = 6; the folds' tables as `main` makes them from
seeds 2 and 3, fold7 centred on the query tiles' centroids; fused4's groups
of 4, unions of 32), the sorts on
`_sort_operands`, `moments_fused` on the flagship target's KD index of
128-point tiles, each its own query tile (`_cov_radius(target, 15)`, k 8,
groups of 4, unions of 32), as `_phase_moments_fused` has it, and
`moments6` on the trimmed target index with the registration's radius and
on that covariance index with its radius, as `_phase_moments6` has them.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BIG = 65536


def _load_smoke():
    """This checkout's chip_smoke.py under its own module name (ROOT, first
    on sys.path in a worker, may hold another chip_smoke.py)."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def worker(root: str) -> None:
    """Answers "reading" and "summary" lines on stdin with one JSON line
    each on stdout; everything else it prints goes to stderr."""
    proto, sys.stdout = sys.stdout, sys.stderr
    sys.path.insert(0, root)
    import icpx_torch

    if not icpx_torch.__file__.startswith(os.path.join(root, "icpx_torch")):
        raise SystemExit(f"imported {icpx_torch.__file__}, not the package under {root}")
    from icpx_torch.cloud import PointCloud
    from icpx_torch.io.loaders import load_cat_pair
    from icpx_torch.kernels import blocknn_cuda, cuda_build, nn_cuda, sort_cuda
    from icpx_torch.kernels.blocknn import (_candidate_tiles, build_kd_index, fused_payload_table,
                                            trim_index)
    from icpx_torch.kernels.knn import nearest_neighbor_reference
    from icpx_torch.kernels.voxel import auto_cell_size
    from icpx_torch.registration.icp import ICPConfig, register

    smoke = _load_smoke()
    cuda_build.compile_all()
    dev = torch.device("cuda", 0)
    src, tgt = load_cat_pair(device=dev)
    tgt_np = tgt.to_numpy()
    tgt = PointCloud.create(tgt_np[np.random.default_rng(0).permutation(len(tgt_np))], device=dev)
    cfg = ICPConfig(objective="symmetric", max_iters=20, diff_threshold=1.0,
                    max_corr_dist=50.0, robust="huber")
    big, cat, cases = smoke._nn_cases(N_BIG, np.random.default_rng(0))
    shapes = {label: tuple(torch.as_tensor(x, device=dev) for x in cases[name][:3])
              for label, name in (("nn_65536", big), ("nn_3456", cat))}
    qc, rc, mc = shapes["nn_3456"]
    # fused4 at the flagship's refine shape, the level sorts of its tile-128 build
    f_src, f_tgt, f_gt = smoke._gt_pair(smoke.N_FLAG, 0, dev)
    tgt_index = trim_index(build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128),
                           f_tgt.capacity, multiple=64)
    query, cand, q_cent = smoke._refine_operands(f_src, tgt_index, f_gt)
    unions = blocknn_cuda.group_unions(cand, 4, 32).to(torch.int32)  # an older checkout's are int64
    # the folds' 6-wide (symmetric) and 12-wide (GICP) payload tables
    fold6_ops, fold7_ops, tables = {}, {}, {}
    for suffix, seed, width in (("", 2, 3), ("_d12", 3, 9)):
        aux = torch.as_tensor(np.random.default_rng(seed).normal(size=(smoke.N_FLAG, width))
                              .astype(np.float32), device=dev)
        tables[suffix] = fused_payload_table(tgt_index, aux)
        fold6_ops["fold6" + suffix] = blocknn_cuda.fold6_prepare(cand, tgt_index, tables[suffix])
        fold7_ops["fold7" + suffix] = blocknn_cuda.fold7_prepare(cand, q_cent, tgt_index, tables[suffix])
        del aux
    # moments_fused at the 1M covariance index
    cov_idx = build_kd_index(f_tgt.xyz, f_tgt.mask, tile_size=128)
    cov_radius = smoke._cov_radius(f_tgt, 15)
    cov_r2 = (cov_radius * cov_radius).reshape(1).to(torch.float32)
    cov_unions = blocknn_cuda.group_unions(_candidate_tiles(cov_idx.tiles, cov_idx, 8)[0], 4, 32)
    cov_cent = blocknn_cuda.group_centroids(cov_idx.tiles, 4)
    cov_args = (cov_idx.tiles, cov_idx.tiles, cov_unions.to(torch.int32), cov_cent)
    # moments6 at the 1M normals shape and at the covariance index, k 8
    radius = auto_cell_size(tgt_index.tiles.reshape(-1, 3), tgt_index.order >= 0, scale=3.0)
    m6_args = {}
    for label, idx, rad, k in (("moments6", tgt_index, radius, 2), ("moments6_k8", cov_idx, cov_radius, 8)):
        c6, cent6 = _candidate_tiles(idx.tiles, idx, k)
        m6_args[label] = (idx.tiles, idx.tiles, c6, cent6, (rad * rad).reshape(1).to(torch.float32))
    del f_src, f_tgt
    levels = [smoke._sort_operands(dev, c, m, i)
              for i, (c, m) in enumerate(((64, 16384), (256, 4096), (1024, 1024), (4096, 256)))]

    def fused4():
        return blocknn_cuda.fused4_cuda(query, tgt_index.tiles, unions, 4)

    def moments():
        return blocknn_cuda.moments_fused_cuda(*cov_args, cov_r2, 4)

    def moments6(label):
        q, tl, c6, cent6, r2 = m6_args[label]
        return blocknn_cuda.moments6_cuda(q, tl, c6.to(torch.int32), cent6, r2)

    def reading():
        wall = smoke._sync_time(lambda: register(src, tgt, cfg), reps=5, warmup=2)[0]
        timed = {}
        for fold, all_ops in (("fold6", fold6_ops), ("fold7", fold7_ops)):
            launch = getattr(blocknn_cuda, f"{fold}_cuda")
            for label, ops in all_ops.items():
                timed[f"{label}_device_ms"] = smoke._graph_ms(lambda: launch(query, ops))
                timed[f"{label}_event_ms"] = smoke._event_ms(lambda: launch(query, ops))
        for label in m6_args:
            timed[f"{label}_device_ms"] = smoke._graph_ms(lambda: moments6(label))
            timed[f"{label}_event_ms"] = smoke._event_ms(lambda: moments6(label))
        timed["fold7_prepare_event_ms"] = smoke._event_ms(
            lambda: blocknn_cuda.fold7_prepare(cand, q_cent, tgt_index, tables[""]))
        return {"cat_wall_ms": 1e3 * wall,
                "nn_3456_event_ms": smoke._event_ms(lambda: nn_cuda.nn_cuda(qc, rc, mc)),
                **timed,
                "fused4_device_ms": smoke._graph_ms(fused4),
                "fused4_event_ms": smoke._event_ms(fused4),
                "sort4_device_ms": sum(smoke._graph_ms(lambda: sort_cuda.sort_cuda(k, [x, o]))
                                       for k, x, o in levels),
                "sort4_event_ms": sum(smoke._event_ms(lambda: sort_cuda.sort_cuda(k, [x, o]))
                                      for k, x, o in levels),
                "moments_fused_device_ms": smoke._graph_ms(moments),
                "moments_fused_event_ms": smoke._event_ms(moments)}

    def summary():
        out = {}
        for label, (q, r, m) in shapes.items():
            d_k, i_k = nn_cuda.nn_cuda(q, r, m)
            d_p, i_p = nearest_neighbor_reference(q, r, ref_mask=m)
            equal = torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)) and torch.equal(i_k, i_p)
            out[label] = {"bit_equal": bool(equal),
                          "device_ms": smoke._graph_ms(lambda: nn_cuda.nn_cuda(q, r, m)),
                          "event_ms": smoke._event_ms(lambda: nn_cuda.nn_cuda(q, r, m))}
        for label, (q, tl, c6, cent6, r2) in m6_args.items():
            want = blocknn_cuda.moments6_reference(q, tl, c6, cent6, r2[0])
            out[label] = {"bit_equal": bool(torch.equal(moments6(label)[0], want[0]))}  # the counts
        for fold, all_ops in (("fold6", fold6_ops), ("fold7", fold7_ops)):
            equal = True
            for ops in all_ops.values():
                d_k, pl_k = getattr(blocknn_cuda, f"{fold}_cuda")(query, ops)
                d_p, pl_p = getattr(blocknn_cuda, f"{fold}_reference")(query, ops)
                equal &= (torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
                          and torch.equal(pl_k, pl_p))
            out[fold] = {"bit_equal": bool(equal)}  # both tables
        d_k, p_k = fused4()
        d_p, p_p = blocknn_cuda.fused4_reference(query, tgt_index.tiles, unions, 4)
        out["fused4"] = {"bit_equal": bool(torch.equal(d_k, d_p) and torch.equal(p_k, p_p))}
        equal = True
        for key, xyz, orig in levels:
            got = sort_cuda.sort_cuda(key, [xyz, orig])
            want = sort_cuda.sort_segments_reference(key, [xyz, orig])
            equal &= all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
        out["sort4"] = {"bit_equal": bool(equal)}
        want = blocknn_cuda.moments_fused_reference(*cov_args, cov_r2[0], 4)
        out["moments_fused"] = {"bit_equal": bool(torch.equal(moments()[0], want[0]))}  # the counts
        return out

    print(json.dumps({"ready": root}), file=proto, flush=True)
    for line in sys.stdin:
        answer = {"reading": reading, "summary": summary}[line.strip()]()
        print(json.dumps(answer), file=proto, flush=True)


def _ask(proc, what=None):
    if what is not None:
        proc.stdin.write(what + "\n")
        proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise SystemExit(f"a worker ended (exit code {proc.wait()})")
    return json.loads(line)


def main(parent: str, change: str, pairs: int, out_path) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    roots = {"parent": os.path.abspath(parent), "change": os.path.abspath(change)}
    procs = {side: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", root],
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for side, root in roots.items()}
    readings = {side: [] for side in roots}
    try:
        for proc in procs.values():
            _ask(proc)  # ready: imported, built, fixtures on the card
        for i in range(pairs):
            for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                readings[side].append(_ask(procs[side], "reading"))
        summary = {side: _ask(proc, "summary") for side, proc in procs.items()}
    finally:
        for proc in procs.values():
            proc.stdin.close()
        for proc in procs.values():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    result = {"card": card, "roots": roots, "pairs": pairs, "summary": summary, "readings": {}}
    print(card)
    for side in roots:
        stats = {}
        for key in readings[side][0]:
            v = [r[key] for r in readings[side]]
            stats[key] = {"median": statistics.median(v), "min": min(v), "max": max(v), "all": v}
            print(f"{side} {key}: median {stats[key]['median']:.4f}, min {min(v):.4f}, "
                  f"max {max(v):.4f} ({pairs} readings)")
        result["readings"][side] = stats
        for label, row in summary[side].items():
            times = (f", device {row['device_ms']:.4f} ms, event {row['event_ms']:.4f} ms"
                     if "device_ms" in row else "")
            print(f"{side} {label}: bit-equal {row['bit_equal']}{times}")
    diffs = [c["cat_wall_ms"] - p["cat_wall_ms"]
             for c, p in zip(readings["change"], readings["parent"])]
    result["cat_wall_diff_ms"] = {"median": statistics.median(diffs), "min": min(diffs),
                                  "max": max(diffs), "change_higher": sum(d > 0 for d in diffs)}
    print(f"cat wall, change - parent by pair: median {result['cat_wall_diff_ms']['median']:.4f} ms, "
          f"change higher in {result['cat_wall_diff_ms']['change_higher']} of {pairs}")
    line = json.dumps(result)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", help="PARENT CHANGE")
    ap.add_argument("--worker", metavar="ROOT")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker))
    elif len(args.roots) == 2:
        main(*args.roots, args.pairs, args.out)
    else:
        ap.error("give PARENT and CHANGE, or --worker ROOT")
