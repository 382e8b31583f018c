"""Rank processes for the distributed parity tests of the PyTorch port.
Not collected (no `test_` prefix). Imports torch, numpy and `icpx_torch`
only: the ranks never import JAX.

`RankPool(size)` starts `size` Python processes running this file, kept
alive for a test module. `pool.run(case, world, **inputs)` hands a case to
ranks 0..world-1: each joins a fresh gloo group of `world` ranks over a
`FileStore` in the pool's temporary directory (no fixed ports, so pytest
workers never collide), runs `CASES[case](**inputs)` on the CPU, leaves the
group, and sends back its result (numpy arrays and plain values). The
protocol is length-free pickle frames on the child's stdin and on a
private copy of its stdout (the child's own stdout goes to stderr).
"""

from __future__ import annotations

import os
import pickle
import select
import subprocess
import sys
import tempfile
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CASE_TIMEOUT = 120.0  # seconds a case may take on every rank


class RankPool:
    def __init__(self, size: int = 4):
        self.size = size
        self._tmp = tempfile.TemporaryDirectory(prefix="icpx_torch_ranks_")
        self._n = 0
        self._start()

    def _start(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
                   OMP_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(r)], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, env=env, cwd=str(ROOT))
            for r in range(self.size)
        ]

    def run(self, case: str, world: int, **inputs):
        """[rank 0's result, ..., rank world-1's]; raises if any rank failed.
        The test's own process waits meanwhile: the ranks and the JAX side
        never compute at once, which keeps the suite's peak load down."""
        if world > self.size:
            raise ValueError(f"{world} ranks asked of a pool of {self.size}")
        self._n += 1
        store = os.path.join(self._tmp.name, f"store{self._n}")
        for p in self.procs[:world]:
            pickle.dump((case, world, store, inputs), p.stdin)
            p.stdin.flush()
        out, errors = [], []
        for r, p in enumerate(self.procs[:world]):
            ready, _, _ = select.select([p.stdout], [], [], CASE_TIMEOUT)
            if not ready:  # a hung rank: fresh processes for the next case
                self._stop()
                self._start()
                raise TimeoutError(f"rank {r} of case {case!r} gave no result in {CASE_TIMEOUT} s")
            status, value = pickle.load(p.stdout)
            if status != "ok":
                errors.append(f"rank {r}: {value}")
            out.append(value)
        if errors:
            raise RuntimeError(f"case {case!r} at W={world} failed:\n" + "\n".join(errors))
        return out

    def close(self):
        self._stop()
        self._tmp.cleanup()

    def _stop(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# ---- the rank side ----------------------------------------------------------------------


def _np(x):
    import torch

    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _cloud(d):
    from icpx_torch import interop

    return interop.cloud_from_numpy(d["xyz"], d["mask"], d.get("normals"), d.get("covs"),
                                    d.get("feats"), d.get("feat_names"), device="cpu")


def _config(d):
    from icpx_torch import interop

    return interop.config_from_dict(d)


def _result(res):
    return {"R": _np(res.transform.R), "t": _np(res.transform.t), "iters": _np(res.iters),
            "converged": _np(res.converged), "final_rmse": _np(res.final_rmse),
            "diff_history": _np(res.diff_history), "rmse_history": _np(res.rmse_history),
            "inlier_count": _np(res.inlier_count)}


def _mesh(shape, names):
    from icpx_torch.distributed.mesh import make_mesh

    return make_mesh(tuple(shape) if shape else None, tuple(names), device="cpu")


def case_mesh(shape, names):
    from icpx_torch.distributed import comm

    mesh = _mesh(shape, names)
    return {"shape": tuple(mesh.shape), "names": tuple(mesh.mesh_dim_names),
            "index": {a: comm.axis_index(mesh.get_group(a)) for a in names},
            "size": {a: comm.axis_size(mesh.get_group(a)) for a in names}}


def case_comm():
    """psum, the ring's order, permute, all_to_all and all_gather, with the
    record of what was issued."""
    import torch

    from icpx_torch.distributed import comm
    from icpx_torch.utils.collectives import assert_overlappable

    mesh = _mesh(None, ("points",))
    g = mesh.get_group("points")
    w, r = comm.axis_size(g), comm.axis_index(g)
    with comm.recording() as rec:
        s = comm.psum((torch.tensor(float(r + 1)), torch.full((2, 3), float(r)),
                       torch.tensor([r], dtype=torch.int32)), g)
        held = [r]
        cur = [torch.tensor([r], dtype=torch.int64), torch.tensor([r % 2 == 0])]
        with comm.recording() as ring_rec:
            for step in range(w):
                shift = comm.ring_shift(cur, g) if step < w - 1 else None
                comm.note_fold()
                if shift is not None:
                    cur = shift.wait()
                    held.append(int(cur[0]))
        fwd = comm.permute([torch.tensor([10.0 * r])], g, [(i, i + 1) for i in range(w - 1)])[0]
        a2a = comm.all_to_all(torch.arange(w * 2, dtype=torch.float32).reshape(w, 2) + 100 * r, g)
        gat = comm.all_gather((torch.full((2,), float(r)), torch.tensor([r % 2 == 1])), g)
    reports = assert_overlappable(ring_rec) if w > 1 else []
    return {"psum": [_np(x) for x in s], "held": held, "fwd": _np(fwd), "a2a": _np(a2a),
            "gather": [_np(x) for x in gat], "kinds": [(e.kind, e.phase, e.bytes) for e in rec],
            "ring_kinds": [(e.kind, e.phase) for e in ring_rec],
            "overlap": [o.folds_between for o in reports]}


def case_ring_nn(q, r, mask, payload, tile_q, tile_r):
    import torch

    from icpx_torch.distributed import comm
    from icpx_torch.distributed.ring import ring_nearest_neighbor

    mesh = _mesh(None, ("points",))
    g = mesh.get_group("points")
    with comm.recording() as rec:
        d, i, pl = ring_nearest_neighbor(
            torch.tensor(q), comm.shard(torch.tensor(r), g), comm.shard(torch.tensor(mask), g), g,
            payload_shard=None if payload is None else comm.shard(torch.tensor(payload), g),
            tile_q=tile_q, tile_r=tile_r)
    order = [(e.kind, e.phase) for e in rec]
    return {"d": _np(d), "i": _np(i), "pl": None if pl is None else _np(pl), "order": order}


def case_sharded_register(src, tgt, config, ring=False, init=None, traffic=False):
    from icpx_torch import interop
    from icpx_torch.distributed.sharded_icp import sharded_register
    from icpx_torch.utils.collectives import collective_traffic

    mesh = _mesh(None, ("points",))
    s, t, cfg = _cloud(src), _cloud(tgt), _config(config)
    init_t = None if init is None else interop.se3_from_numpy(init[0], init[1], device="cpu")
    out = _result(sharded_register(s, t, cfg, mesh, init_t, ring=ring))
    if traffic:
        import dataclasses

        rows = collective_traffic(sharded_register, s, t, dataclasses.replace(cfg, max_iters=1),
                                  mesh, ring=ring)
        out["traffic"] = [(row.computation, row.opcode, row.bytes) for row in rows]
    return out


def case_pairs(arrays, config, shape):
    import torch

    from icpx_torch.distributed.sharded_icp import sharded_register_pairs

    mesh = _mesh(shape, ("pairs", "points"))
    args = [torch.tensor(a) for a in arrays]
    try:
        return _result(sharded_register_pairs(*args, _config(config), mesh))
    except ValueError as e:
        return {"error": str(e)}


def case_routed_nn(blocks, q, kw):
    import torch

    from icpx_torch import interop
    from icpx_torch.distributed import comm
    from icpx_torch.distributed.map_ep import routed_map_nn

    mesh = _mesh(None, ("blocks",))
    g = mesh.get_group("blocks")
    mb = interop.map_blocks_from_numpy(_ns(blocks), device="cpu")
    me = comm.axis_index(g)
    kw = dict(kw)
    block_tile = kw.pop("block_tile", None)
    if block_tile:  # answer through a KD tile index over this rank's block
        from icpx_torch.kernels.blocknn import build_kd_index, fused_payload_table

        idx = build_kd_index(mb.block_xyz[me], mb.block_mask[me], tile_size=block_tile)
        kw.update(block_index=idx, block_payload=fused_payload_table(idx, mb.block_normals[me]))
    d, mx, mn = routed_map_nn(comm.shard(torch.tensor(q), g), mb.block_xyz[me],
                              mb.block_normals[me], mb.block_mask[me], mb.boundaries, mb.lo,
                              mb.inv_extent, g, **kw)
    return {"d": _np(d), "mx": _np(mx), "mn": _np(mn)}


def _ns(d):
    import types

    return types.SimpleNamespace(**d)


def case_map_register(scan, blocks, config, nn):
    from icpx_torch import interop
    from icpx_torch.distributed.map_ep import sharded_map_register

    mesh = _mesh(None, ("blocks",))
    mb = interop.map_blocks_from_numpy(_ns(blocks), device="cpu")
    return _result(sharded_map_register(_cloud(scan), mb, _config(config), mesh, nn=nn))


def case_pipeline(arrays, config, kw):
    import torch

    from icpx_torch.distributed.pipeline import pipelined_pyramid_register

    mesh = _mesh(None, ("stages",))
    out = pipelined_pyramid_register(*[torch.tensor(a) for a in arrays], _config(config), mesh,
                                     **kw)
    return {"R": _np(out.R), "t": _np(out.t)}


def case_posegraph(graph, iters):
    from icpx_torch import interop
    from icpx_torch.odometry.posegraph import optimize_pose_graph_sharded

    mesh = _mesh(None, ("points",))
    poses, chi2 = optimize_pose_graph_sharded(
        interop.pose_graph_from_numpy(_ns(graph), device="cpu"), mesh, iters=iters)
    return {"R": _np(poses.R), "t": _np(poses.t), "chi2": _np(chi2)}


def case_parallel_odometry(frames, config, shape):
    from icpx_torch.odometry.parallel import parallel_odometry

    mesh = _mesh(shape, ("pairs", "points"))
    poses, edges, rmse = parallel_odometry([_cloud(f) for f in frames], _config(config), mesh)
    return {"R": np.stack([_np(p.R) for p in poses]), "t": np.stack([_np(p.t) for p in poses]),
            "edges": [(i, j) for i, j, _ in edges], "rmse": _np(rmse)}


def case_block_ring_order():
    """ring_block_nn over per-rank KD indexes of a random target's shards:
    the record's post / fold / wait order and the exact-NN rate."""
    import torch

    from icpx_torch.distributed import comm
    from icpx_torch.distributed.ring import ring_block_nn
    from icpx_torch.kernels.blocknn import build_kd_index, tile_payload, trim_index
    from icpx_torch.kernels.knn import nearest_neighbor
    from icpx_torch.utils.collectives import overlap_reports

    mesh = _mesh(None, ("points",))
    g = mesh.get_group("points")
    rng = np.random.default_rng(4)
    tgt = torch.tensor(rng.uniform(-1, 1, (2048, 3)).astype(np.float32))
    q = torch.tensor(rng.uniform(-1, 1, (512, 3)).astype(np.float32))
    shard = comm.shard(tgt, g)
    idx = trim_index(build_kd_index(shard, tile_size=32), shard.shape[0], multiple=64)
    pl = tile_payload(idx, shard)
    qi = build_kd_index(comm.shard(q, g), tile_size=16)
    with comm.recording() as rec:
        d, rows = ring_block_nn(qi.tiles, idx, pl, g, k_tiles=6, payload_xyz=3)
    d_ref, _ = nearest_neighbor(qi.tiles.reshape(-1, 3), tgt)
    valid = qi.order >= 0
    exact = float((d[valid] <= d_ref[valid] + 1e-6).float().mean())
    return {"order": [(e.kind, e.phase) for e in rec], "exact": exact,
            "folds_between": [o.folds_between for o in overlap_reports(rec)]}


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def _serve(rank: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)  # the code's own prints go to stderr, never into the frames
    inp = sys.stdin.buffer
    while True:
        try:
            case, world, store, inputs = pickle.load(inp)
        except EOFError:
            return
        try:
            dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                    world_size=world, timeout=timedelta(seconds=CASE_TIMEOUT))
            # every rank's connections stand before any rank can fail and leave
            dist.barrier()
            value = CASES[case](**inputs)
            if isinstance(value, dict):
                value["jax_loaded"] = "jax" in sys.modules or "icpx" in sys.modules
            reply = ("ok", value)
        except BaseException:  # noqa: BLE001 (reported to the parent)
            reply = ("err", traceback.format_exc())
        finally:
            if dist.is_initialized():
                try:  # leave together: a rank that closes early breaks its peers' sockets
                    dist.barrier()
                except RuntimeError:
                    pass
                dist.destroy_process_group()
        pickle.dump(reply, out)
        out.flush()


if __name__ == "__main__":
    _serve(int(sys.argv[1]))
