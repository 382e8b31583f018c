"""Pipeline parallelism over pyramid levels.

Mirrors `icpx/distributed/pipeline.py`. Coarse-to-fine ICP chains its
levels for one pair (level l seeds level l + 1), but a stream of pairs
pipelines: stage (rank) l refines pairs at pyramid level l, so while the
last stage polishes pair b, stage 0 already aligns pair b + L - 1
(GPipe-style filling and draining), the accumulated transform handed
forward along the ``stages`` axis each tick (`comm.permute`).

Every stage runs the same program on same-shape data: a level keeps every
subsample^(L - 1 - l)-th point by mask, not by slicing, so coarse stages do
full-shape work. This is a validated mapping, not a throughput mode: B
pairs take B + L - 1 ticks of a full-resolution level each. For
throughput use the ``pairs`` axis (`sharded_register_pairs`) or
`register_batch`; one pair in flight is `register_pyramid`'s case.

Difference from the reference: the inputs are centred. Each pair is
shifted by its target's masked centroid before the stages run and the
shift is composed back into its result, as `register()` does; the
reference runs on the coordinates it is given, which at UTM-scale offsets
(1e5) lose the fp32 squared-distance expansion's precision. Near the
origin both agree; far from it only this one converges.
"""

from __future__ import annotations

import torch

from icpx_torch.distributed import comm
from icpx_torch.geometry.se3 import SE3
from icpx_torch.kernels.knn import nearest_neighbor
from icpx_torch.registration.icp import ICPConfig, _centre_pair
from icpx_torch.registration.step import correspondence_weights, estimate_increment


def pipelined_pyramid_register(
    src_xyz: torch.Tensor,  # (B, N, 3)
    src_mask: torch.Tensor,  # (B, N)
    src_normals: torch.Tensor,
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_normals: torch.Tensor,
    config: ICPConfig,
    mesh,
    *,
    stages_axis: str = "stages",
    iters_per_level: int = 4,
    subsample: int = 4,
) -> SE3:
    """Register B pairs through an L-stage coarse-to-fine pipeline (L the
    `stages_axis` size; every rank passes the same batch). Returns the
    batched SE3 (B,), the same on every rank: the last stage's results,
    broadcast by a psum of a one-hot."""
    b, n, _ = src_xyz.shape
    dev = src_xyz.device
    group = mesh.get_group(stages_axis)
    L = comm.axis_size(group)
    stage = comm.axis_index(group)
    stride = subsample ** (L - 1 - stage)
    level_keep = (torch.arange(n, device=dev) % stride) == 0  # this stage's level
    eye = SE3.identity(device=dev)
    pairs = [_centre_pair(src_xyz[i], src_mask[i], tgt_xyz[i], tgt_mask[i], eye)
             for i in range(b)]

    def refine(i: int, T: SE3) -> SE3:
        """iters_per_level ICP iterations of pair i at this stage's level."""
        sx, tx = pairs[i][0], pairs[i][1]
        sn, tn = src_normals[i], tgt_normals[i]
        s_mask, t_mask = src_mask[i] & level_keep, tgt_mask[i] & level_keep
        for _ in range(iters_per_level):
            p = T.apply(sx)
            n_p = T.rotate(sn)
            d2, idx = nearest_neighbor(p, tx, ref_mask=t_mask, tile_q=config.tile_q,
                                       tile_r=config.tile_r)
            idx = idx.long()
            q, n_q = tx[idx], tn[idx]
            w = correspondence_weights(config, p, n_p, q, n_q, torch.sqrt(d2), s_mask)
            T = estimate_increment(config, p, q, n_p, n_q, w) @ T
        return T

    out_R = torch.zeros((b, 3, 3), dtype=torch.float32, device=dev)
    out_t = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    forward = [(i, i + 1) for i in range(L - 1)]
    carry = eye
    for s in range(b + L - 1):
        i = s - stage  # the pair this stage works on at tick s
        refined = refine(i, carry) if 0 <= i < b else carry
        if 0 <= i < b and stage == L - 1:  # the last stage emits a finished pair
            out_R[i], out_t[i] = refined.R, refined.t
        # hand the transform to the next stage; stage 0 starts the next
        # pair from identity
        nxt_R, nxt_t = comm.permute([refined.R, refined.t], group, forward)
        carry = eye if stage == 0 else SE3(R=nxt_R, t=nxt_t)
    is_last = float(stage == L - 1)
    out_R, out_t = comm.psum((out_R * is_last, out_t * is_last), group)
    Rs, ts = [], []
    for i in range(b):
        _, _, _, shift, unshift = pairs[i]
        T = unshift @ SE3(R=out_R[i], t=out_t[i]) @ shift
        Rs.append(T.R)
        ts.append(T.t)
    return SE3(R=torch.stack(Rs), t=torch.stack(ts))
