"""Pose-graph back end: Gauss-Newton over SE(3) with Schur marginalization.

Mirrors `icpx/odometry/posegraph.py`. Nodes are keyframe poses, edges
relative-pose measurements:

  * each edge's residual is r = log(meas^-1 (T_i E(d_i))^-1 (T_j E(d_j)))
    with E = SE3.exp, and its (6, 6) Jacobians in d_i and d_j come from
    autodiff vmapped over edges: `torch.func.jacrev`, the exact derivative
    the reference takes with `jax.jacfwd`, in fp32 (torch's forward mode
    mixes fp64 tangents into the SE3 log's fp32 matmuls at the identity);
  * `optimize_pose_graph` assembles the dense (6M, 6M) normal system, and
    `optimize_pose_graph_sharded` the same from edge shards over a mesh
    axis, one psum of (H, b, chi2) an iteration and the same dense solve
    on every rank;
    `optimize_pose_graph_sparse` keeps it edge-indexed, applies it as a
    matvec and solves it by block-Jacobi preconditioned CG, with robust
    edge kernels and an optional marginal prior;
  * `schur_condense` and `SlidingWindowBackend` marginalize old nodes.

The reference's `lax.scan` over Gauss-Newton iterations is a loop here,
and its PCG `while_loop` a loop of the same stop rule and cap. Its
scatter-adds (`.at[].add`) are `utils.segsum` sums, in the reference's
order of adds and the same order on every run, so the card gives the same
bits twice; each plan is built once a call.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacrev, vmap

from icpx_torch.geometry.se3 import SE3
from icpx_torch.registration.step import identity_reduce
from icpx_torch.utils.segsum import segment_plan, segment_sum


@dataclass(frozen=True)
class PoseGraph:
    poses: SE3  # batched (M,)
    edge_i: torch.Tensor  # (E,) int32
    edge_j: torch.Tensor  # (E,) int32
    edge_meas: SE3  # batched (E,) measured i_T_j
    edge_weight: torch.Tensor  # (E,) information weights

    @property
    def n_nodes(self) -> int:
        return self.poses.t.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_i.shape[0]

    @classmethod
    def from_edge_list(cls, poses: SE3, edges, weights=None) -> "PoseGraph":
        """edges: a sequence of (i, j, SE3 i_T_j); on the poses' device."""
        dev = poses.t.device
        ei = torch.tensor([int(e[0]) for e in edges], dtype=torch.int32, device=dev)
        ej = torch.tensor([int(e[1]) for e in edges], dtype=torch.int32, device=dev)
        R = torch.stack([e[2].R.to(dev) for e in edges])
        t = torch.stack([e[2].t.to(dev) for e in edges])
        w = (torch.ones((len(edges),), dtype=torch.float32, device=dev) if weights is None
             else torch.as_tensor(np.asarray(weights, np.float32), device=dev))
        return cls(poses=poses, edge_i=ei, edge_j=ej, edge_meas=SE3(R=R, t=t), edge_weight=w)


def _edge_residual(a_R, a_t, b_R, b_t, m_R, m_t, di, dj) -> torch.Tensor:
    """(6,) residual of one edge at local perturbations (di, dj)."""
    Ti_p = SE3(R=a_R, t=a_t) @ SE3.exp(di)
    Tj_p = SE3(R=b_R, t=b_t) @ SE3.exp(dj)
    return (SE3(R=m_R, t=m_t).inverse() @ Ti_p.inverse() @ Tj_p).log()


_JAC = vmap(jacrev(_edge_residual, argnums=(6, 7)))


def _linearize_edges(graph: PoseGraph, poses: SE3):
    """Each edge's residual (E, 6) and exact Jacobians (E, 6, 6) at zero
    perturbation."""
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    args = (poses.R[ei], poses.t[ei], poses.R[ej], poses.t[ej], graph.edge_meas.R,
            graph.edge_meas.t)
    zero = torch.zeros((ei.shape[0], 6), dtype=torch.float32, device=poses.t.device)
    r = vmap(_edge_residual)(*args, zero, zero)
    Ji, Jj = _JAC(*args, zero, zero)
    return r, Ji, Jj


def _retract(poses: SE3, delta: torch.Tensor) -> SE3:
    return poses @ SE3.exp(delta)


def optimize_pose_graph(
    graph: PoseGraph,
    *,
    iters: int = 10,
    damping: float = 1e-6,
    anchor: int = 0,
    anchor_weight: float = 1e6,
) -> Tuple[SE3, torch.Tensor]:
    """Damped Gauss-Newton on the dense normal system: (optimized poses,
    per-iteration chi2 (iters,))."""
    return _optimize_impl(graph, iters=iters, damping=damping, anchor=anchor,
                          anchor_weight=anchor_weight)


def _optimize_impl(
    graph: PoseGraph,
    *,
    iters: int,
    damping: float,
    anchor: int,
    anchor_weight: float,
    reduce=identity_reduce,
    anchor_scale: float = 1.0,
) -> Tuple[SE3, torch.Tensor]:
    """The shared Gauss-Newton core. `reduce` sums the assembled (H, b,
    chi2) across an edge partition (the identity on one device);
    `anchor_scale` scales the gauge prior so psum'd shards add it exactly
    once."""
    m = graph.n_nodes
    dev = graph.poses.t.device
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    w = graph.edge_weight[:, None, None]
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    # the (i, j) blocks the edges touch, in the reference's order of adds
    # (all ii, then ij, ji, jj), each block's sum over its edges in that order
    keys, inv = torch.unique(torch.cat([ei * m + ei, ei * m + ej, ej * m + ei, ej * m + ej]),
                             return_inverse=True)
    h_plan = segment_plan(inv, keys.shape[0])
    b_plan = segment_plan(torch.cat([ei, ej]), m)
    poses = graph.poses
    chi2s = []
    for _ in range(iters):
        r, Ji, Jj = _linearize_edges(graph, poses)
        blocks = torch.cat([torch.einsum("eki,ekj->eij", A, B)
                            for A, B in ((Ji, Ji), (Ji, Jj), (Jj, Ji), (Jj, Jj))])
        H = torch.zeros((m * m, 6, 6), dtype=torch.float32, device=dev)
        H[keys] = segment_sum(torch.cat([w] * 4) * blocks, h_plan)
        H = H.reshape(m, m, 6, 6)
        wr = graph.edge_weight[:, None] * r
        b = segment_sum(torch.cat([torch.einsum("eki,ek->ei", Ji, wr),
                                   torch.einsum("eki,ek->ei", Jj, wr)]), b_plan)
        # gauge: a strong prior pinning the anchor node at its current pose
        # (scaled so a psum across edge shards adds it exactly once)
        H[anchor, anchor] += anchor_scale * anchor_weight * eye6
        chi2 = torch.sum(graph.edge_weight * torch.sum(r * r, dim=1))
        H, b, chi2 = reduce((H, b, chi2))
        chi2s.append(chi2)

        Hd = H.permute(0, 2, 1, 3).reshape(6 * m, 6 * m)
        Hd = Hd + torch.diag(damping * torch.diagonal(Hd) + 1e-9)
        delta = -torch.linalg.solve(Hd, b.reshape(6 * m)).reshape(m, 6)
        poses = _retract(poses, delta)
    chi2 = torch.stack(chi2s) if chi2s else torch.zeros((0,), dtype=torch.float32, device=dev)
    return poses, chi2


def optimize_pose_graph_sharded(
    graph: PoseGraph,
    mesh,
    *,
    iters: int = 10,
    damping: float = 1e-6,
    anchor: int = 0,
    anchor_weight: float = 1e6,
    edge_axis: str = "points",
) -> Tuple[SE3, torch.Tensor]:
    """Edge-sharded Gauss-Newton (data parallel over edges).

    Every rank passes the same graph and linearizes its shard of the edges
    into a partial (6M, 6M) system; one psum over `edge_axis` merges them
    and every rank runs the same dense solve, so the poses stay the same
    on every rank (the sharded ICP's sufficient-statistics pattern). The
    edge count must divide by the axis size (`pad_edges` pads with
    zero-weight self-edges)."""
    from icpx_torch.distributed import comm

    group = mesh.get_group(edge_axis)
    n_dev = comm.axis_size(group)
    if graph.n_edges % n_dev:
        raise ValueError(f"{graph.n_edges} edges not divisible by '{edge_axis}' size {n_dev}; "
                         "pad with pad_edges()")
    local = PoseGraph(
        poses=graph.poses,
        edge_i=comm.shard(graph.edge_i, group),
        edge_j=comm.shard(graph.edge_j, group),
        edge_meas=SE3(R=comm.shard(graph.edge_meas.R, group),
                      t=comm.shard(graph.edge_meas.t, group)),
        edge_weight=comm.shard(graph.edge_weight, group),
    )
    return _optimize_impl(local, iters=iters, damping=damping, anchor=anchor,
                          anchor_weight=anchor_weight, reduce=partial(comm.psum, group=group),
                          anchor_scale=1.0 / n_dev)


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge list to a multiple with zero-weight self-edges."""
    pad = (-graph.n_edges) % multiple
    if pad == 0:
        return graph
    dev = graph.poses.t.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = torch.zeros(pad, dtype=torch.int32, device=dev)
    return PoseGraph(
        poses=graph.poses,
        edge_i=torch.cat([graph.edge_i, i32]),
        edge_j=torch.cat([graph.edge_j, i32]),
        edge_meas=SE3(R=torch.cat([graph.edge_meas.R, torch.eye(3, **f32).expand(pad, 3, 3)]),
                      t=torch.cat([graph.edge_meas.t, torch.zeros((pad, 3), **f32)])),
        edge_weight=torch.cat([graph.edge_weight, torch.zeros(pad, **f32)]),
    )


# ---- the scalable back end: block-sparse, PCG, robust kernels --------------

ROBUST_KERNELS = ("none", "huber", "dcs", "cauchy")


@dataclass(frozen=True)
class MarginalPrior:
    """Gaussian prior from Schur marginalization: 0.5 d^T H d + b^T d over
    the stacked local perturbations d of `nodes`, linearized at `lin`."""

    nodes: torch.Tensor  # (P,) int32 node ids the prior couples
    H: torch.Tensor  # (P*6, P*6)
    b: torch.Tensor  # (P*6,)
    lin: SE3  # batched (P,) linearization poses

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    def replace(self, **changes) -> "MarginalPrior":
        return replace(self, **changes)


def _edge_robust_weight(kind: str, chi2_e: torch.Tensor, delta) -> torch.Tensor:
    """IRLS weight an edge from its weighted squared residual."""
    if kind == "none":
        return torch.ones_like(chi2_e)
    if kind == "huber":
        s = torch.sqrt(torch.clamp(chi2_e, min=1e-20))
        return torch.clamp(delta / s, max=1.0)
    if kind == "dcs":
        # Dynamic Covariance Scaling (Agarwal et al. 2013)
        s = torch.clamp(2.0 * delta / (delta + chi2_e), max=1.0)
        return s * s
    if kind == "cauchy":
        return 1.0 / (1.0 + chi2_e / (delta * delta))
    raise ValueError(f"robust kernel must be one of {ROBUST_KERNELS}")


_PCG_CHECK_EVERY = 8  # PCG iterations between host fetches of its stop flag


def _pcg(matvec, b: torch.Tensor, Minv_blocks: torch.Tensor, iters: int, tol: float) -> torch.Tensor:
    """Block-Jacobi preconditioned CG on the (M, 6) system.

    The reference's while_loop runs while k < iters and ||r|| > tol ||b||.
    Here every iteration's update is kept only while that holds (the state
    freezes once it fails, as the while_loop stops), and the loop leaves
    early when a fetch every `_PCG_CHECK_EVERY` iterations finds it frozen."""
    def precond(r):
        return torch.einsum("mij,mj->mi", Minv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.sqrt(torch.sum(b * b)) + 1e-30
    active = torch.ones((), dtype=torch.bool, device=b.device)
    for k in range(iters):
        active = active & (torch.sqrt(torch.sum(r * r)) > tol * bnorm)
        if k % _PCG_CHECK_EVERY == 0 and k and not bool(active):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = torch.sum(r_n * z)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
    return x


def _prior_diag(prior: MarginalPrior) -> torch.Tensor:
    """The prior's (P, 6, 6) diagonal blocks."""
    p = prior.n_nodes
    ar = torch.arange(p, device=prior.H.device)
    return prior.H.reshape(p, 6, p, 6)[ar, :, ar, :]


def optimize_pose_graph_sparse(
    graph: PoseGraph,
    *,
    iters: int = 10,
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    damping: float = 1e-6,
    anchor: int = 0,
    anchor_weight: float = 1e6,
    robust: str = "none",
    robust_delta: float = 1.0,
    prior: Optional[MarginalPrior] = None,
) -> Tuple[SE3, torch.Tensor]:
    """Damped Gauss-Newton with the Hessian kept block-sparse (never
    assembled), a block-Jacobi PCG solve, an optional robust edge kernel
    (`robust_delta <= 0`: scale from 5 x the median edge chi2) and an
    optional marginal prior: (poses, per-iteration chi2 (iters,))."""
    m = graph.n_nodes
    dev = graph.poses.t.device
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    pn = prior.nodes.long() if prior is not None else None
    Hp_diag = _prior_diag(prior) if prior is not None else None
    plan = segment_plan(torch.cat([ei, ej]), m)  # every edge sum, the matvec's too
    poses = graph.poses
    chi2s = []
    for _ in range(iters):
        r, Ji, Jj = _linearize_edges(graph, poses)
        chi2_e = graph.edge_weight * torch.sum(r * r, dim=1)
        if robust_delta <= 0:
            # torch.quantile interpolates as jnp.median does on even counts
            delta = torch.clamp(5.0 * torch.quantile(chi2_e, 0.5), min=1e-8)
        else:
            delta = robust_delta
        w = graph.edge_weight * _edge_robust_weight(robust, chi2_e, delta)
        wc = w[:, None, None]
        Hii = wc * torch.einsum("eki,ekj->eij", Ji, Ji)
        Hjj = wc * torch.einsum("eki,ekj->eij", Jj, Jj)
        Hij = wc * torch.einsum("eki,ekj->eij", Ji, Jj)

        Hdiag = segment_sum(torch.cat([Hii, Hjj]), plan)
        wr = w[:, None] * r
        b = segment_sum(torch.cat([torch.einsum("eki,ek->ei", Ji, wr),
                                   torch.einsum("eki,ek->ei", Jj, wr)]), plan)
        Hdiag[anchor] += anchor_weight * eye6

        if prior is not None:
            # the prior's nodes are distinct: a plain add at each
            p = prior.n_nodes
            xi = (prior.lin.inverse() @ SE3(R=poses.R[pn], t=poses.t[pn])).log()
            grad_p = (prior.H @ xi.reshape(p * 6) + prior.b).reshape(p, 6)
            b[pn] = b[pn] + grad_p
            Hdiag[pn] = Hdiag[pn] + Hp_diag

        # Levenberg damping on the diagonal blocks
        dmask = eye6[None]
        Hdiag_d = Hdiag + damping * Hdiag * dmask + 1e-9 * dmask

        def matvec(x, Hdiag_d=Hdiag_d, Hij=Hij):
            y = torch.einsum("mij,mj->mi", Hdiag_d, x)
            y = y + segment_sum(torch.cat([torch.einsum("eij,ej->ei", Hij, x[ej]),
                                           torch.einsum("eji,ej->ei", Hij, x[ei])]), plan)
            if prior is not None:
                p = prior.n_nodes
                yp = (prior.H @ x[pn].reshape(p * 6)).reshape(p, 6)
                # the diagonal blocks are already in Hdiag: take them back out
                yp = yp - torch.einsum("mij,mj->mi", Hp_diag, x[pn])
                y[pn] = y[pn] + yp
            return y

        step = _pcg(matvec, -b, torch.linalg.inv(Hdiag_d), cg_iters, cg_tol)
        chi2s.append(torch.sum(chi2_e))
        poses = _retract(poses, step)
    chi2 = torch.stack(chi2s) if chi2s else torch.zeros((0,), dtype=torch.float32, device=dev)
    return poses, chi2


def schur_condense(H: torch.Tensor, b: torch.Tensor, n_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Schur complement of the trailing block: with H = [[A, B], [B^T, C]]
    and the first `n_keep` rows kept, (A - B C^-1 B^T, b_a - B C^-1 b_c)."""
    A = H[:n_keep, :n_keep]
    B = H[:n_keep, n_keep:]
    C = H[n_keep:, n_keep:]
    C = C + 1e-9 * torch.eye(C.shape[0], dtype=H.dtype, device=H.device)
    CinvBt = torch.linalg.solve(C, B.T)
    Cinvbc = torch.linalg.solve(C, b[n_keep:])
    return A - B @ CinvBt, b[:n_keep] - B @ Cinvbc


def _stack(poses) -> SE3:
    return SE3(R=torch.stack([p.R for p in poses]), t=torch.stack([p.t for p in poses]))


class SlidingWindowBackend:
    """Incremental pose-graph back end with Schur marginalization.

    Keyframes enter through `add_keyframe` / `add_edge`; once the active
    window holds more than `window` nodes, the oldest is marginalized:
    every factor touching it (edges, the running prior, the gauge prior at
    the first marginalization) is linearized at the current estimate, the
    node is Schur-eliminated, and the result becomes a dense
    `MarginalPrior` over its neighbours. Marginalized poses are frozen.
    Edges to marginalized nodes are refused."""

    def __init__(self, window: int = 10, *, iters: int = 5, cg_iters: int = 100,
                 robust: str = "dcs", robust_delta: float = 1.0, anchor_weight: float = 1e6,
                 damping: float = 1e-6):
        self.window = int(window)
        self.iters = iters
        self.cg_iters = cg_iters
        self.robust = robust
        self.robust_delta = robust_delta
        self.anchor_weight = anchor_weight
        self.damping = damping
        self.poses: list = []  # SE3 a keyframe (world), all history
        self.active0 = 0  # first node not marginalized
        self.edges: list = []  # (i, j, SE3 meas, weight), global ids
        self.prior: Optional[MarginalPrior] = None  # nodes in global ids

    def add_keyframe(self, pose: SE3) -> int:
        self.poses.append(pose)
        return len(self.poses) - 1

    def add_edge(self, i: int, j: int, meas: SE3, weight: float = 1.0):
        if min(i, j) < self.active0:
            raise ValueError(f"edge ({i},{j}) touches a marginalized node "
                             f"(window starts at {self.active0})")
        self.edges.append((i, j, meas, float(weight)))

    @property
    def n_active(self) -> int:
        return len(self.poses) - self.active0

    def optimize(self) -> float:
        """Optimize the active window (prior and edges); the final chi2."""
        a0 = self.active0
        if self.n_active < 2 or not self.edges:
            return 0.0
        graph = PoseGraph.from_edge_list(
            _stack(self.poses[a0:]),
            [(i - a0, j - a0, m) for (i, j, m, _) in self.edges],
            weights=[w for (_, _, _, w) in self.edges],
        )
        prior = self._local_prior()
        # gauge: the first marginalization bakes the anchor into the prior
        anchor_w = self.anchor_weight if prior is None else 0.0
        opt, chi2 = optimize_pose_graph_sparse(
            graph, iters=self.iters, cg_iters=self.cg_iters, damping=self.damping, anchor=0,
            anchor_weight=anchor_w, robust=self.robust, robust_delta=self.robust_delta,
            prior=prior)
        for k in range(self.n_active):
            self.poses[a0 + k] = SE3(R=opt.R[k], t=opt.t[k])
        return float(chi2[-1])

    def _local_prior(self) -> Optional[MarginalPrior]:
        if self.prior is None:
            return None
        return self.prior.replace(nodes=self.prior.nodes - self.active0)

    def marginalize_to_window(self):
        """Marginalize the oldest nodes until the active set fits."""
        while self.n_active > self.window:
            self._marginalize_oldest()

    def step(self) -> float:
        """Optimize, then marginalize: call after adding a keyframe and edges."""
        chi2 = self.optimize()
        self.marginalize_to_window()
        return chi2

    def _marginalize_oldest(self):
        o = self.active0
        dev = self.poses[o].t.device
        touching = [e for e in self.edges if o in (e[0], e[1])]
        keep_edges = [e for e in self.edges if o not in (e[0], e[1])]
        nodes = set()
        for (i, j, _, _) in touching:
            nodes.update((i, j))
        if self.prior is not None:
            nodes.update(int(x) for x in self.prior.nodes.cpu().tolist())
        nodes.discard(o)
        keep = sorted(nodes)
        S = keep + [o]  # the marginalized node last (schur keeps the head)
        loc = {g: k for k, g in enumerate(S)}
        ns = len(S)
        H = np.zeros((ns * 6, ns * 6), np.float64)
        b = np.zeros((ns * 6,), np.float64)

        if touching:
            g = PoseGraph.from_edge_list(
                _stack([self.poses[k] for k in S]),
                [(loc[i], loc[j], m) for (i, j, m, _) in touching],
                weights=[w for (_, _, _, w) in touching],
            )
            r, Ji, Jj = (x.cpu().numpy() for x in _linearize_edges(g, g.poses))
            for e, (gi, gj, _, w) in enumerate(touching):
                li, lj = loc[gi] * 6, loc[gj] * 6
                Jie, Jje, re = Ji[e], Jj[e], r[e]
                H[li:li + 6, li:li + 6] += w * Jie.T @ Jie
                H[lj:lj + 6, lj:lj + 6] += w * Jje.T @ Jje
                H[li:li + 6, lj:lj + 6] += w * Jie.T @ Jje
                H[lj:lj + 6, li:li + 6] += w * Jje.T @ Jie
                b[li:li + 6] += w * Jie.T @ re
                b[lj:lj + 6] += w * Jje.T @ re

        if self.prior is not None:
            pn = self.prior.nodes.cpu().tolist()
            lin = self.prior.lin
            xi = np.concatenate([
                (SE3(R=lin.R[k], t=lin.t[k]).inverse() @ self.poses[int(pn[k])]).log().cpu().numpy()
                for k in range(len(pn))
            ])
            Hp = self.prior.H.cpu().numpy().astype(np.float64)
            bp = self.prior.b.cpu().numpy().astype(np.float64) + Hp @ xi
            idx = np.concatenate([np.arange(loc[int(gk)] * 6, loc[int(gk)] * 6 + 6) for gk in pn])
            H[np.ix_(idx, idx)] += Hp
            b[idx] += bp

        if self.prior is None:
            # first marginalization: fold the gauge prior on the anchor in
            lo = loc[o] * 6
            H[lo:lo + 6, lo:lo + 6] += self.anchor_weight * np.eye(6)

        Hk, bk = schur_condense(torch.tensor(H, dtype=torch.float32, device=dev),
                                torch.tensor(b, dtype=torch.float32, device=dev), (ns - 1) * 6)
        self.prior = MarginalPrior(
            nodes=torch.tensor(keep, dtype=torch.int32, device=dev),
            H=Hk,
            b=bk,
            lin=_stack([self.poses[k] for k in keep]),
        )
        self.edges = keep_edges
        self.active0 = o + 1
