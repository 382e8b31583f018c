"""Odometry checkpoint and resume.

Mirrors `OdometryCheckpoint` of `icpx/utils/checkpoint.py`, with the same
`.npz` keys, so a checkpoint either package saved loads in the other and
resumes there. The generic pytree `save_checkpoint` / `load_checkpoint`
wait for ROADMAP queue 1 step 8.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from icpx_torch.cloud import DEFAULT_DEVICE
from icpx_torch.geometry.se3 import SE3


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass
class OdometryCheckpoint:
    """Resumable odometry state (host-side numpy).

    The per-frame arrays and the motion-model state (`is_keyframe`,
    `rmse`, `motion_R` / `motion_t` = stacked [prev_rel, velocity],
    `model_warm`, `consecutive_rejects`) make `run_odometry(resume=...)`
    continue exactly; older checkpoints without them still load, with
    those fields None. `kf_masks` holds the keyframes' post-scrub masks
    (needed with dynamic_sigma > 0); the `win_*` fields the sliding-window
    back end's state (first active node, surviving edges in window ids,
    the marginal prior), so a resumed window is exact too.
    """

    frame_index: int
    poses_R: np.ndarray  # (M, 3, 3)
    poses_t: np.ndarray  # (M, 3)
    keyframe_index: int
    edges: List[Tuple[int, int, np.ndarray, np.ndarray]]  # (i, j, R, t)
    is_keyframe: Optional[np.ndarray] = None  # (M,) bool
    rmse: Optional[np.ndarray] = None  # (M,) float32
    motion_R: Optional[np.ndarray] = None  # (2, 3, 3): prev_rel, velocity
    motion_t: Optional[np.ndarray] = None  # (2, 3)
    model_warm: bool = False
    consecutive_rejects: int = 0
    kf_masks: Optional[np.ndarray] = None  # (K, N) bool
    win_active0: Optional[int] = None
    win_edges: Optional[List[Tuple[int, int, np.ndarray, np.ndarray, float]]] = None
    win_prior_nodes: Optional[np.ndarray] = None  # (P,) int32 window ids
    win_prior_H: Optional[np.ndarray] = None  # (P*6, P*6)
    win_prior_b: Optional[np.ndarray] = None  # (P*6,)
    win_prior_lin_R: Optional[np.ndarray] = None  # (P, 3, 3)
    win_prior_lin_t: Optional[np.ndarray] = None  # (P, 3)

    @classmethod
    def from_result(cls, result) -> "OdometryCheckpoint":
        """Build from a `frontend.OdometryResult` (its full resumable state)."""
        m = result.motion
        return cls(
            frame_index=len(result.poses) - 1,
            poses_R=np.stack([_host(p.R) for p in result.poses]),
            poses_t=np.stack([_host(p.t) for p in result.poses]),
            keyframe_index=result.keyframe_indices[-1],
            edges=[(i, j, _host(T.R), _host(T.t)) for (i, j, T) in result.edges],
            is_keyframe=np.asarray(result.is_keyframe, bool),
            rmse=np.asarray(result.rmse, np.float32),
            motion_R=(np.stack([_host(m.prev_rel.R), _host(m.velocity.R)])
                      if m is not None else None),
            motion_t=(np.stack([_host(m.prev_rel.t), _host(m.velocity.t)])
                      if m is not None else None),
            model_warm=bool(m.model_warm) if m is not None else False,
            consecutive_rejects=int(m.consecutive_rejects) if m is not None else 0,
            kf_masks=(np.stack(result.keyframe_masks)
                      if result.keyframe_masks is not None else None),
            **cls._window_fields(getattr(result, "window", None)),
        )

    @staticmethod
    def _window_fields(win) -> dict:
        """A SlidingWindowBackend's resume-critical state."""
        if win is None:
            return {}
        out = {
            "win_active0": int(win.active0),
            "win_edges": [(int(i), int(j), _host(m.R), _host(m.t), float(w))
                          for (i, j, m, w) in win.edges],
        }
        if win.prior is not None:
            out.update(
                win_prior_nodes=_host(win.prior.nodes).astype(np.int32),
                win_prior_H=_host(win.prior.H).astype(np.float32),
                win_prior_b=_host(win.prior.b).astype(np.float32),
                win_prior_lin_R=_host(win.prior.lin.R).astype(np.float32),
                win_prior_lin_t=_host(win.prior.lin.t).astype(np.float32),
            )
        return out

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        extra = {}
        if self.is_keyframe is not None:
            extra["is_keyframe"] = np.asarray(self.is_keyframe, bool)
        if self.rmse is not None:
            extra["rmse"] = np.asarray(self.rmse, np.float32)
        if self.motion_R is not None:
            extra["motion_R"] = self.motion_R
            extra["motion_t"] = self.motion_t
            extra["model_warm"] = np.asarray(self.model_warm)
            extra["consecutive_rejects"] = np.asarray(self.consecutive_rejects, np.int32)
        if self.kf_masks is not None:
            extra["kf_masks"] = np.asarray(self.kf_masks, bool)
        if self.win_active0 is not None:
            we = self.win_edges or []
            extra["win_active0"] = np.asarray(self.win_active0, np.int32)
            extra["win_edge_i"] = np.asarray([e[0] for e in we], np.int32)
            extra["win_edge_j"] = np.asarray([e[1] for e in we], np.int32)
            extra["win_edge_R"] = (np.stack([e[2] for e in we]) if we
                                   else np.zeros((0, 3, 3), np.float32))
            extra["win_edge_t"] = (np.stack([e[3] for e in we]) if we
                                   else np.zeros((0, 3), np.float32))
            extra["win_edge_w"] = np.asarray([e[4] for e in we], np.float32)
            if self.win_prior_nodes is not None:
                extra["win_prior_nodes"] = self.win_prior_nodes
                extra["win_prior_H"] = self.win_prior_H
                extra["win_prior_b"] = self.win_prior_b
                extra["win_prior_lin_R"] = self.win_prior_lin_R
                extra["win_prior_lin_t"] = self.win_prior_lin_t
        np.savez_compressed(
            path,
            frame_index=self.frame_index,
            poses_R=self.poses_R,
            poses_t=self.poses_t,
            keyframe_index=self.keyframe_index,
            edge_i=np.asarray([e[0] for e in self.edges], np.int32),
            edge_j=np.asarray([e[1] for e in self.edges], np.int32),
            edge_R=(np.stack([e[2] for e in self.edges]) if self.edges
                    else np.zeros((0, 3, 3), np.float32)),
            edge_t=(np.stack([e[3] for e in self.edges]) if self.edges
                    else np.zeros((0, 3), np.float32)),
            **extra,
        )

    @classmethod
    def load(cls, path) -> "OdometryCheckpoint":
        with np.load(Path(path)) as z:
            def opt(key):
                return z[key] if key in z else None

            edges = [(int(i), int(j), R, t)
                     for i, j, R, t in zip(z["edge_i"], z["edge_j"], z["edge_R"], z["edge_t"])]
            win_edges = None
            if "win_active0" in z:
                win_edges = [(int(i), int(j), R, t, float(w)) for i, j, R, t, w in zip(
                    z["win_edge_i"], z["win_edge_j"], z["win_edge_R"], z["win_edge_t"],
                    z["win_edge_w"])]
            return cls(
                frame_index=int(z["frame_index"]),
                poses_R=z["poses_R"],
                poses_t=z["poses_t"],
                keyframe_index=int(z["keyframe_index"]),
                edges=edges,
                is_keyframe=opt("is_keyframe"),
                rmse=opt("rmse"),
                motion_R=opt("motion_R"),
                motion_t=opt("motion_t"),
                model_warm=bool(z["model_warm"]) if "model_warm" in z else False,
                consecutive_rejects=(int(z["consecutive_rejects"])
                                     if "consecutive_rejects" in z else 0),
                kf_masks=opt("kf_masks"),
                win_active0=int(z["win_active0"]) if "win_active0" in z else None,
                win_edges=win_edges,
                win_prior_nodes=opt("win_prior_nodes"),
                win_prior_H=opt("win_prior_H"),
                win_prior_b=opt("win_prior_b"),
                win_prior_lin_R=opt("win_prior_lin_R"),
                win_prior_lin_t=opt("win_prior_lin_t"),
            )

    def poses(self, *, device=DEFAULT_DEVICE) -> List[SE3]:
        """The saved world poses as SE3 on `device`."""
        from icpx_torch.interop import se3_from_numpy

        return [se3_from_numpy(R, t, device=device) for R, t in zip(self.poses_R, self.poses_t)]
