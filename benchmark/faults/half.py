# A fault of the timed path: half of each batch left out, its answers taken from the
# rest: every other pair of the stream, the second half of a request's pairs. Every pool
# pair of the stream has its own ground truth, so another pair's answer is a wrong one.

import dataclasses, torch
import icpx_torch.registration.icp as I
from icpx_torch.geometry.se3 import SE3

_register, _batch = I.register, I.register_batch
_last = {}
def register(src, tgt, cfg, *a, **k):
    _last["n"] = _last.get("n", 0) + 1
    if _last["n"] % 2 == 0 and "res" in _last:
        return _last["res"]
    _last["res"] = _register(src, tgt, cfg, *a, **k)
    return _last["res"]
def _take(res, idx):
    return I.ICPResult(transform=SE3(R=res.transform.R[idx], t=res.transform.t[idx]),
                       iters=res.iters[idx], converged=res.converged[idx],
                       diff_history=res.diff_history[idx], rmse_history=res.rmse_history[idx],
                       final_rmse=res.final_rmse[idx], inlier_count=res.inlier_count[idx])
def register_batch(sx, sm, sn, tx, tm, tn, cfg, init=None):
    h = max(sx.shape[0] // 2, 1)
    sub = None if init is None else SE3(R=init.R[:h], t=init.t[:h])
    res = _batch(sx[:h], sm[:h], sn[:h], tx[:h], tm[:h], tn[:h], cfg, init=sub)
    return _take(res, torch.arange(sx.shape[0]) % h)
I.register, I.register_batch = register, register_batch
