# A fault of the timed path: every answer moved by 5 cm where it is produced.

import dataclasses, torch
import icpx_torch.registration.icp as I
from icpx_torch.geometry.se3 import SE3

_register, _batch = I.register, I.register_batch
def _moved(T):
    return SE3(R=T.R, t=T.t + 0.05)
def register(*a, **k):
    res = _register(*a, **k)
    return res.replace(transform=_moved(res.transform))
def register_batch(*a, **k):
    res = _batch(*a, **k)
    return res.replace(transform=_moved(res.transform))
I.register, I.register_batch = register, register_batch
