# A fault of the timed path: every ICP loop returns the state it was given.

import dataclasses, torch
import icpx_torch.registration.icp as I
from icpx_torch.geometry.se3 import SE3

_scan = I._icp_scan
def _unchanged(config, src_xyz, src_mask, src_n, init, nn_fn, *a, **k):
    return _scan(config, src_xyz, src_mask, src_n, init, nn_fn, *a, **k).replace(transform=init)
I._icp_scan = _unchanged
