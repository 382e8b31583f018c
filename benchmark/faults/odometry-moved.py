# A fault of the online odometry's frame loop: every frame's measurement moved by 5 cm
# where the stream produces it.

import dataclasses
import icpx_torch.odometry.compiled as C
from icpx_torch.geometry.se3 import SE3

_register = C.OdometryStream._register
def _moved(self, *a, **k):
    out = _register(self, *a, **k)
    return dataclasses.replace(out, rel=SE3(R=out.rel.R, t=out.rel.t + 0.05))
C.OdometryStream._register = _moved
