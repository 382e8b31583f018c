# A fault of the online odometry's frame loop: a spawn moves the keyframe's pose and index
# on, but its scan, normals and tile index are not replaced, so later frames register
# against the old keyframe's scan.

import icpx_torch.odometry.compiled as C

_register = C.OdometryStream._register
def _stale(self, *a, **k):
    kept = (self.kf_xyz, self.kf_mask, self.kf_n, self.kf_cache)
    out = _register(self, *a, **k)
    self.kf_xyz, self.kf_mask, self.kf_n, self.kf_cache = kept
    return out
C.OdometryStream._register = _stale
