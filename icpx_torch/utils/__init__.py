from icpx_torch.utils.checkpoint import OdometryCheckpoint

__all__ = ["OdometryCheckpoint"]
