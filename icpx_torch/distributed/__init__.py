from icpx_torch.distributed.fault import degenerate_solve_guard

__all__ = ["degenerate_solve_guard"]
