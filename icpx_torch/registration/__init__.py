from icpx_torch.registration.icp import ICPConfig, ICPResult, format_trace, register
from icpx_torch.registration.linearize import (
    build_normal_equations_gicp,
    build_normal_equations_p2plane,
    build_normal_equations_symmetric,
)
from icpx_torch.registration.solve import (
    reconstruct_symmetric_transform,
    solve_damped_6x6,
)

__all__ = [
    "ICPConfig",
    "ICPResult",
    "register",
    "format_trace",
    "build_normal_equations_symmetric",
    "build_normal_equations_p2plane",
    "build_normal_equations_gicp",
    "reconstruct_symmetric_transform",
    "solve_damped_6x6",
]
