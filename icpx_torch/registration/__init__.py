from icpx_torch.registration.horn import horn_align, umeyama_align
from icpx_torch.registration.icp import (
    ICPConfig,
    ICPResult,
    format_trace,
    register,
    register_batch,
    register_batch_block,
    register_xyz,
)
from icpx_torch.registration.linearize import (
    build_normal_equations_gicp,
    build_normal_equations_p2plane,
    build_normal_equations_symmetric,
)
from icpx_torch.registration.ndt import ndt_cells, register_ndt
from icpx_torch.registration.pyramid import PyramidConfig, register_pyramid
from icpx_torch.registration.solve import (
    reconstruct_symmetric_transform,
    solve_damped_6x6,
)

__all__ = [
    "ndt_cells",
    "register_ndt",
    "horn_align",
    "umeyama_align",
    "PyramidConfig",
    "register_pyramid",
    "ICPConfig",
    "ICPResult",
    "register",
    "register_xyz",
    "register_batch",
    "register_batch_block",
    "format_trace",
    "build_normal_equations_symmetric",
    "build_normal_equations_p2plane",
    "build_normal_equations_gicp",
    "reconstruct_symmetric_transform",
    "solve_damped_6x6",
]
