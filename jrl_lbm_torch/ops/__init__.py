"""Plain PyTorch operator layer over batch-free ``[Q, H, W]`` states (the
names of `jrl_lbm_tpu/ops/__init__.py`)."""

from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.ops.stream import propagate, rebounce_obstacle
from jrl_lbm_torch.ops.macro import macro_compute, macro_compute_C, get_vort
from jrl_lbm_torch.ops.collide import (
    axisymmetric_source,
    bgk_collide,
    kbc_collide,
    mrt_collide,
    mrt_matrices,
)
from jrl_lbm_torch.ops.stencil import get_div, get_grad, get_laplacian
from jrl_lbm_torch.ops.coupling import solve_boundary

__all__ = [
    "feq",
    "propagate",
    "rebounce_obstacle",
    "macro_compute",
    "macro_compute_C",
    "get_vort",
    "axisymmetric_source",
    "bgk_collide",
    "kbc_collide",
    "mrt_collide",
    "mrt_matrices",
    "get_div",
    "get_grad",
    "get_laplacian",
    "solve_boundary",
]
