"""Signed-distance combinator, the cylinder and the four JRL tip SDFs
(counterpart of the JAX package's `utils/sdf.py`).

Box centres may be 0-d float32 tensors (the tip position ``walks`` is
one): PyTorch then does the scalar arithmetic in float32, as JAX does
with its 0-d arrays, so the tip lands on the same rows in both.
"""

from __future__ import annotations

import math

import torch


def union_phi_obs(phi1: torch.Tensor, phi2: torch.Tensor, alpha: float = 0.0):
    """Smooth/boolean union of two SDFs (`functions.py:4-16`)."""
    if alpha < 0.0 or alpha > 1.0:
        raise ValueError("alpha should be in the range [0,1].")
    if alpha == 1.0:
        return torch.minimum(phi1, phi2)
    return (
        1.0
        / (1.0 + alpha)
        * (phi1 + phi2 - torch.sqrt(phi1 * phi1 + phi2 * phi2 - 2 * alpha * phi1 * phi2))
    )


def cylinder_phi(mesh_grid, center, radius: float):
    """Signed distance to a circle (`demo_2d_LBM_cylinder.py:26-40`)."""
    x = mesh_grid[0]
    y = mesh_grid[1]
    cx, cy = center[0], center[1]
    dx, dy = x - cx, y - cy
    d2 = dx * dx + dy * dy - radius * radius
    # the root through float64: PyTorch's float32 sqrt on the CPU is not
    # always correctly rounded, and the result must equal JAX's
    s = torch.sqrt(torch.abs(d2).double()).to(d2.dtype)
    return torch.where(d2 > 0, s, -s)


def jrl_tip_flat(mesh_grid, box_center, box_radius: float, res_y: int | None = None):
    """Flat tip: box-corner max SDF plus the top wall."""
    if res_y is None:
        res_y = mesh_grid.shape[-2]
    tx = (mesh_grid[0] - box_center[0]) - box_radius
    ty = (mesh_grid[1] - box_center[1]) - box_radius
    phi = torch.maximum(tx, ty)
    ty_top = -(mesh_grid[1] - res_y)
    return union_phi_obs(phi, ty_top, alpha=1.0)


def jrl_tip_45degree(mesh_grid, box_center, box_radius: float,
                     with_top: bool = True, res_y: int | None = None):
    """45-degree wedge tip."""
    if res_y is None:
        res_y = mesh_grid.shape[-2]
    x = mesh_grid[0]
    y = mesh_grid[1]
    phi = (y - box_center[1]) - box_radius
    x1 = box_center[0] + box_radius
    y1 = box_center[1] + box_radius
    align = (x + y - (x1 + y1)) / math.sqrt(2.0)
    phi = torch.maximum(phi, align)
    if with_top:
        phi = union_phi_obs(phi, -(y - res_y), alpha=1.0)
    return phi


def jrl_tip_flat_forC(mesh_grid, box_center, box_radius: float,
                      is_negative: bool, res_y: int | None = None):
    """Flat tip for the concentration phase."""
    if res_y is None:
        res_y = mesh_grid.shape[-2]
    tx = (mesh_grid[0] - box_center[0]) - box_radius
    ty = (mesh_grid[1] - box_center[1]) - box_radius
    phi = torch.maximum(tx, ty)
    if is_negative:
        phi = union_phi_obs(phi, -(mesh_grid[1] - res_y), alpha=1.0)
    return phi


def jrl_tip_45degree_forC(mesh_grid, box_center, box_radius: float,
                          is_negative: bool, res_y: int | None = None):
    """45-degree tip for the concentration phase."""
    return jrl_tip_45degree(mesh_grid, box_center, box_radius,
                            with_top=is_negative, res_y=res_y)
