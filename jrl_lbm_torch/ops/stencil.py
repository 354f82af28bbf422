"""Obstacle-aware isotropic grad and div (counterpart of the JAX
package's `ops/stencil.py`; reference `collision_2d.cu:22-220`).

FLUID cells wrap periodically; other cells clamp with ``max(0, i-1)`` /
``min(n-1, i+1)`` (not the streaming reflect-clamp); on the symmetry
axis the negative neighbour collapses onto the axis.
"""

from __future__ import annotations

import torch

from jrl_lbm_torch.utils.types import AxiSymmetricType, CellType


def _shift_x(arr, sx: int, fluid: bool, axis_x: bool):
    """Value at x taken from x + sx."""
    if sx == 0:
        return arr
    a = torch.roll(arr, -sx, dims=-1)
    if sx == -1:
        if axis_x or not fluid:
            a[..., 0] = arr[..., 0]
        return a
    if not fluid:
        a[..., -1] = arr[..., -1]
    return a


def _shift_y(arr, sy: int, fluid: bool, axis_y: bool):
    if sy == 0:
        return arr
    a = torch.roll(arr, -sy, dims=-2)
    if sy == -1:
        if axis_y or not fluid:
            a[..., 0, :] = arr[..., 0, :]
        return a
    if not fluid:
        a[..., -1, :] = arr[..., -1, :]
    return a


def _at(arr, sx, sy, is_fluid, axis_x, axis_y):
    """Per-cell value from offset (sx, sy) with the flag-chosen clamp."""
    f_val = _shift_y(_shift_x(arr, sx, True, axis_x), sy, True, axis_y)
    s_val = _shift_y(_shift_x(arr, sx, False, axis_x), sy, False, axis_y)
    return torch.where(is_fluid, f_val, s_val)


def _axes(axisymmetric_type):
    ax = int(axisymmetric_type)
    return ax == int(AxiSymmetricType.LINE_X_EQ_0), ax == int(AxiSymmetricType.LINE_Y_EQ_0)


def get_grad(rho, flags, dx: float = 1.0, axisymmetric_type: int = 0):
    """Gradient ``[2, H, W]``: a direction pair contributes only if
    neither member is an OBSTACLE, and one blocked pair zeroes the whole
    component; zero at OBSTACLE cells."""
    axis_x, axis_y = _axes(axisymmetric_type)
    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    obs = is_obs.to(rho.dtype)

    def val(sx, sy):
        return _at(rho, sx, sy, is_fluid, axis_x, axis_y)

    def nbr_obs(sx, sy):
        return _at(obs, sx, sy, is_fluid, axis_x, axis_y) > 0.5

    gx = torch.zeros_like(rho)
    p1 = nbr_obs(1, 0) | nbr_obs(-1, 0)
    gx = gx + torch.where(p1, 0.0, 4.0 * (val(1, 0) - val(-1, 0)))
    p2 = nbr_obs(1, 1) | nbr_obs(-1, 1)
    gx = gx + torch.where(p2, 0.0, val(1, 1) - val(-1, 1))
    p3 = nbr_obs(-1, -1) | nbr_obs(1, -1)
    gx = gx + torch.where(p3, 0.0, val(1, -1) - val(-1, -1))
    gx = torch.where(p1 | p2 | p3, 0.0, gx)

    gy = torch.zeros_like(rho)
    p1 = nbr_obs(0, 1) | nbr_obs(0, -1)
    gy = gy + torch.where(p1, 0.0, 4.0 * (val(0, 1) - val(0, -1)))
    p2 = nbr_obs(1, 1) | nbr_obs(1, -1)
    gy = gy + torch.where(p2, 0.0, val(1, 1) - val(1, -1))
    p3 = nbr_obs(-1, 1) | nbr_obs(-1, -1)
    gy = gy + torch.where(p3, 0.0, val(-1, 1) - val(-1, -1))
    gy = torch.where(p1 | p2 | p3, 0.0, gy)

    grad = torch.stack([gx, gy], dim=0) / (12.0 * dx)
    return torch.where(is_obs[None], 0.0, grad)


def get_div(vel, flags, dx: float = 1.0, axisymmetric_type: int = 0):
    """Divergence ``[H, W]`` of ``[2, H, W]``; zero at OBSTACLE cells,
    no neighbour masking (as the reference)."""
    axis_x, axis_y = _axes(axisymmetric_type)
    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    u, v = vel[0], vel[1]

    def at(arr, sx, sy):
        return _at(arr, sx, sy, is_fluid, axis_x, axis_y)

    div = 4.0 * (at(u, 1, 0) - at(u, -1, 0))
    div = div + at(u, 1, 1) - at(u, -1, 1)
    div = div + at(u, 1, -1) - at(u, -1, -1)
    div = div + 4.0 * (at(v, 0, 1) - at(v, 0, -1))
    div = div + at(v, 1, 1) - at(v, 1, -1)
    div = div + at(v, -1, 1) - at(v, -1, -1)
    div = div / (12.0 * dx)
    return torch.where(is_obs, 0.0, div)


def get_laplacian(x, dx: float = 1.0):
    """9-point isotropic laplacian, zero on the border; divides by 5 as
    the reference does (`LBM_collision_2d.py:314-341`, a kept quirk)."""
    lap = (
        4.0 * (x[..., 1:-1, 2:] + x[..., 1:-1, :-2] + x[..., 2:, 1:-1] + x[..., :-2, 1:-1])
        + (x[..., 2:, 2:] + x[..., 2:, :-2] + x[..., :-2, 2:] + x[..., :-2, :-2])
        - 20.0 * x[..., 1:-1, 1:-1]
    ) / (5.0 * dx * dx)
    return torch.nn.functional.pad(lap, (1, 1, 1, 1))
