"""BGK collision with the axisymmetric source terms (counterpart of the
JAX package's `ops/collide.py::axisymmetric_source`, `bgk_collide`;
reference `LBM_collision_2d.py:343-555`). MRT and KBC are not on the JRL
path and are not ported yet.

Reference quirk kept: the convection-rate `elif` repeats LINE_X_EQ_0
where LINE_Y_EQ_0 was meant, so LINE_Y_EQ_0 convection gets no extra
relaxation-rate term.
"""

from __future__ import annotations

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.ops.stencil import get_div, get_grad
from jrl_lbm_torch.utils.types import AxiSymmetricType, CellType


def axisymmetric_source(
    rho,
    vel,
    flags,
    feq_,
    mesh_grid,
    tau: float,
    axisymmetric_type: int,
    is_convection: bool = False,
    dx: float = 1.0,
    dt: float = 1.0,
):
    """Gi source ``[Q, H, W]`` (scalar 0 when not axisymmetric).
    ``mesh_grid`` holds cell-centre coordinates (x, y), already +0.5."""
    c = dx / dt
    cs2 = c * c / 3.0
    e, w = lattice.tables(rho.device, rho.dtype)
    ax = int(axisymmetric_type)

    def grad_fn(a):
        return get_grad(a, flags, dx=dx, axisymmetric_type=ax)

    def div_fn(a):
        return get_div(a, flags, dx=dx, axisymmetric_type=ax)

    if ax == int(AxiSymmetricType.LINE_X_EQ_0):
        r = mesh_grid[0]
        er = e[:, 0][:, None, None]
        ur = vel[0]
        A1 = -rho * ur / r
        if is_convection:
            # Liu et al. 2017 advection-diffusion source; feq carries the weight
            s = (1.0 - 0.5 / tau) * er / r[None]
            return -(ur / r)[None] * feq_ * (1.0 - 0.5 / tau - 0.5 * s)

        visc = cs2 * (tau - 0.5)
        mu = visc * rho
        pressure = rho * cs2
        grad_u = grad_fn(vel[0])
        grad_v = grad_fn(vel[1])

        A2 = grad_fn(pressure)[0]
        A2 = A2 + div_fn(rho[None] * ur[None] * vel)
        A2 = A2 * (dt / (2.0 * r))

        F2 = (mu / r)[None] * torch.stack([grad_u[0] - ur / r, grad_v[0]], dim=0)
        F2 = F2 + vel * A1[None]
        F2 = F2 - dt * (tau - 1.0) * cs2 * grad_fn(A1)
        F2e = e[:, 0][:, None, None] * F2[0][None] + e[:, 1][:, None, None] * F2[1][None]
        G = A1[None] + A2[None] + F2e / cs2
        return G * w[:, None, None]

    if ax == int(AxiSymmetricType.LINE_Y_EQ_0):
        r = mesh_grid[1] - 0.5 * dx
        r = r.clone()
        r[0, :] = 1.0
        ur = vel[1]
        A1 = -rho * ur / r
        if is_convection:
            G = A1[None] * torch.ones((9, 1, 1), dtype=rho.dtype, device=rho.device)
        else:
            visc = cs2 * (tau - 0.5)
            mu = visc * rho
            grad_u = grad_fn(vel[0])
            grad_v = grad_fn(vel[1])
            H1 = mu * (grad_u[1] + grad_v[0]) / r - rho * vel[0] * vel[1] / r
            H2 = (
                mu * (grad_v[1] * 2.0) / r
                - 2.0 * mu * vel[1] / (r * r)
                - rho * vel[1] * vel[1] / r
            )
            G = A1[None] + (
                e[:, 0][:, None, None] * H1[None] + e[:, 1][:, None, None] * H2[None]
            ) / cs2
        return G * w[:, None, None]

    return 0.0


def bgk_collide(
    f,
    rho,
    vel,
    flags,
    tau: float,
    force=None,
    mesh_grid=None,
    is_convection: bool = False,
    axisymmetric_type: int = 0,
    dx: float = 1.0,
    dt: float = 1.0,
):
    """BGK relaxation ``f + w (feq - f) + dt Gi`` with OBSTACLE
    passthrough; ``tau`` is the relaxation time of the lattice collided
    (tau_D for the advection-diffusion lattice)."""
    ax = int(axisymmetric_type)
    feq_ = feq(rho, vel, dx=dx, dt=dt, force=force)

    if is_convection and ax == int(AxiSymmetricType.LINE_X_EQ_0):
        # per-direction rate 1/tau + dt (1 - 0.5/tau) e_r / r
        e, _ = lattice.tables(f.device, f.dtype)
        r = mesh_grid[0]
        s = dt * (1.0 - 0.5 / tau) * e[:, 0][:, None, None] / r[None]
        w_rate = 1.0 / tau + s
    else:
        w_rate = 1.0 / tau

    Gi = axisymmetric_source(
        rho, vel, flags, feq_, mesh_grid, tau, ax,
        is_convection=is_convection, dx=dx, dt=dt,
    )
    collided = f + w_rate * (feq_ - f) + dt * Gi
    return torch.where((flags == int(CellType.OBSTACLE))[None], f, collided)
