"""Curved moving-wall solid-fluid coupling by nonequilibrium
reconstruction (counterpart of the JAX package's
`ops/coupling.py::solve_boundary`; reference
`solid_fluid_coupling.cu:25-252`).

For every non-OBSTACLE cell off the last row and column with an OBSTACLE
neighbour whose fraction ``t = phi_obs`` lies in (-eps, 1+eps]: a target
velocity (t u + u_obs)/(t + 1) averaged over the blocked directions, a
target density with the moving-wall momentum term, the 12-point velocity
gradient, and the pressure-tensor reconstruction of the populations.
"""

from __future__ import annotations

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.ops.stencil import _at, _axes
from jrl_lbm_torch.utils.types import CellType


def solve_boundary(
    vel,
    flags,
    f,
    phi_obs,
    obs_vel=None,
    tau: float = 1.0,
    axisymmetric_type: int = 0,
    dx: float = 1.0,
    dt: float = 1.0,
):
    """Apply the reconstruction; returns the updated ``f``. The JAX op's
    ``rho`` and ``is_convection`` arguments are not ported: the reference
    kernel reads neither."""
    axis_x, axis_y = _axes(axisymmetric_type)
    H, W = flags.shape
    dtype, dev = f.dtype, f.device
    c = dx / dt
    cs2 = c * c / 3.0
    eps = 1e-10

    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    obs_mask = is_obs.to(dtype)

    skip = is_obs.clone()
    skip[:, W - 1] = True
    skip[H - 1, :] = True
    col0 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    col0[:, 0] = True
    row0 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    row0[0, :] = True

    E = lattice.E
    REFL = lattice.REFLECT
    w_np = lattice.W

    def at(arr, sx, sy):
        return _at(arr, sx, sy, is_fluid, axis_x, axis_y)

    t = phi_obs
    t_ok = (t > -eps) & (t <= 1.0 + eps)

    valid = []
    vel_tgt_x = torch.zeros((H, W), dtype=dtype, device=dev)
    vel_tgt_y = torch.zeros((H, W), dtype=dtype, device=dev)
    rho_tgt = torch.sum(f, dim=0)
    count = torch.zeros((H, W), dtype=dtype, device=dev)

    for q in range(9):
        ex, ey = int(E[q, 0]), int(E[q, 1])
        nbr_obs = at(obs_mask, ex, ey) > 0.5
        v_q = nbr_obs & t_ok
        valid.append(v_q)
        vmask = v_q.to(dtype)
        count = count + vmask
        # guard: t == -1 exactly would give 0 * inf = NaN under the mask
        tq = torch.where(v_q, t, torch.zeros_like(t))

        ux = at(vel[0], -ex, -ey)
        uy = at(vel[1], -ex, -ey)
        if axis_x and q in lattice.AXIS_X_IN:
            ux = torch.where(col0, -ux, ux)
        if axis_y and q in lattice.AXIS_Y_IN:
            uy = torch.where(row0, -uy, uy)

        if obs_vel is not None:
            obs_ux = at(obs_vel[0], ex, ey)
            obs_uy = at(obs_vel[1], ex, ey)
            vel_tgt_x = vel_tgt_x + vmask * (tq * ux + obs_ux) / (tq + 1.0)
            vel_tgt_y = vel_tgt_y + vmask * (tq * uy + obs_uy) / (tq + 1.0)
            qi = int(REFL[q])
            rho_tgt = rho_tgt + vmask * 6.0 * float(w_np[q]) * (
                float(E[qi, 0]) * obs_ux + float(E[qi, 1]) * obs_uy
            )
        else:
            vel_tgt_x = vel_tgt_x + vmask * tq * ux / (tq + 1.0)
            vel_tgt_y = vel_tgt_y + vmask * tq * uy / (tq + 1.0)

    safe_count = torch.where(count > 0, count, torch.ones_like(count))
    u0 = vel_tgt_x / safe_count
    u1 = vel_tgt_y / safe_count

    # 12-point velocity-gradient stencil: no obstacle masking, no dx
    def grad12(a):
        gx = (
            4.0 * (at(a, 1, 0) - at(a, -1, 0))
            + (at(a, 1, 1) - at(a, -1, 1))
            + (at(a, 1, -1) - at(a, -1, -1))
        ) / 12.0
        gy = (
            4.0 * (at(a, 0, 1) - at(a, 0, -1))
            + (at(a, 1, 1) - at(a, 1, -1))
            + (at(a, -1, 1) - at(a, -1, -1))
        ) / 12.0
        return gx, gy

    g00, g01 = grad12(vel[0])
    g10, g11 = grad12(vel[1])

    out = list(f.unbind(0))
    for q in range(9):
        qi = int(REFL[q])
        e0, e1 = float(E[qi, 0]), float(E[qi, 1])
        pab = (u0 * u0 - cs2 * tau * (g00 + g00)) * (e0 * e0 - cs2)
        pab = pab + (u1 * u0 - cs2 * tau * (g10 + g01)) * (e1 * e0)
        pab = pab + (u0 * u1 - cs2 * tau * (g01 + g10)) * (e0 * e1)
        pab = pab + (u1 * u1 - cs2 * tau * (g11 + g11)) * (e1 * e1 - cs2)
        recon = float(w_np[qi]) * rho_tgt * (
            1.0 + (c / cs2) * (u0 * e0 + u1 * e1) + 0.5 * pab / (cs2 * cs2)
        )
        out[qi] = torch.where(valid[q] & ~skip, recon, out[qi])
    return torch.stack(out, dim=0)
