"""Pull-streaming with the flag boundary rules (counterpart of the JAX
package's `ops/stream.py::propagate`; reference `propagation.cu:22-488`).

* FLUID cells wrap periodically; other cells use the reflect-clamp
  (``x-1 < 0 -> 1``, ``x+1 >= W -> W-2``);
* on the symmetry axis the pull collapses onto the axis and the
  incoming channel is mirrored;
* OBSTACLE cells store the reflected incoming populations;
* populations from an OBSTACLE neighbour use half-way bounce-back, or
  sub-grid interpolation when ``phi_obs`` is given;
* INFLOW cells get ``feq(rho_in, u_in)``, INFLOW_2 cells ``feq(1, u)``;
* OUTFLOW cells copy all nine populations of the inward neighbour in a
  second pass over the finished field (rows first, then columns), not
  from values another thread of the same pass may still be writing (the
  reference's race, SURVEY §5).
"""

from __future__ import annotations

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.utils.types import AxiSymmetricType, CellType


def _pull_x(arr, ex: int, fluid: bool, axis_x: bool):
    """Value at x pulled from x - ex (last axis)."""
    if ex == 0:
        return arr
    a = torch.roll(arr, ex, dims=-1)
    if ex == 1:
        if axis_x:
            a[..., 0] = arr[..., 0]
        elif not fluid:
            a[..., 0] = arr[..., 1]
        return a
    if not fluid:
        a[..., -1] = arr[..., -2]
    return a


def _pull_y(arr, ey: int, fluid: bool, axis_y: bool):
    """Value at y pulled from y - ey (second-to-last axis)."""
    if ey == 0:
        return arr
    a = torch.roll(arr, ey, dims=-2)
    if ey == 1:
        if axis_y:
            a[..., 0, :] = arr[..., 0, :]
        elif not fluid:
            a[..., 0, :] = arr[..., 1, :]
        return a
    if not fluid:
        a[..., -1, :] = arr[..., -2, :]
    return a


def _pull(arr, ex, ey, fluid, axis_x, axis_y):
    return _pull_y(_pull_x(arr, ex, fluid, axis_x), ey, fluid, axis_y)


def _pull_both(arr, ex, ey, is_fluid, axis_x, axis_y):
    """Per-cell choice between the FLUID (wrap) and non-FLUID pulls."""
    f_val = _pull(arr, ex, ey, True, axis_x, axis_y)
    s_val = _pull(arr, ex, ey, False, axis_x, axis_y)
    return torch.where(is_fluid, f_val, s_val)


def propagate(
    f: torch.Tensor,
    flags: torch.Tensor,
    phi_obs: torch.Tensor | None = None,
    rho: torch.Tensor | None = None,
    vel: torch.Tensor | None = None,
    inflow_vel=None,
    inflow_density: float | None = None,
    axisymmetric_type: int = 0,
    dx: float = 1.0,
    dt: float = 1.0,
):
    """Stream ``f`` one step; returns ``(rho, vel, f_new)``.

    ``rho``/``vel`` pass through except at INFLOW/INFLOW_2 cells; callers
    that supplied none get ``None`` back. INFLOW cells take
    ``feq(rho_in, inflow_vel)`` and, when ``vel`` is given, their ``vel``
    is set to ``inflow_vel`` (a 2-vector, the channel inlet); without
    ``inflow_vel`` they take the local velocity. INFLOW_2 cells always take
    the local velocity. (The JAX op's ``is_convection`` argument is dead
    code there and is not ported.)
    """
    axis_x = int(axisymmetric_type) == int(AxiSymmetricType.LINE_X_EQ_0)
    axis_y = int(axisymmetric_type) == int(AxiSymmetricType.LINE_Y_EQ_0)
    H, W = flags.shape
    dtype, dev = f.dtype, f.device

    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    obs_mask = is_obs.to(dtype)
    col0 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    col0[:, 0] = True
    row0 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    row0[0, :] = True

    REFL = lattice.REFLECT
    MX = lattice.MIRROR_X
    MY = lattice.MIRROR_Y

    raw_in = [f[0]] + [None] * 8
    streamed = [f[0]] + [None] * 8
    for q in range(1, 9):
        ex, ey = int(lattice.E[q, 0]), int(lattice.E[q, 1])

        val = _pull_both(f[q], ex, ey, is_fluid, axis_x, axis_y)
        if axis_x and q in lattice.AXIS_X_IN:
            val_m = _pull_both(f[int(MX[q])], ex, ey, is_fluid, axis_x, axis_y)
            val = torch.where(col0, val_m, val)
        if axis_y and q in lattice.AXIS_Y_IN:
            val_m = _pull_both(f[int(MY[q])], ex, ey, is_fluid, axis_x, axis_y)
            val = torch.where(row0, val_m, val)
        raw_in[q] = val

        nbr_obs = _pull_both(obs_mask, ex, ey, is_fluid, axis_x, axis_y) > 0.5

        f_this = f[int(REFL[q])]
        if phi_obs is None:
            v_obs = f_this
        else:
            f_prev = val
            nxt = _pull_both(f[int(REFL[q])], -ex, -ey, is_fluid, axis_x, axis_y)
            if axis_x and q in lattice.AXIS_X_OUT:
                oq = int(MX[q])
                nxt_m = _pull_both(f[int(REFL[oq])], -ex, -ey, is_fluid, axis_x, axis_y)
                nxt = torch.where(col0, nxt_m, nxt)
            if axis_y and q in lattice.AXIS_Y_OUT:
                oq = int(MY[q])
                nxt_m = _pull_both(f[int(REFL[oq])], -ex, -ey, is_fluid, axis_x, axis_y)
                nxt = torch.where(row0, nxt_m, nxt)

            t = phi_obs
            t1 = 2.0 * t - 1.0
            v1 = t1 * f_prev + (1.0 - t1) * f_this
            t2 = 2.0 * t
            v2 = t2 * f_this + (1.0 - t2) * nxt
            v_obs = torch.where(
                (t >= 0.5) & (t <= 1.0),
                v1,
                torch.where((t >= 0.0) & (t <= 0.5), v2, f_this),
            )
        streamed[q] = torch.where(nbr_obs, v_obs, val)

    out = [f[0]]
    for p in range(1, 9):
        out.append(torch.where(is_obs, raw_in[int(REFL[p])], streamed[p]))
    f_new = torch.stack(out, dim=0)

    # INFLOW: f = feq(rho_in, u), rho overwritten when inflow_density is set
    has_inflow_density = inflow_density is not None and inflow_density >= 0
    rho_out, vel_out = rho, vel
    in_mask = flags == int(CellType.INFLOW)
    if has_inflow_density:
        rho_in = torch.full((H, W), float(inflow_density), dtype=dtype, device=dev)
    elif rho is not None:
        rho_in = rho
    else:
        rho_in = torch.zeros((H, W), dtype=dtype, device=dev)
    u_loc = vel if vel is not None else torch.zeros((2, H, W), dtype=dtype, device=dev)
    if inflow_vel is not None:
        u_in = torch.as_tensor(inflow_vel, dtype=dtype, device=dev)[:, None, None].expand(2, H, W)
    else:
        u_in = u_loc
    f_new = torch.where(in_mask[None], feq(rho_in, u_in, dx=dx, dt=dt), f_new)
    if rho is not None and has_inflow_density:
        rho_out = torch.where(in_mask, rho_in, rho_out)
    if vel is not None and inflow_vel is not None:
        vel_out = torch.where(in_mask[None], u_in, vel_out)

    # INFLOW_2: rho = 1 Dirichlet equilibrium with the local velocity
    in2_mask = flags == int(CellType.INFLOW_2)
    feq_in2 = feq(torch.ones((H, W), dtype=dtype, device=dev), u_loc, dx=dx, dt=dt)
    f_new = torch.where(in2_mask[None], feq_in2, f_new)
    if rho is not None:
        rho_out = torch.where(in2_mask, torch.ones((), dtype=dtype, device=dev), rho_out)

    # OUTFLOW: copy all 9 populations from the adjacent interior cell
    of_mask = flags == int(CellType.OUTFLOW)
    g = f_new.clone()
    g[:, 0, :] = g[:, 1, :]
    g[:, -1, :] = g[:, -2, :]
    g[:, :, 0] = g[:, :, 1]
    g[:, :, -1] = g[:, :, -2]
    f_new = torch.where(of_mask[None], g, f_new)
    return rho_out, vel_out, f_new


def rebounce_obstacle(f, flags):
    """Full bounce-back on OBSTACLE cells by channel permutation
    (`LBM_propagation_2d.py:181-186`)."""
    inverted = f[torch.as_tensor(lattice.REFLECT, dtype=torch.long, device=f.device)]
    return torch.where((flags == int(CellType.OBSTACLE))[None], inverted, f)
