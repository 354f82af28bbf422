"""Moments rho, u and C with OBSTACLE passthrough, the contact-angle
border extrapolation, the multiphase density remap and pressure, and the
vorticity (counterpart of the JAX package's `ops/macro.py`; reference
`LBM_macro_compute_2d.py:177-361`)."""

from __future__ import annotations

import math

import torch

from jrl_lbm_torch.utils.types import CellType


def contact_angle_correctness(rho, flags, contact_angle: float):
    """Ghost-density extrapolation on the domain border
    (`LBM_macro_compute_2d.py:237-271`): a ``rho_obs`` field that is zero
    except on the outermost ring (the adjacent interior line plus a
    tan(pi/2 - theta) slope term), substituted at every OBSTACLE cell, so
    interior obstacle cells read density 0. The reference's bottom-right
    corner averages ``rho_obs[-2, -2]`` with itself; kept."""
    tanv = math.tan(math.pi / 2.0 - float(contact_angle))
    rho_obs = torch.zeros_like(rho)

    hlp = torch.abs(rho[2:, 1] - rho[:-2, 1])
    rho_obs[1:-1, 0] = rho[1:-1, 2] + tanv * hlp
    hlp = torch.abs(rho[2:, -2] - rho[:-2, -2])
    rho_obs[1:-1, -1] = rho[1:-1, -3] + tanv * hlp
    hlp = torch.abs(rho[1, 2:] - rho[1, :-2])
    rho_obs[0, 1:-1] = rho[2, 1:-1] + tanv * hlp
    hlp = torch.abs(rho[-2, 2:] - rho[-2, :-2])
    rho_obs[-1, 1:-1] = rho[-3, 1:-1] + tanv * hlp

    rho_obs[0, 0] = 0.5 * (rho_obs[1, 0] + rho_obs[0, 1])
    rho_obs[-1, 0] = 0.5 * (rho_obs[-2, 0] + rho_obs[-1, 1])
    rho_obs[0, -1] = 0.5 * (rho_obs[0, -2] + rho_obs[1, -1])
    rho_obs[-1, -1] = 0.5 * (rho_obs[-2, -2] + rho_obs[-2, -2])

    return torch.where(flags == int(CellType.OBSTACLE), rho_obs, rho)


def macro_compute(f, rho, vel, flags, dx: float = 1.0, dt: float = 1.0,
                  contact_angle: float | None = None):
    """rho = sum_q f, u = sum_q f e_q c / rho; OBSTACLE cells keep the
    incoming rho and vel, or with ``contact_angle`` take the border
    extrapolation of :func:`contact_angle_correctness` as rho."""
    c = dx / dt
    is_obs = flags == int(CellType.OBSTACLE)

    macro_rho = torch.sum(f, dim=0)
    rho_new = torch.where(is_obs, rho, macro_rho)
    if contact_angle is not None:
        rho_new = contact_angle_correctness(rho_new, flags, contact_angle)

    mom_x = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    mom_y = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    safe_rho = torch.where(rho_new == 0, torch.ones_like(rho_new), rho_new)
    vel_new = torch.stack([mom_x, mom_y], dim=0) * (c / safe_rho)[None]
    vel_new = torch.where(is_obs[None], vel, vel_new)
    return rho_new, vel_new


def macro_compute_C(h, C, flags):
    """C = sum_q h with OBSTACLE passthrough."""
    macro_C = torch.sum(h, dim=0)
    return torch.where(flags == int(CellType.OBSTACLE), C, macro_C)


def density_remap(rho, density_liquid: float, density_gas: float, rho_liquid: float,
                  rho_gas: float):
    """Multiphase density remap (`LBM_macro_compute_2d.py:338-345`)."""
    return density_gas + (density_liquid - density_gas) * (
        (rho - rho_gas) / (rho_liquid - rho_gas)
    )


def get_pressure(density, dx: float = 1.0, dt: float = 1.0):
    """Carnahan-Starling-style pressure (`LBM_macro_compute_2d.py:177-195`)."""
    c = dx / dt
    RT = c * c / 3.0
    a = 12.0 * RT
    td = 4.0 * density / 4.0
    one_m = 1.0 - td
    return (density * RT * td * (4.0 - 2.0 * td) / (one_m * one_m * one_m)
            - a * density * density + density * RT)


def get_vort(vel, dx: float = 1.0):
    """Central-difference vorticity ``[H, W]``, the border padded with the
    edge values (`LBM_macro_compute_2d.py:353-361`)."""
    vort = (
        (vel[0, 2:, 1:-1] - vel[0, :-2, 1:-1])
        - (vel[1, 1:-1, 2:] - vel[1, 1:-1, :-2])
    ) / (2.0 * dx)
    return torch.nn.functional.pad(vort[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
