"""Moments rho, u and C with OBSTACLE passthrough (counterpart of the JAX
package's `ops/macro.py`; reference `LBM_macro_compute_2d.py:273-336`)."""

from __future__ import annotations

import torch

from jrl_lbm_torch.utils.types import CellType


def macro_compute(f, rho, vel, flags, dx: float = 1.0, dt: float = 1.0):
    """rho = sum_q f, u = sum_q f e_q c / rho; OBSTACLE cells keep the
    incoming rho and vel."""
    c = dx / dt
    is_obs = flags == int(CellType.OBSTACLE)

    macro_rho = torch.sum(f, dim=0)
    rho_new = torch.where(is_obs, rho, macro_rho)

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
