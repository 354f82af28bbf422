"""Second-order D2Q9 equilibrium with the Guo half-force shift, and the
multiphase pressure equilibrium and equation of state (counterpart of
the JAX package's `ops/equilibrium.py`; reference
`LBM_collision_2d.py:217-306`)."""

from __future__ import annotations

import torch

from jrl_lbm_torch import lattice


def feq(
    rho: torch.Tensor,
    vel: torch.Tensor,
    dx: float = 1.0,
    dt: float = 1.0,
    force: torch.Tensor | None = None,
) -> torch.Tensor:
    """Equilibrium ``[Q, H, W]`` of ``rho`` ``[H, W]`` and ``vel``
    ``[2, H, W]``; ``force`` shifts the velocity by ``F/(2 rho)`` except
    where ``rho <= 1e-10``."""
    c = dx / dt
    cs2 = c * c / 3.0
    if force is not None:
        eps = 1e-10
        shift = torch.where(rho[None] <= eps, torch.zeros_like(vel), 0.5 * force / rho[None])
        vel = vel + shift

    e, w = lattice.tables(rho.device, rho.dtype)
    eu = c * (e[:, 0, None, None] * vel[0][None] + e[:, 1, None, None] * vel[1][None])
    uv = vel[0] * vel[0] + vel[1] * vel[1]

    rho_w = rho[None] * w[:, None, None]
    out = rho_w * (1.0 + eu / cs2)
    out = out + rho_w * (0.5 * eu * eu / (cs2 * cs2) - 0.5 * uv[None] / cs2)
    return out


def geq(rho, density, vel, pressure, force=None, feq_=None, dx: float = 1.0,
        dt: float = 1.0) -> torch.Tensor:
    """Multiphase pressure equilibrium ``w (p - cs2 density) + cs2 density
    / rho * feq`` (`LBM_collision_2d.py:288-306`; exported by the reference,
    unused by its demos)."""
    c = dx / dt
    cs2 = c * c / 3.0
    if feq_ is None:
        feq_ = feq(rho, vel, dx=dx, dt=dt, force=force)
    _, w = lattice.tables(rho.device, rho.dtype)
    return w[:, None, None] * (pressure - cs2 * density)[None] + (cs2 * density / rho)[None] * feq_


def equation_of_states(rho, dx: float = 1.0, dt: float = 1.0) -> torch.Tensor:
    """Carnahan-Starling-style equation of state
    (`LBM_collision_2d.py:217-234`)."""
    c = dx / dt
    RT = c * c / 3.0
    a = 12.0 * RT
    tr = 4.0 * rho / 4.0
    one_m = 1.0 - tr
    return rho * RT * (4.0 * tr - 2.0 * tr * tr) / (one_m * one_m * one_m) + rho * RT - a * rho * rho
