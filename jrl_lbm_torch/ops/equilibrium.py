"""Second-order D2Q9 equilibrium with the Guo half-force shift
(counterpart of the JAX package's `ops/equilibrium.py::feq`; reference
`LBM_collision_2d.py:236-263`)."""

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
