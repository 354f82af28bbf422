"""Meshgrids, staggered (MAC) resampling, droplet seeding and channel dot
products, batch-free ``[C, H, W]`` (counterpart of the JAX package's
`utils/grid.py`)."""

from __future__ import annotations

from typing import List, Sequence

import torch


def create_2d_meshgrid(
    shape: Sequence[int], dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Cell-index meshgrid ``[2, H, W]``; channel 0 = x, channel 1 = y."""
    H, W = shape[-2], shape[-1]
    y = torch.arange(H, dtype=dtype, device=device)
    x = torch.arange(W, dtype=dtype, device=device)
    ypos, xpos = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xpos, ypos], dim=0)


def create_3d_meshgrid(
    shape: Sequence[int], dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Cell-index meshgrid ``[3, D, H, W]``; channels x, y, z."""
    D, H, W = shape[-3], shape[-2], shape[-1]
    z = torch.arange(D, dtype=dtype, device=device)
    y = torch.arange(H, dtype=dtype, device=device)
    x = torch.arange(W, dtype=dtype, device=device)
    zpos, ypos, xpos = torch.meshgrid(z, y, x, indexing="ij")
    return torch.stack([xpos, ypos, zpos], dim=0)


def _pad_replicate(a: torch.Tensor, axis: int) -> torch.Tensor:
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 0, 1), a, a.narrow(axis, n - 1, 1)], dim=axis)


def get_staggered_x(a: torch.Tensor) -> torch.Tensor:
    """Centre -> x-face resampling, edge-replicated to ``W + 1``."""
    return _pad_replicate(0.5 * (a[..., 1:] + a[..., :-1]), axis=-1)


def get_staggered_y(a: torch.Tensor) -> torch.Tensor:
    """Centre -> y-face resampling, edge-replicated to ``H + 1``."""
    return _pad_replicate(0.5 * (a[..., 1:, :] + a[..., :-1, :]), axis=-2)


def get_staggered_z(a: torch.Tensor) -> torch.Tensor:
    """Centre -> z-face resampling of a 3D field, edge-replicated to ``D + 1``."""
    return _pad_replicate(0.5 * (a[..., 1:, :, :] + a[..., :-1, :, :]), axis=-3)


def get_staggered(vel: torch.Tensor) -> List[torch.Tensor]:
    """Staggered components of a ``[2, H, W]`` velocity."""
    return [get_staggered_x(vel[0]), get_staggered_y(vel[1])]


def create_droplet_2d(
    droplet_center, droplet_radius: float, rho_liquid: float, rho: torch.Tensor
) -> torch.Tensor:
    """``rho`` with ``rho_liquid`` inside the circle of ``droplet_radius``
    cells around ``droplet_center`` (x, y)."""
    mg = create_2d_meshgrid(rho.shape, dtype=rho.dtype, device=rho.device)
    center = torch.as_tensor(droplet_center, dtype=rho.dtype, device=rho.device)[:, None, None]
    dist = torch.linalg.vector_norm(mg - center, dim=0)
    return torch.where(dist < droplet_radius, torch.as_tensor(rho_liquid, dtype=rho.dtype), rho)


def dot(dim: int, x: torch.Tensor, y: torch.Tensor, keep_dim: bool = False) -> torch.Tensor:
    """Channel dot product of two ``[..., dim, *res]`` fields of ``dim``
    spatial axes."""
    axis = -(dim + 1)
    out = torch.sum(x * y, dim=axis)
    return out.unsqueeze(axis) if keep_dim else out


def dot_e_vel(e, vel: torch.Tensor) -> torch.Tensor:
    """``e_q . u`` for each direction: e ``[Q, dim]``, vel ``[dim, *res]``
    -> ``[Q, *res]``."""
    e = torch.as_tensor(e, dtype=vel.dtype, device=vel.device)
    shape = (-1,) + (1,) * (vel.ndim - 1)
    out = e[:, 0].reshape(shape) * vel[0][None]
    for d in range(1, vel.shape[0]):
        out = out + e[:, d].reshape(shape) * vel[d][None]
    return out


def dot_vel_vel(vel1: torch.Tensor, vel2: torch.Tensor, keep_dim: bool = False) -> torch.Tensor:
    """``u . v`` over the leading channel axis (the JAX package's form, not
    the reference's 3D indexing, SURVEY §5.6)."""
    out = torch.sum(vel1 * vel2, dim=0)
    return out[None] if keep_dim else out
