"""Meshgrid and staggered (MAC) resampling, batch-free ``[C, H, W]``
(counterpart of the JAX package's `utils/grid.py`)."""

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


def _pad_replicate(a: torch.Tensor, axis: int) -> torch.Tensor:
    if axis == -1:
        return torch.cat([a[..., :1], a, a[..., -1:]], dim=-1)
    return torch.cat([a[..., :1, :], a, a[..., -1:, :]], dim=-2)


def get_staggered_x(a: torch.Tensor) -> torch.Tensor:
    """Centre -> x-face resampling, edge-replicated to ``W + 1``."""
    return _pad_replicate(0.5 * (a[..., 1:] + a[..., :-1]), axis=-1)


def get_staggered_y(a: torch.Tensor) -> torch.Tensor:
    """Centre -> y-face resampling, edge-replicated to ``H + 1``."""
    return _pad_replicate(0.5 * (a[..., 1:, :] + a[..., :-1, :]), axis=-2)


def get_staggered(vel: torch.Tensor) -> List[torch.Tensor]:
    """Staggered components of a ``[2, H, W]`` velocity."""
    return [get_staggered_x(vel[0]), get_staggered_y(vel[1])]
