"""D2Q9 lattice constants (copy of the JAX package's `lattice.py` tables).

``E[q] = (ex, ey)`` where ``x`` indexes the last axis and ``y`` the
second-to-last; the tables are the standard D2Q9 definitions of the
reference (`propagation.cu:49-64`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Q = 9
DIM = 2

E = np.array(
    [
        [0, 0],
        [1, 0],
        [0, 1],
        [-1, 0],
        [0, -1],
        [1, 1],
        [-1, 1],
        [-1, -1],
        [1, -1],
    ],
    dtype=np.int32,
)

W = np.array(
    [4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 36, 1 / 36],
    dtype=np.float64,
)

# Opposite direction (full bounce-back).
REFLECT = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)
# Mirror about the x=0 axis (flips ex).
MIRROR_X = np.array([0, 3, 2, 1, 4, 6, 5, 8, 7], dtype=np.int32)
# Mirror about the y=0 axis (flips ey).
MIRROR_Y = np.array([0, 1, 4, 3, 2, 8, 7, 6, 5], dtype=np.int32)

# Incoming directions whose pull crosses the x=0 axis (e_x = +1) and the
# outgoing ones (e_x = -1); the same for the y=0 axis.
AXIS_X_IN = (1, 5, 8)
AXIS_X_OUT = (3, 6, 7)
AXIS_Y_IN = (2, 5, 6)
AXIS_Y_OUT = (4, 7, 8)

CS2 = 1.0 / 3.0


def cs2(dx: float, dt: float) -> float:
    """Squared speed of sound for a given grid/time step."""
    c = dx / dt
    return c * c / 3.0


@functools.lru_cache(maxsize=None)
def tables(device: torch.device, dtype: torch.dtype):
    """``(E, W)`` as tensors on ``device``; cached so a step on the card
    does not copy the tables from the host every call."""
    return (
        torch.as_tensor(E, dtype=dtype, device=device),
        torch.as_tensor(W, dtype=dtype, device=device),
    )
