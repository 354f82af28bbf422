"""Device selection for the port's entry points, and states to and from
numpy.

The default is the card. The CPU runs only when the caller asks for it
(the tests do): a missing CUDA runtime is an error, never a silent move
to the plain PyTorch path.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def state_from_numpy(arrays: dict, device="cuda") -> dict:
    """A state or fields dict of numpy arrays (e.g. JAX arrays through
    ``np.asarray``) as tensors on ``device``: integer arrays (flags) as
    int32, the rest as float32."""
    dev = resolve_device(device)
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        out[k] = torch.as_tensor(np.array(a, dtype=dt), device=dev)
    return out


def state_to_numpy(arrays: dict) -> dict:
    """A state or fields dict of tensors as numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in arrays.items()}
