"""Device selection for the port's entry points.

The default is the card. The CPU runs only when the caller asks for it
(the tests do): a missing CUDA runtime is an error, never a silent move
to the plain PyTorch path.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
