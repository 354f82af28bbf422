"""PyTorch/CUDA port of the JRL lattice-Boltzmann framework.

Plain PyTorch operators (`ops/`); the scenes: the JRL tip approach
(`models/jrl.py`, CLI `jrl_main.py`), the cylinder channel
(`models/cylinder.py`, CLI `cylinder_main.py`) and the doubly-periodic shear layer
(`models/shear_layer.py`, CLI `shear_main.py`); the reference-parity
API (`simulation.py`: `SimulationParameters`, `SimulationRunner`);
diagnostics (`utils/metrics.py`), the artifact writers and readers
(`utils/io.py`, `utils/native_io.py`), checkpoints (`utils/checkpoint.py`)
and hand-written CUDA kernels for Hopper
(`kernels/`). Arrays keep the JAX package's batch-free layout: ``f``/``h``
``[9, H, W]``, ``rho``/``C`` ``[H, W]``, ``vel`` ``[2, H, W]``, ``flags``
``[H, W]`` int32; everything is float32.

TF32 is switched off for the whole process on import: a float32
contraction routed through reduced-precision units corrupts the MRT
moment transform silently (the same failure the JAX package hit with
bf16 MXU passes on the TPU, see CLAUDE.md), so the port pins full
float32 wherever PyTorch would otherwise choose TF32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from jrl_lbm_torch import lattice  # noqa: E402
from jrl_lbm_torch.simulation import SimulationParameters, SimulationRunner  # noqa: E402

__version__ = "0.1.0"
__all__ = ["lattice", "SimulationParameters", "SimulationRunner", "__version__"]
