"""Checkpoint and resume of whole scene states (counterpart of the JAX
package's `utils/checkpoint.py`).

One HDF5 file holds a flat dict of arrays, one dataset a key, and the
attrs ``step`` plus any extras, written through a ``.tmp`` file and
``os.replace``: the layout of the JAX package's `save_state`, so a file
that either package writes loads in the other. Dtypes round-trip (int32
flags stay int32). A ``torch.bfloat16`` tensor has no numpy dtype: JAX's
`save_state` stores a bfloat16 leaf as opaque 2-byte records that its
`load_state` refuses, so here `save_state` refuses it (a ``TypeError``
naming the key) before anything is written, and `load_state` refuses an
opaque dataset the same way. The orbax pair of the JAX package
(`save_state_orbax`, `load_state_orbax`) has no counterpart: orbax saves
JAX arrays.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from jrl_lbm_torch.utils.device import resolve_device


def _host_array(key: str, value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        try:
            return value.detach().cpu().numpy()
        except TypeError as e:
            raise TypeError(f"state[{key!r}]: {value.dtype} has no numpy dtype and cannot be "
                            "checkpointed; convert it first") from e
    a = np.asarray(value)
    if a.dtype.kind == "V":
        raise TypeError(f"state[{key!r}]: opaque dtype {a.dtype} cannot be checkpointed")
    return a


def save_state(path: str, state: Dict[str, Any], step: int = 0, **extra):
    """Write a flat dict of tensors or arrays, the step and scalar extras
    to one HDF5 file."""
    import h5py

    arrays = {k: _host_array(k, v) for k, v in state.items()}
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as h5:
        h5.attrs["step"] = int(step)
        for k, v in extra.items():
            h5.attrs[k] = v
        for k, a in arrays.items():
            h5.create_dataset(k, data=a)
    os.replace(tmp, path)


def load_state(path: str, device="cuda") -> Tuple[Dict[str, torch.Tensor], int, Dict[str, Any]]:
    """``(state, step, extra attrs)`` of a checkpoint, the tensors on
    ``device`` (the card unless the caller asks for the CPU)."""
    import h5py

    dev = resolve_device(device)
    state = {}
    with h5py.File(path, "r") as h5:
        step = int(h5.attrs.get("step", 0))
        extra = {k: h5.attrs[k] for k in h5.attrs if k != "step"}
        for k in h5:
            a = np.asarray(h5[k])
            if a.dtype.kind == "V":
                raise TypeError(f"{path}: dataset {k!r} holds opaque {a.dtype} records (a "
                                "bfloat16 array saved by the JAX package?); it cannot be loaded")
            state[k] = torch.as_tensor(a, device=dev)
    return state, step, extra
