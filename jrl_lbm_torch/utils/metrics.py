"""Throughput timer, conservation diagnostics and profiler hooks
(counterpart of the JAX package's `utils/metrics.py`).

`force_sync` waits for the device of a state and fetches a scalar.
`StepTimer` times a run of steps with CUDA events when the state lies on
the card (the host returns before the card finishes) and with
``time.perf_counter`` on the CPU. `trace` and `named_scope` wrap
``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def _first_leaf(tree):
    """The first tensor of a tensor, dict (keys in sorted order, as JAX
    flattens a dict) or sequence, nested to any depth."""
    if isinstance(tree, dict):
        return _first_leaf(tree[sorted(tree)[0]])
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return torch.as_tensor(tree)


def force_sync(state) -> float:
    """Wait until the device of the state's first tensor has finished
    all its work, and return that tensor's sum on the host."""
    leaf = _first_leaf(state)
    total = torch.sum(leaf)
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return float(total)


@dataclasses.dataclass
class StepTimer:
    """MLUPS meter for a lattice of ``cells`` sites. ``start(state)`` and
    ``stop(steps, state)`` bracket a run; the device of ``state`` (a tensor
    or a dict of them) picks the clock."""

    cells: int
    steps: int = 0
    elapsed: float = 0.0
    _t0: Optional[float] = None
    _ev0: Optional[object] = None

    def start(self, state=None):
        dev = _first_leaf(state).device if state is not None else torch.device("cpu")
        if dev.type == "cuda":
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record(torch.cuda.current_stream(dev))
        else:
            self._t0 = time.perf_counter()

    def stop(self, steps: int, state=None):
        if self._ev0 is not None:
            dev = _first_leaf(state).device if state is not None else None
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(dev))
            end.synchronize()
            self.elapsed += self._ev0.elapsed_time(end) / 1e3
            self._ev0 = None
        else:
            self.elapsed += time.perf_counter() - self._t0
            self._t0 = None
        self.steps += steps

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.cells * self.steps / self.elapsed / 1e6

    def report(self) -> Dict[str, float]:
        return {"cells": self.cells, "steps": self.steps, "seconds": round(self.elapsed, 4),
                "mlups": round(self.mlups, 1)}


def mass(f):
    """Total mass of a distribution ``[Q, H, W]``."""
    return torch.sum(f)


def momentum(f):
    """Total momentum ``[2]`` of a distribution."""
    mx = torch.sum(f[1] - f[3] + f[5] - f[6] - f[7] + f[8])
    my = torch.sum(f[2] - f[4] + f[5] + f[6] - f[7] - f[8])
    return torch.stack([mx, my])


def divergence_norm(vel):
    """L2 norm of the central-difference divergence on the interior (an
    incompressibility diagnostic)."""
    du = 0.5 * (vel[0, 1:-1, 2:] - vel[0, 1:-1, :-2])
    dv = 0.5 * (vel[1, 2:, 1:-1] - vel[1, :-2, 1:-1])
    return torch.sqrt(torch.mean((du + dv) ** 2))


def field_stats(state) -> Dict[str, float]:
    """Host-side summary of a state: finite check and ranges per field."""
    out = {}
    for k, v in state.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[f"{k}_finite"] = bool(np.isfinite(a).all())
        out[f"{k}_min"] = float(a.min())
        out[f"{k}_max"] = float(a.max())
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (the card's
    kernels too when there is one) and write ``log_dir/trace.json``, a
    Chrome trace. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def named_scope(name: str):
    """A named range in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)
