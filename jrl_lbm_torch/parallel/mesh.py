"""Device meshes for 2D spatial domain decomposition (counterpart of the
JAX package's `parallel/mesh.py`).

A mesh is a ``(ny, nx)`` grid of shards along the axes ``dy`` (rows) and
``dx`` (columns), in one of two kinds:

* a **local mesh** (`make_mesh`): this process holds every shard, each as
  tensors on its own ``torch.device``; devices may repeat, so
  ``make_mesh((4, 1), [cuda:0] * 4)`` is four shards on one card;
* a **process-group mesh** (`process_mesh`, `multihost.pod_mesh`): one
  shard per rank of a `torch.distributed` group (gloo on the CPU, NCCL on
  cards), rank ``r`` holding shard ``divmod(r, nx)``.

`split` and `gather` carry a global tensor onto the shards this process
holds and back. The collectives over either kind are in `halo.py`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_Y = "dy"
AXIS_X = "dx"


class Mesh:
    """A ``(ny, nx)`` mesh of shards. ``devices`` is the ``(ny, nx)``
    object array of each shard's ``torch.device`` (None for shards another
    process holds); ``local`` lists the ``(iy, ix)`` of the shards this
    process holds, in row-major order; ``group`` is the process group of a
    process-group mesh, None for a local one."""

    axis_names = (AXIS_Y, AXIS_X)

    def __init__(self, devices: np.ndarray, group=None, local=None):
        self.devices = devices
        self.group = group
        ny, nx = devices.shape
        self.local = list(local) if local is not None else [
            (iy, ix) for iy in range(ny) for ix in range(nx)]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)

    def rank_of(self, coord) -> int:
        """The global rank that holds shard ``coord`` (process-group mesh)."""
        import torch.distributed as dist

        r = coord[0] * self.shape[1] + coord[1]
        return dist.get_global_rank(self.group, r) if self.group is not None and \
            self.group != dist.group.WORLD else r

    def __repr__(self):
        kind = "process-group" if self.group is not None else "local"
        return f"Mesh({self.shape}, {kind}, local={self.local})"


def _square(n: int) -> Tuple[int, int]:
    """The most square ``(ny, nx)`` with ``ny * nx == n`` and ``ny <= nx``."""
    ny = int(np.floor(np.sqrt(n)))
    while n % ny:
        ny -= 1
    return ny, n // ny


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A local ``(dy, dx)`` mesh over ``devices`` (default: the visible
    CUDA devices; raises when there are none; the CPU only where the caller
    passes CPU devices). With no shape given, factors the device count into
    the most square ``(ny, nx)``, so halo surface is least."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh; pass devices=['cpu', ...] to "
                               "shard on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = _square(n)
    ny, nx = shape
    if ny * nx != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    arr = np.empty((ny, nx), dtype=object)
    for i, d in enumerate(devices):
        arr[divmod(i, nx)] = d
    return Mesh(arr)


def process_mesh(shape: Optional[Tuple[int, int]] = None, device=None, group=None) -> Mesh:
    """A process-group mesh over the ranks of ``group`` (default: the
    world), one shard per rank, rank ``r`` holding shard ``divmod(r, nx)``
    on ``device`` (default: the current CUDA device; raises when there is
    none). `torch.distributed` must be initialised (`multihost.initialize`)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised (multihost.initialize)")
    n = dist.get_world_size(group)
    if shape is None:
        shape = _square(n)
    ny, nx = shape
    if ny * nx != n:
        raise ValueError(f"mesh shape {shape} does not match {n} processes")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank; pass device='cpu' to shard on "
                               "the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    me = divmod(dist.get_rank(group), nx)
    arr = np.empty((ny, nx), dtype=object)
    arr[me] = torch.device(device)
    return Mesh(arr, group=group if group is not None else dist.group.WORLD, local=[me])


def split(x: torch.Tensor, mesh: Mesh):
    """The blocks of a global ``[..., H, W]`` tensor that the shards this
    process holds own, in ``mesh.local`` order, each contiguous on its
    shard's device."""
    ny, nx = mesh.shape
    H, W = x.shape[-2:]
    if H % ny or W % nx:
        raise ValueError(f"{H}x{W} does not split over a {ny}x{nx} mesh")
    h, w = H // ny, W // nx
    return [x[..., iy * h:(iy + 1) * h, ix * w:(ix + 1) * w].to(mesh.devices[iy, ix]).contiguous()
            for iy, ix in mesh.local]


def gather(blocks, mesh: Mesh) -> torch.Tensor:
    """The global tensor of the shards' blocks (`split`'s inverse), on the
    device of this process's first shard; on a process-group mesh every
    rank gathers the whole."""
    ny, nx = mesh.shape
    if mesh.group is None:
        every = dict(zip(mesh.local, blocks))
        dev = blocks[0].device
    else:
        import torch.distributed as dist

        parts = [torch.empty_like(blocks[0]) for _ in range(ny * nx)]
        dist.all_gather(parts, blocks[0].contiguous(), group=mesh.group)
        every = {divmod(r, nx): p for r, p in enumerate(parts)}
        dev = blocks[0].device
    rows = [torch.cat([every[iy, ix].to(dev) for ix in range(nx)], dim=-1) for iy in range(ny)]
    return torch.cat(rows, dim=-2)
