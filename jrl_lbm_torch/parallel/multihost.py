"""Multi-process execution: process-group meshes (counterpart of the JAX
package's `parallel/multihost.py`).

Each process holds one shard; processes stack along the mesh's ``dy``
axis, so the per-step y halo between neighbouring processes is one row of
each field, O(W) bytes. `initialize` joins the `torch.distributed` group
(gloo on the CPU, NCCL on cards), `pod_mesh` builds the mesh, `lift`
carries host-replicated global arrays onto it. The multi-process path is
held to the local mesh in ``tests/test_torch_parallel.py`` with two gloo
processes on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from jrl_lbm_torch.parallel.mesh import Mesh, process_mesh, split


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, **kwargs) -> None:
    """Join the `torch.distributed` process group (once per process).
    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` URL);
    without it the group is read from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). ``backend`` defaults to
    NCCL where CUDA is available, else gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id), **kwargs)


def pod_mesh(rows_per_process: int = 1, device=None) -> Mesh:
    """Process-spanning ``(dy, dx)`` mesh with the processes stacked along
    ``dy``. Each process holds one shard, so it contributes one mesh row:
    ``rows_per_process`` must divide that one shard (JAX's check, with one
    local device)."""
    import torch.distributed as dist

    local = 1
    if local % rows_per_process:
        raise ValueError(f"local device count {local} not divisible by "
                         f"rows_per_process={rows_per_process}")
    return process_mesh((dist.get_world_size() * rows_per_process, local // rows_per_process),
                        device=device)


def lift(tree: dict, mesh: Mesh) -> dict:
    """Host-replicated global arrays as the blocks of the shards this
    process holds: every process passes the same full-size tensors (the
    scene init is deterministic) and keeps only its own blocks."""
    return {k: split(torch.as_tensor(v), mesh) for k, v in tree.items()}


def mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    return tuple(mesh.devices.shape)
