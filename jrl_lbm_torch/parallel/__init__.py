"""Multi-device scaling: 2D domain decomposition over a mesh of shards
with halo exchange; multi-process meshes via `multihost`."""

from jrl_lbm_torch.parallel.mesh import AXIS_X, AXIS_Y, make_mesh
from jrl_lbm_torch.parallel import multihost
from jrl_lbm_torch.parallel.halo import (
    DomainInfo,
    make_domain,
    make_single_domain,
    pad_halo,
    pad_periodic,
)

__all__ = [
    "AXIS_X",
    "AXIS_Y",
    "make_mesh",
    "multihost",
    "DomainInfo",
    "make_domain",
    "make_single_domain",
    "pad_halo",
    "pad_periodic",
]
