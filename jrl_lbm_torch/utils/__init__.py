"""Enums, grids, SDFs, IO and device selection for the PyTorch port."""

from jrl_lbm_torch.utils.types import (
    AxiSymmetricType,
    CellType,
    KBCType,
    ObsType,
    is_KBC,
    is_KBC_AB,
    is_KBC_AC,
    is_KBC_BD,
    is_KBC_CD,
)
from jrl_lbm_torch.utils.grid import (
    create_2d_meshgrid,
    create_3d_meshgrid,
    create_droplet_2d,
    get_staggered,
    get_staggered_x,
    get_staggered_y,
)
from jrl_lbm_torch.utils.sdf import (
    cylinder_phi,
    jrl_tip_45degree,
    jrl_tip_45degree_forC,
    jrl_tip_flat,
    jrl_tip_flat_forC,
    union_phi_obs,
)

__all__ = [
    "AxiSymmetricType",
    "CellType",
    "KBCType",
    "ObsType",
    "is_KBC",
    "is_KBC_AB",
    "is_KBC_AC",
    "is_KBC_BD",
    "is_KBC_CD",
    "create_2d_meshgrid",
    "create_3d_meshgrid",
    "create_droplet_2d",
    "get_staggered",
    "get_staggered_x",
    "get_staggered_y",
    "cylinder_phi",
    "jrl_tip_45degree",
    "jrl_tip_45degree_forC",
    "jrl_tip_flat",
    "jrl_tip_flat_forC",
    "union_phi_obs",
]
