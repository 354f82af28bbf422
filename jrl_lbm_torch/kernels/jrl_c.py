"""Concentration-phase kernels: the balance step (`csrc/c_balance.cu`) and
the approach step with its tip-disk integrals (`csrc/c_approach.cu`),
each with its plain PyTorch twin.

Replace the TPU kernels ``_make_c_balance_kernel`` and
``_make_c_approach_kernel`` of `jrl_lbm_tpu/ops/pallas/fused_jrl_tiled.py`.
A wrapper given tensors on the CPU runs the twin; given tensors on the
card it launches the kernel or raises. ``c_balance.launches`` /
``c_approach.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels.jrl_fluid import _P, check_state, stream_of
from jrl_lbm_torch.models import jrl as _jrl
from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.ops import macro as _macro
from jrl_lbm_torch.ops import stream as _stream
from jrl_lbm_torch.utils.types import AxiSymmetricType, CellType

_AX = int(AxiSymmetricType.LINE_X_EQ_0)


# ---------------------------------------------------------------------------
# Plain twins (the jnp steps of `jrl_lbm_tpu/models/jrl.py`)
# ---------------------------------------------------------------------------

def c_balance_ref(h, C, flags, cfg, fields):
    """Balance step at zero velocity; returns ``(h, C)``."""
    H, W = cfg.eff_res
    zero_vel = torch.zeros((2, H, W), dtype=cfg.dtype, device=h.device)
    C, _, h = _stream.propagate(
        h, flags, rho=C, vel=zero_vel, inflow_density=0.0, axisymmetric_type=_AX,
    )
    C = _macro.macro_compute_C(h, C, flags)
    h = _collide.bgk_collide(
        h, C, zero_vel, flags, tau=cfg.tau_D, mesh_grid=fields["mesh"],
        is_convection=True, axisymmetric_type=_AX,
    )
    return h, C


def c_approach_ref(h, C, vel, step: int, cfg, fields):
    """Approach step on the interpolated stored velocity ``vel`` (not yet
    scaled by the tip speed); returns ``(h, C, (inflow, current, rec_u,
    rec_v))``."""
    H, W = cfg.eff_res
    dtype = cfg.dtype
    v = cfg.vel_obs_conv
    rint = cfg.radius_obs_int
    mesh = fields["mesh"]
    walks, walks_int = _jrl.tip_walks(cfg.inflow_height, step, v)
    flags = _jrl._c_flags_at(cfg, fields["base_flags"], mesh, walks, walks_int, strict=True)
    phi = _jrl._c_tip_phi(cfg, mesh, walks)
    C = torch.where(flags == int(CellType.OBSTACLE), 0.0, C)

    C_vel = vel * v
    iy, ix = _jrl._iota(H, W, h.device)
    tip_block = (iy < walks_int) & (ix < cfg.Rg_radius)
    C_vel = torch.stack(
        [torch.where(tip_block, 0.0, C_vel[0]), torch.where(tip_block, v, C_vel[1])]
    ).to(dtype)

    C, _, h = _stream.propagate(
        h, flags, phi_obs=phi, rho=C, vel=C_vel, inflow_density=0.0,
        axisymmetric_type=_AX,
    )
    C = _macro.macro_compute_C(h, C, flags)
    if cfg.clamp_C:
        C = torch.clamp(C, 0.0, 1.0)
    h = _collide.bgk_collide(
        h, C, C_vel, flags, tau=cfg.tau_D, mesh_grid=mesh,
        is_convection=True, axisymmetric_type=_AX,
    )

    # per-step integrals over the tip disk; rows clamp into [0, H-1] as
    # jax.lax.dynamic_slice clamps its start
    area = fields["area"]

    def disk_row(arr, row, n=rint):
        return arr[min(max(row, 0), H - 1), :n]

    if cfg.shape in _jrl.FLAT_SHAPES:
        def flux(row):  # dC_z + dC_r (`C_cylinder:344-358`)
            dC_z = disk_row(C, row) - disk_row(C, row - 1)
            r_line = disk_row(mesh[0], row, rint + 1)
            rC = r_line * disk_row(C, row, rint + 1)
            dC_r = (rC[1:] - rC[:-1]) / r_line[:-1]
            return torch.sum((dC_z + dC_r) * area)

        inflow, current = flux(walks_int), flux(walks_int + 1)
    else:  # plain disk integral (`C_ethaline:364-381`)
        inflow = torch.sum(disk_row(C, walks_int) * area)
        current = torch.sum(disk_row(C, walks_int + 1) * area)
    rec_u = torch.sum(disk_row(C_vel[0], walks_int + 1) * area)
    rec_v = torch.sum(disk_row(C_vel[1], walks_int + 1) * area)
    return h, C, (inflow, current, rec_u, rec_v)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class CBalanceParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("w_rate", ctypes.c_float), ("c_tau", ctypes.c_float),
    ]


class CApproachParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int), ("rg", ctypes.c_int), ("rint", ctypes.c_int),
        ("inflow_h_int", ctypes.c_int), ("flat", ctypes.c_int), ("is_negative", ctypes.c_int),
        ("clamp", ctypes.c_int),
        ("inflow_h", ctypes.c_float), ("v", ctypes.c_float), ("box_r", ctypes.c_float),
        ("bcx", ctypes.c_float), ("x1", ctypes.c_float),
        ("w_rate", ctypes.c_float), ("c_tau", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=16)
def _balance_params(cfg) -> CBalanceParams:
    H, W = cfg.eff_res
    tau = cfg.tau_D
    return CBalanceParams(H=H, W=W, w_rate=1.0 / tau, c_tau=1.0 * (1.0 - 0.5 / tau))


@functools.lru_cache(maxsize=16)
def _approach_params(cfg) -> CApproachParams:
    H, W = cfg.eff_res
    tau = cfg.tau_D
    bcx = cfg.Rg_radius - cfg.box_radius
    return CApproachParams(
        H=H, W=W, rg=cfg.Rg_radius, rint=cfg.radius_obs_int,
        inflow_h_int=cfg.inflow_height_int, flat=int(cfg.shape in _jrl.FLAT_SHAPES),
        is_negative=int(cfg.is_negative), clamp=int(cfg.clamp_C), inflow_h=cfg.inflow_height,
        v=cfg.vel_obs_conv, box_r=cfg.box_radius, bcx=bcx, x1=bcx + cfg.box_radius,
        w_rate=1.0 / tau, c_tau=1.0 * (1.0 - 0.5 / tau),
    )


def c_balance(h, C, flags, cfg, fields):
    """Balance step; returns new ``(h, C)``."""
    if h.device.type == "cpu":
        return c_balance_ref(h, C, flags, cfg, fields)
    dev = check_state(cfg, 0, h=(h, (9,)), C=(C, ()), flags=(flags, ()))
    h_out, C_out = torch.empty_like(h), torch.empty_like(C)
    p = _balance_params(cfg)
    fn = build.bind("c_balance", "jrl_c_balance", [_P] * 6 + [_P])
    with torch.cuda.device(dev):
        err = fn(flags.data_ptr(), h.data_ptr(), C.data_ptr(), h_out.data_ptr(),
                 C_out.data_ptr(), ctypes.byref(p), stream_of(dev))
    build.check(err, "c_balance")
    c_balance.launches += 1
    return h_out, C_out


def c_approach(h, C, vel, step: int, cfg, fields, acc):
    """Approach step; returns new ``(h, C)`` and updates ``acc`` (float32
    ``[4]`` on the state's device) in place: ``acc[0] += inflow``,
    ``acc[1] += current``, ``acc[2] = rec_u``, ``acc[3] = rec_v``.
    ``vel`` is the interpolated stored velocity of this step."""
    if h.device.type == "cpu":
        h, C, (inflow, current, rec_u, rec_v) = c_approach_ref(h, C, vel, step, cfg, fields)
        acc[0] += inflow
        acc[1] += current
        acc[2] = rec_u
        acc[3] = rec_v
        return h, C
    base = fields["base_flags"]
    dev = check_state(cfg, step, h=(h, (9,)), C=(C, ()), vel=(vel, (2,)),
                      base_flags=(base, ()))
    rint = cfg.radius_obs_int
    area = fields["area"]
    if rint + 1 > cfg.eff_res[1] or tuple(area.shape) != (rint,) or area.device != dev:
        raise ValueError("tip disk does not fit the grid, or area is not on the card")
    if tuple(acc.shape) != (4,) or acc.dtype != torch.float32 or acc.device != dev:
        raise ValueError("acc must be a float32 [4] tensor on the card")
    h_out, C_out = torch.empty_like(h), torch.empty_like(C)
    p = _approach_params(cfg)
    fn = build.bind("c_approach", "jrl_c_approach", [_P] * 7 + [ctypes.c_int, _P, _P])
    with torch.cuda.device(dev):
        err = fn(base.data_ptr(), h.data_ptr(), vel.data_ptr(), area.data_ptr(),
                 h_out.data_ptr(), C_out.data_ptr(), acc.data_ptr(), int(step),
                 ctypes.byref(p), stream_of(dev))
    build.check(err, "c_approach")
    c_approach.launches += 1
    return h_out, C_out


c_balance.launches = 0
c_approach.launches = 0
