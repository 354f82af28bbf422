"""Doubly-periodic double shear layer, BGK, MRT or KBC (counterpart of the
JAX package's `models/shear_layer.py`; reference `demo/demo_2d_LBM.py`,
and `demo/demo_2d_LBM_KBC.py`, which despite its name builds the MRT
operator: SURVEY §5.4).

`make_step` / `make_runner` are the plain PyTorch path (the JAX package's
jnp step: propagate -> macro -> collide); the kernel path is
`kernels/periodic.py::make_fused_periodic_runner`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.ops import macro as _macro
from jrl_lbm_torch.ops import stream as _stream
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.utils.device import resolve_device, state_from_numpy, state_to_numpy  # noqa: F401
from jrl_lbm_torch.utils.types import CellType


@dataclasses.dataclass(frozen=True)
class ShearLayerConfig:
    res: Tuple[int, int] = (130, 130)  # (H, W)
    Re: float = 3000.0
    Vmax: float = 0.2
    KBC_sigma: float = 0.05
    KBC_kappa: float = 80.0
    dx: float = 1.0
    dt: float = 1.0
    density: float = 0.265
    collision: str = "bgk"  # "bgk" | "mrt" | "kbc"
    kbc_type: Optional[int] = None  # only for collision == "kbc"; None is KBC_A
    contact_angle: float = 0.5 * math.pi
    dtype: object = torch.float32

    @property
    def tau(self) -> float:
        c = self.dx / self.dt
        cs2 = c * c / 3.0
        visc = self.Vmax * max(self.res) * self.dx / self.Re
        return 0.5 + visc / cs2


def init(cfg: ShearLayerConfig, device="cuda"):
    """``(state, fields)`` of the scene (`demo_2d_LBM.py:86-99`), built in
    float32 in the JAX package's order of operations."""
    dev = resolve_device(device)
    H, W = cfg.res
    dtype = cfg.dtype
    flags = torch.full((H, W), int(CellType.FLUID), dtype=torch.int32, device=dev)
    rho = torch.full((H, W), cfg.density, dtype=dtype, device=dev)

    j = torch.arange(H, dtype=dtype, device=dev)[:, None]
    i = torch.arange(W, dtype=dtype, device=dev)[None, :]
    vy = cfg.KBC_sigma * cfg.Vmax * torch.sin(2.0 * math.pi * (i / W + 0.25))
    vx_lo = cfg.Vmax * torch.tanh(cfg.KBC_kappa * (j / H - 0.25))
    vx_hi = cfg.Vmax * torch.tanh(cfg.KBC_kappa * (-j / H + 0.75))
    vx = torch.where(j <= H / 2.0, vx_lo, vx_hi)
    vel = torch.stack([vx.expand(H, W), vy.expand(H, W)], dim=0).contiguous()

    force = torch.zeros((2, H, W), dtype=dtype, device=dev)
    f = feq(rho, vel, dx=cfg.dx, dt=cfg.dt, force=force)
    return {"f": f, "rho": rho, "vel": vel}, {"flags": flags, "force": force}


def make_step(cfg: ShearLayerConfig):
    """One lattice update: propagate -> macro -> collide (plain PyTorch)."""
    minv_s_m = _collide.mrt_matrices(cfg.tau)[0] if cfg.collision == "mrt" else None
    if cfg.collision not in ("bgk", "mrt", "kbc"):
        raise ValueError(cfg.collision)

    def step(state, fields):
        f, rho, vel = state["f"], state["rho"], state["vel"]
        flags = fields["flags"]
        _, _, f = _stream.propagate(f, flags, dx=cfg.dx, dt=cfg.dt)
        rho, vel = _macro.macro_compute(
            f, rho, vel, flags, dx=cfg.dx, dt=cfg.dt, contact_angle=cfg.contact_angle
        )
        kw = dict(force=fields["force"], dx=cfg.dx, dt=cfg.dt)
        if cfg.collision == "bgk":
            f = _collide.bgk_collide(f, rho, vel, flags, tau=cfg.tau, **kw)
        elif cfg.collision == "mrt":
            f = _collide.mrt_collide(f, rho, vel, flags, minv_s_m=minv_s_m, tau=cfg.tau, **kw)
        else:
            f = _collide.kbc_collide(f, rho, vel, flags, tau=cfg.tau,
                                     kbc_type=_collide.resolve_kbc_type(cfg.kbc_type), **kw)
        return {"f": f, "rho": rho, "vel": vel}

    return step


def make_runner(cfg: ShearLayerConfig):
    """``run(state, fields, n)``: n plain steps (a Python loop)."""
    step = make_step(cfg)

    def run(state, fields, n: int):
        for _ in range(int(n)):
            state = step(state, fields)
        return state

    return run


def vorticity(state, cfg: ShearLayerConfig):
    return _macro.get_vort(state["vel"], dx=cfg.dx)
