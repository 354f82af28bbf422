"""Channel flow past a cylinder: inflow/outflow, MRT and the curved
solid-fluid coupling (counterpart of the JAX package's
`models/cylinder.py`; reference `demo/demo_2d_LBM_cylinder.py:43-202`).

An (H, W) channel with an INFLOW row at y=0 (plug velocity +y), an
OUTFLOW row at y=H-1, OBSTACLE side walls, and a static cylinder resolved
by the sub-grid coupling. `make_step` / `make_runner` are the plain
PyTorch path (the JAX package's jnp step); the kernel path is
`kernels/cylinder.py::make_fused_cylinder_runner`.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Tuple

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.ops import coupling as _coupling
from jrl_lbm_torch.ops import macro as _macro
from jrl_lbm_torch.ops import stream as _stream
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.utils.device import resolve_device, state_from_numpy, state_to_numpy  # noqa: F401
from jrl_lbm_torch.utils.grid import create_2d_meshgrid
from jrl_lbm_torch.utils.sdf import cylinder_phi
from jrl_lbm_torch.utils.types import CellType


@dataclasses.dataclass(frozen=True)
class CylinderConfig:
    res: Tuple[int, int] = (800, 400)  # (H, W)
    Re: float = 5000.0
    Vmax: float = 0.05
    D: float = 20.0  # cylinder diameter in cells
    cylinder_center: Optional[Tuple[float, float]] = None  # (x, y); default (10D, 10D)
    dx: float = 1.0
    dt: float = 1.0
    density: float = 1.0
    contact_angle: float = 0.5 * math.pi
    dtype: object = torch.float32

    @property
    def tau(self) -> float:
        c = self.dx / self.dt
        cs2 = c * c / 3.0
        visc = self.Vmax * max(self.res) * self.dx / self.Re
        return 0.5 + visc / cs2

    @property
    def center(self) -> Tuple[float, float]:
        if self.cylinder_center is not None:
            return self.cylinder_center
        return (10.0 * self.D, 10.0 * self.D)


def init(cfg: CylinderConfig, device="cuda"):
    """``(state, fields)`` of the scene (`demo_2d_LBM_cylinder.py:109-136`)."""
    dev = resolve_device(device)
    H, W = cfg.res
    dtype = cfg.dtype
    cx, cy = cfg.center
    if not (0 < cx < W and 0 < cy < H):
        warnings.warn(
            f"cylinder center {cfg.center} lies outside the {H}x{W} domain "
            "(the default center is (10D, 10D) as in the reference demo; "
            "pass cylinder_center= for small grids)",
            stacklevel=2,
        )

    flags = torch.full((H, W), int(CellType.OBSTACLE), dtype=torch.int32, device=dev)
    flags[1:-1, 1:-1] = int(CellType.FLUID)
    flags[0, 1:-1] = int(CellType.INFLOW)
    flags[-1, 1:-1] = int(CellType.OUTFLOW)

    mesh = create_2d_meshgrid((H, W), dtype=dtype, device=dev) + 0.5 * cfg.dx
    phi_obs = cylinder_phi(mesh, cfg.center, cfg.D / 2.0)
    flags = torch.where(phi_obs <= 0, int(CellType.OBSTACLE), flags).to(torch.int32)

    inflow_vel = torch.tensor([0.0, cfg.Vmax], dtype=dtype, device=dev)
    rho = torch.full((H, W), cfg.density, dtype=dtype, device=dev)
    vel = torch.zeros((2, H, W), dtype=dtype, device=dev)
    vel = torch.where((flags == int(CellType.INFLOW))[None], inflow_vel[:, None, None], vel)
    force = torch.zeros((2, H, W), dtype=dtype, device=dev)
    f = feq(rho, vel, dx=cfg.dx, dt=cfg.dt, force=force)

    state = {"f": f, "rho": rho, "vel": vel}
    fields = {
        "flags": flags,
        "phi_obs": phi_obs,
        "obs_vel": torch.zeros((2, H, W), dtype=dtype, device=dev),
        "force": force,
        "inflow_vel": inflow_vel,
    }
    return state, fields


def make_step(cfg: CylinderConfig):
    """propagate (inflow/outflow) -> solid-fluid coupling -> macro (with
    the contact-angle extrapolation) -> MRT; plain PyTorch."""
    minv_s_m, _ = _collide.mrt_matrices(cfg.tau)

    def step(state, fields):
        f, rho, vel = state["f"], state["rho"], state["vel"]
        flags = fields["flags"]
        rho, vel, f = _stream.propagate(
            f, flags, rho=rho, vel=vel, inflow_density=cfg.density,
            inflow_vel=fields["inflow_vel"], dx=cfg.dx, dt=cfg.dt,
        )
        f = _coupling.solve_boundary(
            vel, flags, f, fields["phi_obs"], obs_vel=fields["obs_vel"],
            tau=cfg.tau, dx=cfg.dx, dt=cfg.dt,
        )
        rho, vel = _macro.macro_compute(
            f, rho, vel, flags, dx=cfg.dx, dt=cfg.dt, contact_angle=cfg.contact_angle
        )
        f = _collide.mrt_collide(
            f, rho, vel, flags, minv_s_m=minv_s_m, tau=cfg.tau,
            force=fields["force"], dx=cfg.dx, dt=cfg.dt,
        )
        return {"f": f, "rho": rho, "vel": vel}

    return step


def make_runner(cfg: CylinderConfig):
    """``run(state, fields, n)``: n plain steps (a Python loop)."""
    step = make_step(cfg)

    def run(state, fields, n: int):
        for _ in range(int(n)):
            state = step(state, fields)
        return state

    return run


def drag_lift(state, fields, cfg: CylinderConfig, margin: float = 2.0):
    """Force ``(Fx, Fy)`` on the cylinder from the momentum balance of the
    second-moment tensor Pi_ab = sum_q f_q e_a e_b over a square control
    surface of half-width ``margin * D`` around it:
    F_a = -closed-surface integral of Pi_ab n_b. Cd = Fy / (0.5 rho U^2 D)
    for the +y channel flow."""
    del fields
    f = state["f"]
    cx, cy = cfg.center
    r = margin * cfg.D
    H, W = f.shape[-2:]
    x0, x1 = int(cx - r), int(cx + r)
    y0, y1 = int(cy - r), int(cy + r)
    # a scalar index past the end clamps to the last row/column, as a JAX
    # gather does; the slices keep the bounds as they are
    xi, yi = min(x1, W - 1), min(y1, H - 1)

    E = lattice.E

    def pi(a, b):
        out = None
        for q in range(9):
            c = float(E[q, a] * E[q, b])
            if c != 0.0:
                term = f[q] if c == 1.0 else c * f[q]
                out = term if out is None else out + term
        return out

    pi_xx, pi_xy, pi_yy = pi(0, 0), pi(0, 1), pi(1, 1)
    fx = -(
        torch.sum(pi_xy[yi, x0:x1]) - torch.sum(pi_xy[y0, x0:x1])
        + torch.sum(pi_xx[y0:y1, xi]) - torch.sum(pi_xx[y0:y1, x0])
    )
    fy = -(
        torch.sum(pi_yy[yi, x0:x1]) - torch.sum(pi_yy[y0, x0:x1])
        + torch.sum(pi_xy[y0:y1, xi]) - torch.sum(pi_xy[y0:y1, x0])
    )
    return fx, fy
