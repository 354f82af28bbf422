"""JRL tip approach: axisymmetric fluid phase and concentration phase
(counterpart of the JAX package's `models/jrl.py`).

Configs, unit conversion and geometry follow the reference demos
(`demo_2d_LBM_JRL_fluid_*.py`, `demo_2d_LBM_JRL_C_*.py`) as the JAX
package does. The tip geometry is a pure function of the step index;
the step index enters as a 0-d float32 tensor so the tip position
``walks`` is rounded in float32 exactly as JAX rounds it (the tip row
decides which cells are solid). From 2**24 on the float32 step is
itself rounded, as in the JAX package's jnp step.

A step is split in two halves that match the kernels: stream + coupling
+ moments, then collision (`kernels/jrl_fluid.py`); the concentration
steps are one kernel each (`kernels/jrl_c.py`). `make_*_step` and
`make_*_runner` are the plain PyTorch path. `pick_*_runner` go through
kernel wrappers, which launch the CUDA kernels for tensors on the card
and run the plain twins for tensors on the CPU: on a grid of at most
`kernels.fused_jrl.MAX_FUSED_CELLS` cells the multi-step kernels
(`kernels/fused_jrl.py`, n steps per launch); on a larger grid the
fluid phase goes through the tile-class kernels (`kernels/jrl_tiled.py`,
k steps per launch) and the concentration phases through the per-step
kernels (`make_per_step_*_runner`, one launch per step).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.utils import sdf as _sdf
from jrl_lbm_torch.utils.device import resolve_device, state_from_numpy, state_to_numpy  # noqa: F401
from jrl_lbm_torch.utils.grid import create_2d_meshgrid
from jrl_lbm_torch.utils.types import CellType

FLAT_SHAPES = ("cylinder", "infiniteplane")
WEDGE_SHAPES = ("45degree", "ethaline")
X_INTERVAL = 0.1  # tip travel between stored fluid frames


def _iota(H, W, device):
    iy = torch.arange(H, dtype=torch.int32, device=device)[:, None].expand(H, W)
    ix = torch.arange(W, dtype=torch.int32, device=device)[None, :].expand(H, W)
    return iy, ix


def tip_walks(inflow_height: float, step: int, v: float):
    """``(walks, walks_int)``: the tip position ``inflow_height + step * v``
    as a 0-d float32 CPU tensor (float32 rounding at each operation, as
    JAX with a float32 step index) and its row ``floor(walks + 0.5)``."""
    s = torch.tensor(float(step), dtype=torch.float32)
    walks = inflow_height + s * v
    return walks, int(torch.floor(walks + 0.5))


# ---------------------------------------------------------------------------
# Fluid phase
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JRLFluidConfig:
    """Parameters of `demo_2d_LBM_JRL_fluid_*.py:51-136` (dx = dt = 1)."""

    res: Tuple[int, int] = (128, 64)  # (H, W)
    Re: float = 1e-4
    vel_obs_real: float = 28e-6
    gravity_strength_real: float = -9.8
    Rg: float = 4.0
    shape: str = "cylinder"  # cylinder | 45degree | infiniteplane | ethaline
    refine: int = 1
    dtype: object = torch.float32

    tau: float = 1.0
    density_fluid: float = 1.0
    radius_obs_real: float = 1.25e-5

    def __post_init__(self):
        if self.shape not in FLAT_SHAPES + WEDGE_SHAPES:
            raise ValueError(f"unknown tip shape {self.shape}")

    @property
    def eff_res(self) -> Tuple[int, int]:
        if self.shape == "ethaline":
            return (self.res[0] * self.refine, self.res[1] * self.refine)
        return tuple(self.res)

    @property
    def radius_obs(self) -> float:
        mult = self.refine if self.shape == "ethaline" else 1
        return mult * 6 + 0.50000000000001

    @property
    def inflow_height(self) -> float:
        base = 20 if self.shape in FLAT_SHAPES else 40
        mult = self.refine if self.shape == "ethaline" else 1
        return mult * (base + 0.50000000000001)

    @property
    def inflow_height_int(self) -> int:
        return int(self.inflow_height + 0.5)

    @property
    def visc(self) -> float:
        return (1.0 / 3.0) * (self.tau - 0.5)

    @property
    def vel_obs(self) -> float:
        return self.Re * self.visc / self.radius_obs

    @property
    def gravity_strength(self) -> float:
        # Froude similarity (`fluid_cylinder:90`)
        return (
            self.gravity_strength_real
            / (self.vel_obs_real**2 / self.radius_obs_real)
            * (self.vel_obs**2 / self.radius_obs)
        )

    @property
    def dt_real(self) -> float:
        return (1.0 * self.vel_obs / self.radius_obs) / (
            self.vel_obs_real / self.radius_obs_real
        )

    @property
    def Rg_radius(self) -> int:
        return int(self.Rg * self.radius_obs + 0.5)

    @property
    def total_steps(self) -> int:
        return int((self.eff_res[0] - 1 - self.inflow_height_int) / self.vel_obs)

    @property
    def box_radius(self) -> float:
        return self.Rg_radius + 100.0


def _tip_phi(cfg, mesh, walks):
    """Tip SDF at tip position ``walks`` (0-d float32 tensor or float)."""
    box_center = (cfg.Rg_radius - cfg.box_radius, walks - cfg.box_radius)
    res_y = cfg.eff_res[0]
    if cfg.shape in FLAT_SHAPES:
        return _sdf.jrl_tip_flat(mesh, box_center, cfg.box_radius, res_y=res_y)
    return _sdf.jrl_tip_45degree(mesh, box_center, cfg.box_radius, res_y=res_y)


def fluid_base_flags(cfg: JRLFluidConfig, device="cpu") -> torch.Tensor:
    """Domain flags before tip marking (`fluid_cylinder:161-165`)."""
    H, W = cfg.eff_res
    flags = torch.full((H, W), int(CellType.OUTFLOW), dtype=torch.int32, device=device)
    flags[1:-1, 1:-1] = int(CellType.FLUID)
    flags[:, 0] = int(CellType.FLUID)  # symmetry axis column
    flags[-1, :] = int(CellType.OBSTACLE)  # top wall
    return flags


def fluid_init(cfg: JRLFluidConfig, device="cuda"):
    """Initial state and fixed fields (`fluid_cylinder:141-195`)."""
    dev = resolve_device(device)
    H, W = cfg.eff_res
    dtype = cfg.dtype
    flags0 = fluid_base_flags(cfg, dev)
    mesh = create_2d_meshgrid((H, W), dtype=dtype, device=dev) + 0.5
    iy, ix = _iota(H, W, dev)
    block0 = (iy < cfg.inflow_height_int) & (ix < cfg.Rg_radius)
    flags_init = torch.where(block0, int(CellType.OBSTACLE), flags0)

    rho = torch.where(
        flags_init == int(CellType.OBSTACLE),
        torch.tensor(1.0, dtype=dtype, device=dev),  # density_wall
        torch.tensor(cfg.density_fluid, dtype=dtype, device=dev),
    )
    gravity = torch.tensor([0.0, -cfg.gravity_strength], dtype=dtype, device=dev)[:, None, None]
    force = rho[None] * gravity
    vel = torch.zeros((2, H, W), dtype=dtype, device=dev)
    f = feq(rho, vel, force=force)
    state = {"f": f, "rho": rho, "vel": vel}
    fields = {"base_flags": flags0, "mesh": mesh, "force": force}
    return state, fields


def fluid_geometry(cfg: JRLFluidConfig, fields, step: int):
    """Flags, phi and obstacle velocity of the tip at ``step``
    (`fluid_cylinder:204-214`, `fluid_ethaline:203-220`)."""
    H, W = cfg.eff_res
    dtype = cfg.dtype
    mesh = fields["mesh"]
    dev = mesh.device
    walks, walks_int = tip_walks(cfg.inflow_height, step, cfg.vel_obs)
    phi = _tip_phi(cfg, mesh, walks)
    zeros = torch.zeros((H, W), dtype=dtype, device=dev)
    if cfg.shape in FLAT_SHAPES:
        iy, ix = _iota(H, W, dev)
        tip = (iy < walks_int) & (ix < cfg.Rg_radius)
        obs_vel = torch.stack([zeros, torch.where(tip, cfg.vel_obs, 0.0).to(dtype)])
    else:
        # obstacle = phi <= 0; the top row stays out of the moving velocity
        tip = phi <= 0
        obs_vel = torch.stack([zeros, torch.where(tip, cfg.vel_obs, 0.0).to(dtype)])
        obs_vel[:, -1, :] = 0.0
    flags = torch.where(tip, int(CellType.OBSTACLE), fields["base_flags"])
    return {"flags": flags, "phi": phi, "obs_vel": obs_vel, "tip": tip}


def fluid_tip_velocity(cfg: JRLFluidConfig, geo, vel):
    """Velocity with the tip cells overwritten before streaming."""
    tip = geo["tip"]
    if cfg.shape in FLAT_SHAPES:
        return torch.stack(
            [torch.where(tip, 0.0, vel[0]), torch.where(tip, cfg.vel_obs, vel[1])]
        ).to(cfg.dtype)
    return torch.where(tip[None], geo["obs_vel"], vel)


def make_fluid_step(cfg: JRLFluidConfig):
    """One plain fluid step ``(state, fields, step_idx) -> state``."""
    from jrl_lbm_torch.kernels import jrl_fluid  # imports this module

    def step(state, fields, step_idx: int):
        f, rho, vel = jrl_fluid.fluid_a_ref(
            state["f"], state["rho"], state["vel"], step_idx, cfg, fields)
        f = jrl_fluid.fluid_b_ref(f, rho, vel, step_idx, cfg, fields)
        return {"f": f, "rho": rho, "vel": vel}

    return step


def make_fluid_runner(cfg: JRLFluidConfig):
    """Plain runner ``(state, fields, start_step, n) -> state``."""
    step = make_fluid_step(cfg)

    def run(state, fields, start_step: int, n: int):
        for i in range(int(n)):
            state = step(state, fields, int(start_step) + i)
        return state

    return run


def make_per_step_fluid_runner(cfg: JRLFluidConfig):
    """Runner through the per-step kernel wrappers: the `fluid_a`/`fluid_b`
    CUDA kernels for a state on the card (two launches a step), their
    plain twins on the CPU."""
    from jrl_lbm_torch.kernels import jrl_fluid

    def run(state, fields, start_step: int, n: int):
        f, rho, vel = state["f"], state["rho"], state["vel"]
        for i in range(int(n)):
            s = int(start_step) + i
            f, rho, vel = jrl_fluid.fluid_a(f, rho, vel, s, cfg, fields)
            f = jrl_fluid.fluid_b(f, rho, vel, s, cfg, fields)
        return {"f": f, "rho": rho, "vel": vel}

    return run


def pick_fluid_runner(cfg: JRLFluidConfig):
    """The runner the JAX package's ``_pick_fluid_runner`` picks off the
    CPU: the multi-step kernel's (`kernels/fused_jrl.py`, n steps per
    launch) on a grid of at most ``MAX_FUSED_CELLS`` cells, the tiled
    runner's (`kernels/jrl_tiled.py`: k-step passes of the full, lean and
    below-tip tile classes) on a larger grid with H % 8 == 0, the per-step
    kernels' runner on any other grid (where JAX takes its jnp step, which
    computes the same); ``(state, fields, start_step, n) -> state``."""
    from jrl_lbm_torch.kernels import fused_jrl, jrl_tiled

    if fused_jrl.fits(cfg):
        return fused_jrl.make_fused_fluid_runner(cfg)
    if jrl_tiled.tileable(cfg):
        return jrl_tiled.make_tiled_fluid_runner(cfg)
    return make_per_step_fluid_runner(cfg)


def fluid_record_steps(cfg: JRLFluidConfig, x_interval: float = X_INTERVAL):
    """Steps at which the reference snapshots the velocity field
    (`fluid_cylinder:239-251`): those where int(s * vel_obs / x_interval)
    grows, in doubles (numpy's float64 rounds as Python's floats do, and
    the count never falls), a million steps at a time."""
    v = cfg.vel_obs
    steps = []
    prev = 0.0
    for s0 in range(1, cfg.total_steps, 1 << 20):
        s = np.arange(s0, min(s0 + (1 << 20), cfg.total_steps), dtype=np.float64)
        b = np.floor(s * v / x_interval)
        steps += (s0 + np.flatnonzero(np.diff(b, prepend=prev))).tolist()
        prev = b[-1]
    return steps


def run_fluid_phase(cfg: JRLFluidConfig, device="cuda", progress: bool = False):
    """Whole fluid phase; returns ``(snapshots [N, 2, H, W] numpy, state)``
    with each snapshot interpolated between two post-step fields as the
    reference does (`fluid_cylinder:216,239-250`)."""
    state, fields = fluid_init(cfg, device)
    run = pick_fluid_runner(cfg)
    x_interval = X_INTERVAL
    v = cfg.vel_obs
    records = fluid_record_steps(cfg, x_interval)
    snapshots = []
    cur = 0
    it = records
    if progress:
        from tqdm import tqdm

        it = tqdm(records)
    for s in it:
        if s - cur > 0:
            state = run(state, fields, cur, s - cur)
            cur = s
        vel_prev = state["vel"]
        state = run(state, fields, cur, 1)
        cur += 1
        x_comp = s * v
        b = int(x_comp / x_interval)
        t1 = x_comp / x_interval - b
        t2 = b - (s - 1) * v / x_interval
        h5_vel = (state["vel"] * t2 + vel_prev * t1) / (t2 + t1) / v
        snapshots.append(h5_vel.cpu().numpy())
    if cfg.total_steps - cur > 0:
        state = run(state, fields, cur, cfg.total_steps - cur)
    H, W = cfg.eff_res
    snaps = np.stack(snapshots, axis=0) if snapshots else np.zeros((0, 2, H, W), np.float32)
    return snaps, state


# ---------------------------------------------------------------------------
# Concentration phase
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JRLCConfig:
    """Parameters of `demo_2d_LBM_JRL_C_*.py:52-123` (dx = dt = 1)."""

    res: Tuple[int, int] = (128, 64)
    balance_time: float = 600.0
    Re: float = 1e-4
    Pe: float = 0.01
    vel_obs_real: float = 21e-6
    gravity_strength_real: float = -9.8
    Rg: float = 4.0
    shape: str = "ethaline"
    refine: int = 1
    is_negative: bool = True
    dtype: object = torch.float32
    radius_obs_real: float = 1.25e-5

    def __post_init__(self):
        if self.shape not in FLAT_SHAPES + WEDGE_SHAPES:
            raise ValueError(f"unknown tip shape {self.shape}")

    @property
    def eff_res(self) -> Tuple[int, int]:
        if self.shape == "ethaline":
            return (self.res[0] * self.refine, self.res[1] * self.refine)
        return tuple(self.res)

    @property
    def radius_obs(self) -> float:
        mult = self.refine if self.shape == "ethaline" else 1
        return mult * 6 + 0.50000000000001

    @property
    def radius_obs_int(self) -> int:
        return int(self.radius_obs + 0.5)

    @property
    def inflow_height(self) -> float:
        base = 20 if self.shape in FLAT_SHAPES else 40
        mult = self.refine if self.shape == "ethaline" else 1
        return mult * (base + 0.50000000000001)

    @property
    def inflow_height_int(self) -> int:
        return int(self.inflow_height + 0.5)

    @property
    def tau_D(self) -> float:
        # Pe -> (vel_obs_conv, tau_D) with u capped at 0.1 (`C_ethaline:96-102`)
        cs2 = 1.0 / 3.0
        tau_D = 1.0
        D = cs2 * (tau_D - 0.5)
        v = self.Pe * D / self.radius_obs
        if v > 0.1:
            v = 0.1
            D = v * self.radius_obs / self.Pe
            tau_D = 0.5 + D / cs2
        return tau_D

    @property
    def vel_obs_conv(self) -> float:
        cs2 = 1.0 / 3.0
        v = self.Pe * cs2 * 0.5 / self.radius_obs
        return min(v, 0.1)

    @property
    def D_coeff(self) -> float:
        return (1.0 / 3.0) * (self.tau_D - 0.5)

    @property
    def dt_conv_real(self) -> float:
        return (1.0 * self.vel_obs_conv / self.radius_obs) / (
            self.vel_obs_real / self.radius_obs_real
        )

    @property
    def Rg_radius(self) -> int:
        return int(self.Rg * self.radius_obs + 0.5)

    @property
    def total_steps(self) -> int:
        return int((self.eff_res[0] - 1 - self.inflow_height_int) / self.vel_obs_conv)

    @property
    def balance_steps(self) -> int:
        return int(self.balance_time / self.dt_conv_real)

    @property
    def box_radius(self) -> float:
        return self.Rg_radius + 100.0

    @property
    def clamp_C(self) -> bool:
        # flat/IP variants clamp C to [0,1] (`C_cylinder:324`)
        return self.shape in FLAT_SHAPES

    @property
    def area_array(self) -> np.ndarray:
        """Annulus areas pi (r_{i+1}^2 - r_i^2) (`C_ethaline:189-192`)."""
        r = np.arange(self.radius_obs_int + 1, dtype=np.float64)
        a = math.pi * r * r
        return (a[1:] - a[:-1]).astype(np.float32)


def c_base_flags(cfg: JRLCConfig, device="cpu") -> torch.Tensor:
    """Domain flags before tip marking (`C_ethaline:166-173`)."""
    H, W = cfg.eff_res
    flags = torch.full((H, W), int(CellType.OUTFLOW), dtype=torch.int32, device=device)
    flags[1:-1, 1:-1] = int(CellType.FLUID)
    flags[:, 0] = int(CellType.FLUID)  # symmetry axis
    flags[-1, :] = int(CellType.OBSTACLE) if cfg.is_negative else int(CellType.INFLOW_2)
    if cfg.shape in FLAT_SHAPES:
        right = int(CellType.INFLOW_2)
    else:
        right = int(CellType.INFLOW_2) if cfg.is_negative else int(CellType.OUTFLOW)
    flags[:-1, -1] = right
    flags[0, cfg.Rg_radius:] = int(CellType.INFLOW_2)  # reservoir outside the platform
    return flags


def _c_tip_phi(cfg: JRLCConfig, mesh, walks):
    box_center = (cfg.Rg_radius - cfg.box_radius, walks - cfg.box_radius)
    res_y = cfg.eff_res[0]
    if cfg.shape in FLAT_SHAPES:
        return _sdf.jrl_tip_flat_forC(
            mesh, box_center, cfg.box_radius, cfg.is_negative, res_y=res_y)
    return _sdf.jrl_tip_45degree_forC(
        mesh, box_center, cfg.box_radius, cfg.is_negative, res_y=res_y)


def _c_flags_at(cfg: JRLCConfig, base_flags, mesh, walks, walks_int, strict: bool):
    """Flags with the tip marked at ``walks``: phi < 0 when ``strict``
    (approach, `C_ethaline:302`), phi <= 0 otherwise (balance,
    `C_ethaline:218`); flat tips use the rectangle (`C_cylinder:206`)."""
    H, W = cfg.eff_res
    iy, ix = _iota(H, W, base_flags.device)
    if cfg.shape in FLAT_SHAPES:
        obs = (iy < walks_int) & (ix < cfg.Rg_radius)
    else:
        phi = _c_tip_phi(cfg, mesh, walks)
        obs = (phi < 0) if strict else (phi <= 0)
        # the initial rectangular tip block stays marked (`C_ethaline:172`)
        obs = obs | ((iy < cfg.inflow_height_int) & (ix < cfg.Rg_radius))
    flags = torch.where(obs, int(CellType.OBSTACLE), base_flags)
    # tip head row = INFLOW (C = 0 sink), `C_ethaline:220,303`
    head = (iy == walks_int - 1) & (ix < cfg.radius_obs_int)
    return torch.where(head, int(CellType.INFLOW), flags)


def c_init(cfg: JRLCConfig, device="cuda"):
    """Initial C lattice (`C_ethaline:147-221`); returns
    ``(state, fields, balance_flags)``."""
    dev = resolve_device(device)
    H, W = cfg.eff_res
    dtype = cfg.dtype
    base = c_base_flags(cfg, dev)
    mesh = create_2d_meshgrid((H, W), dtype=dtype, device=dev) + 0.5
    flags = _c_flags_at(cfg, base, mesh, cfg.inflow_height, cfg.inflow_height_int,
                        strict=False)
    C = torch.where(flags == int(CellType.OBSTACLE), 0.0,
                    torch.ones((H, W), dtype=dtype, device=dev))
    h = feq(C, torch.zeros((2, H, W), dtype=dtype, device=dev))
    fields = {
        "base_flags": base,
        "mesh": mesh,
        "area": torch.as_tensor(cfg.area_array, device=dev),
    }
    return {"C": C, "h": h}, fields, flags


def make_balance_step(cfg: JRLCConfig, flags):
    """Plain balance step: zero velocity, fixed flags (`C_ethaline:230-253`)."""
    from jrl_lbm_torch.kernels import jrl_c

    def step(state, fields):
        h, C = jrl_c.c_balance_ref(state["h"], state["C"], flags, cfg, fields)
        return {"C": C, "h": h}

    return step


def make_balance_runner(cfg: JRLCConfig, flags):
    step = make_balance_step(cfg, flags)

    def run(state, fields, n: int):
        for _ in range(int(n)):
            state = step(state, fields)
        return state

    return run


def make_per_step_balance_runner(cfg: JRLCConfig, flags):
    """Balance runner through the per-step `c_balance` kernel wrapper."""
    from jrl_lbm_torch.kernels import jrl_c

    def run(state, fields, n: int):
        h, C = state["h"], state["C"]
        for _ in range(int(n)):
            h, C = jrl_c.c_balance(h, C, flags, cfg, fields)
        return {"C": C, "h": h}

    return run


def pick_balance_runner(cfg: JRLCConfig, flags):
    """The multi-step balance kernel's runner on a grid of at most
    ``MAX_FUSED_CELLS`` cells, the per-step kernel's on a larger grid;
    ``(state, fields, n) -> state`` either way."""
    from jrl_lbm_torch.kernels import fused_jrl

    if fused_jrl.fits(cfg):
        return fused_jrl.make_fused_balance_runner(cfg, flags)
    return make_per_step_balance_runner(cfg, flags)


def frame_pair(step: int, v: float, n_frames: int):
    """``(b, t, lerp)``: the stored frame at or before ``step``'s tip travel,
    the weight of frame ``b + 1`` and whether it is read, with the float32
    rounding of the JAX step (`C_ethaline:294-310`)."""
    x_comp = np.float32(np.float32(step) * np.float32(v))
    q = np.float32(x_comp / np.float32(X_INTERVAL))
    b = min(max(int(np.floor(q)), 0), int(n_frames) - 1)
    return b, np.float32(q - np.float32(b)), b + 1 < int(n_frames)


def stored_velocity(vel_field, step: int, v: float, b0: int = 0, n_frames: int | None = None):
    """Stored fluid velocity at ``step``, linearly interpolated in tip
    travel between frames (`C_ethaline:294-310`), with the float32
    rounding of the JAX step. ``vel_field`` holds frames ``b0, b0 + 1, ...``
    of a history of ``n_frames`` (default: all of it, ``b0 = 0``)."""
    n = int(vel_field.shape[0]) if n_frames is None else int(n_frames)
    b, t, lerp = frame_pair(step, v, n)
    i = b - int(b0)
    if not (0 <= i and i + int(lerp) < int(vel_field.shape[0])):
        raise ValueError(f"step {step} reads frames {b}..{b + int(lerp)}, outside the "
                         f"window of frames {b0}..{int(b0) + int(vel_field.shape[0]) - 1}")
    if lerp:
        return vel_field[i] * float(np.float32(1.0) - t) + vel_field[i + 1] * float(t)
    return vel_field[i]


def make_approach_step(cfg: JRLCConfig, parametrized: bool = False):
    """Plain approach step ``(state, fields, step_idx) -> (state,
    (inflow, current, rec_u, rec_v))``; ``fields`` carries ``vel_field``
    ``[N, 2, H, W]``, the normalized fluid history.

    With ``parametrized=True``, ``fields`` also carries ``vel_obs_conv``
    and ``tau_D`` (float32 scalars), which override the config's, as in the
    JAX package's parametrized step: a Pe sweep's lanes differ only in
    these two and their step counts (`C_ethaline:96-103`)."""
    from jrl_lbm_torch.kernels import jrl_c

    def step(state, fields, step_idx: int):
        if parametrized:
            v = torch.as_tensor(fields["vel_obs_conv"], dtype=cfg.dtype)
            tau_D = torch.as_tensor(fields["tau_D"], dtype=cfg.dtype)
        else:
            v = tau_D = None
        vel = stored_velocity(fields["vel_field"], step_idx,
                              cfg.vel_obs_conv if v is None else float(v))
        h, C, ints = jrl_c.c_approach_ref(state["h"], state["C"], vel, step_idx, cfg, fields,
                                          v=v, tau_D=tau_D)
        return {"C": C, "h": h}, ints

    return step


def make_approach_runner(cfg: JRLCConfig):
    """Plain runner ``(state, fields, start_step, n) -> (state, acc)`` with
    the running sums of the integrals."""
    step = make_approach_step(cfg)

    def run(state, fields, start_step: int, n: int):
        z = torch.zeros((), dtype=cfg.dtype)
        acc = {"inflow_sum": z, "current_sum": z, "count": z, "rec_u": z, "rec_v": z}
        for i in range(int(n)):
            state, (inflow, current, rec_u, rec_v) = step(state, fields, int(start_step) + i)
            acc = {
                "inflow_sum": acc["inflow_sum"] + inflow,
                "current_sum": acc["current_sum"] + current,
                "count": acc["count"] + 1.0,
                "rec_u": rec_u,
                "rec_v": rec_v,
            }
        return state, acc

    return run


def make_per_step_approach_runner(cfg: JRLCConfig, vel_field, route: str | None = None,
                                  b0: int = 0, n_frames: int | None = None):
    """Approach runner with one launch a step: `c_approach_pass` (the frame
    lerp, the step and its integrals in one kernel), or with ``route="pair"``
    the `c_approach` kernel pair after PyTorch's lerp (the yardstick).
    ``vel_field`` holds frames ``b0 ..`` of a history of ``n_frames``
    (default: all of it). The integrals accumulate on the state's device, so
    a run of n steps does not wait on the host. On the card the pass route
    checks the state, the frames and its two ping-pong buffer sets once a
    run and launches unchecked. Same contract as `make_approach_runner`."""
    from jrl_lbm_torch.kernels import jrl_c

    rt = jrl_c.approach_route(route)

    def run(state, fields, start_step: int, n: int):
        h, C = state["h"], state["C"]
        acc = torch.zeros(4, dtype=cfg.dtype, device=h.device)
        if rt == "pair":
            for i in range(int(n)):
                s = int(start_step) + i
                vel = stored_velocity(vel_field, s, cfg.vel_obs_conv, b0, n_frames)
                h, C = jrl_c.c_approach(h, C, vel, s, cfg, fields, acc)
        elif int(n) > 0:
            bufs = [(torch.empty_like(h), torch.empty_like(C)) for _ in range(2)]
            ctx = jrl_c.approach_pass_ctx(h, bufs, vel_field, start_step, n, cfg, fields, acc,
                                          b0, n_frames) if h.device.type == "cuda" else None
            with torch.cuda.device(ctx.dev) if ctx else contextlib.nullcontext():
                for i in range(int(n)):
                    h, C = jrl_c.c_approach_pass(h, vel_field, int(start_step) + i, cfg, fields,
                                                 acc, out=bufs[i & 1], b0=b0, n_frames=n_frames,
                                                 ctx=ctx)
        acc_d = {
            "inflow_sum": acc[0],
            "current_sum": acc[1],
            "count": torch.tensor(float(n), dtype=cfg.dtype),
            "rec_u": acc[2],
            "rec_v": acc[3],
        }
        return {"C": C, "h": h}, acc_d

    run.route = rt
    return run


def pick_approach_runner(cfg: JRLCConfig, vel_field):
    """The multi-step approach kernel's runner on a grid of at most
    ``MAX_FUSED_CELLS`` cells (`fused_approach_cl`, `fused_approach_mc`,
    `fused_approach_rw` or `fused_approach`, as `fused_jrl.fused_route`
    picks), `c_approach_pass` once a step on a
    larger grid; ``(state, fields, start_step, n) -> (state, acc)`` either
    way."""
    from jrl_lbm_torch.kernels import fused_jrl

    if fused_jrl.fits(cfg):
        return fused_jrl.make_fused_approach_runner(cfg, vel_field)
    return make_per_step_approach_runner(cfg, vel_field)


def c_dump_steps(cfg: JRLCConfig):
    """Steps after which the reference writes a record line
    (`C_ethaline:390`): floor(walks) == floor(walks + v) - 1 with walks =
    inflow_height + s v, in doubles (numpy's float64 rounds as Python's
    floats do), a million steps at a time."""
    v = cfg.vel_obs_conv
    out = []
    for s0 in range(0, cfg.total_steps, 1 << 20):
        s = np.arange(s0, min(s0 + (1 << 20), cfg.total_steps), dtype=np.float64)
        walks = cfg.inflow_height + s * v
        out += (s0 + np.flatnonzero(np.floor(walks) == np.floor(walks + v) - 1.0)).tolist()
    return out
