"""Simulation configuration and operator factory, the reference-parity API
(counterpart of the JAX package's `simulation.py`; reference
`src/LBM/simulation/simulation_parameters.py` and `simulation_runner.py`).

`SimulationParameters` is a frozen dataclass; the operator classes that
`SimulationRunner.create_*` returns are thin stateless wrappers over the
plain operators of `jrl_lbm_torch.ops`, with the reference's call
signatures, so a demo of the reference ports line by line. They make
no tensor of their own and run on the device of the tensors they are
given.

As in the JAX package: arrays carry no batch axis and scalar fields no
channel axis (f ``[Q, H, W]``, rho ``[H, W]``, vel ``[2, H, W]``), and
`propagation` returns ``(rho, vel, f)`` or ``f`` as the reference wrapper
does (`LBM_propagation_2d.py:51-92`), without mutating its inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.ops import coupling as _coupling
from jrl_lbm_torch.ops import equilibrium as _equilibrium
from jrl_lbm_torch.ops import macro as _macro
from jrl_lbm_torch.ops import stencil as _stencil
from jrl_lbm_torch.ops import stream as _stream
from jrl_lbm_torch.utils.types import KBCType


@dataclasses.dataclass(frozen=True)
class SimulationParameters:
    """Physics and configuration (`simulation_parameters.py:6-88`).
    ``simulation_size`` keeps the reference's ``[B, C, H, W]`` convention;
    only H and W are used."""

    dim: int = 2
    dtype: object = torch.float32
    dt: float = 1.0
    simulation_size: Tuple[int, ...] = (1, 1, 256, 256)
    density_gas: float = 0.0
    density_fluid: float = 1.0
    gravity_strength: float = 0.0
    axisymmetric_type: int = 0
    contact_angle: Optional[float] = 0.75 * math.pi
    Q: int = 9
    tau: float = 1.0
    rho_gas: float = 0.038
    rho_fluid: float = 0.265
    kappa: float = 0.08
    tau_g: float = 0.7
    tau_f: float = 0.7
    k: float = 1.0

    def __post_init__(self):
        if self.dim == 2 and len(self.simulation_size) != 4:
            raise ValueError(
                "For 2d simulation simulation size should have 4 parameters B x C x H x W"
            )

    @property
    def res(self) -> Tuple[int, int]:
        return tuple(self.simulation_size[-2:])

    def get_dx(self) -> float:
        return 1.0 / max(self.simulation_size)

    def is_2d(self) -> bool:
        return self.dim == 2

    def is_3d(self) -> bool:
        return self.dim == 3


class _FrameClock:
    """Frame bookkeeping (`simulation_parameters.py:61-71`)."""

    def __init__(self, dt: float, frame_length: float = 1.0):
        self.dt = dt
        self.frame = 0
        self.time_per_frame = 0.0
        self.frame_length = frame_length
        self.time_total = 0.0

    def step(self):
        self.time_per_frame += self.dt
        self.time_total += self.dt
        if self.time_per_frame >= self.frame_length:
            self.frame += 1
            self.time_total = self.frame * self.frame_length
            self.time_per_frame = 0.0


class LBMPropagation2d:
    """Streaming operator (`LBM_propagation_2d.py:95-186`)."""

    def __init__(self, tau: float, axisymmetric_type: int = 0, dtype=torch.float32):
        self._tau = tau
        self.axisymmetric_type = int(axisymmetric_type)
        self.dtype = dtype

    def propagation(self, f, flags, phi_obs=None, rho=None, vel=None, inflow_vel=None,
                    inflow_density=None, is_convection=False, dx: float = 1.0,
                    dt: float = 1.0):
        """``(rho, vel, f)`` when inflow information is given, else ``f``.
        ``is_convection`` is accepted and, as in the reference kernel, not
        read."""
        del is_convection
        rho_o, vel_o, f_new = _stream.propagate(
            f, flags, phi_obs=phi_obs, rho=rho, vel=vel, inflow_vel=inflow_vel,
            inflow_density=inflow_density, axisymmetric_type=self.axisymmetric_type,
            dx=dx, dt=dt,
        )
        # The reference also returns a tuple when flags hold INFLOW_2, but
        # every demo that uses INFLOW_2 passes inflow_density too.
        if inflow_density is not None or inflow_vel is not None:
            return rho_o, vel_o, f_new
        return f_new

    def rebounce_obstacle(self, f, flags):
        return _stream.rebounce_obstacle(f, flags)


class LBMMacroCompute2d:
    """Macroscopic moments (`LBM_macro_compute_2d.py:105-361`)."""

    def __init__(self, Q: int = 9, tau: float = 1.0, density_liquid: float = 0.265,
                 density_gas: float = 0.038, rho_liquid: float = 0.265, rho_gas: float = 0.038,
                 axisymmetric_type: int = 0, contact_angle: Optional[float] = 0.5 * math.pi,
                 dtype=torch.float32):
        self._Q = Q
        self._tau = tau
        self._density_liquid = density_liquid
        self._density_gas = density_gas
        self._rho_liquid = rho_liquid
        self._rho_gas = rho_gas
        self.axisymmetric_type = int(axisymmetric_type)
        self._contact_angle = float(contact_angle) if contact_angle is not None else None
        self.dtype = dtype

    def macro_compute(self, f, rho, vel, flags, dx=1.0, dt=1.0, density=None):
        rho_new, vel_new = _macro.macro_compute(
            f, rho, vel, flags, dx=dx, dt=dt, contact_angle=self._contact_angle
        )
        if density is not None:
            density_new = _macro.density_remap(
                rho_new, self._density_liquid, self._density_gas, self._rho_liquid,
                self._rho_gas,
            )
            return rho_new, vel_new, density_new
        return rho_new, vel_new

    def macro_compute_C(self, h, C, flags, vel=None, mesh_grid=None, dx=1.0, dt=1.0):
        return _macro.macro_compute_C(h, C, flags)

    def get_vort(self, vel, dx=1.0):
        return _macro.get_vort(vel, dx=dx)

    # the reference's CUDA twins of the two computations (never called by
    # its demos) are the same implementations here
    def ApplyCompute_C(self, h, C, flags, vel=None, mesh_grid=None, dx=1.0, dt=1.0):
        return self.macro_compute_C(h, C, flags, vel=vel, mesh_grid=mesh_grid, dx=dx, dt=dt)

    def ApplyCompute_fluid(self, f, rho, vel, flags, dx=1.0, dt=1.0, density=None):
        return self.macro_compute(f, rho, vel, flags, dx=dx, dt=dt, density=density)

    def get_pressure(self, density, dx=1.0, dt=1.0):
        return _macro.get_pressure(density, dx=dx, dt=dt)

    def contact_angle_correctness(self, rho, flags):
        return _macro.contact_angle_correctness(rho, flags, self._contact_angle)


class LBMCollision2d:
    """BGK collision (`LBM_collision_2d.py:125-555`)."""

    KIND = "bgk"

    def __init__(self, Q: int = 9, tau: float = 1.0, gravity_strength: float = 0.0,
                 axisymmetric_type: int = 0, dtype=torch.float32, **unused):
        # gravity_strength keeps the reference signature: the gravity vector
        # the reference builds from it (`LBM_collision_2d.py:166-171`) is
        # never read by the collisions
        del gravity_strength
        self._Q = Q
        self._tau = tau
        self._tau_D = None
        self.axisymmetric_type = int(axisymmetric_type)
        self.dtype = dtype

    def preset_KBC(self, dx: float, dt: float, tau: float, tau_D: float | None = None):
        self._tau = tau
        if tau_D is not None:
            self._tau_D = tau_D

    def get_feq_(self, rho, vel, dx=1.0, dt=1.0, tau=None, force=None, is_convection=False):
        return _equilibrium.feq(rho, vel, dx=dx, dt=dt, force=force)

    def get_geq_(self, rho, density, vel, pressure, force=None, feq=None, dx=1.0, dt=1.0):
        return _equilibrium.geq(rho, density, vel, pressure, force=force, feq_=feq, dx=dx, dt=dt)

    def equation_of_states(self, rho, dx=1.0, dt=1.0):
        return _equilibrium.equation_of_states(rho, dx=dx, dt=dt)

    def get_grad(self, rho, flags, dx=1.0):
        return _stencil.get_grad(rho, flags, dx=dx, axisymmetric_type=self.axisymmetric_type)

    def get_div(self, vel, flags, dx=1.0):
        return _stencil.get_div(vel, flags, dx=dx, axisymmetric_type=self.axisymmetric_type)

    def get_laplacian(self, x, dx=1.0, flags=None):
        return _stencil.get_laplacian(x, dx=dx)

    def collision(self, f, rho, vel, flags, force=None, mesh_grid=None, is_convection=False,
                  KBC_type=None, dx=1.0, dt=1.0):
        """BGK whatever ``KBC_type`` says (reference quirk §5.5)."""
        tau = self._tau_D if is_convection else self._tau
        return _collide.bgk_collide(
            f, rho, vel, flags, tau=tau, force=force, mesh_grid=mesh_grid,
            is_convection=is_convection, axisymmetric_type=self.axisymmetric_type, dx=dx, dt=dt,
        )


class LBMCollisionMRT2d(LBMCollision2d):
    """MRT collision (`LBM_collision_MRT_2d.py:11-184`); `preset_KBC`
    builds its matrices."""

    KIND = "mrt"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._minv_s_m = None
        self._minv_s_m_conv = None

    def preset_KBC(self, dx: float, dt: float, tau: float, tau_D: float | None = None):
        super().preset_KBC(dx, dt, tau, tau_D)
        self._minv_s_m, self._minv_s_m_conv = _collide.mrt_matrices(tau, tau_D)

    def collision(self, f, rho, vel, flags, force=None, mesh_grid=None, is_convection=False,
                  KBC_type=None, dx=1.0, dt=1.0):
        assert not is_convection, "reference MRT asserts not is_convection"
        if self._minv_s_m is None:
            raise RuntimeError("call preset_KBC before MRT collision")
        return _collide.mrt_collide(
            f, rho, vel, flags, minv_s_m=self._minv_s_m, tau=self._tau, force=force,
            mesh_grid=mesh_grid, is_convection=is_convection,
            axisymmetric_type=self.axisymmetric_type, dx=dx, dt=dt,
        )


class LBMCollisionKBC2d(LBMCollision2d):
    """KBC entropic collision (`LBM_collision_KBC_2d.py:11-317`); LBGK
    when ``KBC_type`` is None."""

    KIND = "kbc"

    def collision(self, f, rho, vel, flags, force=None, mesh_grid=None, is_convection=False,
                  KBC_type=None, dx=1.0, dt=1.0):
        tau = self._tau_D if is_convection else self._tau
        kbc = int(KBC_type) if KBC_type is not None else int(KBCType.LBGK)
        return _collide.kbc_collide(
            f, rho, vel, flags, tau=tau, kbc_type=kbc, force=force, mesh_grid=mesh_grid,
            is_convection=is_convection, axisymmetric_type=self.axisymmetric_type, dx=dx, dt=dt,
        )


class LBMBoundary2d:
    """Solid-fluid coupling (`LBM_boundary_2d.py:76-158`)."""

    def __init__(self, tau: float = 1.0, axisymmetric_type: int = 0, dtype=torch.float32):
        self._tau = tau
        self.axisymmetric_type = int(axisymmetric_type)
        self.dtype = dtype

    def solve_boundary(self, rho, vel, flags, f, phi_obs, obs_vel=None, tau=None,
                       is_convection=False, dx=1.0, dt=1.0):
        """The reconstructed ``f``; ``rho`` and ``is_convection`` are
        accepted and, as in the reference kernel, not read."""
        del rho, is_convection
        tau = self._tau if tau is None else tau
        return _coupling.solve_boundary(
            vel, flags, f, phi_obs, obs_vel=obs_vel, tau=tau,
            axisymmetric_type=self.axisymmetric_type, dx=dx, dt=dt,
        )


class SimulationRunner:
    """Operator factory (`simulation_runner.py:16-126`)."""

    def __init__(self, parameters: SimulationParameters):
        self.parameters = parameters
        self._clock = _FrameClock(parameters.dt)

    def create_propagation(self) -> LBMPropagation2d:
        p = self.parameters
        if not p.is_2d():
            raise RuntimeError("Not Implemented for 3D propagation")
        return LBMPropagation2d(tau=p.tau, axisymmetric_type=p.axisymmetric_type, dtype=p.dtype)

    def create_macro_compute(self) -> LBMMacroCompute2d:
        p = self.parameters
        if not p.is_2d():
            raise RuntimeError("Not Implemented for 3D macro computation")
        return LBMMacroCompute2d(
            Q=p.Q, tau=p.tau, density_liquid=p.density_fluid, density_gas=p.density_gas,
            rho_liquid=p.rho_fluid, rho_gas=p.rho_gas, axisymmetric_type=p.axisymmetric_type,
            contact_angle=p.contact_angle, dtype=p.dtype,
        )

    def _collision_kwargs(self):
        p = self.parameters
        return dict(Q=p.Q, tau=p.tau, gravity_strength=p.gravity_strength,
                    axisymmetric_type=p.axisymmetric_type, dtype=p.dtype)

    def create_collision(self) -> LBMCollision2d:
        if not self.parameters.is_2d():
            raise RuntimeError("Not Implemented for 3D collision")
        return LBMCollision2d(**self._collision_kwargs())

    def create_collision_KBC(self) -> LBMCollisionKBC2d:
        if not self.parameters.is_2d():
            raise RuntimeError("Not Implemented for 3D KBC collision")
        return LBMCollisionKBC2d(**self._collision_kwargs())

    def create_collision_MRT(self) -> LBMCollisionMRT2d:
        if not self.parameters.is_2d():
            raise RuntimeError("Not Implemented for 3D MRT collision")
        return LBMCollisionMRT2d(**self._collision_kwargs())

    def create_LBM_fluid_solid_coupling(self) -> LBMBoundary2d:
        p = self.parameters
        if not p.is_2d():
            raise NotImplementedError("3D Immersed boundary not implemented")
        return LBMBoundary2d(tau=p.tau, axisymmetric_type=p.axisymmetric_type, dtype=p.dtype)

    def step(self):
        self._clock.step()

    @property
    def frame(self) -> int:
        return self._clock.frame
