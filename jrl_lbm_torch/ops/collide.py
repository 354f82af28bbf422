"""Collision operators (counterpart of the JAX package's `ops/collide.py`):
BGK with the axisymmetric source terms (`axisymmetric_source`,
`bgk_collide`; reference `LBM_collision_2d.py:343-555`), MRT
(`mrt_matrices`, `mrt_collide`; `LBM_collision_MRT_2d.py:36-184`) and the
entropic KBC operator in its five types (`kbc_omega`, `kbc_collide`;
`LBM_collision_KBC_2d.py:28-317`). Every moment contraction is written
out as float32 multiply-adds, so no matrix unit (TF32) rounds it.

Reference quirk kept: the convection-rate `elif` repeats LINE_X_EQ_0
where LINE_Y_EQ_0 was meant, so LINE_Y_EQ_0 convection gets no extra
relaxation-rate term.
"""

from __future__ import annotations

import numpy as np
import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.ops.stencil import get_div, get_grad
from jrl_lbm_torch.utils.types import AxiSymmetricType, CellType, KBCType


def axisymmetric_source(
    rho,
    vel,
    flags,
    feq_,
    mesh_grid,
    tau: float,
    axisymmetric_type: int,
    is_convection: bool = False,
    dx: float = 1.0,
    dt: float = 1.0,
    grad_fn=None,
    div_fn=None,
):
    """Gi source ``[Q, H, W]`` (scalar 0 when not axisymmetric).
    ``mesh_grid`` holds cell-centre coordinates (x, y), already +0.5.
    ``grad_fn``/``div_fn`` replace the whole-grid stencils (the sharded
    step passes halo-aware ones, `parallel/padded_ops.py`)."""
    c = dx / dt
    cs2 = c * c / 3.0
    e, w = lattice.tables(rho.device, rho.dtype)
    ax = int(axisymmetric_type)

    if grad_fn is None:
        def grad_fn(a):
            return get_grad(a, flags, dx=dx, axisymmetric_type=ax)

    if div_fn is None:
        def div_fn(a):
            return get_div(a, flags, dx=dx, axisymmetric_type=ax)

    if ax == int(AxiSymmetricType.LINE_X_EQ_0):
        r = mesh_grid[0]
        er = e[:, 0][:, None, None]
        ur = vel[0]
        A1 = -rho * ur / r
        if is_convection:
            # Liu et al. 2017 advection-diffusion source; feq carries the weight
            s = (1.0 - 0.5 / tau) * er / r[None]
            return -(ur / r)[None] * feq_ * (1.0 - 0.5 / tau - 0.5 * s)

        visc = cs2 * (tau - 0.5)
        mu = visc * rho
        pressure = rho * cs2
        grad_u = grad_fn(vel[0])
        grad_v = grad_fn(vel[1])

        A2 = grad_fn(pressure)[0]
        A2 = A2 + div_fn(rho[None] * ur[None] * vel)
        A2 = A2 * (dt / (2.0 * r))

        F2 = (mu / r)[None] * torch.stack([grad_u[0] - ur / r, grad_v[0]], dim=0)
        F2 = F2 + vel * A1[None]
        F2 = F2 - dt * (tau - 1.0) * cs2 * grad_fn(A1)
        F2e = e[:, 0][:, None, None] * F2[0][None] + e[:, 1][:, None, None] * F2[1][None]
        G = A1[None] + A2[None] + F2e / cs2
        return G * w[:, None, None]

    if ax == int(AxiSymmetricType.LINE_Y_EQ_0):
        r = mesh_grid[1] - 0.5 * dx
        r = r.clone()
        r[0, :] = 1.0
        ur = vel[1]
        A1 = -rho * ur / r
        if is_convection:
            G = A1[None] * torch.ones((9, 1, 1), dtype=rho.dtype, device=rho.device)
        else:
            visc = cs2 * (tau - 0.5)
            mu = visc * rho
            grad_u = grad_fn(vel[0])
            grad_v = grad_fn(vel[1])
            H1 = mu * (grad_u[1] + grad_v[0]) / r - rho * vel[0] * vel[1] / r
            H2 = (
                mu * (grad_v[1] * 2.0) / r
                - 2.0 * mu * vel[1] / (r * r)
                - rho * vel[1] * vel[1] / r
            )
            G = A1[None] + (
                e[:, 0][:, None, None] * H1[None] + e[:, 1][:, None, None] * H2[None]
            ) / cs2
        return G * w[:, None, None]

    return 0.0


def bgk_collide(
    f,
    rho,
    vel,
    flags,
    tau: float,
    force=None,
    mesh_grid=None,
    is_convection: bool = False,
    axisymmetric_type: int = 0,
    dx: float = 1.0,
    dt: float = 1.0,
    grad_fn=None,
    div_fn=None,
):
    """BGK relaxation ``f + w (feq - f) + dt Gi`` with OBSTACLE
    passthrough; ``tau`` is the relaxation time of the lattice collided
    (tau_D for the advection-diffusion lattice); ``grad_fn``, ``div_fn``
    as for `axisymmetric_source`."""
    ax = int(axisymmetric_type)
    feq_ = feq(rho, vel, dx=dx, dt=dt, force=force)

    if is_convection and ax == int(AxiSymmetricType.LINE_X_EQ_0):
        # per-direction rate 1/tau + dt (1 - 0.5/tau) e_r / r
        e, _ = lattice.tables(f.device, f.dtype)
        r = mesh_grid[0]
        s = dt * (1.0 - 0.5 / tau) * e[:, 0][:, None, None] / r[None]
        w_rate = 1.0 / tau + s
    else:
        w_rate = 1.0 / tau

    Gi = axisymmetric_source(
        rho, vel, flags, feq_, mesh_grid, tau, ax,
        is_convection=is_convection, dx=dx, dt=dt, grad_fn=grad_fn, div_fn=div_fn,
    )
    collided = f + w_rate * (feq_ - f) + dt * Gi
    return torch.where((flags == int(CellType.OBSTACLE))[None], f, collided)


# ---------------------------------------------------------------------------
# MRT
# ---------------------------------------------------------------------------

def mrt_matrices(tau: float, tau_D: float | None = None):
    """M^-1 S M for the fluid (and, with ``tau_D``, the convection) lattice
    as float64 numpy arrays: s7 = 1/tau, s4 = 8(2 - s7)/(8 - s7); the
    convection rates are the reference's literal [1, 1.1, 1.1, s3, s3, s3,
    s3, 1.2, 1.2] with s3 = 1/tau_D."""
    M = np.array(
        [
            [1, 1, 1, 1, 1, 1, 1, 1, 1],
            [-4, -1, -1, -1, -1, 2, 2, 2, 2],
            [4, -2, -2, -2, -2, 1, 1, 1, 1],
            [0, 1, 0, -1, 0, 1, -1, -1, 1],
            [0, -2, 0, 2, 0, 1, -1, -1, 1],
            [0, 0, 1, 0, -1, 1, 1, -1, -1],
            [0, 0, -2, 0, 2, 1, 1, -1, -1],
            [0, 1, -1, 1, -1, 0, 0, 0, 0],
            [0, 0, 0, 0, 0, 1, -1, 1, -1],
        ],
        dtype=np.float64,
    )
    s7 = 1.0 / tau
    s4 = 8.0 * (2.0 - s7) / (8.0 - s7)
    S = np.array([0.0, s7, s7, 0.0, s4, 0.0, s4, s7, s7])
    Minv = np.linalg.inv(M)
    MinvSM = Minv @ (S[:, None] * M)

    MinvSM_conv = None
    if tau_D is not None:
        s3 = 1.0 / tau_D
        S_conv = np.array([1.0, 1.1, 1.1, s3, s3, s3, s3, 1.2, 1.2])
        MinvSM_conv = Minv @ (S_conv[:, None] * M)
    return MinvSM, MinvSM_conv


def mrt_collide(
    f,
    rho,
    vel,
    flags,
    minv_s_m,
    tau: float,
    force=None,
    mesh_grid=None,
    is_convection: bool = False,
    axisymmetric_type: int = 0,
    dx: float = 1.0,
    dt: float = 1.0,
):
    """MRT collision ``f + M^-1 S M (feq - f) + dt Gi`` with OBSTACLE
    passthrough. The 9x9 moment contraction is written out as float32
    multiply-adds in a fixed order, so no matrix unit (TF32) ever rounds
    it."""
    feq_ = feq(rho, vel, dx=dx, dt=dt, force=force)
    A = [[float(x) for x in row] for row in np.asarray(minv_s_m, dtype=np.float64)]
    d = feq_ - f
    omega = torch.stack([
        sum((A[a][b] * d[b] for b in range(1, 9)), A[a][0] * d[0]) for a in range(9)
    ])
    Gi = axisymmetric_source(
        rho, vel, flags, feq_, mesh_grid, tau, int(axisymmetric_type),
        is_convection=is_convection, dx=dx, dt=dt,
    )
    collided = f + omega + dt * Gi
    return torch.where((flags == int(CellType.OBSTACLE))[None], f, collided)


# ---------------------------------------------------------------------------
# KBC (entropic)
# ---------------------------------------------------------------------------

# Raw-moment matrix (rows: M00 M10 M01 M20 M11 M02 M21 M12 M22),
# `LBM_collision_KBC_2d.py:38-55`.
KBC_C_MAT = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1],
        [0, 1, 0, -1, 0, 1, -1, -1, 1],
        [0, 0, 1, 0, -1, 1, 1, -1, -1],
        [0, 1, 0, 1, 0, 1, 1, 1, 1],
        [0, 0, 0, 0, 0, 1, -1, 1, -1],
        [0, 0, 1, 0, 1, 1, 1, 1, 1],
        [0, 0, 0, 0, 0, 1, 1, -1, -1],
        [0, 0, 0, 0, 0, 1, -1, -1, 1],
        [0, 0, 0, 0, 0, 1, 1, 1, 1],
    ],
    dtype=np.float64,
)

# Central-moment exponents (`LBM_collision_KBC_2d.py:57-68`), moment
# order [00, 10, 01, 20, 11, 02, 21, 12, 22].
KBC_P = np.array([0, 1, 0, 2, 1, 0, 2, 1, 2], dtype=np.int32)
KBC_Q = np.array([0, 0, 1, 0, 1, 2, 1, 2, 2], dtype=np.int32)

# the moments the shear split reads: M20, M11, M02
_SHEAR_MOMENTS = (3, 4, 5)


def resolve_kbc_type(kbc_type: int | None) -> int:
    """The KBC type a "kbc" scene runs: ``kbc_type``, or KBC_A when it is
    None, the variant the reference demo passes (`demo_2d_LBM_KBC.py:102`)."""
    return int(KBCType.KBC_A) if kbc_type is None else int(kbc_type)


def _power(x, n: int):
    """``x ** n`` for n in 0..2 as products (None for n = 0)."""
    return None if n == 0 else (x if n == 1 else x * x)


def _kbc_moments(f, vel, kbc: int):
    """``[M20, M11, M02]`` of ``f``: central moments (c e - u)^p (c e - u)^q
    per cell for KBC A/B (c = 1, as the reference hard-codes), raw moments
    (rows of `KBC_C_MAT`) for C/D; summed over q in order."""
    central = kbc in (int(KBCType.KBC_A), int(KBCType.KBC_B))
    if central:
        du = [float(lattice.E[q, 0]) - vel[0] for q in range(9)]
        dv = [float(lattice.E[q, 1]) - vel[1] for q in range(9)]
    out = []
    for m in _SHEAR_MOMENTS:
        acc = None
        for q in range(9):
            if central:
                bx, by = _power(du[q], int(KBC_P[m])), _power(dv[q], int(KBC_Q[m]))
                basis = bx if by is None else (by if bx is None else bx * by)
                term = basis * f[q]
            else:
                c = float(KBC_C_MAT[m, q])
                if c == 0.0:
                    continue
                term = f[q] if c == 1.0 else c * f[q]
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def kbc_omega(rho, vel, f, feq_, tau: float, kbc_type: int):
    """Entropic collision operator Omega = -beta (2 ds + gamma dh)
    (`LBM_collision_KBC_2d.py:70-249`): ds the shear part of f - feq
    from its second moments, dh the rest, gamma the entropic stabiliser
    (2 for LBGK, where dh = 0)."""
    kbc = int(kbc_type)
    if kbc not in {int(k) for k in KBCType}:
        raise ValueError(f"unknown KBC type {kbc_type}")
    df = f - feq_
    beta = 1.0 / (2.0 * tau)
    if kbc == int(KBCType.LBGK):
        return -beta * (2.0 * df)

    include_T = kbc in (int(KBCType.KBC_A), int(KBCType.KBC_C))
    u, v = vel[0], vel[1]

    def shear_parts(m20, m11, m02):
        T, N, PIxy = m20 + m02, m20 - m02, m11
        if include_T:
            s0 = rho - T
            sp = 0.5 * (0.5 * (T + N))
            sq = 0.5 * (0.5 * (T - N))
        else:
            s0 = rho
            sp = 0.5 * (0.5 * N)
            sq = 0.5 * (0.5 * (-N))
        return torch.stack([
            s0, sp + 0.5 * rho * u, sq + 0.5 * rho * v, sp - 0.5 * rho * u,
            sq - 0.5 * rho * v, 0.25 * PIxy, -0.25 * PIxy, 0.25 * PIxy, -0.25 * PIxy,
        ])

    ds = shear_parts(*_kbc_moments(f, vel, kbc)) - shear_parts(*_kbc_moments(feq_, vel, kbc))
    dh = df - ds
    eps = 1e-10
    dsdh = torch.sum(ds * dh / (feq_ + eps), dim=0)
    dhdh = torch.sum(dh * dh / (feq_ + eps), dim=0)
    gamma = 1.0 / beta - (2.0 - 1.0 / beta) * (dsdh / (dhdh + eps))
    return -beta * (2.0 * ds + gamma[None] * dh)


def kbc_collide(
    f,
    rho,
    vel,
    flags,
    tau: float,
    kbc_type: int,
    force=None,
    mesh_grid=None,
    is_convection: bool = False,
    axisymmetric_type: int = 0,
    dx: float = 1.0,
    dt: float = 1.0,
):
    """KBC collision ``f + Omega + dt Gi`` with OBSTACLE passthrough
    (`LBM_collision_KBC_2d.py:251-317`)."""
    feq_ = feq(rho, vel, dx=dx, dt=dt, force=force)
    Gi = axisymmetric_source(
        rho, vel, flags, feq_, mesh_grid, tau, int(axisymmetric_type),
        is_convection=is_convection, dx=dx, dt=dt,
    )
    omega = kbc_omega(rho, vel, f, feq_, tau, kbc_type)
    collided = f + omega + dt * Gi
    return torch.where((flags == int(CellType.OBSTACLE))[None], f, collided)
