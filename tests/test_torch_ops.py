"""The PyTorch port's operator layer against the JAX package's jnp ops and
the sequential numpy oracles of `tests/oracle.py`.

Same numpy-seeded inputs through both; per-op tolerance rtol = atol =
1e-5 against jnp (float32 sums in another order, as
`test_collision_oracle.py`), and the JAX suite's own tolerances against
the float64 oracles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

import oracle
from jrl_lbm_tpu import lattice as jlat
from jrl_lbm_tpu.ops import collide as jcollide
from jrl_lbm_tpu.ops import coupling as jcoupling
from jrl_lbm_tpu.ops import equilibrium as jeq
from jrl_lbm_tpu.ops import macro as jmacro
from jrl_lbm_tpu.ops import stencil as jstencil
from jrl_lbm_tpu.ops import stream as jstream
from jrl_lbm_tpu.utils import types as jtypes
from jrl_lbm_torch import lattice as tlat
from jrl_lbm_torch.ops import collide as tcollide
from jrl_lbm_torch.ops import coupling as tcoupling
from jrl_lbm_torch.ops import equilibrium as teq
from jrl_lbm_torch.ops import macro as tmacro
from jrl_lbm_torch.ops import stencil as tstencil
from jrl_lbm_torch.ops import stream as tstream
from jrl_lbm_torch.utils import types as ttypes
from jrl_lbm_torch.utils.types import CellType

TOL = dict(rtol=1e-5, atol=1e-5)
ALL_TYPES = [1, 1, 1, int(CellType.OBSTACLE), int(CellType.OUTFLOW),
             int(CellType.INFLOW), int(CellType.INFLOW_2)]


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _state(rng, H, W):
    f = rng.uniform(0.1, 1.0, size=(9, H, W)).astype(np.float32)
    rho = rng.uniform(0.5, 1.5, size=(H, W)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, size=(2, H, W)).astype(np.float32)
    return f, rho, vel


def _mesh(H, W):
    iy, ix = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return np.stack([ix + 0.5, iy + 0.5]).astype(np.float32)


def test_lattice_tables_and_enums_match():
    for name in ("E", "W", "REFLECT", "MIRROR_X", "MIRROR_Y"):
        np.testing.assert_array_equal(getattr(tlat, name), getattr(jlat, name), err_msg=name)
    for name in ("AXIS_X_IN", "AXIS_X_OUT", "AXIS_Y_IN", "AXIS_Y_OUT", "Q", "CS2"):
        assert getattr(tlat, name) == getattr(jlat, name), name
    for enum in ("CellType", "AxiSymmetricType"):
        t_enum, j_enum = getattr(ttypes, enum), getattr(jtypes, enum)
        assert {m.name: int(m) for m in t_enum} == {m.name: int(m) for m in j_enum}


@pytest.mark.parametrize("with_force", [False, True])
def test_feq(with_force):
    rng = np.random.default_rng(1)
    H, W = 9, 7
    _, rho, vel = _state(rng, H, W)
    rho[0, 0] = 0.0  # the rho <= 1e-10 guard of the force shift
    force = (0.01 * rng.standard_normal((2, H, W))).astype(np.float32) if with_force else None
    got = teq.feq(_t(rho), _t(vel), force=_t(force))
    want = jeq.feq(_j(rho), _j(vel), force=_j(force))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_macro_compute_and_macro_C():
    rng = np.random.default_rng(2)
    H, W = 10, 8
    f, rho, vel = _state(rng, H, W)
    flags = rng.choice(ALL_TYPES, size=(H, W)).astype(np.int32)
    f[:, 1, 1] = 0.0  # safe-rho division
    flags[1, 1] = 1
    r_t, v_t = tmacro.macro_compute(_t(f), _t(rho), _t(vel), _t(flags))
    r_j, v_j = jmacro.macro_compute(_j(f), _j(rho), _j(vel), _j(flags))
    np.testing.assert_allclose(_np(r_t), _np(r_j), **TOL)
    np.testing.assert_allclose(_np(v_t), _np(v_j), **TOL)
    r_o, v_o = oracle.macro_oracle(f, rho, vel, flags)
    np.testing.assert_allclose(_np(r_t), r_o, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(_np(v_t), v_o, rtol=2e-5, atol=2e-6)

    C_t = tmacro.macro_compute_C(_t(f), _t(rho), _t(flags))
    np.testing.assert_allclose(_np(C_t), _np(jmacro.macro_compute_C(_j(f), _j(rho), _j(flags))),
                               **TOL)
    np.testing.assert_allclose(_np(C_t), oracle.macro_C_oracle(f, rho, flags),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize(
    "axisym,with_phi,with_macro,inflow_density",
    [
        (0, True, True, 0.7),
        (1, True, True, 0.7),
        (1, True, True, None),
        (1, False, True, 0.0),
        (0, False, False, None),
        (1, True, False, None),
    ],
)
def test_propagate(axisym, with_phi, with_macro, inflow_density):
    """All six cell types on random flags; x=0 axis mirroring, sub-grid
    bounce, INFLOW rho/u and the OUTFLOW second pass."""
    rng = np.random.default_rng(42 + axisym + 2 * with_phi + 4 * with_macro)
    H, W = 12, 10
    f, rho, vel = _state(rng, H, W)
    flags = rng.choice(ALL_TYPES, size=(H, W)).astype(np.int32)
    phi = rng.uniform(-0.5, 1.5, size=(H, W)).astype(np.float32) if with_phi else None
    if not with_macro:
        rho = vel = None
    kw = dict(inflow_density=inflow_density, axisymmetric_type=axisym)
    r_t, v_t, f_t = tstream.propagate(_t(f), _t(flags), phi_obs=_t(phi), rho=_t(rho),
                                      vel=_t(vel), **kw)
    r_j, v_j, f_j = jstream.propagate(_j(f), _j(flags), phi_obs=_j(phi), rho=_j(rho),
                                      vel=_j(vel), **kw)
    np.testing.assert_allclose(_np(f_t), _np(f_j), **TOL)
    if with_macro:
        np.testing.assert_allclose(_np(r_t), _np(r_j), **TOL)
        np.testing.assert_allclose(_np(v_t), _np(v_j), **TOL)
    else:
        assert r_t is None and v_t is None
    _, _, f_o = oracle.propagate_oracle(f, flags, phi_obs=phi, rho=rho, vel=vel, **kw)
    np.testing.assert_allclose(_np(f_t), f_o, rtol=2e-5, atol=2e-6)


def _flags_with_blob(rng, H, W):
    flags = np.full((H, W), int(CellType.FLUID), np.int32)
    flags[H // 2: H // 2 + 3, W // 2: W // 2 + 3] = int(CellType.OBSTACLE)
    flags[0, :] = rng.choice([int(CellType.OUTFLOW), int(CellType.OBSTACLE), 1], size=W)
    flags[-1, :] = int(CellType.OBSTACLE)
    return flags


@pytest.mark.parametrize("axisym", [0, 1])
def test_grad_and_div(axisym):
    rng = np.random.default_rng(10 + axisym)
    H, W = 12, 11
    _, rho, vel = _state(rng, H, W)
    flags = _flags_with_blob(rng, H, W)
    g_t = tstencil.get_grad(_t(rho), _t(flags), axisymmetric_type=axisym)
    g_j = jstencil.get_grad(_j(rho), _j(flags), axisymmetric_type=axisym)
    np.testing.assert_allclose(_np(g_t), _np(g_j), **TOL)
    np.testing.assert_allclose(_np(g_t), oracle.grad_oracle(rho, flags, axisymmetric_type=axisym),
                               rtol=2e-5, atol=2e-6)
    d_t = tstencil.get_div(_t(vel), _t(flags), axisymmetric_type=axisym)
    d_j = jstencil.get_div(_j(vel), _j(flags), axisymmetric_type=axisym)
    np.testing.assert_allclose(_np(d_t), _np(d_j), **TOL)
    np.testing.assert_allclose(_np(d_t), oracle.div_oracle(vel, flags, axisymmetric_type=axisym),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("with_obs_vel,axisym", [(False, 0), (True, 1), (True, 0)])
def test_solve_boundary(with_obs_vel, axisym):
    rng = np.random.default_rng(30 + axisym + 2 * with_obs_vel)
    H, W = 12, 10
    f, rho, vel = _state(rng, H, W)
    flags = np.full((H, W), int(CellType.FLUID), np.int32)
    flags[4:7, 3:6] = int(CellType.OBSTACLE)
    flags[4:7, 0] = int(CellType.OBSTACLE)
    flags[-1, :] = int(CellType.OBSTACLE)
    flags[0, :] = int(CellType.OUTFLOW)
    phi = rng.uniform(-0.5, 1.5, size=(H, W)).astype(np.float32)
    obs_vel = rng.uniform(-0.02, 0.02, size=(2, H, W)).astype(np.float32) if with_obs_vel else None
    kw = dict(tau=0.8, axisymmetric_type=axisym)
    got = tcoupling.solve_boundary(_t(vel), _t(flags), _t(f), _t(phi), obs_vel=_t(obs_vel),
                                   **kw)
    want = jcoupling.solve_boundary(_j(rho), _j(vel), _j(flags), _j(f), _j(phi),
                                    obs_vel=_j(obs_vel), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    f_o = oracle.solve_boundary_oracle(vel, flags, f, phi, obs_vel=obs_vel, **kw)
    np.testing.assert_allclose(_np(got), f_o, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("is_convection", [False, True])
def test_bgk_collide(is_convection):
    """Fluid branch (Guo force, A1/A2/F2 source) and convection branch
    (per-direction rate, Liu source) about x = 0."""
    rng = np.random.default_rng(3 + is_convection)
    H, W = 20, 14
    flags = rng.choice(ALL_TYPES, size=(H, W)).astype(np.int32)
    flags[-1, :] = int(CellType.OBSTACLE)
    f, rho, vel = _state(rng, H, W)
    force = None if is_convection else (0.01 * rng.standard_normal((2, H, W))).astype(np.float32)
    tau = 0.9 if is_convection else 0.8
    mesh = _mesh(H, W)
    kw = dict(tau=tau, is_convection=is_convection, axisymmetric_type=1)
    got = tcollide.bgk_collide(_t(f), _t(rho), _t(vel), _t(flags), force=_t(force),
                               mesh_grid=_t(mesh), **kw)
    want = jcollide.bgk_collide(_j(f), _j(rho), _j(vel), _j(flags), force=_j(force),
                                mesh_grid=_j(mesh), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    want_o = oracle.collision_oracle(f, rho, vel, flags, tau=tau, force=force,
                                     mesh=mesh.astype(np.float64),
                                     is_convection=is_convection, axisymmetric_type=1)
    np.testing.assert_allclose(_np(got), want_o, rtol=2e-5, atol=2e-6)


def test_axisymmetric_source_line_y():
    """The LINE_Y_EQ_0 branch (fluid and convection) as in JAX."""
    rng = np.random.default_rng(5)
    H, W = 10, 9
    f, rho, vel = _state(rng, H, W)
    flags = _flags_with_blob(rng, H, W)
    mesh = _mesh(H, W)
    for conv in (False, True):
        kw = dict(tau=0.8, is_convection=conv, axisymmetric_type=2)
        got = tcollide.bgk_collide(_t(f), _t(rho), _t(vel), _t(flags), mesh_grid=_t(mesh), **kw)
        want = jcollide.bgk_collide(_j(f), _j(rho), _j(vel), _j(flags), mesh_grid=_j(mesh),
                                    **kw)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_kbc_enum_and_predicates_match():
    for m in jtypes.KBCType:
        assert int(ttypes.KBCType[m.name]) == int(m)
        for pred in ("is_KBC", "is_KBC_AC", "is_KBC_BD", "is_KBC_AB", "is_KBC_CD"):
            assert getattr(ttypes, pred)(m) == getattr(jtypes, pred)(m), (pred, m)
    assert not ttypes.is_KBC(None)


def test_laplacian_and_rebounce():
    """The non-JRL rest of the slice's modules: the /5 laplacian quirk and
    the OBSTACLE bounce-back."""
    rng = np.random.default_rng(6)
    H, W = 11, 9
    f, rho, _ = _state(rng, H, W)
    flags = rng.choice(ALL_TYPES, size=(H, W)).astype(np.int32)
    np.testing.assert_allclose(_np(tstencil.get_laplacian(_t(rho))),
                               _np(jstencil.get_laplacian(_j(rho))), **TOL)
    np.testing.assert_array_equal(_np(tstream.rebounce_obstacle(_t(f), _t(flags))),
                                  _np(jstream.rebounce_obstacle(_j(f), _j(flags))))
