"""The port's plain sharded path (`jrl_lbm_torch/parallel/padded_ops.py`,
`parallel/sharded.py`) against the JAX package's functions, case for case
as `tests/test_parallel.py` holds JAX's sharded steps, at its sizes and
tolerances, on a local mesh of 8 CPU shards.

Inputs come from the JAX init (and seeded numpy draws for the padded
ops), through `state_from_numpy`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import cylinder as cyl
from jrl_lbm_tpu.models import jrl
from jrl_lbm_tpu.ops import stream as _stream
from jrl_lbm_torch.models import cylinder as TC
from jrl_lbm_torch.models import jrl as TJ
from jrl_lbm_torch.parallel import halo as H_
from jrl_lbm_torch.parallel import make_mesh, make_single_domain, pad_periodic
from jrl_lbm_torch.parallel import padded_ops as pops
from jrl_lbm_torch.parallel import sharded as S
from jrl_lbm_torch.utils.device import state_from_numpy
from jrl_lbm_torch.utils.types import CellType

TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_parallel.py: sharded vs unsharded


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cyl_cfgs(res=(48, 32), **kw):
    kw = dict(dict(D=7.4, Re=500.0, cylinder_center=(16.0, 16.0)), **kw)
    return cyl.CylinderConfig(res=res, **kw), TC.CylinderConfig(res=res, **kw)


def test_make_domain_takes_the_card_or_raises():
    """No CPU default: without a device the index tensors go to the card,
    and without a card the call raises."""
    if torch.cuda.is_available():
        assert H_.make_domain((4, 4), (8, 8), (1, 1)).gy.device.type == "cuda"
        assert make_single_domain((4, 4)).gx.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            H_.make_domain((4, 4), (8, 8), (1, 1))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_single_domain((4, 4))
    d = H_.make_domain((4, 4), (8, 8), (1, 0), device="cpu")
    assert d.gy.device.type == "cpu" and int(d.gy[0, 0]) == 4 and int(d.gx[0, -1]) == 3


def test_padded_propagate_matches_core_single_device():
    """The padded op on a periodic-padded single block == JAX's core op."""
    rng = np.random.default_rng(0)
    H, W = 12, 10
    f = rng.uniform(0.1, 1.0, size=(9, H, W)).astype(np.float32)
    flags = rng.choice([int(CellType.FLUID), int(CellType.OBSTACLE), int(CellType.OUTFLOW),
                        int(CellType.INFLOW), int(CellType.INFLOW_2)],
                       size=(H, W)).astype(np.int32)
    phi = rng.uniform(-0.5, 1.5, size=(H, W)).astype(np.float32)
    rho = rng.uniform(0.5, 1.5, size=(H, W)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, size=(2, H, W)).astype(np.float32)
    iv = np.array([0.01, 0.02], np.float32)

    rho_c, vel_c, f_c = _stream.propagate(
        jnp.asarray(f), jnp.asarray(flags), phi_obs=jnp.asarray(phi), rho=jnp.asarray(rho),
        vel=jnp.asarray(vel), inflow_vel=iv, inflow_density=0.7)
    dom = make_single_domain((H, W), device="cpu")
    rho_p, vel_p, f_p = pops.propagate_padded(
        pad_periodic(_t(f)), pad_periodic(_t(flags)), dom, phi_obs=_t(phi), rho=_t(rho),
        vel=_t(vel), inflow_vel=iv, inflow_density=0.7)
    tol = dict(rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_c), **tol)
    np.testing.assert_allclose(rho_p.numpy(), np.asarray(rho_c), **tol)
    np.testing.assert_allclose(vel_p.numpy(), np.asarray(vel_c), **tol)


def test_padded_propagate_axisymmetric_matches_core():
    rng = np.random.default_rng(3)
    H, W = 12, 8
    f = rng.uniform(0.1, 1.0, size=(9, H, W)).astype(np.float32)
    flags = rng.choice([int(CellType.FLUID), int(CellType.FLUID), int(CellType.OBSTACLE),
                        int(CellType.OUTFLOW)], size=(H, W)).astype(np.int32)
    phi = rng.uniform(-0.5, 1.5, size=(H, W)).astype(np.float32)

    _, _, f_c = _stream.propagate(jnp.asarray(f), jnp.asarray(flags), phi_obs=jnp.asarray(phi),
                                  axisymmetric_type=1)
    dom = make_single_domain((H, W), axisymmetric_type=1, device="cpu")
    _, _, f_p = pops.propagate_padded(pad_periodic(_t(f)), pad_periodic(_t(flags)), dom,
                                      phi_obs=_t(phi))
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_c), rtol=2e-6, atol=2e-7)


def test_padded_stencils_match_the_ports_whole_grid_ops():
    """grad, div, coupling and macro (with the contact angle) on a
    periodic-padded single block == the port's whole-grid ops, exactly:
    the same operations on the same values."""
    from jrl_lbm_torch.ops import coupling, macro, stencil

    rng = np.random.default_rng(4)
    H, W = 10, 12
    flags = _t(rng.choice([1, 1, 1, 2, 16], size=(H, W)).astype(np.int32))
    a = _t(rng.uniform(0.5, 1.5, (H, W)).astype(np.float32))
    vel = _t(rng.uniform(-0.1, 0.1, (2, H, W)).astype(np.float32))
    f = _t(rng.uniform(0.01, 0.2, (9, H, W)).astype(np.float32))
    phi = _t(rng.uniform(-0.5, 1.5, (H, W)).astype(np.float32))
    for ax in (0, 1):
        dom = make_single_domain((H, W), axisymmetric_type=ax, device="cpu")
        fp = pad_periodic(flags)
        assert torch.equal(pops.grad_padded(pad_periodic(a), fp, dom),
                           stencil.get_grad(a, flags, axisymmetric_type=ax))
        assert torch.equal(pops.div_padded(pad_periodic(vel), fp, dom),
                           stencil.get_div(vel, flags, axisymmetric_type=ax))
        assert torch.equal(
            pops.solve_boundary_padded(pad_periodic(vel), fp, f, phi, dom,
                                       obs_vel_p=pad_periodic(0.5 * vel), tau=0.8),
            coupling.solve_boundary(vel, flags, f, phi, obs_vel=0.5 * vel, tau=0.8,
                                    axisymmetric_type=ax))
    dom = make_single_domain((H, W), device="cpu")
    for ca in (None, 0.3 * np.pi):
        got = pops.macro_padded(f, a, vel, flags, dom, contact_angle=ca)
        want = macro.macro_compute(f, a, vel, flags, contact_angle=ca)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _assert_coupling_mask_nonempty(fields):
    flags = np.asarray(fields["flags"])
    phi = np.asarray(fields["phi_obs"])
    is_obs = flags == int(CellType.OBSTACLE)
    t_ok = (phi > -1e-10) & (phi <= 1.0 + 1e-10)
    has_obs_nbr = np.zeros_like(is_obs)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                has_obs_nbr |= np.roll(is_obs, (-dy, -dx), axis=(0, 1))
    mask = (~is_obs) & t_ok & has_obs_nbr
    mask[-1, :] = False
    mask[:, -1] = False
    assert mask.sum() > 0, "no cell triggers the curved-boundary reconstruction"


@pytest.mark.parametrize("mesh_shape", [(2, 4)])
def test_sharded_cylinder_step_matches_unsharded(mesh_shape):
    """12 steps of the sharded cylinder step == JAX's single-device step."""
    cj, ct = _cyl_cfgs()
    state, fields = cyl.init(cj)
    _assert_coupling_mask_nonempty(fields)
    ref = cyl.make_runner(cj)(state, fields, 12)

    mesh = _mesh(mesh_shape)
    ss, sf = S.shard_state(state_from_numpy(state, "cpu"), state_from_numpy(fields, "cpu"), mesh)
    out = S.gather_state(S.make_sharded_cylinder_runner(ct, mesh)(ss, sf, 12), mesh)
    for k in ("f", "rho", "vel"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


def test_sharded_step_is_actually_sharded():
    cj, ct = _cyl_cfgs()
    state, fields = cyl.init(cj)
    mesh = _mesh((2, 4))
    ss, sf = S.shard_state(state_from_numpy(state, "cpu"), state_from_numpy(fields, "cpu"), mesh)
    out = S.make_sharded_cylinder_step(ct, mesh)(ss, sf)
    assert {tuple(b.shape) for b in out["f"]} == {(9, 24, 8)}
    assert len(out["f"]) == 8 and len(sf["inflow_vel"]) == 8
    st, fl = S.state_shardings(mesh)
    assert st["f"] == (None, "dy", "dx") and fl["inflow_vel"] == ()


def test_sharded_jrl_fluid_matches_unsharded():
    """Sharded axisymmetric moving-tip step == JAX's single-device step."""
    Re = 4.0
    kw = dict(res=(48, 32), Re=Re, vel_obs_real=Re * 0.89e-6 / 1.25e-5,
              gravity_strength_real=0.0, shape="cylinder")
    cj, ct = jrl.JRLFluidConfig(**kw), TJ.JRLFluidConfig(**kw)
    state, fields = jrl.fluid_init(cj)
    ref = jrl.make_fluid_runner(cj)(state, fields, jnp.asarray(0, jnp.int32), 15)

    mesh = _mesh((2, 4))
    ss, sf = S.shard_jrl_state(state_from_numpy(state, "cpu"),
                               state_from_numpy(fields, "cpu"), mesh)
    out = S.gather_state(S.make_sharded_jrl_fluid_runner(ct, mesh)(ss, sf, 0, 15), mesh)
    for k in ("f", "vel"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_sharded_c_balance_matches_unsharded(shape):
    kw = dict(res=(48, 32), Re=4.0, Pe=5.0, shape=shape)
    cj, ct = jrl.JRLCConfig(**kw), TJ.JRLCConfig(**kw)
    state, fields, flags = jrl.c_init(cj)
    ref = jrl.make_balance_runner(cj, flags)(state, fields, 20)

    mesh = _mesh((2, 4))
    ss, sf, sfl = S.shard_c_state(state_from_numpy(state, "cpu"),
                                  state_from_numpy(fields, "cpu"), mesh,
                                  flags=torch.as_tensor(np.array(flags)))
    out = S.gather_state(S.make_sharded_balance_runner(ct, mesh)(ss, sf, sfl, 20), mesh)
    for k in ("C", "h"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("mesh_shape", [(2, 4)])
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_sharded_c_approach_matches_unsharded(shape, mesh_shape):
    """Sharded approach step (+ psum disk integrals) == JAX's
    single-device step, both integral forms."""
    kw = dict(res=(48, 32), Re=4.0, Pe=5.0, shape=shape)
    cj, ct = jrl.JRLCConfig(**kw), TJ.JRLCConfig(**kw)
    state, fields, _ = jrl.c_init(cj)
    vel_field = np.random.default_rng(7).uniform(-0.5, 0.5, size=(4, 2, 48, 32)).astype(
        np.float32)
    fields = dict(fields, vel_field=jnp.asarray(vel_field))
    ref_state, ref_acc = jrl.make_approach_runner(cj)(state, fields, jnp.asarray(0, jnp.int32), 15)

    mesh = _mesh(mesh_shape)
    ss, sf = S.shard_c_state(state_from_numpy(state, "cpu"), state_from_numpy(fields, "cpu"),
                             mesh)
    out, acc = S.make_sharded_approach_runner(ct, mesh)(ss, sf, 0, 15)
    out = S.gather_state(out, mesh)
    for k in ("C", "h"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_state[k]), err_msg=k, **TOL)
    for k in ("inflow_sum", "current_sum", "count", "rec_u", "rec_v"):
        np.testing.assert_allclose(float(acc[k]), float(ref_acc[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_dryrun_eight_shards():
    """The port's version of `__graft_entry__.py`'s dry run: 8 shards,
    tiny shapes; the cylinder, JRL fluid, balance and approach steps give
    finite fields equal to the port's unsharded plain steps (1e-4 / 1e-6)."""
    mesh = _mesh((2, 4))
    ny, nx = mesh.shape
    Hc, Wc = 8 * ny, 8 * nx
    ct = TC.CylinderConfig(res=(Hc, Wc), D=3.1, Re=100.0, cylinder_center=(Wc / 2.0, Hc / 2.0))
    state, fields = TC.init(ct, "cpu")
    ss, sf = S.shard_state(state, fields, mesh)
    out = S.gather_state(S.make_sharded_cylinder_step(ct, mesh)(ss, sf), mesh)
    ref = TC.make_step(ct)(state, fields)
    for k in ("f", "rho", "vel"):
        assert torch.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), err_msg=k, **TOL)

    Re = 4.0
    jH, jW = ((max(48, Hc) + ny - 1) // ny) * ny, ((max(32, Wc) + nx - 1) // nx) * nx
    fc = TJ.JRLFluidConfig(res=(jH, jW), Re=Re, vel_obs_real=Re * 0.89e-6 / 1.25e-5,
                           gravity_strength_real=0.0, shape="cylinder")
    js, jf = TJ.fluid_init(fc, "cpu")
    ss, sf = S.shard_jrl_state(js, jf, mesh)
    out = S.gather_state(S.make_sharded_jrl_fluid_step(fc, mesh)(ss, sf, 0), mesh)
    ref = TJ.make_fluid_step(fc)(js, jf, 0)
    for k in ("f", "rho", "vel"):
        assert torch.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), err_msg=k, **TOL)

    cc = TJ.JRLCConfig(res=(jH, jW), Re=Re, Pe=5.0, shape="45degree")
    cs, cf, cflags = TJ.c_init(cc, "cpu")
    cf = dict(cf, vel_field=torch.zeros((2, 2) + cc.eff_res))
    ss, sf, sfl = S.shard_c_state(cs, cf, mesh, flags=cflags)
    ss = S.make_sharded_balance_step(cc, mesh)(ss, sf, sfl)
    ss, ints = S.make_sharded_approach_step(cc, mesh)(ss, sf, 0)
    out = S.gather_state(ss, mesh)
    cs = TJ.make_balance_step(cc, cflags)(cs, cf)
    cs, ints_ref = TJ.make_approach_step(cc)(cs, cf, 0)
    for k in ("C", "h"):
        assert torch.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k].numpy(), cs[k].numpy(), err_msg=k, **TOL)
    for g, w in zip(ints, ints_ref):
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4, atol=1e-5)
