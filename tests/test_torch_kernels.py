"""The four kernel modules of the PyTorch port: each plain twin against the
JAX package's jnp step and, for a short case, against its Pallas kernel
in TPU interpret mode, and the wrappers' CPU contract. The CUDA kernels
against their twins, on a card, are in `test_torch_cuda.py`.

Tolerances: one step rtol = atol = 1e-5 against jnp; over a few steps
and against the Pallas kernels (which fold divides into reciprocals) the
trajectory tolerances of `tests/test_fused_jrl_tiled.py` (2e-5, vel
2e-4, integrals rtol 2e-4 / atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_torch import kernels
from jrl_lbm_torch.kernels import build, jrl_c, jrl_fluid
from jrl_lbm_torch.models import jrl as T

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4, "C": 2e-5, "h": 2e-5}


def _fluid_kw(shape, res=(48, 32)):
    return dict(res=res, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8, shape=shape)


def _c_kw(shape, res=(48, 32)):
    return dict(res=res, Re=4.0, Pe=5.0, shape=shape)


def _close(got, want, tol, tag):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=tag)


def _warm_fluid(shape, n=14, res=(48, 32)):
    """Configs and a JAX state ``n`` steps in (fields non-trivial, tip moved)."""
    jc, tc = J.JRLFluidConfig(**_fluid_kw(shape, res)), T.JRLFluidConfig(**_fluid_kw(shape, res))
    js, jf = J.fluid_init(jc)
    step = jax.jit(J.make_fluid_step(jc))
    for i in range(n):
        js = step(js, jf, jnp.asarray(i, jnp.int32))
    return jc, tc, js, jf, step


@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_fluid_twins_match_jnp_step(shape):
    n = 14
    jc, tc, js, jf, step = _warm_fluid(shape, n)
    ref = step(js, jf, jnp.asarray(n, jnp.int32))
    _, tf = T.fluid_init(tc, "cpu")
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    f, rho, vel = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], n, tc, tf)
    f = jrl_fluid.fluid_b_ref(f, rho, vel, n, tc, tf)
    for key, val in (("f", f), ("rho", rho), ("vel", vel)):
        _close(val, ref[key], STEP_TOL["rtol"], f"{shape}:{key}")


def _warm_c(shape, n_bal=6):
    jc, tc = J.JRLCConfig(**_c_kw(shape)), T.JRLCConfig(**_c_kw(shape))
    js, jf, jflags = J.c_init(jc)
    js = J.make_balance_runner(jc, jflags)(js, jf, n_bal)
    _, tf, tflags = T.c_init(tc, "cpu")
    return jc, tc, js, jf, jflags, tf, tflags


@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_c_twins_match_jnp_steps(shape):
    jc, tc, js, jf, jflags, tf, tflags = _warm_c(shape)
    s = T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")

    ref = J.make_balance_step(jc, jflags)(js, jf)
    h, C = jrl_c.c_balance_ref(s["h"], s["C"], tflags, tc, tf)
    _close(h, ref["h"], 1e-5, "balance:h")
    _close(C, ref["C"], 1e-5, "balance:C")

    vf = np.random.default_rng(3).uniform(-0.5, 0.5, size=(4, 2, 48, 32)).astype(np.float32)
    jf = dict(jf, vel_field=jnp.asarray(vf))
    k = 17
    ref, ref_ints = J.make_approach_step(jc)(js, jf, jnp.asarray(k, jnp.int32))
    vel = T.stored_velocity(torch.as_tensor(vf), k, tc.vel_obs_conv)
    h, C, ints = jrl_c.c_approach_ref(s["h"], s["C"], vel, k, tc, tf)
    _close(h, ref["h"], 1e-5, "approach:h")
    _close(C, ref["C"], 1e-5, "approach:C")
    np.testing.assert_allclose([float(x) for x in ints], [float(x) for x in ref_ints],
                               rtol=2e-4, atol=1e-4)


# --- against the Pallas kernels of fused_jrl_tiled.py, interpret mode ---

def test_fluid_twins_match_pallas_kernels():
    from jax.experimental.pallas import tpu as pltpu

    from jrl_lbm_tpu.ops.pallas import fused_jrl_tiled as tiled

    jc, tc = J.JRLFluidConfig(**_fluid_kw("45degree")), T.JRLFluidConfig(**_fluid_kw("45degree"))
    js, jf = J.fluid_init(jc)
    run = tiled.make_tiled_fluid_runner(jc, tile_rows=8, unroll=4)
    with pltpu.force_tpu_interpret_mode():
        out = jax.tree.map(np.asarray, run(js, jf, jnp.asarray(0, jnp.int32), 4))
    ts, tf = T.fluid_init(tc, "cpu")
    got = T.pick_fluid_runner(tc)(ts, tf, 0, 4)
    for key in ("f", "rho", "vel"):
        _close(got[key], out[key], TRAJ_TOL[key], key)


def test_c_twins_match_pallas_kernels():
    from jax.experimental.pallas import tpu as pltpu

    from jrl_lbm_tpu.ops.pallas import fused_jrl_tiled as tiled

    jc, tc = J.JRLCConfig(**_c_kw("45degree")), T.JRLCConfig(**_c_kw("45degree"))
    js, jf, jflags = J.c_init(jc)
    vf = np.random.default_rng(11).uniform(-0.5, 0.5, size=(4, 2, 48, 32)).astype(np.float32)
    bal = tiled.make_tiled_balance_runner(jc, jflags, tile_rows=8, unroll=4)
    app = tiled.make_tiled_approach_runner(jc, jnp.asarray(vf), tile_rows=8, unroll=4)
    with pltpu.force_tpu_interpret_mode():
        b_out = bal(js, jf, 4)
        a_out, a_acc = app(b_out, jf, 0, 4)
        b_out, a_out, a_acc = jax.tree.map(np.asarray, (b_out, a_out, a_acc))

    ts, tf, tflags = T.c_init(tc, "cpu")
    tb = T.pick_balance_runner(tc, tflags)(ts, tf, 4)
    ta, tacc = T.pick_approach_runner(tc, torch.as_tensor(vf))(tb, tf, 0, 4)
    for key in ("C", "h"):
        _close(tb[key], b_out[key], TRAJ_TOL[key], f"balance:{key}")
        _close(ta[key], a_out[key], TRAJ_TOL[key], f"approach:{key}")
    for key in ("inflow_sum", "current_sum", "count", "rec_u", "rec_v"):
        np.testing.assert_allclose(float(tacc[key]), float(a_acc[key]), rtol=2e-4, atol=1e-4,
                                   err_msg=key)


# --- the wrappers' contract on a machine without CUDA ---

def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.fluid_init(T.JRLFluidConfig(**_fluid_kw("45degree")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.c_init(T.JRLCConfig(**_c_kw("45degree")))


def test_wrappers_import_and_run_cpu_without_nvcc(monkeypatch):
    """Importing builds nothing; CPU tensors go to the twins and never
    reach nvcc or the launch counters."""
    assert build._libs == {}
    assert set(kernels.wrappers()) == set(kernels.KERNELS)
    for name in build.NAMES:
        assert (build.CSRC / f"{name}.cu").is_file()

    def no_nvcc():
        raise AssertionError("nvcc must not be needed for CPU tensors")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    kernels.reset_launches()
    tc = T.JRLFluidConfig(**_fluid_kw("45degree"))
    s, f = T.fluid_init(tc, "cpu")
    T.pick_fluid_runner(tc)(s, f, 0, 1)
    cc = T.JRLCConfig(**_c_kw("cylinder"))
    st, cf, flags = T.c_init(cc, "cpu")
    st = T.pick_balance_runner(cc, flags)(st, cf, 1)
    T.pick_approach_runner(cc, torch.zeros((2, 2, 48, 32)))(st, cf, 0, 1)
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def test_wrappers_refuse_bad_tensors():
    tc = T.JRLFluidConfig(**_fluid_kw("45degree"))
    f = torch.zeros((9, 48, 32))
    with pytest.raises(ValueError, match="card"):
        jrl_fluid.check_state(tc, 0, f=(f, (9,)))
    with pytest.raises(ValueError, match="shape"):
        jrl_fluid.check_state(tc, 0, f=(f[:8], (9,)))
    # steps from 2**24 on are taken (float32 rounds them, as the jnp step
    # does); only steps outside int32 are refused
    with pytest.raises(ValueError, match="card"):
        jrl_fluid.check_state(tc, 2**24, f=(f, (9,)))
    with pytest.raises(ValueError, match="int32"):
        jrl_fluid.check_state(tc, 2**31, f=(f, (9,)))
