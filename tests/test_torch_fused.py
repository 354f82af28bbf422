"""The multi-step module of the PyTorch port (`kernels/fused_jrl.py`) on
the CPU, where each wrapper runs its plain twin: against the JAX
package's whole-domain runners of `ops/pallas/fused_jrl.py` in TPU
interpret mode (as `tests/test_fused_jrl.py` runs them), the runners'
contract, and steps past 2**24 against the JAX package's jnp step. The
CUDA kernels against these twins, on a card, are in `test_torch_cuda.py`.

Inputs come from numpy with a seed; JAX states enter the port through
`models/jrl.py::state_from_numpy`. Tolerances are those of
`tests/test_fused_jrl.py`: f and rho 2e-5, vel 2e-4, h and C 1e-5, the
integrals rtol = atol = 1e-4 (the Pallas kernels fold divides into
reciprocals and sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.models import jrl as J
from jrl_lbm_tpu.ops.pallas import fused_jrl as JF
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.kernels import jrl_fluid
from jrl_lbm_torch.models import jrl as T

RES = (48, 32)


def _fluid_kw(shape, **kw):
    return dict(dict(res=RES, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                     shape=shape), **kw)


def _c_kw(shape, is_negative=True, Pe=5.0):
    return dict(res=RES, Re=4.0, Pe=Pe, vel_obs_real=0.2848, shape=shape,
                is_negative=is_negative)


def _close(got, want, tol, tag):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=tag)


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


# --- against the Pallas runners of fused_jrl.py, interpret mode ---

def test_fused_fluid_matches_pallas():
    jc, tc = J.JRLFluidConfig(**_fluid_kw("45degree")), T.JRLFluidConfig(**_fluid_kw("45degree"))
    n = 12
    js, jf = J.fluid_init(jc)
    with _interpret():
        out = JF.make_fused_fluid_runner(jc)(js, jf, jnp.asarray(0, jnp.int32), n)
        out = jax.tree.map(np.asarray, out)
    _, tf = T.fluid_init(tc, "cpu")
    got = F.make_fused_fluid_runner(tc)(T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu"),
                                        tf, 0, n)
    for key, tol in (("f", 2e-5), ("rho", 2e-5), ("vel", 2e-4)):
        _close(got[key], out[key], tol, key)


@pytest.mark.parametrize("shape,is_negative", [("ethaline", True), ("cylinder", False)])
def test_fused_balance_matches_pallas(shape, is_negative):
    jc = J.JRLCConfig(**_c_kw(shape, is_negative))
    tc = T.JRLCConfig(**_c_kw(shape, is_negative))
    n = 10
    js, jf, jflags = J.c_init(jc)
    with _interpret():
        out = jax.tree.map(np.asarray, JF.make_fused_balance_runner(jc, jflags)(js, jf, n))
    _, tf, tflags = T.c_init(tc, "cpu")
    got = F.make_fused_balance_runner(tc, tflags)(
        T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu"), tf, n)
    for key in ("h", "C"):
        _close(got[key], out[key], 1e-5, f"{shape}:{key}")


@pytest.mark.parametrize("shape,is_negative,Pe", [
    ("ethaline", True, 3.0),   # a frame boundary every few steps
    ("cylinder", True, 3.0),
    ("ethaline", True, 0.05),  # one frame pair for the whole run
])
def test_fused_approach_matches_pallas(shape, is_negative, Pe):
    jc = J.JRLCConfig(**_c_kw(shape, is_negative, Pe))
    tc = T.JRLCConfig(**_c_kw(shape, is_negative, Pe))
    n = 8
    H, W = tc.eff_res
    vel_field = (0.1 * np.random.default_rng(0).standard_normal((3, 2, H, W))).astype(np.float32)
    js, jf, jflags = J.c_init(jc)
    js = J.make_balance_runner(jc, jflags)(js, jf, 4)
    with _interpret():
        out, acc = JF.make_fused_approach_runner(jc, vel_field)(js, jf, 0, n)
        out, acc = jax.tree.map(np.asarray, (out, acc))
    _, tf, _ = T.c_init(tc, "cpu")
    got, tacc = F.make_fused_approach_runner(tc, vel_field)(
        T.state_from_numpy(jax.tree.map(np.asarray, js), "cpu"), tf, 0, n)
    for key in ("h", "C"):
        _close(got[key], out[key], 1e-5, f"{shape}:{key}")
    for key in ("inflow_sum", "current_sum", "rec_u", "rec_v", "count"):
        np.testing.assert_allclose(float(tacc[key]), float(acc[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{shape}:{key}")


# --- the runners' contract ---

def _phase_runs(phase):
    """``(picked runner, per-step runner, state)`` of ``phase`` at 48x32,
    where the picked runner is the multi-step one; each runner is called
    ``(state, start, n) -> dict`` (the approach's with its acc)."""
    if phase == "fluid":
        cfg = T.JRLFluidConfig(**_fluid_kw("cylinder"))
        s, f = T.fluid_init(cfg, "cpu")
        fused, per_step = T.pick_fluid_runner(cfg), T.make_per_step_fluid_runner(cfg)
        return (lambda st, a, n: fused(st, f, a, n)), (lambda st, a, n: per_step(st, f, a, n)), s
    cfg = T.JRLCConfig(**_c_kw("45degree"))
    s, f, flags = T.c_init(cfg, "cpu")
    if phase == "balance":
        fused, per_step = T.pick_balance_runner(cfg, flags), \
            T.make_per_step_balance_runner(cfg, flags)
        return (lambda st, a, n: fused(st, f, n)), (lambda st, a, n: per_step(st, f, n)), s
    vf = torch.as_tensor(np.random.default_rng(7).uniform(-0.5, 0.5, (4, 2) + RES)
                         .astype(np.float32))
    fused, per_step = T.pick_approach_runner(cfg, vf), \
        T.make_per_step_approach_runner(cfg, vf)

    def flat(run):
        def call(st, a, n):
            out, acc = run(st, f, a, n)
            return dict(out, **{k: torch.as_tensor(v) for k, v in acc.items()})
        return call

    return flat(fused), flat(per_step), s


def _state_of(out):
    return {k: v for k, v in out.items() if k in ("f", "rho", "vel", "h", "C")}


@pytest.mark.parametrize("phase", ["fluid", "balance", "approach"])
def test_fused_runner_chunks_equal_one_call(phase, monkeypatch):
    """n steps in one call equal n1 + n2 steps in two calls, and a run
    split into several launches equals one launch."""
    fused, _, s = _phase_runs(phase)
    whole = fused(s, 0, 8)
    first = fused(s, 0, 5)
    second = fused(_state_of(first), 5, 3)
    H, W = RES
    # launches of 3, 3 and 2 steps
    monkeypatch.setattr(F, "MAX_LAUNCH_CELL_STEPS", dict.fromkeys(F.MAX_LAUNCH_CELL_STEPS, 3 * H * W))
    split = fused(s, 0, 8)
    for key in _state_of(whole):
        torch.testing.assert_close(second[key], whole[key], rtol=0, atol=0)
        torch.testing.assert_close(split[key], whole[key], rtol=0, atol=0)
    if phase == "approach":
        for key in ("inflow_sum", "current_sum"):
            torch.testing.assert_close(first[key] + second[key], whole[key], rtol=1e-6,
                                       atol=1e-7)
            torch.testing.assert_close(split[key], whole[key], rtol=1e-6, atol=1e-7)
        for key in ("rec_u", "rec_v"):
            torch.testing.assert_close(second[key], whole[key], rtol=0, atol=0)


@pytest.mark.parametrize("phase", ["fluid", "balance", "approach"])
def test_pick_runner_equals_per_step_runner(phase):
    fused, per_step, s = _phase_runs(phase)
    got, want = fused(s, 3, 6), per_step(s, 3, 6)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-7, msg=key)
    cf, cc = T.JRLFluidConfig(**_fluid_kw("45degree")), T.JRLCConfig(**_c_kw("45degree"))
    _, _, flags = T.c_init(cc, "cpu")
    vf = torch.zeros((2, 2) + RES)
    # the 48x32 configs are served by the multi-step runners
    assert T.pick_fluid_runner(cf).__qualname__.startswith("make_fused_fluid_runner")
    assert T.pick_balance_runner(cc, flags).__qualname__.startswith("make_fused_balance")
    assert T.pick_approach_runner(cc, vf).__qualname__.startswith("make_fused_approach")


@pytest.mark.parametrize("res,refine,shape", [
    ((48, 32), 1, "cylinder"), ((128, 64), 1, "ethaline"), ((128, 64), 4, "ethaline"),
    ((512, 256), 1, "45degree"), ((512, 257), 1, "cylinder"), ((128, 64), 8, "ethaline"),
])
def test_fits_agrees_with_fits_vmem(res, refine, shape):
    jc = J.JRLFluidConfig(res=res, refine=refine, shape=shape)
    tc = T.JRLFluidConfig(res=res, refine=refine, shape=shape)
    assert F.fits(tc) == JF.fits_vmem(jc)
    assert F.MAX_FUSED_CELLS == JF.MAX_FUSED_CELLS


def test_fused_runners_refuse_grid_over_limit():
    big = T.JRLFluidConfig(res=(1024, 512), shape="cylinder")
    big_c = T.JRLCConfig(res=(1024, 512), shape="cylinder")
    with pytest.raises(ValueError, match="exceeds"):
        F.make_fused_fluid_runner(big)
    with pytest.raises(ValueError, match="exceeds"):
        F.make_fused_balance_runner(big_c, torch.zeros((1024, 512), dtype=torch.int32))
    with pytest.raises(ValueError, match="exceeds"):
        F.make_fused_approach_runner(big_c, torch.zeros((1, 2, 1024, 512)))
    # a larger grid goes to the tile-class kernels instead (H % 8 == 0), or
    # to the per-step kernels
    assert T.pick_fluid_runner(big).__qualname__.startswith("make_tiled_fluid_runner")
    odd = T.JRLFluidConfig(res=(1020, 512), shape="cylinder")
    assert T.pick_fluid_runner(odd).__qualname__.startswith("make_per_step_fluid_runner")


def test_default_case_one_launch_per_interval():
    """The default 128x64 case: a record step (n = 1), the fluid steps
    between two records, a whole balance interval (`jrl_main.run_balance`)
    and the steps between two approach dumps are one launch each."""
    fc, cc = T.JRLFluidConfig(), T.JRLCConfig()
    assert F.fits(fc) and F.fits(cc)
    record = next(k for k in range(1, fc.total_steps) if int(k * fc.vel_obs / T.X_INTERVAL) > 0)
    interval = max(1, cc.balance_steps // 100)
    dumps = T.c_dump_steps(cc)
    dump = max(b - a for a, b in zip(dumps, dumps[1:]))
    assert (record, interval, dump) == (39_001, 255_528, 3_900)
    assert list(F._chunks(1, fc, "fused_fluid")) == [1]
    assert list(F._chunks(record, fc, "fused_fluid")) == [record]
    assert list(F._chunks(interval, cc, "fused_balance")) == [interval]
    assert list(F._chunks(dump, cc, "fused_approach")) == [dump]
    assert list(F._chunks(0, fc, "fused_fluid")) == []


# --- past step 2**24 ---

@pytest.mark.parametrize("shape", ["cylinder", "45degree"])
def test_fluid_step_past_2_24_matches_jnp(shape):
    """One plain fluid step at step 2**24 + 3 (float32 rounds it to
    2**24 + 4) against the JAX package's jnp step, with Re small enough
    that the tip is inside the grid there."""
    step = 2**24 + 3
    jc, tc = J.JRLFluidConfig(**_fluid_kw(shape, Re=1.2e-5)), \
        T.JRLFluidConfig(**_fluid_kw(shape, Re=1.2e-5))
    walks, walks_int = T.tip_walks(tc.inflow_height, step, tc.vel_obs)
    assert float(walks) == float(jc.inflow_height + jnp.float32(step) * jc.vel_obs)
    assert 1 < walks_int < RES[0] - 1
    js, jf = J.fluid_init(jc)
    rng = np.random.default_rng(24)
    js = {k: np.asarray(v) + (1e-3 * rng.standard_normal(np.shape(v))).astype(np.float32)
          for k, v in js.items()}
    ref = J.make_fluid_step(jc)({k: jnp.asarray(v) for k, v in js.items()}, jf,
                                jnp.asarray(step, jnp.int32))
    _, tf = T.fluid_init(tc, "cpu")
    got = T.make_fluid_step(tc)(T.state_from_numpy(js, "cpu"), tf, step)
    for key in ("f", "rho", "vel"):
        _close(got[key], ref[key], 1e-5, f"{shape}:{key}")


def test_wrapper_checks_accept_steps_past_2_24():
    tc = T.JRLFluidConfig(**_fluid_kw("45degree"))
    f = torch.zeros((9,) + RES)
    for step, n in ((2**24 - 5, 10), (2**24 + 3, 1), (2**31 - 8, 8)):
        with pytest.raises(ValueError, match="card"):  # refused for the device only
            jrl_fluid.check_state(tc, step, n, f=(f, (9,)))
    with pytest.raises(ValueError, match="int32"):
        jrl_fluid.check_state(tc, 2**31 - 8, 9, f=(f, (9,)))
    with pytest.raises(ValueError, match="int32"):
        jrl_fluid.check_state(tc, -1, f=(f, (9,)))
    with pytest.raises(ValueError, match="at least one"):
        jrl_fluid.check_state(tc, 0, 0, f=(f, (9,)))
