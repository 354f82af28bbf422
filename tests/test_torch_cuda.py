"""The CUDA kernels of the PyTorch port against their plain twins, on an
NVIDIA card; every test skips without one (the kernels have no CPU
mode). The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX for the rest
of the suite.)

Each per-step kernel is compared one step at a time with its twin, from
the twin's own trajectory, over steps in which the tip crosses a row.
Tolerances: f, rho, C and h at rtol = atol = 1e-5, vel at 1e-4 (float32
sums in another order); the tip-disk integrals at rtol 2e-4 / atol 1e-4.
Each multi-step kernel runs one launch of many steps (a tip-row crossing,
stored-velocity frame boundaries) against the loop of the twins, at the
trajectory tolerances: f, rho, C and h 2e-5, vel 2e-4.
"""

import ctypes

import numpy as np
import pytest
import torch

from jrl_lbm_torch.kernels import build, jrl_c, jrl_fluid
from jrl_lbm_torch.kernels import fused_jrl as F
from jrl_lbm_torch.models import jrl as T

RES = (128, 64)
# (shape, refine, Rg): the wedges, the flat tips (the infinite plane at the
# CLI's Rg = 200, wider than the grid) and a refined ethaline grid
SCENES = [("45degree", 1, 4.0), ("cylinder", 1, 4.0), ("infiniteplane", 1, 200.0),
          ("ethaline", 2, 4.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol, tag):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=lambda m: f"{tag}: {m}")


def _fluid_steps(dev, shape, refine, rg):
    """Yield ``(cfg, fields, state, k)`` along the twin's fluid trajectory,
    over steps in which the tip crosses a row."""
    cfg = T.JRLFluidConfig(res=RES, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                           shape=shape, refine=refine, Rg=rg)
    s, fields = T.fluid_init(cfg, dev)
    step = T.make_fluid_step(cfg)
    s = T.make_fluid_runner(cfg)(s, fields, 0, 8)
    steps = range(8, 8 + int(1.5 / cfg.vel_obs))
    assert T.tip_walks(cfg.inflow_height, steps[-1], cfg.vel_obs)[1] > T.tip_walks(
        cfg.inflow_height, steps[0], cfg.vel_obs)[1]
    for k in steps:
        yield cfg, fields, s, k
        s = step(s, fields, k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fluid_a_matches_twin(cuda, shape, refine, rg):
    n0, n = jrl_fluid.fluid_a.launches, 0
    for cfg, fields, s, k in _fluid_steps(cuda, shape, refine, rg):
        a = jrl_fluid.fluid_a(s["f"], s["rho"], s["vel"], k, cfg, fields)
        ar = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], k, cfg, fields)
        for name, got, want, tol in zip(("f", "rho", "vel"), a, ar, (1e-5, 1e-5, 1e-4)):
            _close(got, want, tol, f"fluid_a step {k} {name}")
        n += 1
    torch.cuda.synchronize()
    assert jrl_fluid.fluid_a.launches - n0 == n


@pytest.mark.cuda
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fluid_b_matches_twin(cuda, shape, refine, rg):
    n0, n = jrl_fluid.fluid_b.launches, 0
    for cfg, fields, s, k in _fluid_steps(cuda, shape, refine, rg):
        ar = jrl_fluid.fluid_a_ref(s["f"], s["rho"], s["vel"], k, cfg, fields)
        _close(jrl_fluid.fluid_b(*ar, k, cfg, fields), jrl_fluid.fluid_b_ref(*ar, k, cfg, fields),
               1e-5, f"fluid_b step {k} f")
        n += 1
    torch.cuda.synchronize()
    assert jrl_fluid.fluid_b.launches - n0 == n


def _c_setup(dev, shape, refine, rg, is_negative):
    cfg = T.JRLCConfig(res=RES, Re=4.0, Pe=5.0, shape=shape, refine=refine, Rg=rg,
                       is_negative=is_negative)
    st, fields, flags = T.c_init(cfg, dev)
    return cfg, T.make_balance_runner(cfg, flags)(st, fields, 5), fields, flags


@pytest.mark.cuda
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_c_balance_matches_twin(cuda, shape, refine, rg, is_negative):
    cfg, st, fields, flags = _c_setup(cuda, shape, refine, rg, is_negative)
    step = T.make_balance_step(cfg, flags)
    n0 = jrl_c.c_balance.launches
    for k in range(3):
        h, C = jrl_c.c_balance(st["h"], st["C"], flags, cfg, fields)
        hr, Cr = jrl_c.c_balance_ref(st["h"], st["C"], flags, cfg, fields)
        _close(h, hr, 1e-5, f"c_balance step {k} h")
        _close(C, Cr, 1e-5, f"c_balance step {k} C")
        st = step(st, fields)
    torch.cuda.synchronize()
    assert jrl_c.c_balance.launches - n0 == 3


@pytest.mark.cuda
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_c_approach_matches_twin(cuda, shape, refine, rg, is_negative):
    cfg, st, fields, _ = _c_setup(cuda, shape, refine, rg, is_negative)
    H, W = cfg.eff_res
    vf = np.random.default_rng(5).uniform(-0.5, 0.5, (3, 2, H, W)).astype(np.float32)
    vf = torch.as_tensor(vf, device=cuda)
    step = T.make_approach_step(cfg)
    fields = dict(fields, vel_field=vf)
    n0 = jrl_c.c_approach.launches
    steps = range(3, 3 + int(1.5 / cfg.vel_obs_conv))  # the tip crosses a row
    for k in steps:
        vel = T.stored_velocity(vf, k, cfg.vel_obs_conv)
        acc = torch.zeros(4, device=cuda)
        h, C = jrl_c.c_approach(st["h"], st["C"], vel, k, cfg, fields, acc)
        hr, Cr, ints = jrl_c.c_approach_ref(st["h"], st["C"], vel, k, cfg, fields)
        _close(h, hr, 1e-5, f"c_approach step {k} h")
        _close(C, Cr, 1e-5, f"c_approach step {k} C")
        np.testing.assert_allclose(acc.cpu().numpy(), [float(x) for x in ints], rtol=2e-4,
                                   atol=1e-4, err_msg=f"c_approach step {k} integrals")
        st, _ = step(st, fields, k)
    torch.cuda.synchronize()
    assert jrl_c.c_approach.launches - n0 == len(steps)


# --- the multi-step kernels (kernels/fused_jrl.py) ---

TRAJ_TOL = {"f": 2e-5, "rho": 2e-5, "vel": 2e-4, "h": 2e-5, "C": 2e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fused_fluid_matches_twin(cuda, shape, refine, rg):
    """One launch across a tip-row crossing, for an odd and an even step
    count (the final state lands in the outputs either way)."""
    cfg = T.JRLFluidConfig(res=RES, Re=4.0, vel_obs_real=0.2848, gravity_strength_real=-9.8,
                           shape=shape, refine=refine, Rg=rg)
    s, fields = T.fluid_init(cfg, cuda)
    s = T.make_fluid_runner(cfg)(s, fields, 0, 8)
    n = int(1.5 / cfg.vel_obs)
    assert T.tip_walks(cfg.inflow_height, 8 + n, cfg.vel_obs)[1] > T.tip_walks(
        cfg.inflow_height, 8, cfg.vel_obs)[1]
    want = F.fused_fluid_ref(s["f"], s["rho"], s["vel"], 8, n, cfg, fields)
    n0 = F.fused_fluid.launches
    for m in (n, n + 1):
        got = F.fused_fluid(s["f"], s["rho"], s["vel"], 8, m, cfg, fields)
        for name, g, w in zip(("f", "rho", "vel"), got, want):
            _close(g, w, TRAJ_TOL[name], f"fused_fluid {m} steps {name}")
        want = F.fused_fluid_ref(*want, 8 + m, 1, cfg, fields)
    torch.cuda.synchronize()
    assert F.fused_fluid.launches - n0 == 2


@pytest.mark.cuda
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fused_balance_matches_twin(cuda, shape, refine, rg, is_negative):
    cfg, st, fields, flags = _c_setup(cuda, shape, refine, rg, is_negative)
    n0 = F.fused_balance.launches
    want = F.fused_balance_ref(st["h"], st["C"], flags, 20, cfg, fields)
    for m in (20, 21):
        got = F.fused_balance(st["h"], st["C"], flags, m, cfg, fields)
        _close(got[0], want[0], TRAJ_TOL["h"], f"fused_balance {m} steps h")
        _close(got[1], want[1], TRAJ_TOL["C"], f"fused_balance {m} steps C")
        want = F.fused_balance_ref(*want, flags, 1, cfg, fields)
    torch.cuda.synchronize()
    assert F.fused_balance.launches - n0 == 2


@pytest.mark.cuda
@pytest.mark.parametrize("is_negative", [True, False])
@pytest.mark.parametrize("shape,refine,rg", SCENES)
def test_cuda_fused_approach_matches_twin(cuda, shape, refine, rg, is_negative):
    """One launch over stored-velocity frame boundaries (a new frame pair
    every ~3 steps) and a tip-row crossing, with the integrals."""
    probe = T.JRLCConfig(res=RES, shape=shape, refine=refine, Rg=rg)
    Pe = 0.03 * probe.radius_obs / (0.5 / 3.0)  # tip speed 0.03: ~3.3 steps per frame
    cfg = T.JRLCConfig(res=RES, Re=4.0, Pe=Pe, shape=shape, refine=refine, Rg=rg,
                       is_negative=is_negative)
    st, fields, flags = T.c_init(cfg, cuda)
    st = T.make_balance_runner(cfg, flags)(st, fields, 5)
    H, W = cfg.eff_res
    n = int(1.5 / cfg.vel_obs_conv)
    vf = np.random.default_rng(6).uniform(-0.5, 0.5, (20, 2, H, W)).astype(np.float32)
    vf = torch.as_tensor(vf, device=cuda)
    assert int(n * cfg.vel_obs_conv / 0.1) >= 10  # frame boundaries inside the run
    acc = torch.zeros(4, device=cuda)
    n0 = F.fused_approach.launches
    h, C = F.fused_approach(st["h"], st["C"], vf, 0, n, cfg, fields, acc)
    hr, Cr, ints = F.fused_approach_ref(st["h"], st["C"], vf, 0, n, cfg, fields)
    _close(h, hr, TRAJ_TOL["h"], "fused_approach h")
    _close(C, Cr, TRAJ_TOL["C"], "fused_approach C")
    np.testing.assert_allclose(acc.cpu().numpy(), [float(x) for x in ints], rtol=2e-4,
                               atol=1e-4, err_msg="fused_approach integrals")
    torch.cuda.synchronize()
    assert F.fused_approach.launches - n0 == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["45degree", "cylinder"])
def test_cuda_fluid_from_step_2_24_minus_5_matches_twin(cuda, shape):
    """Steps 2**24 - 5 .. 2**24 + 4 (float32 rounds the step from 2**24 on)
    through the multi-step kernel and through fluid_a / fluid_b; Re is small
    enough that the tip is inside the grid there."""
    cfg = T.JRLFluidConfig(res=RES, Re=1.2e-5, shape=shape)
    start, n = 2**24 - 5, 10
    assert 1 < T.tip_walks(cfg.inflow_height, start + n, cfg.vel_obs)[1] < RES[0] - 1
    s, fields = T.fluid_init(cfg, cuda)
    rng = np.random.default_rng(24)
    s = {k: v + torch.as_tensor((1e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                                device=cuda) for k, v in s.items()}
    want = F.fused_fluid_ref(s["f"], s["rho"], s["vel"], start, n, cfg, fields)
    got = F.fused_fluid(s["f"], s["rho"], s["vel"], start, n, cfg, fields)
    per_step = T.make_per_step_fluid_runner(cfg)(s, fields, start, n)
    for name, g, w in zip(("f", "rho", "vel"), got, want):
        _close(g, w, TRAJ_TOL[name], f"fused_fluid {name}")
        _close(per_step[name], w, TRAJ_TOL[name], f"fluid_a/fluid_b {name}")


@pytest.mark.cuda
def test_cuda_fused_grid_over_coresident_limit_raises(cuda):
    """The co-residency check passes the limit and refuses one block more,
    and the launcher itself refuses such a grid without launching."""
    index = torch.cuda.current_device()
    for name in ("fused_fluid", "fused_balance", "fused_approach"):
        for cpt in F.CELLS_PER_THREAD:
            limit = F.max_blocks(name, cpt, F.FUSED_BLOCK, index)
            assert limit >= 1
            F.check_coresident(name, cpt, F.FUSED_BLOCK, limit, index)
            with pytest.raises(ValueError, match="co-resident"):
                F.check_coresident(name, cpt, F.FUSED_BLOCK, limit + 1, index)
    cfg, st, fields, flags = _c_setup(cuda, "45degree", 1, 4.0, True)
    out = [torch.empty_like(st["h"]), torch.empty_like(st["C"])] * 2
    limit = F.max_blocks("fused_balance", 1, F.FUSED_BLOCK, index)
    fn = build.bind("fused_balance", "jrl_fused_balance", [jrl_fluid._P] * 7 + [
        ctypes.c_int, jrl_fluid._P, ctypes.c_int, ctypes.c_int, jrl_fluid._P])
    n0 = F.fused_balance.launches
    err = fn(flags.data_ptr(), st["h"].data_ptr(), st["C"].data_ptr(),
             *(t.data_ptr() for t in out), 1, ctypes.byref(F._balance_params(cfg)), 1, limit + 1,
             jrl_fluid.stream_of(cuda))
    assert err != 0
    with pytest.raises(RuntimeError, match="cudaError"):
        build.check(err, "fused_balance")
    assert F.fused_balance.launches == n0
