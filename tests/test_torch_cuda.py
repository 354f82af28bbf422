"""The four CUDA kernels of the PyTorch port against their plain twins, on
an NVIDIA card; every test skips without one (the kernels have no CPU
mode). The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX for the rest
of the suite.)

Each kernel is compared one step at a time with its twin, from the twin's
own trajectory, over steps in which the tip crosses a row. Tolerances:
f, rho, C and h at rtol = atol = 1e-5, vel at 1e-4 (float32 sums in
another order); the tip-disk integrals at rtol 2e-4 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

from jrl_lbm_torch.kernels import jrl_c, jrl_fluid
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
